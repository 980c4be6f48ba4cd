"""Relation-masked mean aggregation, the ``'segment'`` backend.

For the selected relation, output row i is the mean of ``x[dst]`` over the
edges ``(i, dst)`` (aggregation into the source column of link.dat), with a
zero row where i has no edge. It is also the plain reference that the
``'csr'`` kernels are held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpgnn_tpu_torch.ops.segment import segment_mean, segment_sum


def rel_mean_aggregate(
    x: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    num_nodes: int,
    inv_count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[i] = mean over edges (i, d) of x[d].

    ``inv_count`` ([num_nodes] = 1/max(deg, 1)) is graph-static; passing it
    replaces the per-call count with one multiply."""
    gathered = x[dst]
    if inv_count is None:
        return segment_mean(gathered, src, num_nodes)
    return segment_sum(gathered, src, num_nodes) * inv_count.to(x.dtype)[:, None]
