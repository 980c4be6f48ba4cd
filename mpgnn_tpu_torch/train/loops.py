"""Per-hop aggregation operands for a metapath set."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.ops.csr import build_csr_blocking


def build_hop_arrays(
    graph: HeteroGraph,
    metapaths: Sequence[Sequence[int]],
    backend: str = "segment",
    device=None,
) -> List[List[tuple]]:
    """Per-(metapath, hop) aggregation operands on ``device``, as tagged
    tuples for ``models.mpgnn.hop_aggregate``:

      * 'segment': (src, dst) sorted by src and the graph-static
        1/max(deg, 1), for the gather + ``index_add_`` mean;
      * 'csr': the (forward, backward) blockings of ``ops.csr``, whose
        kernels run the aggregation on the GPU.

    Operands are built once per relation and shared by every hop that
    aggregates it."""
    if backend not in ("segment", "csr"):
        raise ValueError(f"unknown backend {backend!r}")
    device = resolve_device(device)
    cache = {}
    hop_ops: List[List[tuple]] = []
    for mp in metapaths:
        ops = []
        for rel in mp:
            rel = int(rel)
            if rel not in cache:
                if backend == "segment":
                    s, d = graph.rel_edges_csr(rel)
                    deg = graph.rel_degrees(rel)
                    inv = (1.0 / np.maximum(deg, 1)).astype(np.float32)
                    cache[rel] = (
                        "segment",
                        torch.from_numpy(s.astype(np.int64)).to(device),
                        torch.from_numpy(d.astype(np.int64)).to(device),
                        torch.from_numpy(inv).to(device),
                    )
                else:
                    s, d = graph.rel_edges(rel)
                    fwd, bwd = build_csr_blocking(s, d, graph.num_nodes)
                    cache[rel] = ("csr", fwd.to(device), bwd.to(device))
            ops.append(cache[rel])
        hop_ops.append(ops)
    return hop_ops
