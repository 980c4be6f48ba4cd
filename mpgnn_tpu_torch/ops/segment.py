"""Segment reductions on tensors (``index_add_``), the counterparts of
``torch_scatter.scatter`` sum and mean in the reference's message passing."""

from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = sum of data[i] over i with segment_ids[i] == s."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def stack_edge_lists(edge_lists, num_nodes: int):
    """(src, dst, inv) of C relations' edge lists ``(src, dst, inv_deg)``
    over one graph of ``num_nodes``, stacked block-diagonally: list c is
    offset by ``c * num_nodes``, so one gather and one ``index_add_`` over
    [C * num_nodes] rows aggregate every list at once. No edge padding."""
    src, dst, inv = zip(*edge_lists)
    return (torch.cat([s + c * num_nodes for c, s in enumerate(src)]),
            torch.cat([d + c * num_nodes for c, d in enumerate(dst)]),
            torch.cat(inv))


def segment_mean(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Mean per segment; empty segments give 0 (scatter-mean parity:
    sources without an edge of the relation produce a zero row)."""
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(
        torch.ones(segment_ids.shape[0], dtype=torch.float32,
                   device=data.device),
        segment_ids, num_segments,
    )
    inv = (1.0 / count.clamp_min(1.0)).to(data.dtype)
    return total * inv.reshape(inv.shape + (1,) * (total.dim() - 1))
