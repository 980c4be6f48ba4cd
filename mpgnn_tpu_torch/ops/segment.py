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
