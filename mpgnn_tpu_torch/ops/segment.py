"""Segment reductions on tensors (``index_add_``, ``scatter_reduce_``),
the counterparts of ``torch_scatter.scatter`` sum, mean and max in the
reference's message passing, and of ``mpgnn_tpu/ops/segment.py``: the JAX
package leaves them to XLA, and here they are PyTorch ops."""

from __future__ import annotations

from typing import Optional, Tuple

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


def _per_row(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``v`` [S] shaped to broadcast over the trailing axes of ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def masked_segment_mean(
    data: torch.Tensor, segment_ids: torch.Tensor, mask: torch.Tensor,
    num_segments: int,
) -> torch.Tensor:
    """Mean over the entries where ``mask`` is true; empty segments give 0.
    The sums and the counts are float32 whatever ``data``'s dtype (bf16
    holds whole numbers exactly only up to 256), each sum rounded to that
    dtype once, as the bf16 forms of K1 and K2 round a row; the inverse
    count is cast to the data's dtype before the multiply. (The JAX
    package's CPU segment sum rounds a bf16 sum at every add instead.)"""
    masked = data.float() * _per_row(mask.to(torch.float32), data)
    total = segment_sum(masked, segment_ids, num_segments).to(data.dtype)
    count = segment_sum(mask.to(torch.float32), segment_ids, num_segments)
    inv = (1.0 / count.clamp_min(1.0)).to(data.dtype)
    return total * _per_row(inv, total)


def _segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, reduce: str, init) -> torch.Tensor:
    """``scatter_reduce_`` of ``data``'s rows into ``num_segments`` rows
    that start at ``init`` ('amax' or 'amin'; both exact, so the result
    does not depend on the order of the entries)."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), init)
    idx = _per_row(segment_ids, data).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce)


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None, fill: float = 0.0,
) -> torch.Tensor:
    """Max per segment over the entries where ``mask`` is true (all without
    one); a segment without such an entry gives ``fill``."""
    if mask is not None:
        data = torch.where(mask, data, float("-inf"))
    out = _segment_reduce(data, segment_ids, num_segments, "amax",
                          float("-inf"))
    return torch.where(torch.isneginf(out), fill, out)


def segment_argmax(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max value, index into ``data`` of its first occurrence) per segment
    of the 1-D ``data``, over the entries where ``mask`` is true: the first
    in ``data``'s order, as ``torch.argmax`` over the reference's
    adjacency-list order (model.py:85). A segment without an entry gives
    value -inf and index 0."""
    n = data.shape[0]
    if mask is not None:
        data = torch.where(mask, data, float("-inf"))
    maxv = _segment_reduce(data, segment_ids, num_segments, "amax",
                           float("-inf"))
    is_max = data == maxv[segment_ids]
    if mask is not None:
        is_max = is_max & mask
    pos = torch.arange(n, device=data.device)
    first = _segment_reduce(torch.where(is_max, pos, n), segment_ids,
                            num_segments, "amin", n)
    return maxv, torch.where(first >= n, 0, first)


def segment_count(segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """[num_segments] float32 count of the entries of each segment."""
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)
