"""The ``'onehot'`` backend: scatter-free mean aggregation by block-local
one-hot products.

Counterpart of ``mpgnn_tpu/ops/pallas_spmm.py``, which, despite its name,
reaches no ``pallas_call``: its aggregation is XLA ops, and here it is
PyTorch ops. A relation's edges are sorted by target row and cut into
blocks of ``block_rows`` rows, each block's edges padded to the largest
block's count ``EB`` with weight 0. Aggregation is then

  1. a row gather of the feature rows the edges name, [nb, EB, F], and
  2. one ``torch.bmm`` against the block incidence [nb, BM, EB], whose
     entries are the edges' 1/deg(src) weights at their local rows.

The backward is the same computation on the blocking sorted by
destination (``dh[dst] += g[src] / deg(src)``), so neither direction
scatters. The JAX package lays the per-edge arrays out as [nb, EB/128, 128]
and rounds EB up to 128 lanes for Pallas TPU block shapes; the port keeps
[nb, EB] (the padded slots weigh 0, so the sums are the same).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.ops.spmm import full_fp32


@dataclasses.dataclass(frozen=True)
class SpmmBlocking:
    """One direction of one relation's blocking. ``fwd``: rows are edge
    sources; ``bwd``: rows are destinations, with the edge's 1/deg(src)
    weight."""

    dst: torch.Tensor        # [nb, EB] int64 gathered feature rows
    local_row: torch.Tensor  # [nb, EB] int64 target row within the block
    weight: torch.Tensor     # [nb, EB] float32 edge weight (0: padding)
    incidence: torch.Tensor  # [nb, BM, EB] float32 one-hot with weight
    num_rows: int
    block_rows: int

    def to(self, device) -> "SpmmBlocking":
        return dataclasses.replace(
            self, dst=self.dst.to(device),
            local_row=self.local_row.to(device),
            weight=self.weight.to(device),
            incidence=self.incidence.to(device))


def _build_one_side(rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
                    num_rows: int, block_rows: int) -> SpmmBlocking:
    order = np.argsort(rows, kind="stable")
    rows, cols, weights = rows[order], cols[order], weights[order]
    nb = -(-max(num_rows, 1) // block_rows)
    block_of = rows // block_rows
    counts = np.bincount(block_of, minlength=nb)
    eb = max(int(counts.max()), 1)
    offsets = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    slot = np.arange(len(rows), dtype=np.int64) - offsets[block_of]
    dst = np.zeros((nb, eb), dtype=np.int64)
    local = np.zeros((nb, eb), dtype=np.int64)
    wt = np.zeros((nb, eb), dtype=np.float32)
    dst[block_of, slot] = cols
    local[block_of, slot] = rows - block_of * block_rows
    wt[block_of, slot] = weights
    inc = ((local[:, None, :] == np.arange(block_rows)[None, :, None])
           * wt[:, None, :]).astype(np.float32)
    return SpmmBlocking(
        dst=torch.from_numpy(dst), local_row=torch.from_numpy(local),
        weight=torch.from_numpy(wt), incidence=torch.from_numpy(inc),
        num_rows=num_rows, block_rows=block_rows)


def build_spmm_blocking(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                        block_rows: int = 128
                        ) -> Tuple[SpmmBlocking, SpmmBlocking]:
    """(forward, backward) blockings of one relation, on the CPU. Forward:
    the mean over out-edges into source rows, weights 1/deg(src);
    backward: dh[d] = sum over edges (s -> d) of g[s] / deg(s), the same
    weights with rows and columns swapped."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    deg = np.bincount(src, minlength=num_nodes).astype(np.float32)
    ew = (1.0 / np.maximum(deg, 1.0))[src]
    return (_build_one_side(src, dst, ew, num_nodes, block_rows),
            _build_one_side(dst, src, ew, num_nodes, block_rows))


def _onehot_apply(blocking: SpmmBlocking, h: torch.Tensor) -> torch.Tensor:
    nb, eb = blocking.dst.shape
    gathered = h[blocking.dst.reshape(-1)].view(nb, eb, h.shape[1])
    with full_fp32():
        out = torch.bmm(blocking.incidence.to(h.dtype), gathered)
    return out.reshape(nb * blocking.block_rows, h.shape[1])[
        :blocking.num_rows]


class _OnehotMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, fwd, bwd):
        ctx.bwd = bwd
        return _onehot_apply(fwd, h)

    @staticmethod
    def backward(ctx, g):
        return _onehot_apply(ctx.bwd, g), None, None


def onehot_spmm_mean(fwd: SpmmBlocking, bwd: SpmmBlocking,
                     h: torch.Tensor) -> torch.Tensor:
    """The relation's mean aggregation of ``h`` [N, F], differentiable in
    h, through the forward blocking (the backward through ``bwd``)."""
    return _OnehotMean.apply(h, fwd, bwd)
