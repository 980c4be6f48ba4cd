"""Relation-masked mean aggregation: the ``'segment'``, ``'ell'``,
``'ell2'`` and ``'dense'`` backends.

Counterpart of ``mpgnn_tpu/ops/spmm.py``. For the selected relation, output
row i is the mean of ``x[dst]`` over the edges ``(i, dst)`` (aggregation
into the source column of link.dat), with a zero row where i has no edge.
Every backend computes that mean; they differ in the operand:

* ``segment``: the edge list, gather + ``index_add_``. It is also the plain
  reference that the ``'csr'`` kernels are held against;
* ``ell``: the [N, D] neighbour table, gather + masked mean over D;
* ``ell2``: paired out/in tables with 1/deg folded into weights, a
  weighted gather both ways (the backward gathers over the transposed
  table, no scatter anywhere);
* ``dense``: the row-normalised float32 adjacency A and its transpose, one
  GEMM each way.

None of them reaches a kernel of its own: the JAX package leaves them to
XLA, and here they are PyTorch ops.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.device import resolve_device
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


@contextlib.contextmanager
def full_fp32():
    """Float32 products in full float32, and bf16 products summed in
    float32, inside the block, whatever the process set:
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``allow_bf16_reduced_precision_reduction`` are read, set to False and
    restored on exit. (TF32 keeps about three decimal digits; the JAX
    package's float32 GEMMs keep float32, and its bf16 ones accumulate in
    float32, ``preferred_element_type=f32``.)"""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    m.allow_tf32 = m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


# ------------------------------------------------------------------- ell
def ell_mean_aggregate(x: torch.Tensor, nbr: torch.Tensor,
                       nbr_mask: torch.Tensor) -> torch.Tensor:
    """``ell`` backend: ``nbr`` [N, D] neighbour ids per source (int64),
    ``nbr_mask`` [N, D] which of them are edges. out[i] is the mean over
    the valid d of x[nbr[i, d]]; rows without a valid neighbour are 0."""
    total = (x[nbr] * nbr_mask.to(x.dtype)[..., None]).sum(dim=-2)
    # the count in float32: exact past bf16's 256-integer range
    count = nbr_mask.to(torch.float32).sum(dim=-1, keepdim=True)
    return total * (1.0 / count.clamp_min(1.0)).to(x.dtype)


def ell_max_gather(w: torch.Tensor, nbr: torch.Tensor,
                   nbr_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scorer's primitive (model.py:74-89): for each source i, (value,
    winner) = (max over the valid d of w[nbr[i, d]], the nbr[i, d] that
    holds it first), ``w`` [N], ``nbr`` / ``nbr_mask`` [N, D]. A row
    without a valid neighbour gives (-inf, nbr[i, 0]). The gradient
    reaches only the selected element of ``w``; a row without a valid
    neighbour gives it none (the reference's index assignment)."""
    vals = torch.where(nbr_mask, w[nbr], float("-inf"))
    j = vals.argmax(dim=-1, keepdim=True)     # the first maximum on ties
    return vals.gather(-1, j)[..., 0], nbr.gather(-1, j)[..., 0]


# ------------------------------------------------------------------ ell2
class Ell2Operand(NamedTuple):
    """Paired out/in ELL tables with the mean's 1/deg(src) folded into the
    weights (0 in padded slots): aggregation gathers in both directions."""

    out_nbr: torch.Tensor   # [N, D_out] destinations per source
    out_w: torch.Tensor     # [N, D_out] 1/deg(src)
    in_nbr: torch.Tensor    # [N, D_in] sources per destination
    in_w: torch.Tensor      # [N, D_in] 1/deg(src)

    def to(self, device) -> "Ell2Operand":
        return Ell2Operand(*(t.to(device) for t in self))


def _ell_with_weights(rows, cols, weights, num_nodes: int, lo: int = 4):
    """(nbr [N, D] int64, w [N, D] float32): row r's columns and weights in
    input order (a stable sort by row), D the largest row count and at
    least ``lo``."""
    order = np.argsort(rows, kind="stable")
    rows, cols, weights = rows[order], cols[order], weights[order]
    deg = np.bincount(rows, minlength=num_nodes)
    d = max(lo, int(deg.max()) if len(rows) else 1)
    nbr = np.zeros((num_nodes, d), np.int64)
    wt = np.zeros((num_nodes, d), np.float32)
    starts = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(len(rows), dtype=np.int64) - starts[rows]
    nbr[rows, slot] = cols
    wt[rows, slot] = weights
    return torch.from_numpy(nbr), torch.from_numpy(wt)


def build_ell2_operand(src: np.ndarray, dst: np.ndarray,
                       num_nodes: int) -> Ell2Operand:
    """The ``ell2`` operand of one relation, on the CPU."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    deg = np.bincount(src, minlength=num_nodes).astype(np.float32)
    inv = (1.0 / np.maximum(deg, 1.0))[src]
    out_nbr, out_w = _ell_with_weights(src, dst, inv, num_nodes)
    in_nbr, in_w = _ell_with_weights(dst, src, inv, num_nodes)
    return Ell2Operand(out_nbr, out_w, in_nbr, in_w)


def _weighted_gather(h: torch.Tensor, nbr: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    return (h[nbr] * w[..., None]).sum(dim=1)


class _Ell2Mean(torch.autograd.Function):
    """out[i] = sum_d h[out_nbr[i, d]] * out_w[i, d]; the backward gathers
    over the transposed table: dh[d] = sum over in-edges (s -> d) of
    g[s] / deg(s). A bf16 h (or g) is summed in float32 against the float32
    weights and rounded to bf16 once, both ways. (The JAX package's
    ``ell2`` does not train in bf16: its VJP returns a float32 cotangent for
    the bf16 primal and JAX refuses it.)"""

    @staticmethod
    def forward(ctx, out_nbr, out_w, in_nbr, in_w, h):
        ctx.save_for_backward(in_nbr, in_w)
        return _weighted_gather(h, out_nbr, out_w).to(h.dtype)

    @staticmethod
    def backward(ctx, g):
        in_nbr, in_w = ctx.saved_tensors
        return (None, None, None, None,
                _weighted_gather(g, in_nbr, in_w).to(g.dtype))


def ell2_mean_aggregate(op: Ell2Operand, h: torch.Tensor) -> torch.Tensor:
    """``ell2`` backend: the relation's mean aggregation of ``h``,
    differentiable in h, with no scatter either way."""
    return _Ell2Mean.apply(*op, h)


# ----------------------------------------------------------------- dense
def dense_adjacency(src, dst, num_nodes: int,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, A^T) of one relation on ``device`` (the GPU unless
    ``device='cpu'``): A[i, d] = multiplicity(i -> d) / out_deg(i) in
    float32, so that A @ x is the mean aggregation, and its transpose as a
    contiguous copy, so that the backward is a GEMM too."""
    device = resolve_device(device)
    src = torch.as_tensor(np.asarray(src, dtype=np.int64), device=device)
    dst = torch.as_tensor(np.asarray(dst, dtype=np.int64), device=device)
    a = torch.zeros((num_nodes, num_nodes), dtype=torch.float32,
                    device=device)
    a.index_put_((src, dst), torch.ones_like(src, dtype=torch.float32),
                 accumulate=True)
    a /= a.sum(dim=1, keepdim=True).clamp_min(1.0)
    return a, a.t().contiguous()


class _DenseMean(torch.autograd.Function):
    """A @ h forward, A^T @ g backward over the stored transpose, both in
    full float32 (``full_fp32``); for a bf16 h, a bf16 GEMM summed in
    float32 and rounded to bf16, both ways, over the operand's A (which a
    bf16 run stores in bf16: ``train.loops.relation_operand``)."""

    @staticmethod
    def forward(ctx, a, a_t, h):
        ctx.save_for_backward(a_t)
        with full_fp32():
            return a.to(h.dtype) @ h

    @staticmethod
    def backward(ctx, g):
        (a_t,) = ctx.saved_tensors
        with full_fp32():
            return None, None, a_t.to(g.dtype) @ g


def dense_mean_aggregate(a: torch.Tensor, a_t: torch.Tensor,
                         h: torch.Tensor) -> torch.Tensor:
    """``dense`` backend: A @ h, differentiable in h."""
    return _DenseMean.apply(a, a_t, h)
