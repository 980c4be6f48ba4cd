"""Fused dense-adjacency RelConv on two hand-written CUDA kernels.

Counterpart of ``mpgnn_tpu/ops/pallas_conv.py``. With ``A`` the
row-normalised mean adjacency of one relation, stored in bf16, one hop of
the ``'pallas'`` backend is

    agg = A @ bf16(h)                       (float32 sums)
    out = relu(agg @ W + h @ root + b)

* K3 (``csrc/dense_matmul.cu``, ``mpgnn_dense_conv``) computes ``out`` and
  ``agg`` in one pass over A;
* K4 (the same source, ``mpgnn_dense_matmul``) computes ``A^T @ bf16(d)``
  for the backward, over the stored transpose, so no transpose is ever
  formed during training.

Both run one main loop (TMA and ``wgmma``, the reduction split over CTAs by
``matmul_splits``) and differ in their last pass: K4 adds the splits, K3's
epilogue adds them and applies W, root, b and the ReLU. K3 takes any F and
H, as the JAX kernel does (its main loop runs once a slice of at most
``MAX_WIDTH`` columns of h, its epilogue stages f in chunks); K4 takes
``MAX_WIDTH`` columns a launch.

``dense_conv`` is a ``torch.autograd.Function`` whose backward is
``_conv_vjp_bwd`` of the JAX package: the small GEMMs stay ``torch.matmul``
and K4 runs only when the input ``h`` needs a gradient (hop 0's input
``x`` needs none). K4 also runs the batched ``'dense'`` evaluation's
grouped products, forward and backward (``grouped_dense_aggregate``: the
candidates of one relation side by side, at most ``MAX_WIDTH`` columns a
launch). Each kernel has a plain PyTorch version beside it
(float64 sums over the same bf16-rounded operands, rounded once); a wrapper
takes it for CPU tensors only and launches its kernel for CUDA tensors.
``CONV_LAUNCHES`` and ``MATMUL_LAUNCHES`` count the kernels' launches,
``CONV_BF16H_LAUNCHES`` K3's with a bf16 h: the hop 0 of a
``compute_dtype='bfloat16'`` run, whose input is bf16(x); K3's output, and
so every later hop's input, is float32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.ops import _kernels

CONV_LAUNCHES = 0
MATMUL_LAUNCHES = 0
# K3's launches with a bf16 h (the hop 0 of a compute_dtype='bfloat16' run)
CONV_BF16H_LAUNCHES = 0
# widest input of one main loop (four 64-wide wgmma products): a K4
# launch's width, a K3 slice's
MAX_WIDTH = 256


@dataclasses.dataclass(frozen=True)
class DenseConvOperand:
    """One relation's mean adjacency ``a`` [N, N] bf16 and its transpose
    ``a_t``, on one device. The row stride of each is N rounded up to 8 (the
    16 bytes the kernels' TMA copies need), so for N not a multiple of 8
    each is a view of the first N columns of its storage, the rest zero."""

    a: torch.Tensor
    a_t: torch.Tensor
    num_rows: int


def build_dense_conv_operand(src, dst, num_nodes: int,
                             device=None) -> DenseConvOperand:
    """The operand of one relation, built on ``device`` (default the GPU;
    ``device='cpu'`` for the CPU): edge counts scattered into [N, N]
    float32, each row divided by its degree (clamped to 1), then cast to
    bf16 (round to nearest even) as is and transposed. The values are those
    of the JAX package's ``build_dense_conv_operand`` rows ``[:N]``; its
    256-row padding is a TPU block size and is not kept."""
    device = resolve_device(device)
    src = torch.as_tensor(np.asarray(src, dtype=np.int64), device=device)
    dst = torch.as_tensor(np.asarray(dst, dtype=np.int64), device=device)
    a = torch.zeros((num_nodes, num_nodes), dtype=torch.float32,
                    device=device)
    a.index_put_((src, dst), torch.ones_like(src, dtype=torch.float32),
                 accumulate=True)
    a /= a.sum(dim=1, keepdim=True).clamp_min(1.0)
    stride = -(-num_nodes // 8) * 8
    a_pad = torch.zeros((num_nodes, stride), dtype=torch.bfloat16,
                        device=device)
    a_pad[:, :num_nodes] = a
    del a
    a = a_pad[:, :num_nodes]
    a_t = torch.zeros_like(a_pad)
    a_t[:, :num_nodes] = a.t()
    return DenseConvOperand(a=a, a_t=a_t[:, :num_nodes], num_rows=num_nodes)


# ------------------------------------------------------------- plain versions
def dense_conv_plain(a: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                     root: torch.Tensor,
                     b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in PyTorch: (out, agg), float64 sums over the bf16
    adjacency and bf16-rounded h (h @ root over h as it is, float32 or
    bf16), each output rounded once to float32."""
    agg = a.double() @ h.to(torch.bfloat16).double()
    z = agg @ w.double() + h.double() @ root.double() + b.double()
    return torch.relu(z).float(), agg.float()


def dense_matmul_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K4's function in PyTorch: ``a @ bf16(x)`` summed in float64."""
    return (a.double() @ x.to(torch.bfloat16).double()).to(x.dtype)


# ------------------------------------------------------------------ wrappers
def _same_device(*xs: torch.Tensor) -> None:
    for x in xs[1:]:
        if x.device != xs[0].device:
            raise ValueError(f"tensors on {x.device} and {xs[0].device}")


def _check(a: torch.Tensor, *xs: torch.Tensor) -> None:
    """Types and layouts the kernels take: ``a`` needs 16-byte aligned
    rows (TMA), as ``DenseConvOperand.a`` and ``a_t`` have, the rest
    contiguity and float32 (K3's h is checked by its wrapper)."""
    if a.dtype != torch.bfloat16 or a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise TypeError(f"kernel takes a square bf16 adjacency, got {a.dtype} "
                        f"{tuple(a.shape)}")
    if a.stride(1) != 1 or a.stride(0) % 8 or a.data_ptr() % 16:
        raise ValueError(f"kernel takes 16-byte aligned rows of a, got "
                         f"strides {a.stride()}: use build_dense_conv_operand")
    for x in xs:
        if not x.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"kernel takes float32 operands, got {x.dtype}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _k4_width(f: int) -> int:
    """The main loop's tile width for F: 64, 128, 192 or 256 (one to four
    64-wide wgmma products)."""
    return next(w for w in (64, 128, 192, 256) if w >= f)


def matmul_splits(n: int, sms: int) -> int:
    """How many ranges K3 and K4 split the reduction of N = n into: enough
    that the ceil(n / 128) row blocks give each of ``sms`` SMs a CTA, and no
    more; at least 1 and at most one 64-column tile each."""
    return max(1, min(-(-n // 64), sms // -(-n // 128)))


def _main_loop_scratch(x: torch.Tensor):
    """(splits, xt): the split count on x's card and the [FP, N8] bf16
    scratch of the transposed, rounded x (at most ``MAX_WIDTH`` columns)
    that the main loop reads."""
    n, f = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    xt = torch.empty((_k4_width(f), -(-n // 8) * 8), dtype=torch.bfloat16,
                     device=x.device)
    return matmul_splits(n, sms), xt


def _split_scratch(out: torch.Tensor, splits: int) -> torch.Tensor:
    """The [splits, n, F] scratch of the split sums; ``out`` itself for one
    split (the main loop then writes it directly)."""
    return out if splits == 1 else out.new_empty((splits,) + out.shape)


def _conv_shapes(a: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                 root: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int]:
    """(n, F, H): the card path's check of K3's operands, which refuses bad
    types, layouts and shapes and takes any F and H."""
    bf16h = h.dtype == torch.bfloat16
    _check(a, w, root, b, *([] if bf16h else [h]))
    if not h.is_contiguous():
        raise ValueError("kernel takes contiguous tensors")
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"h {tuple(h.shape)} and w {tuple(w.shape)} must "
                         f"be 2-D")
    n, f = h.shape
    hdim = w.shape[1]
    if a.shape[0] != n or w.shape != (f, hdim) or root.shape != (f, hdim) \
            or b.shape != (hdim,):
        raise ValueError(f"shapes a {tuple(a.shape)}, h {tuple(h.shape)}, "
                         f"w {tuple(w.shape)}, root {tuple(root.shape)}, "
                         f"b {tuple(b.shape)} do not fit")
    if min(n, f, hdim) <= 0:
        raise ValueError(f"K3 takes n, F, H > 0, got {n}, {f}, {hdim}")
    return n, f, hdim


def dense_conv_fwd(a: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                   root: torch.Tensor,
                   b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, agg), both float32: K3 on CUDA tensors (its bf16-h form for a
    bf16 h), its plain version on CPU tensors. On the card ``a``'s rows
    must be 16-byte aligned (row stride a multiple of 8), as
    ``DenseConvOperand.a`` is."""
    _same_device(a, h, w, root, b)
    if h.device.type == "cpu":
        return dense_conv_plain(a, h, w, root, b)
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    bf16h = h.dtype == torch.bfloat16
    n, f, hdim = _conv_shapes(a, h, w, root, b)
    out = torch.empty((n, hdim), dtype=torch.float32, device=h.device)
    agg = torch.empty((n, f), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        # one scratch of the widest slice, reused by every slice
        splits, xt = _main_loop_scratch(h[:, :MAX_WIDTH])
        part = _split_scratch(agg, splits)
        _kernels.launch(
            "dense_conv_bf16h" if bf16h else "dense_conv", a.data_ptr(),
            a.stride(0), xt.data_ptr(), h.data_ptr(), w.data_ptr(),
            root.data_ptr(), b.data_ptr(), out.data_ptr(), agg.data_ptr(),
            part.data_ptr(), n, f, hdim, splits, _stream(h),
        )
    global CONV_LAUNCHES, CONV_BF16H_LAUNCHES
    if bf16h:
        CONV_BF16H_LAUNCHES += 1
    else:
        CONV_LAUNCHES += 1
    return out, agg


def dense_matmul(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ bf16(x)``: K4 on CUDA tensors, its plain version on CPU
    tensors. On the card ``a``'s rows must be 16-byte aligned (row stride a
    multiple of 8), as ``DenseConvOperand.a`` and ``a_t`` are; an x wider
    than ``MAX_WIDTH`` columns runs one launch a slice of at most
    ``MAX_WIDTH`` columns, each streaming ``a`` once."""
    _same_device(a, x)
    if x.device.type == "cpu":
        return dense_matmul_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(a, x)
    if x.dim() != 2 or a.shape[0] != x.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and x {tuple(x.shape)} do not "
                         f"fit")
    if x.shape[1] > MAX_WIDTH:
        return torch.cat([_dense_matmul_launch(a, s.contiguous())
                          for s in x.split(MAX_WIDTH, dim=1)], dim=1)
    return _dense_matmul_launch(a, x)


def _dense_matmul_launch(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One K4 launch, x [N, F <= MAX_WIDTH]."""
    n, f = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        splits, xt = _main_loop_scratch(x)
        part = _split_scratch(out, splits)
        _kernels.launch("dense_matmul", a.data_ptr(), a.stride(0),
                        xt.data_ptr(), x.data_ptr(), out.data_ptr(),
                        part.data_ptr(), n, f, splits, _stream(x))
    global MATMUL_LAUNCHES
    MATMUL_LAUNCHES += 1
    return out


class _DenseConv(torch.autograd.Function):
    """K3 forward; ``_conv_vjp_bwd`` backward with K4 for ``dh``."""

    @staticmethod
    def forward(ctx, a, a_t, h, w, root, b):
        out, agg = dense_conv_fwd(a, h, w, root, b)
        ctx.save_for_backward(a_t, h, w, root, out, agg)
        return out

    @staticmethod
    def backward(ctx, g):
        a_t, h, w, root, out, agg = ctx.saved_tensors
        dz = torch.where(out > 0, g, torch.zeros_like(g))
        dw = agg.t() @ dz
        db = dz.sum(0)
        droot = h.to(dz.dtype).t() @ dz    # a bf16 h widened, as in JAX
        dh = None
        if ctx.needs_input_grad[2]:
            dh = dense_matmul(a_t, (dz @ w.t()).contiguous()) + dz @ root.t()
            dh = dh.to(h.dtype)
        return None, None, dh, dw, droot, db


def dense_conv(op: DenseConvOperand, h: torch.Tensor, w: torch.Tensor,
               root: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu((A @ bf16(h)) @ w + h @ root + b) for the relation of ``op``,
    float32, differentiable in h, w, root and b; h float32 or bf16."""
    return _DenseConv.apply(op.a, op.a_t, h, w, root, b)


class _DenseAggregate(torch.autograd.Function):
    """``a @ bf16(x)`` through K4, differentiable in x: K4 forward over
    ``a``, K4 backward over the stored ``a_t``."""

    @staticmethod
    def forward(ctx, a, a_t, x):
        ctx.save_for_backward(a_t)
        return dense_matmul(a, x)

    @staticmethod
    def backward(ctx, g):
        (a_t,) = ctx.saved_tensors
        return None, None, dense_matmul(a_t, g.contiguous())


def grouped_dense_aggregate(op: DenseConvOperand, h: torch.Tensor,
                            idx=None) -> torch.Tensor:
    """The batched ``'dense'`` evaluation's aggregation of the candidates
    ``idx`` (default all) of h's [C, N, F] blocks, which take the relation
    of ``op`` at one hop: ``A @ bf16(h[g])`` for each, float32 sums,
    differentiable in h (the JAX package's ``_grouped_dense_agg``). The
    blocks go through K4 side by side, ``MAX_WIDTH // F`` candidates a
    launch (one if F is wider), so each launch streams A once for up to
    ``MAX_WIDTH`` columns; each launch's [N, k * F] operand is gathered
    from h in one copy. Returns [len(idx), N, F]."""
    c, n, f = h.shape
    idx = torch.as_tensor(list(range(c)) if idx is None else list(idx),
                          dtype=torch.int64, device=h.device)
    per = max(1, MAX_WIDTH // f)
    by_node = h.transpose(0, 1)
    outs = [_DenseAggregate.apply(op.a, op.a_t,
                                  by_node[:, part].reshape(n, -1))
            .view(n, -1, f).transpose(0, 1)
            for part in idx.split(per)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)
