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
epilogue adds them and applies W, root, b and the ReLU.

``dense_conv`` is a ``torch.autograd.Function`` whose backward is
``_conv_vjp_bwd`` of the JAX package: the small GEMMs stay ``torch.matmul``
and K4 runs only when the input ``h`` needs a gradient (hop 0's input
``x`` needs none). Each kernel has a plain PyTorch version beside it
(float64 sums over the same bf16-rounded operands, rounded once); a wrapper
takes it for CPU tensors only and launches its kernel for CUDA tensors.
``CONV_LAUNCHES`` and ``MATMUL_LAUNCHES`` count the kernels' launches.
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
# widest input the kernels take (four 64-wide wgmma products), and the
# largest F * H whose W and root the K3 epilogue stages in shared memory
MAX_WIDTH = 256
MAX_EPILOGUE_WEIGHTS = 16384


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
    adjacency and bf16-rounded h, each output rounded once to float32."""
    agg = a.double() @ h.to(torch.bfloat16).double()
    z = agg @ w.double() + h.double() @ root.double() + b.double()
    return torch.relu(z).to(h.dtype), agg.to(h.dtype)


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
    contiguity."""
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
    scratch of the transposed, rounded x that the main loop reads."""
    n, f = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    xt = torch.empty((_k4_width(f), -(-n // 8) * 8), dtype=torch.bfloat16,
                     device=x.device)
    return matmul_splits(n, sms), xt


def _split_scratch(out: torch.Tensor, splits: int) -> torch.Tensor:
    """The [splits, n, F] scratch of the split sums; ``out`` itself for one
    split (the main loop then writes it directly)."""
    return out if splits == 1 else out.new_empty((splits,) + out.shape)


def dense_conv_fwd(a: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                   root: torch.Tensor,
                   b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, agg): K3 on CUDA tensors, its plain version on CPU tensors. On
    the card ``a``'s rows must be 16-byte aligned (row stride a multiple of
    8), as ``DenseConvOperand.a`` is."""
    _same_device(a, h, w, root, b)
    if h.device.type == "cpu":
        return dense_conv_plain(a, h, w, root, b)
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    _check(a, h, w, root, b)
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
    if f > MAX_WIDTH or f * hdim > MAX_EPILOGUE_WEIGHTS:
        raise ValueError(f"K3 takes F <= {MAX_WIDTH} and F * H <= "
                         f"{MAX_EPILOGUE_WEIGHTS}, got F={f}, H={hdim}")
    out = torch.empty((n, hdim), dtype=h.dtype, device=h.device)
    agg = torch.empty((n, f), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        splits, xt = _main_loop_scratch(h)
        part = _split_scratch(agg, splits)
        _kernels.launch(
            "dense_conv", a.data_ptr(), a.stride(0), xt.data_ptr(),
            h.data_ptr(), w.data_ptr(), root.data_ptr(), b.data_ptr(),
            out.data_ptr(), agg.data_ptr(), part.data_ptr(), n, f, hdim,
            splits, _stream(h),
        )
    global CONV_LAUNCHES
    CONV_LAUNCHES += 1
    return out, agg


def dense_matmul(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ bf16(x)``: K4 on CUDA tensors, its plain version on CPU
    tensors. On the card ``a``'s rows must be 16-byte aligned (row stride a
    multiple of 8), as ``DenseConvOperand.a_t`` is."""
    _same_device(a, x)
    if x.device.type == "cpu":
        return dense_matmul_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(a, x)
    if x.dim() != 2 or a.shape[0] != x.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and x {tuple(x.shape)} do not "
                         f"fit")
    n, f = x.shape
    if f > MAX_WIDTH:
        raise ValueError(f"K4 takes F <= {MAX_WIDTH}, got {f}")
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
        droot = h.t() @ dz
        dh = None
        if ctx.needs_input_grad[2]:
            dh = dense_matmul(a_t, (dz @ w.t()).contiguous()) + dz @ root.t()
        return None, None, dh, dw, droot, db


def dense_conv(op: DenseConvOperand, h: torch.Tensor, w: torch.Tensor,
               root: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu((A @ bf16(h)) @ w + h @ root + b) for the relation of ``op``,
    differentiable in h, w, root and b."""
    return _DenseConv.apply(op.a, op.a_t, h, w, root, b)
