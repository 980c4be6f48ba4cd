"""Sorted-CSR mean aggregation on two hand-written CUDA kernels.

Counterpart of ``mpgnn_tpu/ops/pallas_csr.py``. One relation's aggregation
``out[s] = mean over edges (s, d) of x[d]`` (rows without edges give 0)
runs in one of two forms, chosen per direction by ``build_csr_blocking``:

* ``CsrBlocking`` -> K1 (``csrc/csr_scatter.cu``): a row-sorted CSR with
  per-edge weights 1/deg; a group of threads per row gathers the row's
  neighbours and sums them in registers.
* ``DedupCsrBlocking`` -> K2 (``csrc/csr_dedup.cu``): for hub-skewed
  relations, where many edges of one row block repeat the same gather
  column. Each tile of a row block gathers its distinct columns once into
  shared memory and fans them out to its edges from there.

Each kernel has a plain PyTorch version beside it (``index_add_`` over the
same blocking). A wrapper takes the plain version for a tensor on the CPU
and launches its kernel for a CUDA tensor; there is no fallback from one to
the other. ``SCATTER_LAUNCHES`` and ``DEDUP_LAUNCHES`` count the kernels'
launches.

``csr_mean_aggregate`` is a ``torch.autograd.Function``: its backward runs
the same kernels (or, on the CPU, the same plain versions) on the
destination-sorted blocking, as the JAX package's ``custom_vjp`` does.
Autograd never differentiates the plain versions' ``index_add_``.
``CSR_BACKWARD_LAUNCHES`` counts the backward passes that ran on the GPU.
It is not a third kernel's count: each such pass launched K1 or K2 once,
and that launch is already in ``SCATTER_LAUNCHES`` or ``DEDUP_LAUNCHES``.

The blockings are the port's own: no edge padding, no [16, 128] edge
panels, no column padding of gathered rows and no trailing gather dummy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from mpgnn_tpu_torch.native import degrees, sort_block_col
from mpgnn_tpu_torch.ops import _kernels
from mpgnn_tpu_torch.ops.segment import segment_mean

# A direction routes to the dedup blocking when its edges per distinct
# (row block, column) pair reach this ratio. The value was measured on the
# TPU (v5e) for the Pallas kernels and has not yet been measured on the card.
DEDUP_MIN_RATIO = 2.0
# Rows per dedup row block (one CTA of K2 owns a block) and the ratio's
# block size.
DEDUP_BLOCK_ROWS = 1024
# Distinct columns per dedup tile: the rows K2 stages in shared memory
# (512 rows x 64 floats = 128 KB).
DEDUP_UNIQ = 512
# A row's edges inside a dedup tile are cut into at most this many
# segments of at least this many edges, so that K2's thread groups share a
# hub row.
DEDUP_PIECE = 32

SCATTER_LAUNCHES = 0
DEDUP_LAUNCHES = 0
CSR_BACKWARD_LAUNCHES = 0


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


class _Tensors:
    def tensors(self):
        """(name, tensor) of every tensor field."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def to(self, device):
        """The same blocking with its tensors on ``device``."""
        return dataclasses.replace(
            self, **{name: t.to(device) for name, t in self.tensors()})


@dataclasses.dataclass(frozen=True)
class CsrBlocking(_Tensors):
    """Row-sorted CSR of one direction:
    ``out[r] = sum over e in row r of weight[e] * x[col[e]]``."""

    row_ptr: torch.Tensor   # [num_rows + 1] int32
    col: torch.Tensor       # [E] int32, ascending inside each row
    weight: torch.Tensor    # [E] float32
    num_rows: int
    num_cols: int           # rows of the gathered operand x


@dataclasses.dataclass(frozen=True)
class DedupCsrBlocking(_Tensors):
    """Unique-column tiles of one direction (layout in csrc/csr_dedup.cu):
    ``out[r] = post * sum over edges (r, c) of pre[c] * x[c]`` where
    ``scale`` is the post-scale of output rows (forward) or, with
    ``scale_is_pre``, the pre-scale of gathered rows (backward)."""

    block_tile_ptr: torch.Tensor  # [nb + 1] tiles of each row block
    tile_uniq_ptr: torch.Tensor   # [T + 1] offsets into uniq_col
    uniq_col: torch.Tensor        # [sum of unique counts] gather rows
    tile_seg_ptr: torch.Tensor    # [T + 1] offsets into seg_row
    seg_row: torch.Tensor         # [S] output row inside the block
    seg_ptr: torch.Tensor         # [S + 1] edge offsets of each segment
    slot: torch.Tensor            # [E] position in the tile's unique list
    scale: torch.Tensor           # [num_rows] or [num_cols] float32
    num_rows: int
    num_cols: int
    block_rows: int
    uniq: int
    scale_is_pre: bool


Blocking = Union[CsrBlocking, DedupCsrBlocking]


# ------------------------------------------------------------------ builders
def _build_one_direction(rows, cols, weights, num_rows, num_cols) -> CsrBlocking:
    order = sort_block_col(rows, cols, 1)
    row_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=num_rows), out=row_ptr[1:])
    return CsrBlocking(
        row_ptr=_i32(row_ptr), col=_i32(cols[order]),
        weight=torch.from_numpy(np.ascontiguousarray(weights[order],
                                                     dtype=np.float32)),
        num_rows=num_rows, num_cols=num_cols,
    )


def _build_one_direction_dedup(
    rows, cols, scale, num_rows, num_cols, bm, scale_is_pre, u=DEDUP_UNIQ,
) -> DedupCsrBlocking:
    """Inside each row block (edges sorted by column) a new tile starts at
    every ``u``-th distinct column, so a column never straddles two tiles of
    one block. Inside a tile, edges are regrouped by (row, slot) and cut
    into segments: one per output row, a long row into up to
    ``DEDUP_PIECE`` segments of at least ``DEDUP_PIECE`` edges."""
    nb = max(1, -(-num_rows // bm))
    order = sort_block_col(rows, cols, bm)
    rows, cols = rows[order], cols[order]
    blk = rows // bm
    e = len(rows)
    new = np.ones(e, dtype=bool)              # first edge of a (block, col)
    new[1:] = (blk[1:] != blk[:-1]) | (cols[1:] != cols[:-1])
    pair = np.cumsum(new) - 1                 # distinct-pair index
    pairs_per_block = np.bincount(blk[new], minlength=nb)
    pair_off = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(pairs_per_block, out=pair_off[1:])
    rank = pair - pair_off[blk]               # column rank inside the block
    block_tile_ptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(-(-pairs_per_block // u), out=block_tile_ptr[1:])
    t = int(block_tile_ptr[-1])
    tile = block_tile_ptr[blk] + rank // u
    slot = rank % u
    tile_uniq_ptr = np.zeros(t + 1, dtype=np.int64)
    np.cumsum(np.bincount(tile[new], minlength=t), out=tile_uniq_ptr[1:])
    uniq_col = cols[new]

    order = np.lexsort((slot, rows, tile))
    rows, slot, tile = rows[order], slot[order], tile[order]
    run_new = np.ones(e, dtype=bool)          # first edge of a (tile, row)
    run_new[1:] = (tile[1:] != tile[:-1]) | (rows[1:] != rows[:-1])
    run_start = np.flatnonzero(run_new)
    run_len = np.diff(np.append(run_start, e))
    piece = np.maximum(DEDUP_PIECE, -(-run_len // DEDUP_PIECE))
    pieces = -(-run_len // piece)
    run_of = np.repeat(np.arange(len(run_start)), pieces)
    k = np.arange(len(run_of)) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    seg_start = run_start[run_of] + k * piece[run_of]
    tile_seg_ptr = np.zeros(t + 1, dtype=np.int64)
    np.cumsum(np.bincount(tile[seg_start], minlength=t), out=tile_seg_ptr[1:])
    return DedupCsrBlocking(
        block_tile_ptr=_i32(block_tile_ptr), tile_uniq_ptr=_i32(tile_uniq_ptr),
        uniq_col=_i32(uniq_col), tile_seg_ptr=_i32(tile_seg_ptr),
        seg_row=_i32(rows[seg_start] % bm),
        seg_ptr=_i32(np.append(seg_start, e)), slot=_i32(slot),
        scale=torch.from_numpy(np.ascontiguousarray(scale, dtype=np.float32)),
        num_rows=num_rows, num_cols=num_cols, block_rows=bm, uniq=u,
        scale_is_pre=scale_is_pre,
    )


def dedup_ratio(rows: np.ndarray, cols: np.ndarray, bm: int) -> float:
    """Edges per distinct (row block, column) pair: the factor by which the
    dedup tiles cut the rows gathered from device memory."""
    if len(rows) == 0:
        return 1.0
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    key = (rows // bm) * (int(cols.max()) + 1) + cols
    return float(len(rows) / max(len(np.unique(key)), 1))


def build_csr_blocking(
    src: np.ndarray, dst: np.ndarray, num_nodes: int,
    bm: Optional[int] = None, dedup: str = "auto",
) -> Tuple[Blocking, Blocking]:
    """(forward, backward) blockings of one relation's mean aggregation, as
    CPU tensors (``.to(device)`` moves them).

    Forward rows are edge sources (mean over out-edges, 1/deg(src));
    backward rows are destinations with the same per-edge weight,
    ``dx[d] = sum over edges (s, d) of g[s] / deg(s)``. ``bm`` is the dedup
    row-block size (default ``DEDUP_BLOCK_ROWS``). ``dedup='auto'`` routes a
    direction to the dedup tiles when its ``dedup_ratio`` at ``bm`` reaches
    ``DEDUP_MIN_RATIO``; ``'never'`` and ``'always'`` force a side."""
    if dedup not in ("auto", "never", "always"):
        raise ValueError(f"dedup must be auto, never or always, not {dedup!r}")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    bm = bm or DEDUP_BLOCK_ROWS
    inv = (1.0 / np.maximum(degrees(src, num_nodes), 1)).astype(np.float32)
    ew = inv[src]

    def want(rows, cols):
        if dedup == "never" or len(src) == 0:
            return False
        return dedup == "always" or dedup_ratio(rows, cols, bm) >= DEDUP_MIN_RATIO

    n = num_nodes
    if want(src, dst):
        fwd = _build_one_direction_dedup(src, dst, inv, n, n, bm, False)
    else:
        fwd = _build_one_direction(src, dst, ew, n, n)
    if want(dst, src):
        bwd = _build_one_direction_dedup(dst, src, inv, n, n, bm, True)
    else:
        bwd = _build_one_direction(dst, src, ew, n, n)
    return fwd, bwd


# ------------------------------------------------------------- plain versions
# The plain versions sum in float64 and round once: a hub row of the
# power-law KG has 80k edges, and a float32 sum in another order than the
# kernels' compensated one would drift past the 1e-5 the two are held to.
def csr_scatter_plain(blk: CsrBlocking, x: torch.Tensor) -> torch.Tensor:
    """K1's function in PyTorch: weighted gather + ``index_add_``."""
    rows = torch.repeat_interleave(
        torch.arange(blk.num_rows, device=x.device), blk.row_ptr.diff().long()
    )
    vals = x[blk.col.long()].double() * blk.weight.double()[:, None]
    out = torch.zeros((blk.num_rows, x.shape[1]), dtype=torch.float64,
                      device=x.device)
    return out.index_add_(0, rows, vals).to(x.dtype)


def csr_dedup_plain(blk: DedupCsrBlocking, x: torch.Tensor) -> torch.Tensor:
    """K2's function in PyTorch: gather each tile's unique rows, fan them
    out to the edges by slot, ``index_add_`` into rows, scale."""
    dtype = x.dtype
    x = x.double()
    if blk.scale_is_pre:
        x = x * blk.scale.double()[:, None]
    dev = x.device
    num_tiles = blk.tile_uniq_ptr.shape[0] - 1
    y = x[blk.uniq_col.long()]
    tile_edges = blk.seg_ptr[blk.tile_seg_ptr.long()].diff().long()
    edge_tile = torch.repeat_interleave(
        torch.arange(num_tiles, device=dev), tile_edges)
    tile_block = torch.repeat_interleave(
        torch.arange(blk.block_tile_ptr.shape[0] - 1, device=dev),
        blk.block_tile_ptr.diff().long())
    edge_row = torch.repeat_interleave(
        blk.seg_row.long(), blk.seg_ptr.diff().long()
    ) + tile_block[edge_tile] * blk.block_rows
    vals = y[blk.tile_uniq_ptr[edge_tile].long() + blk.slot.long()]
    out = x.new_zeros((blk.num_rows, x.shape[1])).index_add_(0, edge_row, vals)
    if not blk.scale_is_pre:
        out = out * blk.scale.double()[:, None]
    return out.to(dtype)


# ------------------------------------------------------------------ wrappers
def _check_cuda(x: torch.Tensor, blk: Blocking) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"kernel takes a 2-D float32 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("kernel takes a contiguous tensor")
    if x.shape[0] != blk.num_cols:
        raise ValueError(f"x has {x.shape[0]} rows, blocking gathers from "
                         f"{blk.num_cols}")
    for name, t in blk.tensors():
        if t.device != x.device:
            raise ValueError(f"blocking.{name} is on {t.device}, x on "
                             f"{x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def csr_scatter(blk: CsrBlocking, x: torch.Tensor) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return csr_scatter_plain(blk, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda(x, blk)
    out = torch.empty((blk.num_rows, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    f = x.shape[1]
    vec = 4 if f % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(x.device):
        _kernels.launch(
            "csr_scatter", blk.row_ptr.data_ptr(), blk.col.data_ptr(),
            blk.weight.data_ptr(), x.data_ptr(), out.data_ptr(),
            blk.num_rows, f, vec, _stream(x),
        )
    global SCATTER_LAUNCHES
    SCATTER_LAUNCHES += 1
    return out


def csr_dedup(blk: DedupCsrBlocking, x: torch.Tensor) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return csr_dedup_plain(blk, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda(x, blk)
    post = blk.scale
    if blk.scale_is_pre:
        x = (x * blk.scale[:, None]).contiguous()
        post = None
    out = torch.empty((blk.num_rows, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        _kernels.launch(
            "csr_dedup", blk.block_tile_ptr.data_ptr(),
            blk.tile_uniq_ptr.data_ptr(), blk.uniq_col.data_ptr(),
            blk.tile_seg_ptr.data_ptr(), blk.seg_row.data_ptr(),
            blk.seg_ptr.data_ptr(), blk.slot.data_ptr(),
            None if post is None else post.data_ptr(),
            x.data_ptr(), out.data_ptr(), blk.num_rows, blk.block_rows,
            x.shape[1], blk.uniq, _stream(x),
        )
    global DEDUP_LAUNCHES
    DEDUP_LAUNCHES += 1
    return out


def _apply_direction(blk: Blocking, x: torch.Tensor) -> torch.Tensor:
    if isinstance(blk, DedupCsrBlocking):
        return csr_dedup(blk, x)
    return csr_scatter(blk, x)


class _CsrMeanAggregate(torch.autograd.Function):
    """Forward on ``fwd``; the input gradient is the same aggregation on
    ``bwd`` (``dx[d] = sum over edges (s, d) of g[s] / deg(s)``). The
    blockings get no gradient."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _apply_direction(fwd, x)

    @staticmethod
    def backward(ctx, g):
        dx = _apply_direction(ctx.bwd, g.contiguous())
        if g.device.type == "cuda":
            global CSR_BACKWARD_LAUNCHES
            CSR_BACKWARD_LAUNCHES += 1
        return dx, None, None


def csr_mean_aggregate(x: torch.Tensor, fwd: Blocking,
                       bwd: Blocking) -> torch.Tensor:
    """out[s] = mean over edges (s, d) of x[d]; rows without edges give 0.

    Differentiable in ``x``: the backward runs the kernel of ``bwd``, the
    destination-sorted blocking that ``build_csr_blocking`` returns beside
    ``fwd``."""
    return _CsrMeanAggregate.apply(x, fwd, bwd)


def ref_mean(x: torch.Tensor, src, dst, num_nodes: int) -> torch.Tensor:
    """Segment-mean reference for tests."""
    src = torch.as_tensor(np.asarray(src, dtype=np.int64), device=x.device)
    dst = torch.as_tensor(np.asarray(dst, dtype=np.int64), device=x.device)
    return segment_mean(x[dst], src, num_nodes)
