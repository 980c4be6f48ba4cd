"""Sorted-CSR mean aggregation on two hand-written CUDA kernels.

Counterpart of ``mpgnn_tpu/ops/pallas_csr.py``. One relation's aggregation
``out[s] = mean over edges (s, d) of x[d]`` (rows without edges give 0)
runs in one of two forms, chosen per direction by ``build_csr_blocking``:

* ``CsrBlocking`` -> K1 (``csrc/csr_scatter.cu``): a row-sorted CSR with
  per-edge weights 1/deg. The merged list of row ends and edges is cut into
  equal shares (``k1_layout``), one thread group a share (merge-path); a row
  longer than a share is cut and completed by a second, ordered pass over
  the shares' carries.
* ``DedupCsrBlocking`` -> K2 (``csrc/csr_dedup.cu``): for hub-skewed
  relations, where many edges of one row block repeat the same gather
  column and a few rows hold most edges. The edges are cut into pieces of
  at most ``DEDUP_PIECE``, one thread group each, so a hub row is summed by
  many groups at once; the partial sums of a row cut into several pieces
  are added in later passes, in a fixed order.

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
from mpgnn_tpu_torch.utils.prof import span

# A direction routes to the dedup blocking when its edges per distinct
# (row block, column) pair reach this ratio. The value was measured on the
# TPU (v5e) for the Pallas kernels and has not yet been measured on the card.
DEDUP_MIN_RATIO = 2.0
# The row-block size at which ``dedup_ratio`` counts distinct (row block,
# column) pairs.
DEDUP_BLOCK_ROWS = 1024
# Most items (edges, or partial sums of a cut row) that one piece of K2, one
# thread group, sums.
DEDUP_PIECE = 64

SCATTER_LAUNCHES = 0
DEDUP_LAUNCHES = 0
CSR_BACKWARD_LAUNCHES = 0
# launches of the bf16 forms (bf16 rows in and out, float32 sums)
SCATTER_BF16_LAUNCHES = 0
DEDUP_BF16_LAUNCHES = 0


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
    """Pieces of one direction (layout in csrc/csr_dedup.cu):
    ``out[r] = post * sum over edges (r, c) of pre[c] * x[c]`` where
    ``scale`` is the post-scale of output rows (forward) or, with
    ``scale_is_pre``, the pre-scale of gathered rows (backward).

    Items are the edges ``[0, E)`` in (row, column) order, then the partial
    sums ``E + s`` (slot ``s`` of a [num_partials, F] scratch). Piece ``p``
    sums items ``piece_ptr[p] .. piece_ptr[p+1]`` into output row
    ``piece_dest[p]`` if that is >= 0, else into slot ``-1 - piece_dest[p]``.
    Pass ``l`` runs pieces ``level_pieces[l] .. level_pieces[l+1]``; pass 0,
    which always runs, also writes the rows without edges, ``zero_rows``,
    as 0."""

    col: torch.Tensor             # [E] gather row of each edge
    piece_ptr: torch.Tensor       # [P + 1] item offsets of each piece
    piece_dest: torch.Tensor      # [P] output row, or -1 - partial slot
    zero_rows: torch.Tensor       # [Z] rows without edges
    scale: torch.Tensor           # [num_rows] or [num_cols] float32
    level_pieces: Tuple[int, ...]  # [passes + 1] piece offsets
    num_partials: int
    num_rows: int
    num_cols: int
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


def _cut(counts: np.ndarray, piece: int):
    """Cut consecutive non-empty item ranges of ``counts`` items each into
    near-equal pieces of at most ``piece`` items. Returns (range of each
    piece, first item of each piece counted from the first range's start,
    pieces of each range)."""
    n = -(-counts // piece)
    owner = np.repeat(np.arange(len(counts)), n)
    j = np.arange(len(owner)) - np.repeat(np.cumsum(n) - n, n)
    first = np.cumsum(counts) - counts
    return owner, first[owner] + j * counts[owner] // n[owner], n


def _build_one_direction_dedup(
    rows, cols, scale, num_rows, num_cols, scale_is_pre,
) -> DedupCsrBlocking:
    """Pass 0 cuts the edges of every row that has any (sorted by row,
    then column) into near-equal pieces of at most ``DEDUP_PIECE``. A row of
    one piece is written by it; a row of several gets one partial slot per
    piece, and the next pass cuts each such row's slots the same way, until
    every row has one piece. Rows without edges are listed apart; pass 0
    runs even without pieces, to write them."""
    order = sort_block_col(rows, cols, 1)
    e = len(rows)
    degree = np.bincount(rows, minlength=num_rows).astype(np.int64)
    target = np.flatnonzero(degree)          # the output row of each range
    counts = degree[target]
    base = slots = end = 0
    starts, dests, level_pieces = [], [], [0]
    while len(counts):
        end = base + int(counts.sum())
        owner, start, n = _cut(counts, DEDUP_PIECE)
        dest = target[owner]
        split = n[owner] > 1
        k = int(split.sum())
        dest[split] = -1 - (slots + np.arange(k))
        starts.append(base + start)
        dests.append(dest)
        level_pieces.append(level_pieces[-1] + len(owner))
        keep = n > 1
        counts, target = n[keep], target[keep]
        base, slots = e + slots, slots + k
    if len(level_pieces) == 1:
        level_pieces.append(0)
    return DedupCsrBlocking(
        col=_i32(cols[order]),
        piece_ptr=_i32(np.concatenate(starts + [[end]])),
        piece_dest=_i32(np.concatenate(dests + [np.zeros(0, np.int64)])),
        zero_rows=_i32(np.flatnonzero(degree == 0)),
        scale=torch.from_numpy(np.ascontiguousarray(scale, dtype=np.float32)),
        level_pieces=tuple(level_pieces), num_partials=slots,
        num_rows=num_rows, num_cols=num_cols, scale_is_pre=scale_is_pre,
    )


def dedup_ratio(rows: np.ndarray, cols: np.ndarray, bm: int) -> float:
    """Edges per distinct (row block, column) pair: the factor by which the
    JAX package's dedup tiles cut the rows gathered, and the measure of hub
    skew that routes a direction to K2."""
    if len(rows) == 0:
        return 1.0
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    key = (rows // bm) * (int(cols.max()) + 1) + cols
    # distinct keys by a sort and a count of changes, not np.unique, which
    # hashes plain integers in numpy 2.3: with it the blockings of four
    # 10^7-edge relations took 123 s to build on an 8-core host (numpy
    # 2.3.5), with the sort 13.4 s (benchmarks/bench_routing.py's build_s)
    key = np.sort(key)
    return float(len(rows) / (1 + np.count_nonzero(key[1:] != key[:-1])))


def build_csr_blocking(
    src: np.ndarray, dst: np.ndarray, num_nodes: int,
    bm: Optional[int] = None, dedup: str = "auto",
) -> Tuple[Blocking, Blocking]:
    """(forward, backward) blockings of one relation's mean aggregation, as
    CPU tensors (``.to(device)`` moves them).

    Forward rows are edge sources (mean over out-edges, 1/deg(src));
    backward rows are destinations with the same per-edge weight,
    ``dx[d] = sum over edges (s, d) of g[s] / deg(s)``. ``bm`` is the
    row-block size of ``dedup_ratio`` (default ``DEDUP_BLOCK_ROWS``).
    ``dedup='auto'`` routes a direction to the dedup blocking (K2) when its
    ``dedup_ratio`` at ``bm`` reaches ``DEDUP_MIN_RATIO``; ``'never'`` and
    ``'always'`` force a side. Each direction's routing is timed as the
    span ``csr.route``, its build as ``csr.build``."""
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
        if dedup == "always":
            return True
        with span("csr.route"):
            return dedup_ratio(rows, cols, bm) >= DEDUP_MIN_RATIO

    n = num_nodes
    fwd_dedup, bwd_dedup = want(src, dst), want(dst, src)
    with span("csr.build"):
        fwd = (_build_one_direction_dedup(src, dst, inv, n, n, False)
               if fwd_dedup else _build_one_direction(src, dst, ew, n, n))
    with span("csr.build"):
        bwd = (_build_one_direction_dedup(dst, src, inv, n, n, True)
               if bwd_dedup else _build_one_direction(dst, src, ew, n, n))
    return fwd, bwd


def build_rect_csr_blocking(
    rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
    num_rows: int, num_cols: int,
) -> Tuple[CsrBlocking, CsrBlocking]:
    """(forward, backward) K1 blockings of a rectangular weighted sum,
    ``out[r] = sum over edges (r, c) of w * x[c]`` with out [num_rows, F]
    and x [num_cols, F], as CPU tensors; the backward is the transpose,
    ``dx[c] = sum over edges (r, c) of w * g[r]``. The counterpart of
    ``pallas_csr.py:620`` ``build_rect_csr_blocking``: K1's layout in both
    directions, no routing to K2. ``build_csr_blocking`` is the square
    case with w = 1/deg; the node-sharded halo aggregation
    (``parallel/halo.py``) gives each shard two of these, rows its own
    [S] block and columns its [S] block or the exchanged halo buffer.
    Either side may be empty."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float32)
    return (_build_one_direction(rows, cols, weights, num_rows, num_cols),
            _build_one_direction(cols, rows, weights, num_cols, num_rows))


@dataclasses.dataclass(frozen=True)
class RowTermBlockings:
    """K1 blockings of R-GCN relation terms on the rows each relation
    reaches, for the relations ``rels`` side by side: relation
    ``rels[i]``'s rows R_i, the rows of its square forward blocking that
    have an edge (sorted), are the stacked rows ``offsets[i]`` ..
    ``offsets[i + 1]`` of M = ``offsets[-1]``. On one device:

    * ``fwd`` [M, N]: each relation's mean on its rows, all in one pass;
    * ``take`` [M, N]: one edge a row, weight 1, its column the row's
      node: gathers the rows of an [N, F] tensor that the stacked rows
      belong to;
    * ``place`` [N, M], ``take``'s transpose: sums each node's stacked
      rows, in their order (relation order), into its row;
    * ``bwd`` [N, M], ``fwd``'s transpose: the input gradient of every
      relation's mean at once.

    A last layer read at T rows alone (``row_term_tail``) has ``root``
    set: its outputs are those T rows, in their order, so ``take`` is
    [M, T] and ``place`` [T, M]; each relation keeps the rows of R_i among
    them, and one more block, the stacked rows ``offsets[-2]`` ..
    ``offsets[-1]``, is the root's: its row k gathers output k's node
    (weight 1), so that the root's product is one more block's product,
    ``place`` adds it to the relations' terms and ``bwd`` carries its input
    gradient."""

    fwd: CsrBlocking
    take: CsrBlocking
    place: CsrBlocking
    bwd: CsrBlocking
    rels: Tuple[int, ...]
    offsets: Tuple[int, ...]
    root: bool = False


def transpose_blocking(blk: CsrBlocking) -> CsrBlocking:
    """The transpose of a K1 blocking, built on its device: row c holds
    the edges (r, c) with their weights, in ascending r."""
    dev = blk.col.device
    e = blk.col.numel()
    rows = torch.repeat_interleave(
        torch.arange(blk.num_rows, dtype=torch.int32, device=dev),
        blk.row_ptr.diff().long(), output_size=e)
    col = blk.col.long()
    order = torch.sort(col, stable=True).indices
    row_ptr = torch.zeros(blk.num_cols + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(col, minlength=blk.num_cols), 0,
                 out=row_ptr[1:])
    return CsrBlocking(row_ptr=row_ptr.int(), col=rows[order],
                       weight=blk.weight[order], num_rows=blk.num_cols,
                       num_cols=blk.num_rows)


def row_term_blockings(rels, fwds) -> RowTermBlockings:
    """``RowTermBlockings`` of the relations ``rels`` from their square
    forward K1 blockings ``fwds`` ([N, N], ``build_csr_blocking``'s
    forward), derived on their device: their edge arrays concatenated and
    their row offsets renumbered to the rows with edges. K1 counts rows
    plus edges in int32: M + N plus the edges must stay under 2^31."""
    fwds = list(fwds)
    if not fwds or not all(isinstance(b, CsrBlocking) for b in fwds):
        raise TypeError("row_term_blockings takes one or more CsrBlockings")
    n = fwds[0].num_rows
    if any((b.num_rows, b.num_cols) != (n, n) for b in fwds):
        raise ValueError("row_term_blockings takes square blockings of one "
                         "size")
    rows = [torch.nonzero(b.row_ptr.diff()).flatten() for b in fwds]
    offsets = np.concatenate([[0], np.cumsum([r.numel() for r in rows])])
    edges = np.concatenate([[0], np.cumsum([b.col.numel() for b in fwds])])
    m = int(offsets[-1])
    if m + n + int(edges[-1]) >= 2 ** 31:
        raise ValueError(f"{len(fwds)} relations of {int(edges[-1])} edges "
                         f"overflow K1's int32 items")
    fwd = CsrBlocking(
        row_ptr=torch.cat([b.row_ptr[r] + int(o) for b, r, o
                           in zip(fwds, rows, edges)]
                          + [fwds[0].row_ptr.new_tensor([int(edges[-1])])]),
        col=torch.cat([b.col for b in fwds]),
        weight=torch.cat([b.weight for b in fwds]), num_rows=m, num_cols=n)
    dev = fwd.col.device
    take = CsrBlocking(
        row_ptr=torch.arange(m + 1, dtype=torch.int32, device=dev),
        col=torch.cat(rows).int(), weight=torch.ones(m, device=dev),
        num_rows=m, num_cols=n)
    return RowTermBlockings(
        fwd=fwd, take=take, place=transpose_blocking(take),
        bwd=transpose_blocking(fwd), rels=tuple(int(r) for r in rels),
        offsets=tuple(int(o) for o in offsets))


def row_term_tail(blk: RowTermBlockings, rows: torch.Tensor
                  ) -> RowTermBlockings:
    """The ``RowTermBlockings`` of a last layer read at ``rows`` (T
    distinct nodes) alone, derived on ``blk``'s device from ``blk``, the
    same layer's blockings at every row: relation i's rows are its rows
    in ``blk`` whose node is among ``rows``, in the same order, each with
    all its edges in their order; a relation that reaches none of them is
    left out; the root's block follows (``root``). Output k is node
    ``rows[k]``."""
    fwd = blk.fwd
    n, dev = fwd.num_cols, fwd.col.device
    rows = rows.to(dev, torch.int64)
    t = rows.numel()
    at = torch.full((n,), -1, dtype=torch.int64, device=dev)
    at[rows] = torch.arange(t, device=dev)
    if not torch.equal(at[rows], torch.arange(t, device=dev)):
        raise ValueError("row_term_tail takes distinct rows")
    at = at[blk.take.col.long()]           # each stacked row's output
    keep = torch.nonzero(at >= 0).flatten()
    o = torch.tensor(blk.offsets, device=dev)
    counts = torch.searchsorted(keep, o).diff().tolist()
    ptr = fwd.row_ptr.long()
    deg = ptr.diff()[keep]
    row_ptr = torch.zeros(keep.numel() + t + 1, dtype=torch.int64,
                          device=dev)
    torch.cumsum(deg, 0, out=row_ptr[1:keep.numel() + 1])
    e = int(row_ptr[keep.numel()])
    row_ptr[keep.numel() + 1:] = e + torch.arange(1, t + 1, device=dev)
    m = keep.numel() + t
    if m + n + e + t >= 2 ** 31:
        raise ValueError(f"a tail of {e + t} edges overflows K1's int32 "
                         f"items")
    edge = torch.repeat_interleave(ptr[keep] - row_ptr[:keep.numel()], deg,
                                   output_size=e)
    edge += torch.arange(e, device=dev)
    tail = CsrBlocking(
        row_ptr=row_ptr.int(), col=torch.cat([fwd.col[edge], rows.int()]),
        weight=torch.cat([fwd.weight[edge], torch.ones(t, device=dev)]),
        num_rows=m, num_cols=n)
    take = CsrBlocking(
        row_ptr=torch.arange(m + 1, dtype=torch.int32, device=dev),
        col=torch.cat([at[keep], torch.arange(t, device=dev)]).int(),
        weight=torch.ones(m, device=dev), num_rows=m, num_cols=t)
    reached = [(r, c) for r, c in zip(blk.rels, counts) if c]
    offsets = np.cumsum([0] + [c for _, c in reached] + [t])
    return RowTermBlockings(
        fwd=tail, take=take, place=transpose_blocking(take),
        bwd=transpose_blocking(tail), rels=tuple(r for r, _ in reached),
        offsets=tuple(int(x) for x in offsets), root=True)


def stack_blockings(blockings) -> CsrBlocking:
    """One block-diagonal ``CsrBlocking`` of C same-shaped K1 blockings:
    block c maps rows ``c*N + r`` to columns ``c*N + col``, so K1 on the
    stacked [C*N, F] features computes every block's aggregation in one
    launch. Built on the blockings' device. K1 counts rows plus edges in
    int32: C * (N + E) must stay under 2^31."""
    blockings = list(blockings)
    if not blockings or not all(isinstance(b, CsrBlocking)
                                for b in blockings):
        raise TypeError("stack_blockings takes one or more CsrBlockings")
    n, m = blockings[0].num_rows, blockings[0].num_cols
    if any((b.num_rows, b.num_cols) != (n, m) for b in blockings):
        raise ValueError("stack_blockings takes blockings of one shape")
    edges = [b.col.shape[0] for b in blockings]
    c = len(blockings)
    if c * n + sum(edges) >= 2 ** 31 or c * max(n, m) >= 2 ** 31:
        raise ValueError(f"{c} stacked blockings of {n} rows and "
                         f"{sum(edges)} edges overflow K1's int32 items")
    offsets = np.concatenate([[0], np.cumsum(edges)])
    row_ptr = [b.row_ptr[:-1] + int(o) for b, o in zip(blockings, offsets)]
    row_ptr.append(blockings[0].row_ptr.new_tensor([int(offsets[-1])]))
    return CsrBlocking(
        row_ptr=torch.cat(row_ptr),
        col=torch.cat([b.col + i * m for i, b in enumerate(blockings)]),
        weight=torch.cat([b.weight for b in blockings]),
        num_rows=c * n, num_cols=c * m,
    )


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
    """K2's function in PyTorch, pass by pass as the kernel runs it: gather
    the edges' rows, ``index_add_`` each pass's items into its pieces, and
    put each piece's sum into its output row or partial slot; scale."""
    dtype = x.dtype
    x = x.double()
    if blk.scale_is_pre:
        x = x * blk.scale.double()[:, None]
    e = blk.col.shape[0]
    items = torch.cat([x[blk.col.long()],
                       x.new_zeros((blk.num_partials, x.shape[1]))])
    ptr, dest = blk.piece_ptr.long(), blk.piece_dest.long()
    item_piece = torch.repeat_interleave(
        torch.arange(dest.shape[0], device=x.device), ptr.diff())
    out = x.new_zeros((blk.num_rows, x.shape[1]))
    lp = blk.level_pieces
    for p0, p1 in zip(lp[:-1], lp[1:]):
        i0, i1 = int(ptr[p0]), int(ptr[p1])
        sums = x.new_zeros((p1 - p0, x.shape[1])).index_add_(
            0, item_piece[i0:i1] - p0, items[i0:i1])
        d = dest[p0:p1]
        out[d[d >= 0]] = sums[d >= 0]
        items[e - 1 - d[d < 0]] = sums[d < 0]       # slot s is item E + s
    if not blk.scale_is_pre:
        out = out * blk.scale.double()[:, None]
    return out.to(dtype)


# ------------------------------------------------------------------ wrappers
def _check_cuda(x: torch.Tensor, blk: Blocking) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"kernel takes a 2-D float32 or bf16 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
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


def row_vec(x: torch.Tensor) -> int:
    """Values a lane loads at once from x's rows (16 bytes where F and the
    alignment allow): float32 4 or 1, bf16 8, 4 or 1."""
    f, ptr = x.shape[1], x.data_ptr()
    if x.dtype == torch.bfloat16:
        if f % 8 == 0 and ptr % 16 == 0:
            return 8
        return 4 if f % 4 == 0 and ptr % 8 == 0 else 1
    return 4 if f % 4 == 0 and ptr % 16 == 0 else 1


def k1_layout(width: int, vec: int) -> Tuple[int, int]:
    """(lanes a group, items a share) of K1 for ``width`` columns read
    ``vec`` floats at a time, as ``csrc/csr_scatter.cu`` lays them out: the
    lanes a power of two that covers the columns, at most 32; a share 64
    items (row ends and edges of the merged CSR list), or 16 per lane for
    fewer than 4 lanes."""
    chunks = max(width // vec, 1)
    tpr = min(32, 1 << (chunks - 1).bit_length())
    return tpr, (64 if tpr >= 4 else 16 * tpr)


def csr_scatter(blk: CsrBlocking, x: torch.Tensor) -> torch.Tensor:
    """K1 on a CUDA tensor (its bf16 form for a bf16 x: float32 sums, each
    row rounded to bf16 once), its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return csr_scatter_plain(blk, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda(x, blk)
    f = x.shape[1]
    bf16 = x.dtype == torch.bfloat16
    if blk.num_rows == 0 or f == 0:
        # nothing to write: the kernel would not launch, and is not counted
        return x.new_zeros((blk.num_rows, f))
    out = torch.empty((blk.num_rows, f), dtype=x.dtype, device=x.device)
    e = blk.col.shape[0]
    vec = row_vec(x)
    _, share = k1_layout(f, vec)
    shares = max(-(-(blk.num_rows + e) // share), 1)
    # float32 carries (and, in the bf16 form, the float32 part of each cut
    # row that its last share sums)
    carry = torch.empty((shares, f), dtype=torch.float32, device=x.device)
    share_row = torch.empty(shares, dtype=torch.int32, device=x.device)
    ptrs = [blk.row_ptr.data_ptr(), blk.col.data_ptr(), blk.weight.data_ptr(),
            x.data_ptr(), out.data_ptr(), carry.data_ptr()]
    if bf16:
        head = torch.empty_like(carry)
        ptrs.append(head.data_ptr())
    with torch.cuda.device(x.device):
        _kernels.launch(
            "csr_scatter_bf16" if bf16 else "csr_scatter", *ptrs,
            share_row.data_ptr(), blk.num_rows, e, f, vec, share, _stream(x),
        )
    global SCATTER_LAUNCHES, SCATTER_BF16_LAUNCHES
    if bf16:
        SCATTER_BF16_LAUNCHES += 1
    else:
        SCATTER_LAUNCHES += 1
    return out


def csr_dedup(blk: DedupCsrBlocking, x: torch.Tensor) -> torch.Tensor:
    """K2 on a CUDA tensor (its bf16 form for a bf16 x: float32 sums and
    partial sums, each row rounded to bf16 once), its plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return csr_dedup_plain(blk, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda(x, blk)
    f = x.shape[1]
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((blk.num_rows, f), dtype=x.dtype, device=x.device)
    part = torch.empty((max(blk.num_partials, 1), f), dtype=torch.float32,
                       device=x.device)
    scale = blk.scale.data_ptr()
    pre, post = (scale, None) if blk.scale_is_pre else (None, scale)
    levels = np.asarray(blk.level_pieces, dtype=np.int32)
    with torch.cuda.device(x.device):
        _kernels.launch(
            "csr_dedup_bf16" if bf16 else "csr_dedup",
            blk.piece_ptr.data_ptr(), blk.piece_dest.data_ptr(),
            blk.col.data_ptr(), pre, post, x.data_ptr(), part.data_ptr(),
            out.data_ptr(), blk.zero_rows.data_ptr(),
            blk.zero_rows.shape[0], levels.ctypes.data, len(levels) - 1,
            blk.col.shape[0], f, row_vec(x), _stream(x),
        )
    global DEDUP_LAUNCHES, DEDUP_BF16_LAUNCHES
    if bf16:
        DEDUP_BF16_LAUNCHES += 1
    else:
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
    ``fwd``. A bf16 x runs the kernels' bf16 forms both ways, bf16(float32
    sum), the value of the JAX package's route (``mpgnn.py:146-152``: cast
    to float32, the float32 kernel, cast back), which the TPU took because
    bf16 rows gathered slower there. On an NVIDIA H100 80GB HBM3 at 700 W
    (``chip_smoke.py`` 7 (f), device ms, bf16 form against that cast
    route) the bf16 form was faster at every shape measured: K1 on a
    2.5M-edge uniform relation 0.061 / 0.080 at F = 16, 0.132 / 0.242 at
    F = 64, backward 0.132 / 0.241; on the power-law KG's relation 141
    0.018 / 0.024 at F = 1, 0.025 / 0.038 at F = 4, 0.034 / 0.106 at
    F = 64; K2 on its hub relation 0.024 / 0.032 at F = 4, 0.040 / 0.055
    at F = 16, 0.066 / 0.141 at F = 64, backward 0.054 / 0.129."""
    return _CsrMeanAggregate.apply(x, fwd, bwd)


def ref_mean(x: torch.Tensor, src, dst, num_nodes: int) -> torch.Tensor:
    """Segment-mean reference for tests."""
    src = torch.as_tensor(np.asarray(src, dtype=np.int64), device=x.device)
    dst = torch.as_tensor(np.asarray(dst, dtype=np.int64), device=x.device)
    return segment_mean(x[dst], src, num_nodes)
