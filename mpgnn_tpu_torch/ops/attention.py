"""Softmax attention over every relation of a node, on a hand-written CUDA
kernel (K6, ``csrc/csr_attention.cu``): the message passing of HGT (Hu et
al. 2020, arXiv:2003.01332, eq. 3-6).

For target t, edge e = (t, s) of relation r and head i,

    ATT(e)_i = K(s)_i W^ATT_{r,i} Q(t)_i^T mu_{r,i} / sqrt(d_k)
    out(t)_i = sum over e of t of softmax_e(ATT(e)_i) V(s)_i W^MSG_{r,i}

with the softmax over all of t's edges, every relation at once. The
relation's matrices act on the source side: a stacked source row is one
(source node, relation) pair, and ``kt`` / ``vt`` hold its node's K and V
times the relation's per-head matrices (``head_products``: one batched
product a relation, on the rows that relation reaches). The kernel then
sees one CSR of each target's edges, all relations together, into those
rows, and knows nothing of relations.

``AttentionBlockings`` holds that CSR, its transpose (for the backward's
column pass) and their chunks, and K1's ``place`` blocking that sums each
node's stacked rows. ``attention_blockings`` derives them on the device
from the relations' square K1 forward blockings (``build_csr_blocking``'s
forward; ``ops.csr.build_csr_forward`` builds it alone), at every node or
at given target rows alone.

Each kernel pass has a plain PyTorch version beside it, in float64 with
one rounding; a wrapper takes it for a tensor on the CPU and launches the
kernel for a CUDA tensor. ``ATTENTION_LAUNCHES`` counts the forward's
launches on the card, ``ATTENTION_BACKWARD_LAUNCHES`` the backward's: its
row pass and its column pass each count one.
``hgt_attention`` is the differentiable operation: its forward and
backward recompute ``kt`` and ``vt`` from K and V, so autograd keeps no
tensor of the stacked rows and none of E rows."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.ops import _kernels
from mpgnn_tpu_torch.ops.csr import CsrBlocking, csr_scatter, \
    transpose_blocking

# edges a chunk of a row, at most: a power-law graph's longest rows are cut
# into pieces this long, each its own warp, whose partials a second pass
# folds in order
CHUNK = 256
# rows a block of a per-head weight gradient's sum (head_weight_grad)
SPLIT_ROWS = 4096
# the widths the kernel takes: 8 heads of 32
KERNEL_WIDTH, KERNEL_HEADS = 256, 8

ATTENTION_LAUNCHES = 0
ATTENTION_BACKWARD_LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class Chunks:
    """A CSR's rows cut into chunks of at most ``CHUNK`` edges: chunk k
    covers edges ``ptr[k]`` .. ``ptr[k + 1]`` of row ``row[k]`` (a row
    without edges is one empty chunk); ``slot[k]`` is -1 where the chunk
    is its row's only one, else its partial slot; ``long_row[i]``, a row of
    several chunks, has the slots ``slot_ptr[i]`` .. ``slot_ptr[i + 1]``.
    int32, on the CSR's device."""

    ptr: torch.Tensor
    row: torch.Tensor
    slot: torch.Tensor
    long_row: torch.Tensor
    slot_ptr: torch.Tensor
    num_slots: int


def chunk_rows(row_ptr: torch.Tensor, size: int = CHUNK) -> Chunks:
    """``Chunks`` of the CSR ``row_ptr``: a row of d edges in ceil(d /
    size) chunks of near-equal length (one chunk for d = 0)."""
    dev = row_ptr.device
    ptr = row_ptr.long()
    deg = ptr.diff()
    n = ((deg + size - 1) // size).clamp_min(1)
    k = int(n.sum())
    row = torch.repeat_interleave(torch.arange(deg.numel(), device=dev), n,
                                  output_size=k)
    first = torch.cumsum(n, 0) - n
    j = torch.arange(k, device=dev) - first[row]
    start = ptr[row] + (j * deg[row]) // n[row]
    long = n > 1
    in_long = long[row]
    slot = torch.cumsum(in_long.long(), 0) - 1
    slot = torch.where(in_long, slot, torch.full_like(slot, -1))
    slot_ptr = torch.zeros(int(long.sum()) + 1, dtype=torch.int64,
                           device=dev)
    torch.cumsum(n[long], 0, out=slot_ptr[1:])
    return Chunks(ptr=torch.cat([start, ptr[-1:]]).int(), row=row.int(),
                  slot=slot.int(), long_row=torch.nonzero(long).flatten()
                  .int(), slot_ptr=slot_ptr.int(),
                  num_slots=int(slot_ptr[-1]))


@dataclasses.dataclass(frozen=True)
class AttentionBlockings:
    """The operands of one attention layer over the relations ``rels``:

    * ``row_ptr`` [T + 1], ``col`` [E]: each target row's edges, grouped
      by relation in ``rels``' order, each into its stacked source row;
      ``chunks`` cut its rows;
    * ``t_row_ptr`` [M + 1], ``t_col`` [E], ``t_eid`` [E]: the transpose,
      each stacked source row's edges (their target rows, and their
      positions in ``col``), in ascending position; ``t_chunks`` cut them;
    * ``src_node`` [M]: the node of each stacked source row; relation
      ``rels[i]``'s are ``offsets[i]`` .. ``offsets[i + 1]``, ascending;
    * ``place`` [N, M]: K1's blocking that sums each node's stacked rows,
      in relation order (the backward's way from the stacked rows back to
      the nodes).

    Target row t is node t, or with ``rows`` (ascending node ids) node
    ``rows[t]``. int32 index arrays, ``src_node`` and ``rows`` int64, all
    on one device."""

    row_ptr: torch.Tensor
    col: torch.Tensor
    chunks: Chunks
    t_row_ptr: torch.Tensor
    t_col: torch.Tensor
    t_eid: torch.Tensor
    t_chunks: Chunks
    src_node: torch.Tensor
    place: CsrBlocking
    rels: Tuple[int, ...]
    offsets: Tuple[int, ...]
    rows: Optional[torch.Tensor] = None

    @property
    def num_rows(self) -> int:
        return self.row_ptr.numel() - 1

    @property
    def num_edges(self) -> int:
        return self.col.numel()

    @property
    def num_sources(self) -> int:
        return self.src_node.numel()


def attention_blockings(rels: Sequence[int], fwds: Sequence[CsrBlocking],
                        relabel: Optional[torch.Tensor] = None,
                        rows: Optional[torch.Tensor] = None
                        ) -> AttentionBlockings:
    """``AttentionBlockings`` of the relations ``rels`` from their square
    forward K1 blockings ``fwds`` ([N, N]: row t's edges (t, s), relation
    r's term written into t's row), derived on their device. ``relabel``
    [N] maps the blockings' node ids to the layer's (new = relabel[old]);
    ``rows`` (ascending, in the layer's ids) keeps the edges into those
    target rows alone. Within a target's relation its edges keep their
    order in ``fwds``. The CSRs count edges in int32."""
    fwds = list(fwds)
    if not fwds or not all(isinstance(b, CsrBlocking) for b in fwds):
        raise TypeError("attention_blockings takes one or more CsrBlockings")
    n = fwds[0].num_rows
    if any((b.num_rows, b.num_cols) != (n, n) for b in fwds):
        raise ValueError("attention_blockings takes square blockings of one "
                         "size")
    dev = fwds[0].col.device
    at = None
    if rows is not None:
        rows = rows.to(dev, torch.int64)
        if rows.numel() > 1 and not bool((rows.diff() > 0).all()):
            raise ValueError("attention_blockings takes ascending distinct "
                             "rows")
        at = torch.full((n,), -1, dtype=torch.int64, device=dev)
        at[rows] = torch.arange(rows.numel(), device=dev)
    ts, cs, srcs, keys = [], [], [], []
    offset = 0
    for i, b in enumerate(fwds):
        deg = b.row_ptr.diff().long()
        t = torch.repeat_interleave(torch.arange(n, device=dev), deg,
                                    output_size=b.col.numel())
        s = b.col.long()
        if relabel is not None:
            t, s = relabel[t], relabel[s]
        if at is not None:
            t = at[t]
            keep = t >= 0
            t, s = t[keep], s[keep]
        src = torch.unique(s)
        cs.append(offset + torch.searchsorted(src, s))
        offset += src.numel()
        srcs.append(src)
        ts.append(t)
        keys.append(t * len(fwds) + i)
    num_rows = n if rows is None else rows.numel()
    e = sum(t.numel() for t in ts)
    if e + num_rows + offset >= 2 ** 31:
        raise ValueError(f"{e} edges overflow the kernel's int32 edges")
    order = torch.sort(torch.cat(keys), stable=True).indices
    col = torch.cat(cs)[order]
    trow = torch.cat(ts)[order]
    del keys, order
    row_ptr = _ptr(trow, num_rows)
    t_order = torch.sort(col, stable=True).indices
    t_row_ptr = _ptr(col, offset)
    src_node = torch.cat(srcs)
    take = CsrBlocking(
        row_ptr=torch.arange(offset + 1, dtype=torch.int32, device=dev),
        col=src_node.int(), weight=torch.ones(offset, device=dev),
        num_rows=offset, num_cols=n)
    return AttentionBlockings(
        row_ptr=row_ptr, col=col.int(), chunks=chunk_rows(row_ptr),
        t_row_ptr=t_row_ptr, t_col=trow[t_order].int(),
        t_eid=t_order.int(), t_chunks=chunk_rows(t_row_ptr),
        src_node=src_node, place=transpose_blocking(take),
        rels=tuple(int(r) for r in rels),
        offsets=tuple(int(x) for x in np.cumsum([0] + [s.numel()
                                                       for s in srcs])),
        rows=rows)


def _ptr(sorted_rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """int32 CSR offsets of ``num_rows`` rows from each edge's row."""
    ptr = torch.zeros(num_rows + 1, dtype=torch.int64,
                      device=sorted_rows.device)
    torch.cumsum(torch.bincount(sorted_rows, minlength=num_rows), 0,
                 out=ptr[1:])
    return ptr.int()


# ------------------------------------------------------ relation products
def head_products(x: torch.Tensor, w: torch.Tensor,
                  blk: AttentionBlockings, transpose: bool = False
                  ) -> torch.Tensor:
    """[M, D]: each stacked source row of relation r, head by head, times
    ``w[r]`` ([R, H, D/H, D/H]; its transpose per head with
    ``transpose``): one batched product a relation, on its rows."""
    m, d = x.shape
    h = w.shape[1]
    out = torch.empty_like(x)
    o = blk.offsets
    for i, r in enumerate(blk.rels):
        a, b = o[i], o[i + 1]
        if a == b:
            continue
        wi = w[r].transpose(1, 2) if transpose else w[r]
        torch.bmm(x[a:b].view(b - a, h, d // h).transpose(0, 1), wi,
                  out=out[a:b].view(b - a, h, d // h).transpose(0, 1))
    return out


def head_weight_grad(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                     blk: AttentionBlockings) -> torch.Tensor:
    """The gradient of ``w`` in ``head_products(x, w, blk)`` given the
    output's gradient ``g``: ``x_h^T g_h`` over each relation's rows.

    A head's product is [d_k, d_k] summed over up to millions of rows: one
    batched product of the 8 heads gives the card 8 tiles to run and took
    869 ms an epoch of HGT on ogbn-mag (NVIDIA H100 80GB HBM3, 700 W). So
    each head's rows are cut into ``SPLIT_ROWS`` blocks, one batched
    product of those (strided views, no copy) and their sum, then the
    rows left over, in a fixed order: 52 ms an epoch there."""
    gw = torch.zeros_like(w)
    m, d = x.shape
    dk = d // w.shape[1]
    o = blk.offsets
    for i, r in enumerate(blk.rels):
        a, b = o[i], o[i + 1]
        s = (b - a) // SPLIT_ROWS
        cut = a + s * SPLIT_ROWS
        for j in range(w.shape[1]):
            cols = slice(j * dk, (j + 1) * dk)
            if s:
                xs = x[a:cut, cols].unflatten(0, (s, SPLIT_ROWS))
                gs = g[a:cut, cols].unflatten(0, (s, SPLIT_ROWS))
                torch.sum(torch.bmm(xs.transpose(1, 2), gs), 0,
                          out=gw[r, j])
            if cut < b:
                gw[r, j].addmm_(x[cut:b, cols].t(), g[cut:b, cols])
    return gw


# -------------------------------------------------------- plain versions
def _edge_rows(blk: AttentionBlockings) -> torch.Tensor:
    return torch.repeat_interleave(
        torch.arange(blk.num_rows, device=blk.col.device),
        blk.row_ptr.diff().long(), output_size=blk.num_edges)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    return x.double().view(x.shape[0], heads, x.shape[1] // heads)


def attention_plain(blk: AttentionBlockings, q, kt, vt, heads: int):
    """(out [T, D], lse [T, H]): K6's forward in PyTorch, float64 sums
    rounded once; a row without edges gives out 0 and lse -inf."""
    rows, col = _edge_rows(blk), blk.col.long()
    e, t = blk.num_edges, blk.num_rows
    s = (_heads(q, heads)[rows] * _heads(kt, heads)[col]).sum(-1)
    m = s.new_full((t, heads), -math.inf).scatter_reduce(
        0, rows[:, None].expand(e, heads), s, "amax")
    p = torch.exp(s - m[rows])
    lsum = s.new_zeros((t, heads)).index_add_(0, rows, p)
    o = s.new_zeros((t, heads, q.shape[1] // heads)).index_add_(
        0, rows, p[..., None] * _heads(vt, heads)[col])
    o = torch.where(lsum[..., None] > 0, o / lsum[..., None], 0.0)
    return o.view(t, -1).to(q.dtype), (m + torch.log(lsum)).to(q.dtype)


def attention_bwd_rows_plain(blk: AttentionBlockings, q, kt, vt, out, dout,
                             lse, heads: int):
    """(dq [T, D], p [E, H], ds [E, H]): K6's row pass in PyTorch."""
    rows, col = _edge_rows(blk), blk.col.long()
    s = (_heads(q, heads)[rows] * _heads(kt, heads)[col]).sum(-1)
    p = torch.exp(s - lse.double()[rows])
    dp = (_heads(dout, heads)[rows] * _heads(vt, heads)[col]).sum(-1)
    dsum = (_heads(dout, heads) * _heads(out, heads)).sum(-1)
    ds = p * (dp - dsum[rows])
    dq = s.new_zeros(_heads(q, heads).shape).index_add_(
        0, rows, ds[..., None] * _heads(kt, heads)[col])
    return (dq.view(q.shape).to(q.dtype), p.to(q.dtype), ds.to(q.dtype))


def attention_bwd_cols_plain(blk: AttentionBlockings, q, dout, p, ds,
                             heads: int):
    """(dkt, dvt) [M, D]: K6's column pass in PyTorch, over the
    transposed CSR."""
    m = blk.num_sources
    rows = torch.repeat_interleave(
        torch.arange(m, device=q.device), blk.t_row_ptr.diff().long(),
        output_size=blk.num_edges)
    t, e = blk.t_col.long(), blk.t_eid.long()
    shape = (m, heads, q.shape[1] // heads)
    dkt = q.new_zeros(shape, dtype=torch.float64).index_add_(
        0, rows, ds.double()[e][..., None] * _heads(q, heads)[t])
    dvt = q.new_zeros(shape, dtype=torch.float64).index_add_(
        0, rows, p.double()[e][..., None] * _heads(dout, heads)[t])
    return (dkt.view(m, -1).to(q.dtype), dvt.view(m, -1).to(q.dtype))


# -------------------------------------------------------------- wrappers
def _check_cuda(blk: AttentionBlockings, heads: int, *rows) -> None:
    if heads != KERNEL_HEADS:
        raise ValueError(f"K6 takes {KERNEL_HEADS} heads, not {heads}")
    for x in rows:
        if x.dtype != torch.float32 or x.dim() != 2 \
                or x.shape[1] != KERNEL_WIDTH:
            raise TypeError(f"K6 takes float32 rows {KERNEL_WIDTH} wide, "
                            f"got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("K6 takes contiguous 16-byte aligned rows")
        if x.device != blk.col.device:
            raise ValueError(f"a row tensor is on {x.device}, the "
                             f"blockings on {blk.col.device}")


def _chunk_args(ch: Chunks):
    return (ch.ptr.data_ptr(), ch.row.data_ptr(), ch.slot.data_ptr(),
            ch.row.numel(), ch.long_row.data_ptr(), ch.slot_ptr.data_ptr(),
            ch.long_row.numel())


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def csr_attention(blk: AttentionBlockings, q, kt, vt, heads: int):
    """(out [T, D], lse [T, H]) of the attention of ``blk``'s target rows
    ``q`` over their edges' stacked source rows ``kt`` and ``vt``: K6 on
    CUDA tensors, its plain version on CPU ones."""
    if q.device.type == "cpu":
        return attention_plain(blk, q, kt, vt, heads)
    _check_cuda(blk, heads, q, kt, vt)
    t = blk.num_rows
    out = q.new_empty((t, q.shape[1]))
    lse = q.new_empty((t, heads))
    slots = max(blk.chunks.num_slots, 1)
    part = q.new_empty((slots, q.shape[1]))
    part_ml = q.new_empty((slots, 2 * heads))
    with torch.cuda.device(q.device):
        _kernels.launch("attn_fwd", *_chunk_args(blk.chunks),
                        blk.col.data_ptr(), q.data_ptr(), kt.data_ptr(),
                        vt.data_ptr(), out.data_ptr(), lse.data_ptr(),
                        part.data_ptr(), part_ml.data_ptr(), _stream(q))
    global ATTENTION_LAUNCHES
    ATTENTION_LAUNCHES += 1
    return out, lse


def csr_attention_bwd_rows(blk: AttentionBlockings, q, kt, vt, out, dout,
                           lse, heads: int):
    """(dq, p, ds): the backward's row pass, K6 or its plain version."""
    if q.device.type == "cpu":
        return attention_bwd_rows_plain(blk, q, kt, vt, out, dout, lse,
                                        heads)
    _check_cuda(blk, heads, q, kt, vt, out, dout)
    dq = torch.empty_like(q)
    p = q.new_empty((blk.num_edges, heads))
    ds = torch.empty_like(p)
    part = q.new_empty((max(blk.chunks.num_slots, 1), q.shape[1]))
    with torch.cuda.device(q.device):
        _kernels.launch("attn_bwd_rows", *_chunk_args(blk.chunks),
                        blk.col.data_ptr(), q.data_ptr(), kt.data_ptr(),
                        vt.data_ptr(), out.data_ptr(), dout.data_ptr(),
                        lse.contiguous().data_ptr(), p.data_ptr(),
                        ds.data_ptr(), dq.data_ptr(), part.data_ptr(),
                        _stream(q))
    global ATTENTION_BACKWARD_LAUNCHES
    ATTENTION_BACKWARD_LAUNCHES += 1
    return dq, p, ds


def csr_attention_bwd_cols(blk: AttentionBlockings, q, dout, p, ds,
                           heads: int):
    """(dkt, dvt): the backward's column pass, K6 or its plain version."""
    if q.device.type == "cpu":
        return attention_bwd_cols_plain(blk, q, dout, p, ds, heads)
    _check_cuda(blk, heads, q, dout)
    m = blk.num_sources
    dkt = q.new_empty((m, q.shape[1]))
    dvt = torch.empty_like(dkt)
    part = q.new_empty((2 * max(blk.t_chunks.num_slots, 1), q.shape[1]))
    with torch.cuda.device(q.device):
        _kernels.launch("attn_bwd_cols", *_chunk_args(blk.t_chunks),
                        blk.t_col.data_ptr(), blk.t_eid.data_ptr(),
                        q.data_ptr(), dout.data_ptr(), p.data_ptr(),
                        ds.data_ptr(), dkt.data_ptr(), dvt.data_ptr(),
                        part.data_ptr(), _stream(q))
    global ATTENTION_BACKWARD_LAUNCHES
    ATTENTION_BACKWARD_LAUNCHES += 1
    return dkt, dvt


class _HgtAttention(torch.autograd.Function):
    """``out = softmax-attention(q, kt, vt)`` with ``kt`` = K's stacked
    source rows times ``w_att``, ``vt`` = V's times ``w_msg``
    (``head_products``). Both passes build ``kt`` and ``vt`` anew from
    ``k`` and ``v``; the backward's gradients of the stacked rows go back
    to the nodes by K1 on ``blk.place``, in a fixed order. The blockings
    get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, w_att, w_msg, blk):
        heads = w_att.shape[1]
        kt = head_products(k.index_select(0, blk.src_node), w_att, blk)
        vt = head_products(v.index_select(0, blk.src_node), w_msg, blk)
        out, lse = csr_attention(blk, q, kt, vt, heads)
        ctx.save_for_backward(q, k, v, w_att, w_msg, out, lse)
        ctx.blk = blk
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, w_att, w_msg, out, lse = ctx.saved_tensors
        blk, heads = ctx.blk, w_att.shape[1]
        g = g.contiguous()
        kg = k.index_select(0, blk.src_node)
        vg = v.index_select(0, blk.src_node)
        kt = head_products(kg, w_att, blk)
        vt = head_products(vg, w_msg, blk)
        dq, p, ds = csr_attention_bwd_rows(blk, q, kt, vt, out, g, lse,
                                           heads)
        del kt, vt
        dkt, dvt = csr_attention_bwd_cols(blk, q, g, p, ds, heads)
        del p, ds
        g_att = head_weight_grad(kg, dkt, w_att, blk)
        del kg
        dk = csr_scatter(blk.place, head_products(dkt, w_att, blk, True))
        del dkt
        g_msg = head_weight_grad(vg, dvt, w_msg, blk)
        del vg
        dv = csr_scatter(blk.place, head_products(dvt, w_msg, blk, True))
        return dq, dk, dv, g_att, g_msg, None


def hgt_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w_att: torch.Tensor, w_msg: torch.Tensor,
                  blk: AttentionBlockings) -> torch.Tensor:
    """[T, D]: HGT's message passing into ``blk``'s T target rows.
    ``q`` [T, D] holds their Q, ``k`` and ``v`` [N, D] every node's K and
    V; ``w_att`` and ``w_msg`` [R, H, D/H, D/H] the relations' per-head
    matrices, ``w_att`` already scaled by mu_{r,i} / sqrt(D/H).
    Differentiable in all five."""
    return _HgtAttention.apply(q, k, v, w_att, w_msg, blk)
