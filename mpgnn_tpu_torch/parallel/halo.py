"""Node-sharded mean aggregation with a halo exchange, and training on it.

Counterpart of ``mpgnn_tpu/parallel/halo.py``. The nodes are cut into P
blocks of S = ceil(N / P) rows; rank p of the mesh axis owns rows
[p*S, (p+1)*S) of every activation and the edges whose aggregation target
(source) falls in its block, so output rows stay where they are computed.
The destination rows a rank reads from other blocks, its halo, are
exchanged each hop:

* ``'a2a'``: one ``all_to_all_single`` with the exact per-peer row counts;
* ``'ppermute'``: P - 1 point-to-point rounds; in round r rank p sends to
  (p + r) % P and receives from (p - r) % P, and the self chunk is never
  sent.

The exchange is differentiable (``_HaloExchange``): its backward sends the
halo's cotangent back the same way and ``index_add_``s it into the rows
that were sent. Each rank then sums its local edges and its halo edges,
weighted by 1 / total degree so that the two partial sums add to the mean:
``'segment'`` with ``index_add_`` in float32, ``'csr'`` with K1
(``csrc/csr_scatter.cu``) on two rectangular blockings a rank, the local
one (S rows gathering from its [S] block) launched before the exchange is
waited on and the halo one (gathering from the received rows) after it, in
float32 for a bf16 input too, then one rounding (``halo.py:415``,
``:456-459``).

Not inherited from the JAX package: the padding of halo buffers to 128-row
multiples and of edge lists to powers of two (``halo.py:58-70``, ``:143``)
and the shards' common tile count (``pad_stack``, ``:255-303``), which
gave XLA static shapes; the port sends the exact rows. So ``halo_volume``'s
wire rows equal its useful rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.ops.csr import CsrBlocking, build_rect_csr_blocking, \
    csr_scatter
from mpgnn_tpu_torch.parallel.mesh import (
    Exchange,
    all_reduce_sum,
    start_all_to_all,
    start_ring,
)
from mpgnn_tpu_torch.utils.prof import start_span, stop_span

EXCHANGES = ("a2a", "ppermute")
LOCALS = ("segment", "csr")

# Each exchange (forward and backward) is timed as the span
# ``halo.exchange``, from its start to its received rows. An NCCL exchange
# returns to the host before its rows land: with EXCHANGE_SYNC set, each
# wait synchronizes the device before the span closes, so that its host
# seconds cover the exchange (and the local K1 launched while it was in
# flight) on either backend
EXCHANGE_SYNC = False


# --------------------------------------------------------------------- plan
@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Which rows move where for one relation over ``num_shards`` blocks.

    ``halo_nodes`` holds, for every (reader p, owner q) pair in that order,
    the sorted distinct destinations of p's edges that q owns (global ids);
    the pair's run starts at ``pair_start[p, q]`` and has ``pair_rows[q,
    p]`` rows. On reader p the received rows sit after its [S] block in the
    order ``recv_order(p)`` gives, and ``edge_slot`` is each edge's row in
    that concatenation (its destination's local row, or S + its halo row).
    ``edge_owner`` is each edge's shard (its source's block)."""

    num_shards: int
    block: int
    num_nodes: int
    exchange: str
    pair_rows: np.ndarray      # [P, P] rows owner q sends reader p
    pair_start: np.ndarray     # [P, P] (reader, owner) run start
    halo_nodes: np.ndarray     # [sum(pair_rows)] global ids
    src: np.ndarray            # [E] the relation's sources
    edge_owner: np.ndarray     # [E]
    edge_slot: np.ndarray      # [E]

    def recv_order(self, p: int) -> List[int]:
        """The owners whose rows reader p receives, in buffer order: every
        q (its own chunk has 0 rows) for 'a2a', (p - r) % P for rounds
        r = 1 .. P-1 for 'ppermute'."""
        P = self.num_shards
        if self.exchange == "a2a":
            return list(range(P))
        return [(p - r) % P for r in range(1, P)]

    def send_order(self, q: int) -> List[int]:
        """The readers owner q sends to, in its send buffer's order."""
        P = self.num_shards
        if self.exchange == "a2a":
            return list(range(P))
        return [(q + r) % P for r in range(1, P)]

    def halo_ids(self, q: int, p: int) -> np.ndarray:
        """Global ids of the rows owner q sends reader p, sorted."""
        s = self.pair_start[p, q]
        return self.halo_nodes[s:s + self.pair_rows[q, p]]

    def halo_rows(self, p: int) -> int:
        """Rows of reader p's received halo buffer."""
        return int(self.pair_rows[:, p].sum())

    def shard_edges(self, p: int) -> Tuple[np.ndarray, np.ndarray]:
        """(local source row, slot) of shard p's edges, in the relation's
        edge order."""
        sel = np.flatnonzero(self.edge_owner == p)
        return self.src[sel] - p * self.block, self.edge_slot[sel]

    def shard(self, p: int, device, local: str = "segment") -> "HaloShard":
        """Rank p's part of the plan on ``device``, with its local
        aggregation's operands (``local``: 'segment' or 'csr')."""
        if local not in LOCALS:
            raise ValueError(f"halo_local must be one of {LOCALS}, not "
                             f"{local!r}")
        S, P = self.block, self.num_shards
        send = [self.halo_ids(p, r) - p * S for r in self.send_order(p)]
        send_idx = (np.concatenate(send) if send
                    else np.zeros(0, dtype=np.int64))
        src_l, slot = self.shard_edges(p)
        deg = np.bincount(src_l, minlength=S)
        halo = self.halo_rows(p)
        out = dict(
            rank=p, num_shards=P, block=S, exchange=self.exchange,
            local=local, halo=halo,
            send_idx=torch.as_tensor(send_idx.astype(np.int64),
                                     device=device),
            send_splits=tuple(int(self.pair_rows[p, r])
                              for r in self.send_order(p)),
            recv_splits=tuple(int(self.pair_rows[q, p])
                              for q in self.recv_order(p)),
            moves=bool(self.pair_rows.any()),
        )
        if local == "csr":
            out["blockings"] = tuple(
                b.to(device) for b in build_halo_csr_operands(self, p))
        else:
            is_local = slot < S

            def t(a):
                return torch.as_tensor(a.astype(np.int64), device=device)

            out.update(
                src_local=t(src_l[is_local]), dst_local=t(slot[is_local]),
                src_halo=t(src_l[~is_local]), dst_halo=t(slot[~is_local] - S),
                degree=torch.as_tensor(np.maximum(deg, 1).astype(np.float32),
                                       device=device))
        return HaloShard(**out)


def _first_of_runs(keys: np.ndarray) -> np.ndarray:
    """Mask of the first element of each run of equal sorted ``keys``."""
    first = np.ones(len(keys), dtype=bool)
    if len(keys):
        first[1:] = keys[1:] != keys[:-1]
    return first


def build_halo_plan(src, dst, num_nodes: int, num_shards: int,
                    exchange: str = "a2a") -> HaloPlan:
    """The halo plan of one relation (edges ``src`` -> ``dst``, mean over
    each source's edges) over ``num_shards`` blocks of ceil(N / P) rows.
    Vectorised: one sort of the remote edges' (reader, owner, destination)
    keys gives every pair's distinct rows and every edge's slot."""
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    P, N = int(num_shards), int(num_nodes)
    S = -(-N // P)
    owner_src, owner_dst = src // S, dst // S
    slot = dst - owner_dst * S          # local edges: the destination's row
    remote = np.flatnonzero(owner_src != owner_dst)
    key = (owner_src[remote] * P + owner_dst[remote]) * N + dst[remote]
    order = np.argsort(key, kind="stable")
    first = _first_of_runs(key[order])
    uniq = key[order][first]
    run = np.cumsum(first) - 1          # each sorted remote edge's key
    pq, nodes = uniq // N, uniq % N
    reader, owner = pq // P, pq % P
    counts = np.bincount(reader * P + owner, minlength=P * P).reshape(P, P)
    pair_rows = np.ascontiguousarray(counts.T)     # [owner, reader]
    pair_start = np.zeros(P * P, dtype=np.int64)
    np.cumsum(counts.reshape(-1)[:-1], out=pair_start[1:])
    pair_start = pair_start.reshape(P, P)
    pos = np.arange(len(uniq)) - pair_start[reader, owner]
    plan = HaloPlan(P, S, N, exchange, pair_rows, pair_start, nodes, src,
                    owner_src, slot)
    # each reader's chunk offsets in its halo buffer, by owner
    chunk = np.zeros((P, P), dtype=np.int64)
    for p in range(P):
        off = 0
        for q in plan.recv_order(p):
            chunk[p, q] = off
            off += pair_rows[q, p]
    slot_of_key = S + chunk[reader, owner] + pos
    edge_slot = slot.copy()
    edge_slot[remote[order]] = slot_of_key[run]
    return dataclasses.replace(plan, edge_slot=edge_slot)


def build_halo_csr_operands(plan: HaloPlan, p: int):
    """Shard p's (local forward, local backward, halo forward, halo
    backward) K1 blockings, CPU tensors: the local pair has S rows and
    gathers from the shard's [S] block, the halo pair S rows gathering from
    its received buffer; both weigh each edge 1 / total degree of its
    source, so the two partial sums add to the mean (``halo.py:197-306``,
    without the common tile count)."""
    S = plan.block
    src_l, slot = plan.shard_edges(p)
    w = (1.0 / np.maximum(np.bincount(src_l, minlength=S), 1)).astype(
        np.float32)[src_l]
    is_local = slot < S
    lf, lb = build_rect_csr_blocking(src_l[is_local], slot[is_local],
                                     w[is_local], S, S)
    hf, hb = build_rect_csr_blocking(src_l[~is_local], slot[~is_local] - S,
                                     w[~is_local], S, plan.halo_rows(p))
    return lf, lb, hf, hb


def halo_volume(plan: HaloPlan, feat_dim: int, dtype_bytes: int = 4) -> dict:
    """Rows and bytes one aggregation moves between ranks. ``useful``
    counts the rows readers consume (the JAX package's ``useful_*``);
    ``wire`` what is sent, the same rows here (no padding, no self
    chunk)."""
    useful = int(plan.pair_rows.sum())
    return {
        "exchange": plan.exchange,
        "useful_rows": useful,
        "wire_rows": useful,
        "useful_bytes": useful * feat_dim * dtype_bytes,
        "wire_bytes": useful * feat_dim * dtype_bytes,
        "utilization": 1.0,
    }


def pad_node_features(x: np.ndarray, plan: HaloPlan) -> np.ndarray:
    """[N, F] features padded with zero rows to P * S."""
    out = np.zeros((plan.num_shards * plan.block, x.shape[1]), x.dtype)
    out[: x.shape[0]] = x
    return out


def shard_graph_features(x: np.ndarray, mesh, axis: str = "nodes",
                         device=None) -> torch.Tensor:
    """This rank's [S, F] block of the features padded to P * ceil(N / P)
    rows (the rows every ``build_halo_plan`` of the same N and P uses), on
    ``device`` (default the mesh's)."""
    P, p = mesh.axis_size(axis), mesh.axis_rank(axis)
    S = -(-x.shape[0] // P)
    block = np.zeros((S, x.shape[1]), dtype=np.float32)
    rows = np.asarray(x[p * S: (p + 1) * S], dtype=np.float32)
    block[: len(rows)] = rows
    return torch.as_tensor(block, device=device or mesh.device)


# -------------------------------------------------------------------- shard
@dataclasses.dataclass(frozen=True)
class HaloShard:
    """One rank's part of a ``HaloPlan`` on its device: the rows it sends
    (``send_idx``, per peer or round ``send_splits``), the rows it
    receives (``recv_splits``, ``halo`` in all) and its local aggregation's
    operands: for 'segment' its local and halo edges and the total degree
    of its rows, for 'csr' its four K1 blockings."""

    rank: int
    num_shards: int
    block: int
    exchange: str
    local: str
    halo: int
    send_idx: torch.Tensor
    send_splits: Tuple[int, ...]
    recv_splits: Tuple[int, ...]
    moves: bool                 # whether any rank sends any row
    blockings: Optional[Tuple[CsrBlocking, ...]] = None
    src_local: Optional[torch.Tensor] = None
    dst_local: Optional[torch.Tensor] = None
    src_halo: Optional[torch.Tensor] = None
    dst_halo: Optional[torch.Tensor] = None
    degree: Optional[torch.Tensor] = None


def _start(shard: HaloShard, group, ranks, rows: torch.Tensor,
           reverse: bool) -> Tuple[Exchange, object]:
    """Start the exchange of ``rows``: forward, the send rows; reverse, the
    halo's cotangent back to the rows' owners. Returns the exchange and its
    open span, which ``_wait`` closes."""
    sp = start_span("halo.exchange")
    width = rows.shape[1]
    if not shard.moves:
        return Exchange([], [rows.new_zeros((0, width))], rows.device), sp
    send_splits, recv_splits = shard.send_splits, shard.recv_splits
    if reverse:
        send_splits, recv_splits = recv_splits, send_splits
    if shard.exchange == "a2a":
        return start_all_to_all(rows, send_splits, recv_splits, group), sp
    P, p = shard.num_shards, shard.rank
    chunks, off = [], 0
    for r, n in enumerate(send_splits, start=1):
        to, frm = (p + r) % P, (p - r) % P
        if reverse:
            to, frm = frm, to
        chunks.append((rows[off:off + n], to, frm, recv_splits[r - 1]))
        off += n
    return start_ring(chunks, width, rows.dtype, ranks, group,
                      rows.device), sp


def _wait(started: Tuple[Exchange, object]) -> torch.Tensor:
    ex, sp = started
    out = ex.wait()
    if EXCHANGE_SYNC and out.is_cuda:
        torch.cuda.synchronize(out.device)
    stop_span(sp)
    return out


class _HaloExchange(torch.autograd.Function):
    """[halo, F] rows of the other blocks that this rank's edges read, in
    its buffer order; the backward returns their cotangent to the owners,
    who ``index_add_`` it into the rows they sent."""

    @staticmethod
    def forward(ctx, x_l, shard, group, ranks):
        ctx.shard, ctx.group, ctx.ranks = shard, group, ranks
        ctx.rows = x_l.shape[0]
        return _wait(_start(shard, group, ranks, x_l[shard.send_idx], False))

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        back = _wait(_start(shard, ctx.group, ctx.ranks, g.contiguous(),
                            True))
        dx = g.new_zeros((ctx.rows, g.shape[1]))
        return dx.index_add_(0, shard.send_idx, back), None, None, None


class _HaloCsr(torch.autograd.Function):
    """The halo mean on K1: the local blocking while the exchange is in
    flight, then the halo blocking on the received rows, float32 sums of
    both added and rounded once to x's dtype. The backward runs the two
    transposed blockings and returns the halo's cotangent (in x's dtype)
    to its owners, with the local blocking's launch between the return's
    start and its wait."""

    @staticmethod
    def forward(ctx, x_l, shard, group, ranks):
        ctx.shard, ctx.group, ctx.ranks = shard, group, ranks
        lf, _, hf, _ = shard.blockings
        started = _start(shard, group, ranks, x_l[shard.send_idx], False)
        out = csr_scatter(lf, x_l.float().contiguous())
        halo = _wait(started)
        out = out + csr_scatter(hf, halo.float().contiguous())
        return out.to(x_l.dtype)

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        _, lb, _, hb = shard.blockings
        g32 = g.float().contiguous()
        started = _start(shard, ctx.group, ctx.ranks,
                         csr_scatter(hb, g32).to(g.dtype), True)
        dx = csr_scatter(lb, g32).to(g.dtype)
        back = _wait(started)
        return dx.index_add_(0, shard.send_idx, back), None, None, None


def halo_sharded_mean_aggregate(mesh, x_local: torch.Tensor,
                                shard: HaloShard,
                                axis: str = "nodes") -> torch.Tensor:
    """out[i] = mean over edges (i, d) of x[d] for this rank's [S] rows,
    ``x_local`` its [S, F] block; rows without edges (padding among them)
    give 0. Every rank of the axis calls it together. Differentiable in
    ``x_local``; the exchange runs in its dtype, the sums in float32."""
    group, ranks = mesh.axis_group(axis), mesh.axis_ranks(axis)
    if shard.local == "csr":
        return _HaloCsr.apply(x_local, shard, group, ranks)
    halo = _HaloExchange.apply(x_local, shard, group, ranks)
    f = x_local.shape[1]
    tot = x_local.new_zeros((shard.block, f), dtype=torch.float32)
    tot = tot.index_add(0, shard.src_local, x_local[shard.dst_local].float())
    tot = tot.index_add(0, shard.src_halo, halo[shard.dst_halo].float())
    return (tot / shard.degree[:, None]).to(x_local.dtype)


# ------------------------------------------------------------------ training
class HaloRows:
    """This rank's rows of a node-sharded training run on ``mesh``'s
    ``axis``: its part of the split (local row ids), the NLL of its train
    rows over the global weight sum, the gradient sum across ranks, the
    global loss and macro-F1s from per-class counts summed across ranks,
    and its rows of the dropout masks (``shard_rows``)."""

    def __init__(self, mesh, axis: str, block: int, split, cw: np.ndarray,
                 device):
        self.group = mesh.axis_group(axis)
        lo = mesh.axis_rank(axis) * block
        self.shard_rows = (lo, mesh.axis_size(axis) * block)
        self.split = []
        for idx, y in ((split.train_idx, split.train_y),
                       (split.val_idx, split.val_y),
                       (split.test_idx, split.test_y)):
            idx, y = np.asarray(idx), np.asarray(y)
            mine = (idx >= lo) & (idx < lo + block)
            self.split += [torch.as_tensor(idx[mine] - lo, dtype=torch.int64,
                                           device=device),
                           torch.as_tensor(y[mine], dtype=torch.int64,
                                           device=device)]
        w = torch.as_tensor(np.asarray(cw, dtype=np.float32)[
            np.asarray(split.train_y)])
        self.weight_sum = w.sum().to(device)

    def nll(self, logp, idx, y, w) -> torch.Tensor:
        """This rank's share of the weighted NLL: its rows' weighted sum
        over the weight sum of every rank's train rows."""
        per = -logp[idx].gather(1, y[:, None])[:, 0]
        return (per * w).sum() / self.weight_sum

    def sync_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Sum every parameter's gradient across the ranks, in one
        collective."""
        grads = [p.grad for p in params if p.grad is not None]
        total = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                               self.group)
        off = 0
        for g in grads:
            g.copy_(total[off:off + g.numel()].view_as(g))
            off += g.numel()

    def total(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t.detach(), self.group)

    def macro_f1s(self, preds, pairs, num_classes: int) -> List[torch.Tensor]:
        """Macro-F1 of ``preds`` on each (local idx, labels) pair, over the
        rows of every rank (one collective)."""
        # imported here: the train package imports the model, which imports
        # this module
        from mpgnn_tpu_torch.train.metrics import f1_counts, macro_f1_counts

        counts = torch.stack([f1_counts(preds[i], y, num_classes)
                              for i, y in pairs])
        counts = all_reduce_sum(counts, self.group)
        return [macro_f1_counts(*c) for c in counts]


def build_node_sharded_train_step(mesh, graph, metapaths, split,
                                  num_classes: int, cfg=None, seed: int = 0,
                                  axis: str = "nodes",
                                  class_weighted: bool = False):
    """The node-sharded MPNetm training step, one call an epoch's step:
    the pieces of ``train_mpgnn(backend='halo')`` (``halo.py:507-632``).
    Returns ``(step, model, optimizer, x_local)``: ``step(generator=None)``
    runs one forward, backward (gradients summed across the ranks) and
    Adam step on every rank of ``axis`` together and returns the global
    loss; hop 0's aggregation of the constant features is computed once,
    here. ``metapaths`` may be one metapath or a list."""
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.models.mpgnn import precompute_first_hop
    from mpgnn_tpu_torch.train.loops import (
        build_hop_arrays,
        class_weights,
        compute_dtype,
        make_optimizer,
        seeded_init,
        train_step,
    )

    cfg = cfg or MPGNNConfig()
    if metapaths and not hasattr(metapaths[0], "__len__"):
        metapaths = [list(metapaths)]
    metapaths = [list(mp) for mp in metapaths]
    device = mesh.device
    dt = compute_dtype(cfg)
    hop_ops = build_hop_arrays(
        graph, metapaths, backend="halo", device=device, dtype=dt,
        mesh=mesh, mesh_axis=axis, halo_exchange=cfg.halo_exchange,
        halo_local=cfg.halo_local)
    x_local = shard_graph_features(graph.x, mesh, axis, device).to(dt)
    cw = class_weights(split.train_y, num_classes, class_weighted)
    rows = HaloRows(mesh, axis, x_local.shape[0], split, cw, device)
    model, _ = seeded_init(x_local.shape[1], cfg.hidden_dim, num_classes,
                           metapaths, seed, device, cfg.num_bases,
                           cfg.num_blocks)
    opt = make_optimizer(model, cfg)
    first = precompute_first_hop(x_local, hop_ops, dt)
    train_idx, train_y = rows.split[:2]
    w = torch.as_tensor(cw, device=device)[train_y]

    def step(generator: Optional[torch.Generator] = None) -> torch.Tensor:
        loss = train_step(model, opt, x_local, hop_ops, first, train_idx,
                          train_y, w, cfg, generator, dt, rows)
        return rows.total(loss)

    return step, model, opt, x_local
