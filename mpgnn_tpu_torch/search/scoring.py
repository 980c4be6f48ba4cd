"""Relation-scoring sweeps: every candidate relation's scorer trained at
once, on a leading relation axis.

Counterpart of ``mpgnn_tpu/search/scoring.py``. The reference trains one
small model per relation in its own MPI process (main.py:727-760,
853-917); the JAX package vmaps the relation axis into one XLA program per
chunk; here the relation axis is the leading ``R`` dimension of batched
tensors on the device, and the epochs are a Python loop of launches with
no host read inside it (one device-to-host copy per chunk round).

Semantics kept from the reference, as the JAX package keeps them:
* Adam(lr=0.1) + MSE, 100 epochs flat / 50 per bag restart
  (main.py:521-528, 755, 890), weights and attribution vector clamped to
  [0, 1] after every step (main.py:667-669);
* label-informed init, U(0, 1) re-init with frozen destinations kept
  (main.py:479-516);
* bag restarts until 2 consecutive non-improvements (main.py:884-911),
  with the grad mask accumulating monotonically (main.py:909-910);
* reported score = the last epoch's forward loss, before its step;
* degenerate flag: one cleaned bag, or no positive cleaned bag
  (main.py:876-882).

Every random number is drawn on the host from one ``np.random.Generator``
in the JAX package's order, and that order follows the chunk layout: the
pow2 bucketing of ``_chunks``/``_instance_chunks`` (a compile-signature
device in the JAX package) is kept so that each relation gets the same
draws, with its padding to at least the sweep mesh's rank count.

Under an active sweep mesh (``parallel.context``; ``run.py --mesh``) each
rank computes its slice of a chunk's relation or instance axis and the
slices are gathered back, the reference's ``np.array_split`` over MPI
ranks (main.py:1319, 1400); every rank draws the whole chunk's numbers and
keeps the whole result.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.config import ScorerConfig
from mpgnn_tpu_torch.device import free_memory_bytes, resolve_device
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.models.scorer import (
    Adam,
    ScorerParams,
    apply_freeze,
    bag_forward_ell,
    bag_forward_seg,
    bag_grads,
    clamp_params,
    flat_forward_ell,
    flat_forward_seg,
    flat_grad,
    flat_loss,
    init_attribution,
    init_scorer_params,
    init_weights,
    reinitialize_scorer_weights,
)
from mpgnn_tpu_torch.parallel.context import (
    gather_sweep,
    sweep_devices,
    sweep_slice,
)
from mpgnn_tpu_torch.utils.prof import span

log = logging.getLogger("mpgnn_tpu_torch.scoring")

# Per-chunk cap on sweep operand entries. None: on the GPU, derived from
# the free device memory at each call; on the CPU, the JAX package's value
# on a CPU host (4 GiB // 10), so both packages cut the same chunks there.
# Tests pin it.
_MEM_BUDGET_ENTRIES: Optional[int] = None
_CPU_BUDGET_ENTRIES = (4 << 30) // 10
# Device bytes a chunk entry takes: an int64 index, a bool mask and the
# per-epoch float32 temporaries of the gathers (values, masked values,
# products), about 24 bytes.
_BYTES_PER_ENTRY = 24
# Share of the free device memory the sweep operands may take.
_FREE_FRACTION = 0.2
# A relation whose pow2 ELL table would exceed this multiple of its padded
# edge count is hub-inflated: one high-degree node would widen the whole
# [N, D] table, so it scores through the segment path instead.
_SEG_RATIO = 64


def _mem_budget_entries(device=None) -> int:
    """Entry budget of one sweep chunk. On the GPU: ``_FREE_FRACTION`` of
    the free device memory (memory PyTorch holds in its cache counts as
    free) over ``_BYTES_PER_ENTRY``, at least 16M entries."""
    if _MEM_BUDGET_ENTRIES is not None:
        return _MEM_BUDGET_ENTRIES
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return _CPU_BUDGET_ENTRIES
    free = free_memory_bytes(device)
    return max(16_000_000, int(free * _FREE_FRACTION) // _BYTES_PER_ENTRY)


# ------------------------------------------------------------------ helpers
def _pow2_bucket(n: int, lo: int = 4) -> int:
    """Round up to a power of two (>= lo)."""
    n = max(n, lo)
    return 1 << (n - 1).bit_length()


def _relation_mode(graph: HeteroGraph, relation: int,
                   budget: Optional[int] = None) -> Tuple[str, int]:
    """('ell', D_pad) or ('seg', E_pad) for one relation's scorer operands:
    ELL tables ([N, D], D = pow2(max degree)) unless one hub would inflate
    the table past ``_SEG_RATIO`` x the padded edge count or a quarter of
    the chunk budget; then [E] edge lists with segment reductions."""
    budget = _mem_budget_entries() if budget is None else budget
    d = _pow2_bucket(graph.rel_max_degree(int(relation)))
    n_ell = graph.num_nodes * d
    e_pad = _pow2_bucket(int(graph.rel_counts[relation]), lo=128)
    if n_ell > budget // 4 or n_ell > _SEG_RATIO * e_pad:
        return "seg", e_pad
    return "ell", d


def _relation_ell_stack(
    graph: HeteroGraph, relations: Sequence[int], d_pad: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-relation ELL tables stacked to a common [R, N, D]."""
    tables = [graph.neighbor_table(int(r)) for r in relations]
    d_max = max(t[0].shape[1] for t in tables)
    if d_pad is not None:
        d_max = max(d_max, d_pad)
    R, N = len(tables), graph.num_nodes
    nbr = np.zeros((R, N, d_max), dtype=np.int64)
    mask = np.zeros((R, N, d_max), dtype=bool)
    for i, (t, m) in enumerate(tables):
        nbr[i, :, : t.shape[1]] = t
        mask[i, :, : m.shape[1]] = m
    return nbr, mask


def _relation_segment_stack_compact(
    graph: HeteroGraph, relations: Sequence[int], e_pad: int, c_pad: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[np.ndarray]]:
    """Per-relation source-sorted edge lists stacked to [R, e_pad], each in
    its relation's compact endpoint space: (src, dst, mask, nodes), with
    ``nodes[i]`` relation i's sorted endpoints (compact id c is node
    ``nodes[i][c]``). Sources are stable-sorted, so the lowest edge index
    among a source's maxima is its first in file order; pad edges point at
    compact row ``c_pad - 1`` (after every real id) and are masked."""
    R = len(relations)
    src = np.full((R, e_pad), c_pad - 1, dtype=np.int64)
    dst = np.zeros((R, e_pad), dtype=np.int64)
    mask = np.zeros((R, e_pad), dtype=bool)
    nodes: List[np.ndarray] = []
    for i, r in enumerate(relations):
        s, d = graph.rel_edges_csr(int(r))
        nd = graph.rel_endpoint_nodes(int(r))
        n = len(s)
        src[i, :n] = np.searchsorted(nd, s)
        dst[i, :n] = np.searchsorted(nd, d)
        mask[i, :n] = True
        nodes.append(nd)
    return src, dst, mask, nodes


def _gather_compact(full_rows: np.ndarray, nodes: List[np.ndarray],
                    c_pad: int, fill=0.0) -> np.ndarray:
    """[R, N] host rows -> [R, c_pad] compact rows (pad lanes ``fill``)."""
    R = len(nodes)
    out = np.full((R, c_pad), fill, dtype=full_rows.dtype)
    for i, nd in enumerate(nodes):
        out[i, : len(nd)] = full_rows[i][nd]
    return out


def _compact_pad(graph: HeteroGraph, relation: int) -> int:
    """Pow2 bucket of a relation's compact node-space width."""
    return _pow2_bucket(len(graph.rel_endpoint_nodes(int(relation))), lo=128)


def _chunks(
    relations: Sequence[int], graph: HeteroGraph,
    budget: Optional[int] = None,
) -> List[Tuple[str, int, int, List[int]]]:
    """Relations grouped into (mode, pad, cpad, relation-list) chunks:
    routed by ``_relation_mode``, bucketed by pow2 pad and (segment form)
    pow2 compact width ``cpad`` (ELL chunks: cpad = N), each bucket split so
    a chunk's entries fit the budget, each chunk padded to a power of two,
    and to at least the sweep mesh's rank count, by repeating its last
    relation (callers keep the first result)."""
    budget = _mem_budget_entries() if budget is None else budget
    N = graph.num_nodes
    by_bucket: Dict[Tuple[str, int, int], List[int]] = {}
    for r in relations:
        mode, pad = _relation_mode(graph, int(r), budget)
        cpad = _compact_pad(graph, r) if mode == "seg" else N
        by_bucket.setdefault((mode, pad, cpad), []).append(int(r))
    out: List[Tuple[str, int, int, List[int]]] = []
    for (mode, pad, cpad), rels in sorted(by_bucket.items()):
        per_rel = N * pad if mode == "ell" else 2 * pad + 4 * cpad
        max_r = max(1, budget // per_rel)
        max_r = max(1, 1 << (max_r.bit_length() - 1))  # pow2 floor
        for i in range(0, len(rels), max_r):
            chunk = rels[i : i + max_r]
            pad_to = min(max(_pow2_bucket(len(chunk), lo=1),
                             sweep_devices()), max_r)
            while len(chunk) < pad_to:
                chunk = chunk + [chunk[-1]]
            out.append((mode, pad, cpad, chunk))
    return out


def dest_min_labels(
    graph: HeteroGraph,
    relation: int,
    source_mask: np.ndarray,   # [N] bool: sources contributing labels
    node_labels: np.ndarray,   # [N] float: per-node (pseudo-)labels
) -> Tuple[np.ndarray, np.ndarray]:
    """(destination ids, min source label per destination) of one relation,
    the label-informed init data (destination_dictionary, main.py:412-424)."""
    src, dst = graph.rel_edges(relation)
    sel = source_mask[src]
    src, dst = src[sel], dst[sel]
    if len(dst) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    order = np.argsort(dst, kind="stable")
    dsts, starts = np.unique(dst[order], return_index=True)
    mins = np.minimum.reduceat(node_labels[src[order]], starts)
    return dsts.astype(np.int64), mins.astype(np.float32)


def _flat_ids(a: np.ndarray, width: int, device) -> torch.Tensor:
    """[R, ...] per-row ids -> int64 ids into an [R, width] tensor's flat
    view, on ``device`` (the span ``score.upload``)."""
    with span("score.upload"):
        a = torch.as_tensor(a, dtype=torch.long, device=device)
        off = torch.arange(a.shape[0], device=device) * width
        return a + off.view(-1, *([1] * (a.dim() - 1)))


def _segment_has(seg: torch.Tensor, em: torch.Tensor, size: int):
    """[R, size] bool: which flat segments hold a real entry."""
    has = torch.zeros(seg.numel() // seg.shape[-1] * size, dtype=torch.bool,
                      device=seg.device)
    has[seg[em]] = True
    return has.view(-1, size)


def _t(a, device, dtype=None) -> torch.Tensor:
    """``a`` on ``device`` (the span ``score.upload``)."""
    with span("score.upload"):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)


# ======================================================== flat (hop-0) sweep
@dataclasses.dataclass
class FlatScore:
    relation: int
    loss: float
    weights: np.ndarray  # trained [N] node weights


def _flat_sweep(w, forward, ct, has, y, lmask, denom, const,
                *, epochs: int, lr: float):
    """Train R flat scorers for ``epochs`` steps from ``w``; return (w,
    loss [R] of the last epoch's forward, before its step). Timed as the
    span ``score.epochs``."""
    with span("score.epochs"):
        opt = Adam([w], lr)
        loss = None
        for e in range(epochs):
            pred, win = forward(w)
            if e == epochs - 1:
                loss = flat_loss(pred, y, lmask, denom, const)
            g = flat_grad(w, pred, win, has, y, ct)
            w = opt.update([w], [g])[0].clamp(0.0, 1.0)     # main.py:668
        return w, loss


def score_relations_flat(
    graph: HeteroGraph,
    relations: Sequence[int],
    node_labels: np.ndarray,
    source_nodes: Optional[Sequence[int]],
    cfg: ScorerConfig = ScorerConfig(),
    rng: Optional[np.random.Generator] = None,
    device=None,
    warmer=None,
) -> Dict[int, FlatScore]:
    """Hop-0 sweep (score_relation_parallel, main.py:727-760) on ``device``
    (the GPU unless ``device='cpu'``).

    ``source_nodes=None``: each relation's source set is the sources of its
    own edges (main.py:728-735); otherwise the fixed labeled-source list
    serves every relation (FB15K mode). ``warmer``
    (``utils.warm.ProgramWarmer``) warms each chunk's sweep form before
    the chunk loop reaches it. Each chunk's host operands are timed as the
    span ``score.operands``, its copies to the device as ``score.upload``,
    its epochs as ``score.epochs`` and its results' return to the host
    (with the sweep mesh's gather) as ``score.gather``."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    node_labels = np.asarray(node_labels, dtype=np.float32).reshape(-1)
    N = graph.num_nodes
    results: Dict[int, FlatScore] = {}

    fixed_mask = None
    if source_nodes is not None:
        fixed_mask = np.zeros(N, dtype=bool)
        fixed_mask[np.asarray(list(source_nodes), dtype=np.int64)] = True

    chunks = _chunks(relations, graph, _mem_budget_entries(device))
    if warmer is not None:
        for mode, pad, cpad, chunk in chunks:
            warmer.warm_flat_signature(len(chunk), N, pad, cfg.epochs_flat,
                                       cfg.lr, mode=mode, C=cpad,
                                       device=device)
    for ci, (mode, pad, cpad, chunk) in enumerate(chunks):
        R = len(chunk)
        log.info(
            "flat sweep chunk %d/%d: %d relations, mode=%s, pad=%d, C=%d",
            ci + 1, len(chunks), R, mode, pad, cpad,
        )
        with span("score.operands"):
            if mode == "ell":
                nbr, mask = _relation_ell_stack(graph, chunk, pad)
                has_edge_rows = mask.any(axis=-1)              # [R, N]
            else:
                srcs, dsts_a, emask, nodes = _relation_segment_stack_compact(
                    graph, chunk, pad, cpad
                )
                has_edge_rows = np.stack(
                    [graph.rel_degrees(int(r)) > 0 for r in chunk]
                )
            w0 = np.empty((R, N), dtype=np.float32)
            loss_mask = np.zeros((R, N), dtype=np.float32)
            for i, r in enumerate(chunk):
                src_mask = (has_edge_rows[i] if fixed_mask is None
                            else fixed_mask)
                loss_mask[i] = src_mask.astype(np.float32)
                dsts, mins = dest_min_labels(graph, r, src_mask, node_labels)
                w0[i] = init_weights(rng, N, dsts, mins, cfg.init_noise)
        sl = sweep_slice(R)     # this rank's relations of the chunk
        if mode == "ell":
            lmask = _t(loss_mask[sl], device)
            denom = lmask.sum(1).clamp_min(1.0)
            has = _t(has_edge_rows[sl], device)
            nbr_f = _flat_ids(nbr[sl], N, device)
            mask_t = _t(mask[sl], device)
            w, loss = _flat_sweep(
                _t(w0[sl], device),
                lambda w: flat_forward_ell(w, nbr_f, mask_t, has),
                (1.0 / denom)[:, None] * lmask, has,
                _t(node_labels, device), lmask, denom, None,
                epochs=cfg.epochs_flat, lr=cfg.lr,
            )
            with span("score.gather"):
                w = gather_sweep(w, R).cpu().numpy()
        else:
            # device state in each relation's compact endpoint space; the
            # label-informed init and the masks stay full-space on the host
            with span("score.operands"):
                y_rows = np.broadcast_to(node_labels, (R, N))
                lmask_c = _gather_compact(loss_mask, nodes, cpad)[sl]
                w0_c = _gather_compact(w0, nodes, cpad)[sl]
                y_c = _gather_compact(y_rows, nodes, cpad)[sl]
                denom = np.maximum(loss_mask.sum(axis=1),
                                   1.0).astype(np.float32)
                # sources outside the compact space but in the loss mask
                # (fixed sources without edges of the relation) add a
                # constant
                y2 = node_labels.astype(np.float64) ** 2
                const = np.array([
                    float((y2 * loss_mask[i]).sum()
                          - (y2[nodes[i]] * loss_mask[i][nodes[i]]).sum())
                    for i in range(R)
                ], dtype=np.float32)
            lmask = _t(lmask_c, device)
            src_f = _flat_ids(srcs[sl], cpad, device)
            dst_f = _flat_ids(dsts_a[sl], cpad, device)
            em = _t(emask[sl], device)
            has = _segment_has(src_f, em, cpad)
            denom_t = _t(denom[sl], device)
            w_c, loss = _flat_sweep(
                _t(w0_c, device),
                lambda w: flat_forward_seg(w, src_f, dst_f, em, has),
                (1.0 / denom_t)[:, None] * lmask, has,
                _t(y_c, device), lmask,
                denom_t, _t(const[sl], device),
                epochs=cfg.epochs_flat, lr=cfg.lr,
            )
            # back to full space: nodes outside the endpoint space keep
            # their init (zero gradient, zero Adam update, clamp no-op)
            with span("score.gather"):
                w_c = gather_sweep(w_c, R).cpu().numpy()
            w = w0
            for i, nd in enumerate(nodes):
                w[i][nd] = w_c[i][: len(nd)]
        with span("score.gather"):
            loss = gather_sweep(loss, R).cpu().numpy()
        for i, r in enumerate(chunk):
            if int(r) not in results:   # chunk padding repeats relations
                results[int(r)] = FlatScore(int(r), float(loss[i]), w[i])
    return results


# =========================================================== bag-mode sweep
def _bag_buckets(tasks: Sequence) -> Tuple[int, int, int]:
    """Shared pow2 (B, M, P) across all tasks: B bags, M members per bag
    (ELL form), P members in all (flattened segment form)."""
    B = _pow2_bucket(max((len(t[2]) for t in tasks), default=1), lo=8)
    M = _pow2_bucket(
        max((len(b) for t in tasks for b in t[2]), default=1), lo=2
    )
    P = _pow2_bucket(
        max((sum(len(b) for b in t[2]) for t in tasks), default=1), lo=8
    )
    return B, M, P


def _instance_chunks(
    graph: HeteroGraph, tasks: Sequence, N: int,
    budget: Optional[int] = None,
) -> List[Tuple[str, int, int, list]]:
    """(task index, relation) instances grouped into chunks (mode, pad,
    cpad, instance-list) as ``_chunks`` groups relations; segment-form
    instances also carry [C, F] feature rows. Deterministic in ``tasks``."""
    budget = _mem_budget_entries() if budget is None else budget
    F = graph.feat_dim
    instances = [
        (ti, int(r)) for ti, (tid, rels, _, _) in enumerate(tasks)
        for r in rels
    ]
    by_bucket: Dict[Tuple[str, int, int], list] = {}
    for inst in instances:
        mode, pad = _relation_mode(graph, inst[1], budget)
        cpad = _compact_pad(graph, inst[1]) if mode == "seg" else N
        by_bucket.setdefault((mode, pad, cpad), []).append(inst)
    chunks = []
    for (mode, pad, cpad), insts in sorted(by_bucket.items()):
        per_rel = N * pad if mode == "ell" else 2 * pad + cpad * (F + 6)
        max_r = max(1, budget // per_rel)
        max_r = max(1, 1 << (max_r.bit_length() - 1))
        for i in range(0, len(insts), max_r):
            chunk = insts[i : i + max_r]
            pad_to = min(max(_pow2_bucket(len(chunk), lo=1),
                             sweep_devices()), max_r)
            while len(chunk) < pad_to:
                chunk = chunk + [chunk[-1]]
            chunks.append((mode, pad, cpad, chunk))
    return chunks


@dataclasses.dataclass
class BagScore:
    relation: int
    loss: float                    # best loss across restarts
    degenerate: bool               # the reference's ``v`` flag
    weights: np.ndarray            # [N] node weights of the last restart
    attribution: np.ndarray        # [F] attribution vector of the last restart
    member_pred_max: np.ndarray    # [N] running max member value over restarts
    member_recorded: np.ndarray    # [N] bool: member had r-edges (recorded)
    num_restarts: int


def _bag_round(forward, w0, u0, x, labels, keep, bag_has, has, gmask, fmask,
               *, epochs: int, lr: float):
    """One restart round for R instances at once: ``epochs`` Adam steps of
    the bag loss from (w0, u0) with the grad mask, the [0, 1] clamps and the
    frozen weights restored after each step (main.py:641-673). The reported
    loss, per-bag losses, winners and member values come from the last
    epoch's forward, before its step; the weights from after it.

    Returns (w, u, loss [R], per_bag [R, B], winner [R, B] flat ids,
    member_value [R, S])."""
    denom = keep.sum(1).clamp_min(1.0)
    ct = (1.0 / denom)[:, None] * keep
    opt = Adam([w0, u0], lr)
    w, u = w0, u0
    for e in range(epochs):
        fwd = forward(w, u)
        if e == epochs - 1:
            per_bag = (fwd.pred - labels) ** 2
            loss = (per_bag * keep).sum(1) / denom
            winner = fwd.member_winner.reshape(-1)[fwd.bag_member]
            member_value = fwd.member_value
        gw, gu = bag_grads(w, fwd, x, labels, ct, bag_has, has)
        w, u = opt.update([w, u], [gw * gmask, gu])     # main.py:663-664
        w, u = apply_freeze(clamp_params(ScorerParams(w, u)), fmask,
                            w0)                         # main.py:668-672
    return w, u, loss, per_bag, winner, member_value


def _retrain_mode(graph: HeteroGraph, relation: int,
                  budget: Optional[int] = None) -> Tuple[str, int]:
    """Operand mode of the single-relation retrain: the sweeps' routing,
    but ELL at the raw largest degree (``_relation_ell_stack`` without a
    pad)."""
    mode, pad = _relation_mode(graph, relation, budget)
    if mode == "ell":
        return "ell", graph.rel_max_degree(relation)
    return mode, pad


def _flat_members(bags: List[List[int]], B: int, P: int):
    """Bags flattened into member segments: (member ids [P], bag ids [P]
    sorted, pads at bag B - 1, valid [P])."""
    mn = np.zeros(P, dtype=np.int64)
    mb = np.full(P, B - 1, dtype=np.int64)
    mv = np.zeros(P, dtype=bool)
    p = 0
    for i, b in enumerate(bags):
        mn[p : p + len(b)] = b
        mb[p : p + len(b)] = i
        mv[p : p + len(b)] = True
        p += len(b)
    return mn, mb, mv


class _Chunk:
    """One chunk's bag operands on the device, and its round function.

    ``insts`` holds one dict per instance, with its task's padded bag table
    (``bags``, ``valid``: [B, M]), bag ``labels`` [B] and flattened
    ``members`` (``_flat_members``). ELL form reads the tables, segment form
    the flattened members only. The host bookkeeping covers every
    instance; the device operands only this rank's ``sweep_slice``."""

    def __init__(self, graph, mode, pad, cpad, rels, insts, x, B, device):
        R, N = len(rels), graph.num_nodes
        self.mode, self.nodes = mode, []
        self.rows = sl = sweep_slice(R)
        if mode == "ell":
            nbr, mask = _relation_ell_stack(graph, rels, pad)
            has_edge = mask.any(axis=-1)                  # [R, N]
            bags_i = np.stack([t["bags"] for t in insts])
            member_mask = np.stack([t["valid"] for t in insts]) & (
                np.take_along_axis(has_edge[:, None, :],
                                   bags_i.reshape(R, 1, -1), axis=2)
                .reshape(R, B, -1))
            bag_keep = member_mask.any(axis=-1)
        else:
            srcs, dsts_a, emask, self.nodes = _relation_segment_stack_compact(
                graph, rels, pad, cpad
            )
            has_edge = np.stack([graph.rel_degrees(r) > 0 for r in rels])
            # members with r-edges, flattened; a bag is kept if it has one
            member_mask = [t["members"][2] & has_edge[i][t["members"][0]]
                           for i, t in enumerate(insts)]
            bag_keep = np.zeros((R, B), dtype=bool)
            for i, t in enumerate(insts):
                bag_keep[i, t["members"][1][member_mask[i]]] = True
        self.has_edge = has_edge
        self.bag_keep = bag_keep.astype(np.float32)            # [R, B]
        self.labels = _t(np.stack([t["labels"] for t in insts])[sl], device)
        self.keep = _t(self.bag_keep[sl], device)
        self.bag_has = self.keep > 0.5
        if mode == "ell":
            nbr_f = _flat_ids(nbr[sl], N, device)
            mask_t = _t(mask[sl], device)
            self.has = _t(has_edge[sl], device)
            bags_f = _flat_ids(bags_i[sl], N, device)
            mmask = _t(member_mask[sl], device)
            self.x = _t(x, device)
            self.forward = lambda w, u: bag_forward_ell(
                w, u, self.x, nbr_f, mask_t, self.has, bags_f, mmask,
                self.bag_has)
            self.width = N
        else:
            # compact endpoint space; members remapped into it (members
            # without r-edges are masked, any in-range id works) and each
            # instance's feature rows gathered
            src_f = _flat_ids(srcs[sl], cpad, device)
            dst_f = _flat_ids(dsts_a[sl], cpad, device)
            em = _t(emask[sl], device)
            self.has = _segment_has(src_f, em, cpad)
            mm_i = np.stack(member_mask)
            mn_i = np.zeros(mm_i.shape, dtype=np.int64)
            mb_i = np.stack([t["members"][1] for t in insts])
            x_c = np.zeros((R, cpad, x.shape[1]), dtype=np.float32)
            for i, nd in enumerate(self.nodes):
                mn = insts[i]["members"][0]
                mc = np.searchsorted(nd, mn).clip(0, cpad - 1)
                mn_i[i] = np.where(mm_i[i], mc, 0)
                x_c[i, : len(nd)] = x[nd]
            mn_f = _flat_ids(mn_i[sl], cpad, device)
            mb_f = _flat_ids(mb_i[sl], B, device)
            mm = _t(mm_i[sl], device)
            self.x = _t(x_c[sl], device)
            self.forward = lambda w, u: bag_forward_seg(
                w, u, self.x, src_f, dst_f, em, self.has, mn_f, mb_f, mm,
                self.bag_has)
            self.width = cpad

    def run(self, w0, u0, grad_mask, frozen_mask, *, epochs, lr, device):
        """One restart round from host state; results back on the host in
        full node space."""
        R, N = w0.shape
        if self.mode == "ell":
            hw0, hgm, hfm = w0, grad_mask, frozen_mask
        else:
            cpad = self.width
            hw0 = _gather_compact(w0, self.nodes, cpad)
            hgm = _gather_compact(grad_mask, self.nodes, cpad)
            hfm = _gather_compact(frozen_mask, self.nodes, cpad, fill=False)
        sl = self.rows
        w, u, loss, per_bag, winner, member_value = _bag_round(
            self.forward, _t(hw0[sl], device), _t(u0[sl], device), self.x,
            self.labels, self.keep, self.bag_has, self.has,
            _t(hgm[sl], device), _t(hfm[sl], device), epochs=epochs, lr=lr,
        )
        winner = winner - (torch.arange(winner.shape[0], device=device)
                           * self.width)[:, None]
        w, u, loss, per_bag, winner, member_value = (
            gather_sweep(a, R).cpu().numpy()
            for a in (w, u, loss, per_bag, winner, member_value))
        if self.mode == "seg":
            # back to full space: outside the endpoint set the weights keep
            # their round init and member values are exactly 0
            w_full = w0.copy()
            mv_full = np.zeros((R, N), dtype=np.float32)
            win_full = np.zeros(winner.shape, dtype=np.int64)
            for i, nd in enumerate(self.nodes):
                w_full[i][nd] = w[i][: len(nd)]
                mv_full[i][nd] = member_value[i][: len(nd)]
                win_full[i] = nd[winner[i].clip(0, len(nd) - 1)]
            w, member_value, winner = w_full, mv_full, win_full
        return w, u, loss, per_bag, winner, member_value


def retrain_bags_predictions(
    graph: HeteroGraph,
    relation: int,
    bags: List[List[int]],
    bag_labels: np.ndarray,
    cfg: ScorerConfig = ScorerConfig(),
    rng: Optional[np.random.Generator] = None,
    x: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One fresh bag-training round on the chosen relation, returning
    (member values [N], recorded mask [N]): the extra prediction round
    before relabeling (retrain_bags, main.py:814-851: 1 restart, no
    freezing, fresh label-informed init)."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    x = np.asarray(graph.x if x is None else x, dtype=np.float32)
    N, F = x.shape
    n_bags = len(bags)
    B = _pow2_bucket(n_bags, lo=8)
    M = _pow2_bucket(max((len(b) for b in bags), default=1), lo=2)
    bags_arr = np.zeros((B, M), dtype=np.int64)
    member_valid = np.zeros((B, M), dtype=bool)
    for i, b in enumerate(bags):
        bags_arr[i, : len(b)] = b
        member_valid[i, : len(b)] = True
    bag_labels = np.concatenate([
        np.asarray(bag_labels, dtype=np.float32).reshape(-1),
        np.zeros(B - n_bags, dtype=np.float32),
    ])

    member_min_label = np.full(N, np.inf, dtype=np.float32)
    for i, b in enumerate(bags):
        for s in b:
            member_min_label[s] = min(member_min_label[s], bag_labels[i])
    is_member = np.isfinite(member_min_label)

    mode, pad = _retrain_mode(graph, int(relation),
                              _mem_budget_entries(device))
    cpad = _compact_pad(graph, int(relation)) if mode == "seg" else N
    P = _pow2_bucket(sum(len(b) for b in bags), lo=8)
    inst = dict(bags=bags_arr, valid=member_valid, labels=bag_labels,
                members=_flat_members(bags, B, P))
    chunk = _Chunk(graph, mode, pad if mode == "seg" else None, cpad,
                   [int(relation)], [inst], x, B, device)

    dsts, mins = dest_min_labels(graph, relation, is_member, member_min_label)
    p0 = init_scorer_params(rng, N, F, dsts, mins, cfg.init_noise)
    _, _, _, _, _, member_value = chunk.run(
        p0.w[None], p0.u[None], np.ones((1, N), np.float32),
        np.zeros((1, N), bool),
        epochs=cfg.epochs_bags, lr=cfg.lr, device=device,
    )
    recorded = chunk.has_edge[0] & is_member
    return member_value[0], recorded


def score_relations_bags(
    graph: HeteroGraph,
    relations: Sequence[int],
    bags: List[List[int]],
    bag_labels: np.ndarray,
    cfg: ScorerConfig = ScorerConfig(),
    rng: Optional[np.random.Generator] = None,
    x: Optional[np.ndarray] = None,
    device=None,
) -> Dict[int, BagScore]:
    """Bag sweep with restarts (score_relation_bags_parallel, main.py:853-917)
    for one search state; ``score_bag_tasks`` is the batched form."""
    return score_bag_tasks(
        graph, [(0, relations, bags, bag_labels)], cfg, rng, x, device=device
    )[0]


def score_bag_tasks(
    graph: HeteroGraph,
    tasks: Sequence,
    cfg: ScorerConfig = ScorerConfig(),
    rng: Optional[np.random.Generator] = None,
    x: Optional[np.ndarray] = None,
    stats: Optional[list] = None,
    device=None,
    warmer=None,
) -> Dict:
    """Bag sweeps for many search states at once on ``device``.

    ``tasks`` is a list of ``(task_id, relations, bags, bag_labels)``; every
    (task, relation) pair is one instance on the batch axis, so a whole
    frontier hop (the reference's per-metapath MPI fan-outs,
    main.py:1381-1408) runs as one batch per chunk and restart round.
    Returns ``{task_id: {relation: BagScore}}``. The restart control flow
    stays on the host, per instance. ``stats``, if given, receives one dict
    of shapes per chunk. ``warmer`` warms each chunk's restart-round form
    before the host's bag bookkeeping below."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    x = np.asarray(graph.x if x is None else x, dtype=np.float32)
    N, F = x.shape
    B, M, P = _bag_buckets(tasks)
    chunks = _instance_chunks(graph, tasks, N, _mem_budget_entries(device))
    if warmer is not None:
        for mode, pad, cpad, chunk in chunks:
            warmer.warm_bag_signature(len(chunk), N, pad, B, M, F,
                                      cfg.epochs_bags, cfg.lr, mode=mode,
                                      C=cpad, P=P, device=device)

    per_task = []
    for tid, rels, bag_list, labels in tasks:
        bags_arr = np.zeros((B, M), dtype=np.int64)
        member_valid = np.zeros((B, M), dtype=bool)
        for i, b in enumerate(bag_list):
            bags_arr[i, : len(b)] = b
            member_valid[i, : len(b)] = True
        lab = np.concatenate([
            np.asarray(labels, dtype=np.float32).reshape(-1),
            np.zeros(B - len(bag_list), dtype=np.float32),
        ])
        # min bag label per member (destination_bag_dictionary init,
        # main.py:426-438)
        mml = np.full(N, np.inf, dtype=np.float32)
        for i, b in enumerate(bag_list):
            for m in b:
                mml[m] = min(mml[m], lab[i])
        per_task.append(dict(
            tid=tid, bags=bags_arr, valid=member_valid, labels=lab,
            member_min_label=mml, is_member=np.isfinite(mml),
            members=_flat_members(bag_list, B, P),
        ))

    results: Dict = {t[0]: {} for t in tasks}
    for ci, (mode, pad, cpad, chunk) in enumerate(chunks):
        R = len(chunk)
        log.info(
            "bag sweep chunk %d/%d: %d instances, mode=%s, pad=%d, C=%d",
            ci + 1, len(chunks), R, mode, pad, cpad,
        )
        if stats is not None:
            stats.append(dict(mode=mode, R=R, E=pad, C=cpad, B=B, M=M, P=P,
                              F=F))
        dev = _Chunk(graph, mode, pad, cpad, [r for _, r in chunk],
                     [per_task[ti] for ti, _ in chunk], x, B, device)
        has_edge, bag_keep = dev.has_edge, dev.bag_keep
        labels_i = np.stack([per_task[ti]["labels"] for ti, _ in chunk])

        # degenerate flag (main.py:876-882) over cleaned bags
        kept_counts = bag_keep.sum(axis=1)
        pos_kept = (bag_keep * (labels_i > 0.5)).sum(axis=1)
        degenerate = (kept_counts == 1) | ((kept_counts > 1) & (pos_kept == 0))

        # per-instance init weights from destination bag labels
        w0 = np.empty((R, N), dtype=np.float32)
        for i, (ti, r) in enumerate(chunk):
            t = per_task[ti]
            dsts, mins = dest_min_labels(
                graph, r, t["is_member"], t["member_min_label"]
            )
            w0[i] = init_weights(rng, N, dsts, mins, cfg.init_noise)
        u0 = init_attribution(rng, F, R)

        grad_mask = np.ones((R, N), dtype=np.float32)
        frozen_mask = np.zeros((R, N), dtype=bool)
        active = np.ones(R, dtype=bool)
        rest = np.zeros(R, dtype=np.int64)
        current_loss = np.full(R, 100.0, dtype=np.float32)  # main.py:854
        member_pred_max = np.full((R, N), -np.inf, dtype=np.float32)
        member_recorded = np.zeros((R, N), dtype=bool)
        last_w = w0.copy()
        last_u = u0.copy()
        n_restarts = np.zeros(R, dtype=np.int64)

        for _round in range(cfg.max_restarts):
            if not active.any():
                break
            t_round = time.time()
            w, u, loss, per_bag, winner, member_value = dev.run(
                w0, u0, grad_mask, frozen_mask, epochs=cfg.epochs_bags,
                lr=cfg.lr, device=device,
            )
            log.info(
                "  bag restart round %d: %d/%d instances active, %.1fs",
                _round + 1, int(active.sum()), R, time.time() - t_round,
            )

            for i in range(R):
                if not active[i]:
                    continue
                ti = chunk[i][0]
                n_restarts[i] += 1
                last_w[i], last_u[i] = w[i], u[i]
                rec = has_edge[i] & per_task[ti]["is_member"]
                member_recorded[i] |= rec
                member_pred_max[i][rec] = np.maximum(
                    member_pred_max[i][rec], member_value[i][rec]
                )
                if loss[i] < current_loss[i]:
                    # freeze winning dsts of near-zero-loss bags (main.py:901)
                    low = (per_bag[i] < cfg.freeze_loss_threshold) & (
                        bag_keep[i] > 0.5
                    )
                    fset = np.unique(winner[i][low])
                    frozen_mask[i] = False
                    frozen_mask[i][fset] = True
                    current_loss[i] = loss[i]
                    rest[i] = 0
                else:
                    rest[i] += 1
                # monotone grad-mask accumulation (main.py:909-910)
                grad_mask[i][frozen_mask[i]] = 0.0
                # re-init: frozen keep trained values, rest U(0,1)
                # (main.py:911 with BAGS=False -> U(0,1) branch)
                w0[i] = reinitialize_scorer_weights(rng, w[i], frozen_mask[i])
                # fresh LinearLayerAttri each restart (get_model, main.py:886)
                u0[i] = init_attribution(rng, F)
                if rest[i] >= cfg.max_consecutive_misses:
                    active[i] = False

        for i, (ti, r) in enumerate(chunk):
            tid = tasks[ti][0]
            if r in results[tid]:       # chunk padding repeats instances
                continue
            results[tid][r] = BagScore(
                relation=r,
                loss=float(current_loss[i]),
                degenerate=bool(degenerate[i]),
                weights=last_w[i],
                attribution=last_u[i],
                member_pred_max=member_pred_max[i],
                member_recorded=member_recorded[i],
                num_restarts=int(n_restarts[i]),
            )
    return results
