"""MPGNN training: per-hop operands, the epoch loop and its entry point.

Counterpart of ``mpgnn_tpu/train/loops.py`` (the reference's metapath
evaluation harness, main.py:1117-1160): full-graph Adam(lr, weight_decay)
NLL training of an MPNetm for ``cfg.epochs`` epochs, returning the last
epoch's (or, with ``track_best``, the best-validation epoch's) macro-F1 on
each split. The JAX package runs the epochs as one ``lax.scan``; here they
are a Python loop of eager launches that keeps every metric on the device
until the end.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.device import free_memory_bytes, resolve_device
from mpgnn_tpu_torch.graph.hetero import HeteroGraph, NodeSplit
from mpgnn_tpu_torch.models.mpgnn import (
    ROW_TAIL_MIN_DROP,
    ROW_TAIL_SHARE,
    MPNetm,
    RgcnNet,
    init_mpgnn,
    precompute_first_hop,
)
from mpgnn_tpu_torch.ops.conv import build_dense_conv_operand
from mpgnn_tpu_torch.ops.csr import RowTermBlockings, build_csr_blocking
from mpgnn_tpu_torch.ops.onehot import build_spmm_blocking
from mpgnn_tpu_torch.ops.spmm import build_ell2_operand, dense_adjacency
from mpgnn_tpu_torch.parallel.halo import (
    EXCHANGES,
    LOCALS,
    HaloRows,
    build_halo_plan,
    shard_graph_features,
)
from mpgnn_tpu_torch.train.metrics import macro_f1
from mpgnn_tpu_torch.utils.prof import span

log = logging.getLogger("mpgnn_tpu_torch.train")

# the single-device backends; 'halo' (node-sharded over a mesh,
# parallel/halo.py) also takes ``mesh=``
BACKENDS = ("segment", "csr", "pallas", "ell", "ell2", "dense", "onehot")

# 'auto' (``resolve_backend``): the share of the card's free memory that the
# dense (A, A^T) pairs may take; the rest stays for activations, parameters,
# optimizer state and the batched evaluation (the JAX package's choice).
AUTO_DENSE_FREE_FRACTION = 0.4
# 'auto' on the card: the largest dense operand size, 2 * Ru * N^2 * 4
# bytes, at which 'dense' trains as fast as 'csr' and 'segment'.
# chip_smoke.py's ``auto_routing`` times whole train_mpgnn runs, set-up
# included, hidden 64, 150 epochs and 1000 extrapolated, the mean of two
# runs each, on an NVIDIA H100 80GB HBM3 at 700.00 W (two runs of the
# script): at 0.54 GB (N = 8,192), 0.80 GB (N = 5,000, four relations)
# and 2.1 GB (N = 16,384) all three are host-bound (3.0-4.4 ms an epoch)
# and dense was fastest or within 3% of the fastest; from 4.8 GB (N =
# 24,576 and 32,768) its float32 GEMMs take it to 6.5-6.8 ms an epoch
# against 2.6-4.5.
AUTO_DENSE_BUDGET_BYTES = 2 << 30
# 'auto' on the CPU: the JAX package's budget where the device reports no
# memory (its CPU), so that the CPU decides as the JAX package does there.
AUTO_DENSE_CPU_BUDGET_BYTES = 4 << 30
# 'auto' past the dense budget, for train_mpgnn and for the batched
# evaluation (``batch_eval.resolve_eval_backend``): 'csr' from this many
# edges in a relation, 'segment' below. Read from the traffic 'auto'
# serves by default, a search's final evaluation and greedy stage, where
# each relation's blockings are built once for every model:
# ``python -m mpgnn_tpu_torch.benchmarks.bench_routing`` (15 candidates
# over 4 uniform relations of 200,000 nodes, hidden 64, build included) on
# an NVIDIA H100 80GB HBM3 at 700.00 W. Totals csr / segment, 150 and 1000
# epochs: 10^5 edges a relation 5.5 / 6.3 s and 40.7 / 45.2 s; 10^6 7.5 /
# 11.7 s and 39.4 / 74.7 s; 10^7 21.9 / 63.9 s and 73.2 / 384.4 s (csr's
# build 13.4 s for the 4 relations). Below 10^5 no search was measured; one
# train_mpgnn run at 10^4 edges (chip_smoke.py ``auto_routing``) is
# host-bound either way, within 3%.
CSR_EDGE_CUTOVER = 100_000


def auto_dense_budget_bytes(device=None) -> int:
    """The bytes 'auto' lets the dense operands take on ``device`` (the GPU
    unless ``device='cpu'``): ``AUTO_DENSE_FREE_FRACTION`` of the card's
    free memory, at most ``AUTO_DENSE_BUDGET_BYTES``; on the CPU
    ``AUTO_DENSE_CPU_BUDGET_BYTES``."""
    device = resolve_device(device)
    if device.type != "cuda":
        return AUTO_DENSE_CPU_BUDGET_BYTES
    return int(min(free_memory_bytes(device) * AUTO_DENSE_FREE_FRACTION,
                   AUTO_DENSE_BUDGET_BYTES))


def resolve_backend(
    backend: str,
    graph: HeteroGraph,
    metapaths: Sequence[Sequence[int]],
    budget_bytes: Optional[int] = None,
) -> str:
    """The aggregation backend of ``backend`` for this workload: 'auto'
    resolves, the others pass through. 'auto' picks 'dense' where its
    (A, A^T) pairs, 2 * Ru * N^2 * 4 bytes for the Ru relations of the
    metapaths, fit ``budget_bytes`` (default ``auto_dense_budget_bytes()``,
    the GPU's); past it 'csr' where a relation has ``CSR_EDGE_CUTOVER``
    edges or more, else 'segment'. The JAX package's decision order."""
    if backend != "auto":
        return backend
    with span("train.resolve_backend"):
        if budget_bytes is None:
            budget_bytes = auto_dense_budget_bytes()
        uniq = {int(r) for mp in metapaths for r in mp}
        dense_bytes = 2 * len(uniq) * graph.num_nodes * graph.num_nodes * 4
        if dense_bytes <= budget_bytes:
            return "dense"
        max_e = max((int(graph.rel_counts[r]) for r in uniq), default=0)
        return "csr" if max_e >= CSR_EDGE_CUTOVER else "segment"


def _check_backend(backend: str, mesh=None) -> None:
    if backend == "halo":
        if mesh is None:
            raise ValueError("backend='halo' requires a mesh")
    elif backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


def build_hop_arrays(
    graph: HeteroGraph,
    metapaths: Sequence[Sequence[int]],
    backend: str = "segment",
    device=None,
    dtype: torch.dtype = torch.float32,
    mesh=None,
    mesh_axis: str = "nodes",
    halo_exchange: str = "a2a",
    halo_local: str = "auto",
) -> List[List[tuple]]:
    """Per-(metapath, hop) aggregation operands on ``device``, as tagged
    tuples for ``models.mpgnn.hop_aggregate``:

      * 'segment': (src, dst) sorted by src and the graph-static
        1/max(deg, 1), for the gather + ``index_add_`` mean;
      * 'csr': the (forward, backward) blockings of ``ops.csr``, whose
        kernels run the aggregation on the GPU;
      * 'ell': the relation's neighbour table and mask;
      * 'ell2': the out/in tables with weights of ``ops.spmm``;
      * 'dense': the float32 mean adjacency and its transpose;
      * 'onehot': the (forward, backward) blockings of ``ops.onehot``;
      * 'pallas': ('fused', operand), the bf16 mean adjacency and its
        transpose of ``ops.conv``, whose kernels run the whole conv;
      * 'halo': ('halo', mesh, mesh_axis, shard), this rank's part of the
        relation's halo plan over ``mesh``'s ``mesh_axis``
        (``parallel.halo``): ``halo_exchange`` 'a2a' or 'ppermute',
        ``halo_local`` 'segment', 'csr' (K1 on rectangular blockings) or
        'auto', which takes 'csr' where the relation has
        ``CSR_EDGE_CUTOVER`` edges or more, the JAX package's rule
        (``loops.py:248-254``: the global count, not the shard's).

    Every hop that aggregates a relation shares its operand
    (``relation_operand``). 'auto' is not a backend here:
    ``resolve_backend`` resolves it. ``dtype`` is the compute dtype of the
    model the operands serve: under bf16 'dense' keeps A and A^T in bf16,
    cast once (the JAX package casts A to h's dtype in every product)."""
    _check_backend(backend, mesh)
    with span("train.build_hop_arrays"):
        if backend == "halo":
            return [[halo_operand(graph, rel, mesh, mesh_axis, halo_exchange,
                                  halo_local, mesh.device if device is None
                                  else torch.device(device))
                     for rel in mp] for mp in metapaths]
        device = resolve_device(device)
        return [[relation_operand(graph, rel, backend, device, dtype)
                 for rel in mp] for mp in metapaths]


def halo_operand(graph: HeteroGraph, rel: int, mesh, axis: str,
                 exchange: str, local: str, device) -> tuple:
    """('halo', mesh, axis, shard) of one relation: the relation's halo
    plan over the axis (kept on the graph per (relation, ranks, exchange))
    and this rank's shard of it on ``device``. ``local`` 'auto' is 'csr'
    where the relation has ``CSR_EDGE_CUTOVER`` edges or more (all of
    them, as the JAX package counts), else 'segment'."""
    cache = getattr(graph, "_operand_cache", None)
    if cache is None:
        cache = graph._operand_cache = {}
    P, p = mesh.axis_size(axis), mesh.axis_rank(axis)
    key = ("halo_plan", int(rel), P, exchange)
    if key not in cache:
        s, d = graph.rel_edges(int(rel))
        cache[key] = build_halo_plan(s, d, graph.num_nodes, P, exchange)
    if local == "auto":
        local = ("csr" if int(graph.rel_counts[int(rel)]) >= CSR_EDGE_CUTOVER
                 else "segment")
    skey = key + (local, p, device_key(device))
    if skey not in cache:
        cache[skey] = cache[key].shard(p, device, local)
    return ("halo", mesh, axis, cache[skey])


def relation_operand(graph: HeteroGraph, rel: int, backend: str,
                     device: torch.device,
                     dtype: torch.dtype = torch.float32) -> tuple:
    """``relation_op`` of one relation, built once per graph, backend and
    device and kept on the graph, so that a search's evaluations and its
    greedy stage share it (the dense ones too, as the JAX package keeps
    them: N^2 each). A 'dense' operand for a bf16 model is kept apart, in
    bf16."""
    cache = getattr(graph, "_operand_cache", None)
    if cache is None:
        cache = graph._operand_cache = {}
    low = backend == "dense" and dtype != torch.float32
    key = (backend, int(rel), device_key(device)) + ((str(dtype),) if low
                                                     else ())
    if key not in cache:
        op = relation_op(graph, int(rel), backend, device)
        cache[key] = (op[0],) + tuple(a.to(dtype) for a in op[1:]) if low \
            else op
    return cache[key]


def operand_cached(graph: HeteroGraph, rel: int, backend: str,
                   device: torch.device) -> bool:
    """Whether ``relation_operand`` of these arguments is built already."""
    return (backend, int(rel), device_key(device)) in getattr(
        graph, "_operand_cache", {})


def device_key(device) -> str:
    """``device`` with its index, as the operand cache keys it: 'cuda' is
    the current card's 'cuda:N', so that a caller's 'cuda' and a tensor's
    'cuda:0' find the same operands."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def drop_operands(graph: HeteroGraph, backend: str) -> None:
    """Forget the ``backend`` operands kept on ``graph``, on every
    device."""
    cache = getattr(graph, "_operand_cache", {})
    for key in [k for k in cache if k[0] == backend]:
        del cache[key]


def relation_op(graph: HeteroGraph, rel: int, backend: str,
                device: torch.device, num_rows: Optional[int] = None,
                dedup: str = "auto") -> tuple:
    """One relation's aggregation operand on ``device``, the tagged tuple
    of ``build_hop_arrays`` for ``backend``, built anew.

    ``num_rows`` (at least ``graph.num_nodes``; 'segment' and 'csr' only)
    gives the operand that many rows, the extra ones with no edges: the
    fused clustered mode's common row count. ``dedup`` is
    ``build_csr_blocking``'s. The copies to ``device`` are timed as the
    span ``operand.upload``."""
    if num_rows is not None and backend not in ("segment", "csr"):
        raise ValueError(f"num_rows is for segment and csr, not {backend!r}")
    n = graph.num_nodes if num_rows is None else num_rows
    if backend == "segment":
        s, d = graph.rel_edges_csr(rel)
        deg = np.zeros(n, dtype=np.int64)
        deg[: graph.num_nodes] = graph.rel_degrees(rel)
        inv = (1.0 / np.maximum(deg, 1)).astype(np.float32)
        host = (s.astype(np.int64), d.astype(np.int64), inv)
        with span("operand.upload"):
            return ("segment",) + tuple(torch.from_numpy(a).to(device)
                                        for a in host)
    if backend == "ell":
        nbr, mask = graph.neighbor_table(rel)
        nbr = nbr.astype(np.int64)
        with span("operand.upload"):
            return ("ell", torch.from_numpy(nbr).to(device),
                    torch.from_numpy(mask).to(device))
    s, d = graph.rel_edges(rel)
    if backend == "csr":
        fwd, bwd = build_csr_blocking(s, d, n, dedup=dedup)
        with span("operand.upload"):
            return ("csr", fwd.to(device), bwd.to(device))
    if backend == "ell2":
        op = build_ell2_operand(s, d, graph.num_nodes)
        with span("operand.upload"):
            return ("ell2",) + tuple(op.to(device))
    if backend == "dense":
        return ("dense",) + dense_adjacency(s, d, graph.num_nodes, device)
    if backend == "onehot":
        fwd, bwd = build_spmm_blocking(s, d, graph.num_nodes)
        with span("operand.upload"):
            return ("onehot", fwd.to(device), bwd.to(device))
    return ("fused", build_dense_conv_operand(s, d, graph.num_nodes, device))


@dataclasses.dataclass
class MPGNNTrainResult:
    params: MPNetm
    val_f1: float
    test_f1: float
    train_f1: float
    final_loss: float


def make_optimizer(model: torch.nn.Module,
                   cfg: MPGNNConfig) -> torch.optim.Optimizer:
    """Adam(lr) with L2 weight decay added to the gradient before the
    moments (not AdamW): the JAX package's
    ``optax.chain(add_decayed_weights, adam)``. Timed as the span
    ``train.make_optimizer``."""
    with span("train.make_optimizer"):
        return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                                weight_decay=cfg.weight_decay)


def weighted_nll(logp: torch.Tensor, idx: Optional[torch.Tensor],
                 y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum(per * w) / sum(w)`` of the per-node NLL of ``logp[idx]``
    against ``y``, ``w`` the [len(idx)] per-node class weights; ``idx``
    None when logp's rows are already the loss's, in its order."""
    per = (-logp.gather(1, y[:, None])[:, 0] if idx is None
           else -logp[idx, y])
    return (per * w).sum() / w.sum()


def compute_dtype(cfg: MPGNNConfig) -> torch.dtype:
    """The torch dtype of ``cfg.compute_dtype`` ('float32' or
    'bfloat16')."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, not "
                         f"{cfg.compute_dtype!r}")
    return dtypes[cfg.compute_dtype]


def optimizer_step(opt: torch.optim.Optimizer,
                   loss_of: Callable[[], torch.Tensor],
                   after_backward: Optional[Callable[[], None]] = None
                   ) -> torch.Tensor:
    """One training step of any model, the skeleton every step shares:
    zero the gradients, ``loss_of()`` (the forward with its loss), the
    loss's backward (then ``after_backward()``), the optimizer's step.
    Returns the loss. Timed as the span ``train.step`` around
    ``train_step.forward``, ``train_step.backward`` (with
    ``after_backward``) and ``train_step.optimizer`` (``utils.prof``)."""
    with span("train.step"):
        opt.zero_grad(set_to_none=True)
        with span("train_step.forward"):
            loss = loss_of()
        with span("train_step.backward"):
            loss.backward()
            if after_backward is not None:
                after_backward()
        with span("train_step.optimizer"):
            opt.step()
    return loss


def train_step(model: MPNetm, opt: torch.optim.Optimizer, x: torch.Tensor,
               hop_ops, first, train_idx: torch.Tensor,
               train_y: torch.Tensor, w: torch.Tensor, cfg: MPGNNConfig,
               generator: Optional[torch.Generator], dt: torch.dtype,
               rows=None) -> torch.Tensor:
    """One epoch's step of an MPNetm (``optimizer_step``): the training
    forward, the weighted NLL, its backward and Adam. With ``rows``
    (``parallel.halo.HaloRows``) the model runs on this rank's rows of a
    node-sharded run: the NLL is its share and the gradients are summed
    across the ranks before the step. Returns the loss (this rank's share
    with ``rows``).

    Without ``rows``, where the loss reads at most ``ROW_TAIL_SHARE`` of
    the N rows and leaves at least ``ROW_TAIL_MIN_DROP`` of them out, the
    forward runs its tail on ``train_idx`` alone (``MPNetm.forward``'s
    ``rows``): the same loss, gradients and masks."""
    t, n = train_idx.numel(), x.shape[0]
    tail = (rows is None and t <= ROW_TAIL_SHARE * n
            and n - t >= ROW_TAIL_MIN_DROP)

    def loss_of():
        logp = model(x, hop_ops, dropout_rate=cfg.dropout,
                     generator=generator, train=True, first_hop_agg=first,
                     compute_dtype=dt,
                     shard_rows=None if rows is None else rows.shard_rows,
                     rows=train_idx if tail else None)
        if rows is not None:
            return rows.nll(logp, train_idx, train_y, w)
        return weighted_nll(logp, None if tail else train_idx, train_y, w)

    return optimizer_step(
        opt, loss_of, None if rows is None
        else lambda: rows.sync_grads(list(model.parameters())))


def rgcn_train_step(model: RgcnNet, opt: torch.optim.Optimizer,
                    x: torch.Tensor, blk: Optional[RowTermBlockings],
                    first: Optional[torch.Tensor],
                    metapath_length: int, train_idx: torch.Tensor,
                    train_y: torch.Tensor, w: torch.Tensor, *,
                    tail: Optional[RowTermBlockings] = None,
                    tail_first: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One epoch's step of the RGCN ``Net`` (``optimizer_step``): the
    forward over the relations' row-term blockings ``blk``
    (``rgcn_baseline.rgcn_operands``) from layer 0's aggregations
    ``first`` (``precompute_rgcn_rows``), the last layer on the train rows
    alone where their blockings ``tail`` are given
    (``rgcn_baseline.rgcn_tail_operands``; ``tail_first`` its layer 0's
    aggregations), else the head on them alone, the weighted NLL, its
    backward and Adam. Returns the loss."""
    return optimizer_step(opt, lambda: weighted_nll(
        model(x, blk, metapath_length, first=first, rows=train_idx,
              tail=tail, tail_first=tail_first),
        None, train_y, w))


def fit_mpgnn(
    model: MPNetm,
    hop_ops,
    x: torch.Tensor,
    split: Sequence[torch.Tensor],
    cw: torch.Tensor,
    cfg: MPGNNConfig,
    generator: Optional[torch.Generator],
    num_classes: int,
    track_best: bool = False,
    rows=None,
) -> Tuple[float, float, float, float]:
    """Train ``model`` in place for ``cfg.epochs`` epochs and return
    (train_f1, val_f1, test_f1, last epoch's loss).

    ``split`` is (train_idx, train_y, val_idx, val_y, test_idx, test_y) on
    x's device and ``cw`` the [C] class weights of the NLL
    ``sum(per * w) / sum(w)``. The hop-0 aggregation of x is computed once,
    before the epochs. With ``track_best`` the model is evaluated after
    every step and ends holding the parameters of the epoch with the best
    validation macro-F1 (the earliest on ties; the initial parameters if
    none beat 0.0), as the JAX package does. The forward runs in
    ``cfg.compute_dtype``; the parameters, their gradients and Adam's state
    stay float32. With ``rows`` (``parallel.halo.HaloRows``) x, the split
    and the hops are this rank's of a node-sharded run, and the loss and
    F1s returned are every rank's together."""
    train_idx, train_y, val_idx, val_y, test_idx, test_y = split
    dt = compute_dtype(cfg)
    x = x.to(dt)          # once, not in every epoch's forward
    opt = make_optimizer(model, cfg)
    first = precompute_first_hop(x, hop_ops, dt)
    params = list(model.parameters())
    pairs = ((train_idx, train_y), (val_idx, val_y), (test_idx, test_y))

    @torch.no_grad()
    def evaluate():
        preds = model(x, hop_ops, first_hop_agg=first,
                      compute_dtype=dt).argmax(dim=1)
        if rows is not None:
            return rows.macro_f1s(preds, pairs, num_classes)
        return [macro_f1(preds[i], y, num_classes) for i, y in pairs]

    if track_best:
        best_val = torch.zeros((), device=x.device)
        best = [p.detach().clone() for p in params]
    w = cw[train_y]
    loss = torch.zeros((), device=x.device)
    for _ in range(cfg.epochs):
        loss = train_step(model, opt, x, hop_ops, first, train_idx, train_y,
                          w, cfg, generator, dt, rows)
        if track_best:
            val = evaluate()[1]
            better = val > best_val
            best_val = torch.where(better, val, best_val)
            with torch.no_grad():
                for b, p in zip(best, params):
                    b.copy_(torch.where(better, p, b))
    if track_best:
        with torch.no_grad():
            for b, p in zip(best, params):
                p.copy_(b)
    train_f1, val_f1, test_f1 = evaluate()
    if rows is not None:
        loss = rows.total(loss)
    return (float(train_f1), float(val_f1), float(test_f1),
            float(loss.detach()))


def split_tensors(split: NodeSplit, device) -> List[torch.Tensor]:
    """(train_idx, train_y, val_idx, val_y, test_idx, test_y) of ``split``
    as int64 tensors on ``device``, the order ``fit_mpgnn`` takes."""
    return [torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
            for a in (split.train_idx, split.train_y, split.val_idx,
                      split.val_y, split.test_idx, split.test_y)]


def class_weights(train_y: np.ndarray, num_classes: int,
                  class_weighted: bool) -> np.ndarray:
    """Balanced weights n / (C * count) (the reference's RGCN baseline,
    main_rgcn.py:379), or ones, which reduce the NLL to the plain mean."""
    if not class_weighted:
        return np.ones(num_classes, dtype=np.float32)
    counts = np.maximum(np.bincount(np.asarray(train_y),
                                    minlength=num_classes), 1)
    return (len(train_y) / (num_classes * counts)).astype(np.float32)


def train_mpgnn(
    graph: HeteroGraph,
    metapaths: Sequence[Sequence[int]],
    split: NodeSplit,
    num_classes: int,
    cfg: Optional[MPGNNConfig] = None,
    seed: int = 0,
    track_best: bool = False,
    x_override: Optional[np.ndarray] = None,
    backend: Optional[str] = None,
    class_weighted: bool = False,
    device=None,
    mesh=None,
    mesh_axis: str = "nodes",
) -> MPGNNTrainResult:
    """Train an MPNetm on the metapath set, full-graph, on ``device`` (the
    GPU unless ``device='cpu'``).

    Mirrors the JAX package's ``train_mpgnn``: NLL on the train split (class
    weights applied only with ``class_weighted``), Adam with L2 weight
    decay, dropout after every hop, the forward in ``cfg.compute_dtype``,
    the convs decomposed by ``cfg.num_bases`` / ``cfg.num_blocks``. The
    parameters are drawn by ``init_mpgnn`` from ``seed``; the dropout
    generator is seeded from a draw of the same stream after them.
    ``backend`` (default ``cfg.backend``) is one of ``BACKENDS``, or
    'auto', which ``resolve_backend`` resolves for this workload and
    ``device``.

    ``backend='halo'`` with a ``mesh`` trains node-sharded, every rank of
    ``mesh``'s ``mesh_axis`` calling together (``parallel.halo``): each
    holds its block of the features and of every activation, exchanges its
    halo each hop (``cfg.halo_exchange``, ``cfg.halo_local``), takes its
    train rows' share of the loss and sums the gradients with the others
    before Adam, so that the parameters stay the same on every rank; each
    rank draws the dropout masks of all rows and keeps its own. ``device``
    defaults to the mesh's. The result's loss and F1s are the whole
    graph's, on every rank."""
    cfg = cfg or MPGNNConfig()
    metapaths = [list(mp) for mp in metapaths]
    backend = backend or cfg.backend
    if backend == "halo":
        _check_backend(backend, mesh)
        device = mesh.device if device is None else torch.device(device)
    else:
        device = resolve_device(device)
    if backend == "auto":
        backend = resolve_backend(backend, graph, metapaths,
                                  auto_dense_budget_bytes(device))
        log.info("train_mpgnn: backend 'auto' -> %r (%d nodes, relations "
                 "%s)", backend, graph.num_nodes,
                 sorted({r for mp in metapaths for r in mp}))
    _check_backend(backend, mesh)
    check_config(cfg)
    x_np = np.asarray(x_override if x_override is not None else graph.x,
                      dtype=np.float32)
    hop_ops = build_hop_arrays(
        graph, metapaths, backend=backend, device=device,
        dtype=compute_dtype(cfg), mesh=mesh, mesh_axis=mesh_axis,
        halo_exchange=cfg.halo_exchange, halo_local=cfg.halo_local)
    cw_np = class_weights(split.train_y, num_classes, class_weighted)
    rows = None
    if backend == "halo":
        x = shard_graph_features(x_np, mesh, mesh_axis, device)
        rows = HaloRows(mesh, mesh_axis, x.shape[0], split, cw_np, device)
        parts = rows.split
    else:
        x = torch.as_tensor(x_np, device=device)
        parts = split_tensors(split, device)
    model, drop_seed = seeded_init(x.shape[1], cfg.hidden_dim, num_classes,
                                   metapaths, seed, device, cfg.num_bases,
                                   cfg.num_blocks)
    generator = torch.Generator(device=device).manual_seed(drop_seed)
    train_f1, val_f1, test_f1, loss = fit_mpgnn(
        model, hop_ops, x, parts, torch.as_tensor(cw_np, device=device), cfg,
        generator, num_classes, track_best=track_best, rows=rows)
    return MPGNNTrainResult(params=model, val_f1=val_f1, test_f1=test_f1,
                            train_f1=train_f1, final_loss=loss)


def check_config(cfg: MPGNNConfig) -> None:
    """Refuse a compute dtype that is not float32 or bfloat16, and halo
    settings the port does not know."""
    compute_dtype(cfg)
    if cfg.halo_exchange not in EXCHANGES:
        raise ValueError(f"halo_exchange must be one of {EXCHANGES}, not "
                         f"{cfg.halo_exchange!r}")
    if cfg.halo_local not in LOCALS + ("auto",):
        raise ValueError(f"halo_local must be one of {LOCALS + ('auto',)}, "
                         f"not {cfg.halo_local!r}")


def seeded_init(input_dim: int, hidden_dim: int, num_classes: int,
                metapaths: Sequence[Sequence[int]], seed: int,
                device, num_bases: Optional[int] = None,
                num_blocks: Optional[int] = None) -> Tuple[MPNetm, int]:
    """(initial MPNetm, dropout seed) of a run seeded with ``seed``: the
    parameters drawn by ``init_mpgnn`` from a CPU generator seeded with
    ``seed`` (a decomposed conv draws in the JAX package's key order:
    bases, comp, root; blocks, root), the dropout seed one further draw of
    the same stream. The draws depend on the metapaths' lengths, not on
    their relations."""
    init_gen = torch.Generator().manual_seed(seed)
    model = init_mpgnn(input_dim, hidden_dim, num_classes, metapaths,
                       generator=init_gen, device=device,
                       num_bases=num_bases, num_blocks=num_blocks)
    return model, int(torch.randint(2 ** 62, (1,), generator=init_gen))


@torch.no_grad()
def evaluate_mpgnn(
    graph: HeteroGraph,
    metapaths: Sequence[Sequence[int]],
    model: MPNetm,
    idx: np.ndarray,
    y: np.ndarray,
    num_classes: int,
    x_override: Optional[np.ndarray] = None,
    device=None,
    cfg: Optional[MPGNNConfig] = None,
) -> Tuple[float, np.ndarray]:
    """(macro-F1 on ``idx`` against ``y``, [N] predictions) of ``model``
    (moved to ``device``; any conv variant), with the segment backend, as
    the JAX package, in ``cfg.compute_dtype`` (default float32, as the JAX
    package's evaluation)."""
    device = resolve_device(device)
    model = model.to(device)
    x = torch.as_tensor(np.asarray(
        x_override if x_override is not None else graph.x, dtype=np.float32),
        device=device)
    hop_ops = build_hop_arrays(graph, [list(m) for m in metapaths],
                               device=device)
    preds = model(x, hop_ops,
                  compute_dtype=compute_dtype(cfg or MPGNNConfig())
                  ).argmax(dim=1)
    f1 = macro_f1(preds[torch.as_tensor(np.asarray(idx, dtype=np.int64),
                                        device=device)],
                  torch.as_tensor(np.asarray(y, dtype=np.int64),
                                  device=device), num_classes)
    return float(f1), preds.cpu().numpy()
