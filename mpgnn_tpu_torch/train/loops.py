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
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.graph.hetero import HeteroGraph, NodeSplit
from mpgnn_tpu_torch.models.mpgnn import (
    MPNetm,
    init_mpgnn,
    precompute_first_hop,
)
from mpgnn_tpu_torch.ops.conv import build_dense_conv_operand
from mpgnn_tpu_torch.ops.csr import build_csr_blocking
from mpgnn_tpu_torch.train.metrics import macro_f1

BACKENDS = ("segment", "csr", "pallas")
# backends of the JAX package that the port does not have yet, with the
# ROADMAP.md queue item that brings them
NOT_PORTED = {
    "auto": "A3 (it chooses 'dense')",
    "dense": "A3",
    "ell": "A3",
    "ell2": "A3",
    "onehot": "A3",
    "halo": "A12",
}


def _check_backend(backend: str) -> None:
    if backend in NOT_PORTED:
        raise ValueError(f"backend {backend!r} is not ported yet "
                         f"(ROADMAP.md {NOT_PORTED[backend]})")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


def build_hop_arrays(
    graph: HeteroGraph,
    metapaths: Sequence[Sequence[int]],
    backend: str = "segment",
    device=None,
) -> List[List[tuple]]:
    """Per-(metapath, hop) aggregation operands on ``device``, as tagged
    tuples for ``models.mpgnn.hop_aggregate``:

      * 'segment': (src, dst) sorted by src and the graph-static
        1/max(deg, 1), for the gather + ``index_add_`` mean;
      * 'csr': the (forward, backward) blockings of ``ops.csr``, whose
        kernels run the aggregation on the GPU;
      * 'pallas': ('fused', operand), the bf16 mean adjacency and its
        transpose of ``ops.conv``, whose kernels run the whole conv.

    Every hop that aggregates a relation shares its operand
    (``relation_operand``)."""
    _check_backend(backend)
    device = resolve_device(device)
    ops = {}
    hop_ops: List[List[tuple]] = []
    for mp in metapaths:
        for rel in mp:
            if int(rel) not in ops:
                ops[int(rel)] = relation_operand(graph, rel, backend, device)
        hop_ops.append([ops[int(rel)] for rel in mp])
    return hop_ops


def relation_operand(graph: HeteroGraph, rel: int, backend: str,
                     device: torch.device) -> tuple:
    """``relation_op`` of one relation. A 'segment' or 'csr' operand is
    built once per graph, backend and device and kept on the graph, so that
    a search's evaluations and its greedy stage share it; a dense
    ('pallas') operand, N^2 bf16 twice, is built anew."""
    if backend == "pallas":
        return relation_op(graph, int(rel), backend, device)
    cache = getattr(graph, "_operand_cache", None)
    if cache is None:
        cache = graph._operand_cache = {}
    key = (backend, int(rel), str(device))
    if key not in cache:
        cache[key] = relation_op(graph, int(rel), backend, device)
    return cache[key]


def relation_op(graph: HeteroGraph, rel: int, backend: str,
                device: torch.device) -> tuple:
    """One relation's aggregation operand on ``device``, the tagged tuple
    of ``build_hop_arrays`` for ``backend``, built anew."""
    if backend == "segment":
        s, d = graph.rel_edges_csr(rel)
        deg = graph.rel_degrees(rel)
        inv = (1.0 / np.maximum(deg, 1)).astype(np.float32)
        return ("segment",
                torch.from_numpy(s.astype(np.int64)).to(device),
                torch.from_numpy(d.astype(np.int64)).to(device),
                torch.from_numpy(inv).to(device))
    s, d = graph.rel_edges(rel)
    if backend == "csr":
        fwd, bwd = build_csr_blocking(s, d, graph.num_nodes)
        return ("csr", fwd.to(device), bwd.to(device))
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
    ``optax.chain(add_decayed_weights, adam)``."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            weight_decay=cfg.weight_decay)


def weighted_nll(logp: torch.Tensor, idx: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """``sum(per * w) / sum(w)`` of the per-node NLL of ``logp[idx]``
    against ``y``, ``w`` the [len(idx)] per-node class weights."""
    per = -logp[idx].gather(1, y[:, None])[:, 0]
    return (per * w).sum() / w.sum()


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
) -> Tuple[float, float, float, float]:
    """Train ``model`` in place for ``cfg.epochs`` epochs and return
    (train_f1, val_f1, test_f1, last epoch's loss).

    ``split`` is (train_idx, train_y, val_idx, val_y, test_idx, test_y) on
    x's device and ``cw`` the [C] class weights of the NLL
    ``sum(per * w) / sum(w)``. The hop-0 aggregation of x is computed once,
    before the epochs. With ``track_best`` the model is evaluated after
    every step and ends holding the parameters of the epoch with the best
    validation macro-F1 (the earliest on ties; the initial parameters if
    none beat 0.0), as the JAX package does."""
    train_idx, train_y, val_idx, val_y, test_idx, test_y = split
    opt = make_optimizer(model, cfg)
    first = precompute_first_hop(x, hop_ops)
    params = list(model.parameters())

    @torch.no_grad()
    def evaluate():
        preds = model(x, hop_ops, first_hop_agg=first).argmax(dim=1)
        return (macro_f1(preds[train_idx], train_y, num_classes),
                macro_f1(preds[val_idx], val_y, num_classes),
                macro_f1(preds[test_idx], test_y, num_classes))

    if track_best:
        best_val = torch.zeros((), device=x.device)
        best = [p.detach().clone() for p in params]
    w = cw[train_y]
    loss = torch.zeros((), device=x.device)
    for _ in range(cfg.epochs):
        opt.zero_grad(set_to_none=True)
        logp = model(x, hop_ops, dropout_rate=cfg.dropout,
                     generator=generator, train=True, first_hop_agg=first)
        loss = weighted_nll(logp, train_idx, train_y, w)
        loss.backward()
        opt.step()
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
) -> MPGNNTrainResult:
    """Train an MPNetm on the metapath set, full-graph, on ``device`` (the
    GPU unless ``device='cpu'``).

    Mirrors the JAX package's ``train_mpgnn``: NLL on the train split (class
    weights applied only with ``class_weighted``), Adam with L2 weight
    decay, dropout after every hop. The parameters are drawn by
    ``init_mpgnn`` from ``seed``; the dropout generator is seeded from a
    draw of the same stream after them. ``backend`` (default
    ``cfg.backend``) is 'segment', 'csr' or 'pallas'."""
    cfg = cfg or MPGNNConfig()
    backend = backend or cfg.backend
    _check_backend(backend)
    check_config(cfg)
    device = resolve_device(device)
    metapaths = [list(mp) for mp in metapaths]
    x = torch.as_tensor(np.asarray(
        x_override if x_override is not None else graph.x, dtype=np.float32),
        device=device)
    hop_ops = build_hop_arrays(graph, metapaths, backend=backend,
                               device=device)
    model, drop_seed = seeded_init(x.shape[1], cfg.hidden_dim, num_classes,
                                   metapaths, seed, device)
    generator = torch.Generator(device=device).manual_seed(drop_seed)
    cw = torch.as_tensor(class_weights(split.train_y, num_classes,
                                       class_weighted), device=device)
    train_f1, val_f1, test_f1, loss = fit_mpgnn(
        model, hop_ops, x, split_tensors(split, device), cw, cfg, generator,
        num_classes, track_best=track_best)
    return MPGNNTrainResult(params=model, val_f1=val_f1, test_f1=test_f1,
                            train_f1=train_f1, final_loss=loss)


def check_config(cfg: MPGNNConfig) -> None:
    """Refuse the settings of ``MPGNNConfig`` that the port does not have
    yet, naming their ROADMAP.md item."""
    if cfg.compute_dtype != "float32":
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is not ported "
                         f"yet (ROADMAP.md A1): the port trains in float32")
    if cfg.num_bases is not None or cfg.num_blocks is not None:
        raise ValueError("num_bases / num_blocks are not ported yet "
                         "(ROADMAP.md A4)")
    default = MPGNNConfig()
    if (cfg.halo_exchange, cfg.halo_local) != (default.halo_exchange,
                                               default.halo_local):
        raise ValueError("halo_exchange / halo_local are not ported yet "
                         "(ROADMAP.md A12)")


def seeded_init(input_dim: int, hidden_dim: int, num_classes: int,
                metapaths: Sequence[Sequence[int]], seed: int,
                device) -> Tuple[MPNetm, int]:
    """(initial MPNetm, dropout seed) of a run seeded with ``seed``: the
    parameters drawn by ``init_mpgnn`` from a CPU generator seeded with
    ``seed``, the dropout seed one further draw of the same stream. The
    draws depend on the metapaths' lengths, not on their relations."""
    init_gen = torch.Generator().manual_seed(seed)
    model = init_mpgnn(input_dim, hidden_dim, num_classes, metapaths,
                       generator=init_gen, device=device)
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
) -> Tuple[float, np.ndarray]:
    """(macro-F1 on ``idx`` against ``y``, [N] predictions) of ``model``
    (moved to ``device``), with the segment backend, as the JAX package."""
    device = resolve_device(device)
    model = model.to(device)
    x = torch.as_tensor(np.asarray(
        x_override if x_override is not None else graph.x, dtype=np.float32),
        device=device)
    hop_ops = build_hop_arrays(graph, [list(m) for m in metapaths],
                               device=device)
    preds = model(x, hop_ops).argmax(dim=1)
    f1 = macro_f1(preds[torch.as_tensor(np.asarray(idx, dtype=np.int64),
                                        device=device)],
                  torch.as_tensor(np.asarray(y, dtype=np.int64),
                                  device=device), num_classes)
    return float(f1), preds.cpu().numpy()
