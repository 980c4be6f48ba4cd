"""Out-of-core MPGNN training over a ``PartitionedHeteroGraph``.

Cluster-GCN-style subgraph SGD (the reference replicates the whole graph
per MPI rank and cannot exceed host memory): the node blocks are grouped
once, and each step trains a normal full-graph MPGNN step on one group's
induced subgraph, the loss masked to the group's own training nodes. Only
the groups' feature rows are read from ``x``, which may be an
``np.memmap``; evaluation goes group by group too, each node predicted in
the one group where it is core.

Each group's operands (features, per-hop aggregation operands, loss mask and
labels) are built on the host once. Then, as the JAX package's
``train/stream.py``:

* ``resident=True`` puts every group on the device once;
* ``resident=False`` (streaming) keeps them in pinned host memory and
  copies each group to the card on a side CUDA stream one visit ahead, so
  the copy rides under the previous step; a group's device buffers are
  released after its visit, so about two groups are on the card at a time;
* ``fused=True`` puts every group on the card at one common row count
  ``n_max`` (csr blockings built at ``n_max`` rows with dedup off, so K1
  alone runs), visits the groups in an order drawn for all epochs up front,
  and draws dropout masks at ``[n_max, H]``. The JAX package runs those
  visits as one scanned device program in epoch blocks, because its TPU
  link charged for each dispatch; here they are an eager loop.

``backend='csr'`` runs K1 (and K2 on a relation whose ``dedup_ratio``
routes it there) in every hop of every visit, forward and backward.
Cut edges between groups are dropped unless the halo covers them: the
default halo is the longest metapath, so core nodes see their whole
receptive field.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.graph.hetero import NodeSplit
from mpgnn_tpu_torch.graph.partition import PartitionedHeteroGraph, Subgraph
from mpgnn_tpu_torch.models.mpgnn import MPNetm
from mpgnn_tpu_torch.train.loops import (
    MPGNNTrainResult,
    _check_backend,
    auto_dense_budget_bytes,
    check_config,
    compute_dtype,
    make_optimizer,
    relation_op,
    seeded_init,
)
from mpgnn_tpu_torch.train.metrics import macro_f1_np

# resident=None puts every group on the card when all groups' host bytes
# stay under this share of ``auto_dense_budget_bytes`` (the JAX package's
# share of its own budget)
RESIDENT_BUDGET_FRACTION = 0.5


def _group_blocks(num_parts: int, blocks_per_step: int,
                  rng: np.random.Generator) -> List[List[int]]:
    """Groups of ``blocks_per_step`` blocks, drawn as the JAX package
    draws them: one permutation, cut in order, each group sorted."""
    order = rng.permutation(num_parts)
    q = max(1, blocks_per_step)
    return [sorted(order[i: i + q].tolist()) for i in range(0, num_parts, q)]


def _map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``obj`` with ``fn`` applied to every tensor in it: tensors, tuples
    (named too), lists and dataclasses (the blockings and operands). A 2-D
    tensor whose rows are padded (the dense conv operand's, for TMA) keeps
    its row stride: ``fn`` takes the padded rows and the view is cut
    again."""
    if isinstance(obj, torch.Tensor):
        if (obj.dim() == 2 and obj.shape[0] and obj.stride(1) == 1
                and obj.stride(0) > obj.shape[1]):
            full = obj.as_strided((obj.shape[0], obj.stride(0)),
                                  (obj.stride(0), 1))
            return fn(full)[:, : obj.shape[1]]
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(v, fn) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _tensors(obj) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_tensors(obj, lambda t: out.append(t) or t)
    return out


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


@dataclasses.dataclass
class _Group:
    """One group's operands: features, per-(metapath, hop) aggregation
    operands, the loss mask (train nodes that are core) and the labels."""

    x: torch.Tensor
    hop_ops: list
    tmask: torch.Tensor
    y: torch.Tensor


class _Feeder:
    """Where each group's operands live between visits. Resident: on the
    device from the start. Streaming: in pinned host memory, copied on a
    side stream by ``fetch`` (one visit ahead), waited for by ``take`` and
    dropped by ``release``."""

    def __init__(self, host: List[_Group], device: torch.device,
                 resident: bool):
        """``host`` is taken over: streaming to a card pins its groups in
        place, one at a time, so the pageable copies go as they are
        pinned."""
        self.device = device
        self.resident = resident
        self.side = None
        if resident:
            self.groups = [_map_tensors(g, lambda t: t.to(device))
                           for g in host]
            return
        if device.type == "cuda":
            # a non_blocking copy from pageable memory would be synchronous
            for i in range(len(host)):
                host[i] = _map_tensors(host[i], lambda t: t.pin_memory())
            self.side = torch.cuda.Stream(device)
        self.host = host
        self.inflight: Dict[int, tuple] = {}

    def fetch(self, gi: int) -> None:
        if self.resident or gi in self.inflight:
            return
        if self.side is None:
            self.inflight[gi] = (_map_tensors(
                self.host[gi], lambda t: t.to(self.device)), None)
            return
        with torch.cuda.stream(self.side):
            dev = _map_tensors(self.host[gi], lambda t: t.to(
                self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.side)
        self.inflight[gi] = (dev, event)

    def take(self, gi: int) -> _Group:
        if self.resident:
            return self.groups[gi]
        self.fetch(gi)
        dev, event = self.inflight[gi]
        if event is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(event)
            # the buffers were allocated on the side stream: tell the
            # allocator the main stream uses them, so that a release does
            # not hand them to the next copy before the step's work is done
            for t in _tensors(dev):
                t.record_stream(main)
            self.inflight[gi] = (dev, None)
        return dev

    def release(self, gi: int) -> None:
        if not self.resident:
            self.inflight.pop(gi, None)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _group_loss(model: MPNetm, g: _Group, cfg: MPGNNConfig,
                generator: Optional[torch.Generator],
                dt: torch.dtype) -> torch.Tensor:
    """Plain mean NLL over the group's train core nodes (the JAX package's
    ``sum(per * w) / max(sum(w), 1)``)."""
    logp = model(g.x, g.hop_ops, dropout_rate=cfg.dropout,
                 generator=generator, train=True, compute_dtype=dt)
    per = -logp.gather(1, g.y[:, None])[:, 0]
    w = g.tmask.to(per.dtype)
    return (per * w).sum() / w.sum().clamp_min(1.0)


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    out = t.new_zeros((n,) + tuple(t.shape[1:]))
    out[: t.shape[0]] = t
    return out


def host_hop_ops(sub: Subgraph, metapaths, backend: str,
                 dt: torch.dtype = torch.float32,
                 fused_rows: Optional[int] = None) -> list:
    """Per-(metapath, hop) operands of one group as a clustered run builds
    them, on the host (CPU tensors), one a relation; not kept on the
    subgraph, so that a streamed group's pinned copy is its only copy.
    ``fused_rows``, fused mode's common row count, builds them at that many
    rows with dedup off (K1 alone)."""
    built: Dict[int, tuple] = {}
    for rel in sorted(set(int(r) for mp in metapaths for r in mp)):
        op = relation_op(sub.graph, rel, backend, torch.device("cpu"),
                         num_rows=fused_rows,
                         dedup="auto" if fused_rows is None else "never")
        if backend == "dense" and dt != torch.float32:
            op = (op[0],) + tuple(a.to(dt) for a in op[1:])
        built[rel] = op
    return [[built[int(r)] for r in mp] for mp in metapaths]


def fit_mpgnn_clustered(
    model: MPNetm,
    pgraph: PartitionedHeteroGraph,
    metapaths: Sequence[Sequence[int]],
    split: NodeSplit,
    num_classes: int,
    cfg: MPGNNConfig,
    generator: Optional[torch.Generator],
    blocks_per_step: int = 2,
    seed: int = 0,
    backend: str = "segment",
    halo_hops: Optional[int] = None,
    resident: Optional[bool] = None,
    halo_relations: Optional[Sequence[int]] = None,
    report: Optional[dict] = None,
    fused: bool = False,
) -> MPGNNTrainResult:
    """Train ``model`` (on its device) in place with subgraph SGD and
    evaluate it group-wise; the arguments are ``train_mpgnn_clustered``'s.

    ``seed`` seeds the numpy stream that draws the groups and each epoch's
    order (the JAX package's draws, so both visit the same subgraphs in the
    same order); dropout masks come from ``generator``, advanced by every
    step."""
    _check_backend(backend)
    check_config(cfg)
    if fused and backend not in ("segment", "csr"):
        raise ValueError("fused=True requires backend segment or csr")
    device = next(model.parameters()).device
    dt = compute_dtype(cfg)
    metapaths = [list(mp) for mp in metapaths]
    if halo_hops is None:
        halo_hops = max((len(mp) for mp in metapaths), default=0)
    if halo_relations is None:
        halo_relations = sorted(set(r for mp in metapaths for r in mp))
    rng = np.random.default_rng(seed)

    y_full = np.zeros(pgraph.num_nodes, dtype=np.int64)
    in_train = np.zeros(pgraph.num_nodes, dtype=bool)
    y_full[np.asarray(split.train_idx)] = np.asarray(split.train_y)
    in_train[np.asarray(split.train_idx)] = True
    y_full[np.asarray(split.val_idx)] = np.asarray(split.val_y)
    y_full[np.asarray(split.test_idx)] = np.asarray(split.test_y)

    def host_group(sub: Subgraph) -> _Group:
        # fused csr builds its blockings at the common row count later;
        # per-group layouts here would double the host build for nothing
        hop_ops = [] if fused else host_hop_ops(sub, metapaths, backend, dt)
        return _Group(
            x=torch.from_numpy(np.asarray(sub.graph.x, dtype=np.float32)),
            hop_ops=hop_ops,
            tmask=torch.from_numpy(in_train[sub.nodes] & sub.core_mask),
            y=torch.from_numpy(y_full[sub.nodes]),
        )

    t_prep = time.perf_counter()
    groups = _group_blocks(pgraph.num_parts, blocks_per_step, rng)
    prepared = []
    for g in groups:
        sub = pgraph.subgraph(g, halo_hops=halo_hops,
                              halo_relations=halo_relations)
        prepared.append((sub, host_group(sub)))
    mp_rels = sorted(set(r for mp in metapaths for r in mp))
    if report is not None:
        report["groups"] = [
            {
                "blocks": list(map(int, g)),
                "real_nodes": int(sub.num_real_nodes),
                "real_edges": int(sub.num_real_edges),
                "pad_nodes": int(len(sub.nodes)),
                "mp_edges": int(sum(int(sub.graph.rel_counts[r])
                                    for r in mp_rels)),
                "host_bytes": _nbytes(arrs),
            }
            for g, (sub, arrs) in zip(groups, prepared)
        ]
        report["prep_s"] = time.perf_counter() - t_prep
        report["halo_hops"] = int(halo_hops)
        report["halo_relations"] = list(map(int, halo_relations))

    subs = [sub for sub, _ in prepared]
    host = [arrs for _, arrs in prepared]
    del prepared
    if fused:
        # every group at the largest group's row count, zero-padded
        t0 = time.perf_counter()
        n_max = max(sub.num_real_nodes for sub in subs)
        host = [_Group(x=_pad_rows(g.x, n_max),
                       hop_ops=host_hop_ops(sub, metapaths, backend, dt,
                                            fused_rows=n_max),
                       tmask=_pad_rows(g.tmask, n_max),
                       y=_pad_rows(g.y, n_max))
                for sub, g in zip(subs, host)]
        if report is not None:
            report["stack_build_s"] = time.perf_counter() - t0
            report["stacked_bytes"] = sum(_nbytes(g) for g in host)
            report["fused_rows"] = int(n_max)
        resident = True
    elif resident is None:
        resident = (sum(_nbytes(g) for g in host)
                    < RESIDENT_BUDGET_FRACTION * auto_dense_budget_bytes(device))

    opt = make_optimizer(model, cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_up = time.perf_counter()
    feeder = _Feeder(host, device, resident)
    if report is not None and fused:
        _sync(device)
        report["upload_s"] = time.perf_counter() - t_up
    # fused: every epoch's order drawn up front, as the JAX package's scan
    # takes it; streaming draws each epoch's at its start (the same draws)
    perms = ([rng.permutation(len(host)) for _ in range(cfg.epochs)]
             if fused else None)
    loss = torch.zeros((), device=device)
    steps = 0
    epoch_s = []
    t_train = time.perf_counter()
    for epoch in range(cfg.epochs):
        t_epoch = time.perf_counter()
        order = perms[epoch] if fused else rng.permutation(len(host))
        for oi, gi in enumerate(order):
            g = feeder.take(int(gi))
            if oi + 1 < len(order):
                feeder.fetch(int(order[oi + 1]))   # the next group's copy
            opt.zero_grad(set_to_none=True)
            loss = _group_loss(model, g, cfg, generator, dt)
            loss.backward()
            opt.step()
            feeder.release(int(gi))
            steps += 1
        if report is not None:
            _sync(device)
            epoch_s.append(time.perf_counter() - t_epoch)
    last_loss = float(loss.detach())
    if report is not None:
        report["train_s"] = time.perf_counter() - t_train
        report["epoch_s"] = epoch_s
        report["epochs"] = int(cfg.epochs)
        report["steps"] = steps
        report["resident"] = bool(resident)
        report["fused"] = bool(fused)
        report["mp_edges_per_epoch"] = int(
            sum(g["mp_edges"] for g in report["groups"]))
        if device.type == "cuda":
            report["device_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(device))

    # group-wise evaluation: each node is core in exactly one group
    t_eval = time.perf_counter()
    preds = np.zeros(pgraph.num_nodes, dtype=np.int64)
    with torch.no_grad():
        for gi, sub in enumerate(subs):
            g = feeder.take(gi)
            if gi + 1 < len(subs):
                feeder.fetch(gi + 1)
            p = model(g.x, g.hop_ops, compute_dtype=dt).argmax(dim=1)
            feeder.release(gi)
            # fused rows are at the common n_max: slice to the group first
            p = p[: sub.num_real_nodes].cpu().numpy()
            preds[sub.nodes[sub.core_mask]] = p[sub.core_mask]
    if report is not None:
        report["eval_s"] = time.perf_counter() - t_eval

    def f1(idx, y):
        idx = np.asarray(idx)
        return float(macro_f1_np(preds[idx], np.asarray(y), num_classes))

    return MPGNNTrainResult(
        params=model,
        val_f1=f1(split.val_idx, split.val_y),
        test_f1=f1(split.test_idx, split.test_y),
        train_f1=f1(split.train_idx, split.train_y),
        final_loss=last_loss,
    )


def train_mpgnn_clustered(
    pgraph: PartitionedHeteroGraph,
    metapaths: Sequence[Sequence[int]],
    split: NodeSplit,
    num_classes: int,
    cfg: Optional[MPGNNConfig] = None,
    blocks_per_step: int = 2,
    seed: int = 0,
    backend: str = "segment",
    halo_hops: Optional[int] = None,
    resident: Optional[bool] = None,
    halo_relations: Optional[Sequence[int]] = None,
    report: Optional[dict] = None,
    fused: bool = False,
    device=None,
) -> MPGNNTrainResult:
    """Train an MPNetm with subgraph SGD on ``device`` (the GPU unless
    ``device='cpu'``) and evaluate it group-wise.

    As ``train_mpgnn``: Adam(lr) with L2 weight decay, dropout after every
    hop, ``cfg.compute_dtype``, the decomposed convs of ``cfg``, parameters
    drawn by ``seeded_init`` from ``seed`` and dropout masks from a
    generator seeded after them. ``cfg.epochs`` epochs each visit every
    group of ``blocks_per_step`` blocks once, in a random order; the loss
    is the plain mean NLL over a group's train core nodes.

    ``halo_hops`` defaults to the longest metapath (complete receptive
    fields: exact gradients and predictions), ``halo_relations`` to the
    metapaths' relations. ``resident`` / ``fused``: see the module
    docstring; ``resident=None`` puts the groups on the card when their host
    bytes are under ``RESIDENT_BUDGET_FRACTION`` of
    ``auto_dense_budget_bytes``. ``report``, a dict, receives per-group
    sizes (``groups``), the phase walls (``prep_s``, ``train_s``,
    ``epoch_s``, ``eval_s``; fused: ``stack_build_s``, ``upload_s``),
    ``steps``, ``mp_edges_per_epoch``, fused mode's row count
    (``fused_rows``) and, on the card,
    ``device_peak_bytes`` (``torch.cuda.max_memory_allocated`` since the
    operands' upload began)."""
    cfg = cfg or MPGNNConfig()
    device = resolve_device(device)
    model, drop_seed = seeded_init(pgraph.feat_dim, cfg.hidden_dim,
                                   num_classes, metapaths, seed, device,
                                   cfg.num_bases, cfg.num_blocks)
    generator = torch.Generator(device=device).manual_seed(drop_seed)
    return fit_mpgnn_clustered(
        model, pgraph, metapaths, split, num_classes, cfg, generator,
        blocks_per_step=blocks_per_step, seed=seed, backend=backend,
        halo_hops=halo_hops, resident=resident,
        halo_relations=halo_relations, report=report, fused=fused)
