"""Batched final evaluation of the search: candidates of one length train
together.

Counterpart of ``mpgnn_tpu/train/batch_eval.py`` (``evaluate_candidates``,
``resolve_eval_backend``). The reference trains one MPNetm per candidate
metapath (main.py:1444-1459); the JAX package vmaps the candidates of one
length into one program. Here a length group's C candidates are one
``MPNetmStack``: parameters [C, ...], features [C * N, H] candidate-major,
one ``torch.optim.Adam`` over the stacked parameters (elementwise, so each
candidate takes its own run's step) and the sum of the candidates' losses
(so each gets its own gradient). Each hop's aggregation is one launch for
the group:

* ``'segment'``: the candidates' edge lists concatenated with ``c * N``
  offsets (``ops.segment.stack_edge_lists``), one gather and one
  ``index_add_``;
* ``'csr'``: the candidates' K1 blockings stacked block-diagonally
  (``ops.csr.stack_blockings``), K1 forward and backward over all of them;
  a candidate whose relation routes either direction to K2 runs its own
  ``csr_mean_aggregate`` on its [N, H] slice;
* ``'dense'``: one grouped product a unique relation of the hop, the
  features of the G candidates that take it side by side, [N, G * H],
  times its bf16 adjacency through K4 (``ops.conv.grouped_dense_aggregate``,
  forward over A, backward over A^T), as the JAX package's
  ``_grouped_dense_agg``; hop 0 aggregates bf16(x) the same way.

``'auto'`` routes each length group as ``resolve_eval_backend`` says
('csr' where a relation of the group has ``loops.CSR_EDGE_CUTOVER`` edges,
else 'segment'); a set whose groups route both ways is evaluated as two
calls whose results are merged, as the JAX package does.

Hop 0 aggregates the input features once per run. Each relation's operand
is built once per graph and kept on it (``train.loops.relation_operand``),
so the blockings are not rebuilt for every candidate.

Seeds: the port's ``train_mpgnn`` seeds every candidate from the same
``seed`` and ``init_mpgnn``'s draws depend on the metapath's length alone,
so every candidate of a length group starts from the same parameters and
draws the same dropout masks, one [N, H] mask a hop in hop order. The group
draws each mask once and applies it to every candidate, so the batched
evaluation computes the per-candidate one. (The JAX package gives each
candidate its own key instead; the port cannot reproduce JAX's draws.)

Under an active sweep mesh (``parallel.context``; ``run.py --mesh``) each
chunk is padded to a multiple of the ranks by repeating its last
candidate and each rank trains its slice; the F1s are gathered, so every
rank holds every result (the reference's final-evaluation fan-out,
main.py:1444-1450). Every batched backend splits this way, so 'auto'
routes alike with or without a mesh (the JAX package keeps 'segment'
under one, ``batch_eval.py:207``).

Not inherited from the JAX package: the TPU crash caps and v5e-calibrated
chunk caps, the edge padding, the epoch blocks, the compile-ahead store and
``compile_only`` and the optimization-barrier chain (``ROADMAP.md``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.device import free_memory_bytes, resolve_device
from mpgnn_tpu_torch.graph.hetero import HeteroGraph, NodeSplit
from mpgnn_tpu_torch.models.mpgnn import (
    MPNetmStack,
    hop_aggregate,
    stack_hop_aggregate,
)
from mpgnn_tpu_torch.ops.csr import CsrBlocking, stack_blockings
from mpgnn_tpu_torch.ops.segment import stack_edge_lists
from mpgnn_tpu_torch.parallel.context import (
    gather_sweep,
    pad_batch_list,
    sweep_devices,
    sweep_slice,
)
from mpgnn_tpu_torch.train import loops as _loops
from mpgnn_tpu_torch.train.loops import (
    check_config,
    drop_operands,
    make_optimizer,
    operand_cached,
    relation_operand,
    seeded_init,
    split_tensors,
)
from mpgnn_tpu_torch.train.metrics import macro_f1

log = logging.getLogger("mpgnn_tpu_torch.batch_eval")

BATCH_BACKENDS = ("segment", "csr", "dense")

# Candidates a chunk. None: from the memory the device has free (the CPU:
# ``_CPU_BUDGET_BYTES``). Tests pin it.
_CHUNK_CAP: Optional[int] = None
_CPU_BUDGET_BYTES = 4 << 30
# Share of the free device memory one chunk may take.
_FREE_FRACTION = 0.5
# [N, H] float32 tensors that one hop of one candidate keeps through an
# epoch: the aggregation, the pre-activation, the ReLU and dropout outputs
# and mask, the gradients of the backward; 'dense' also the grouped
# product's side-by-side copies of its input and output.
_NH_PER_HOP = 8
_NH_PER_DENSE_HOP = 3


def resolve_eval_backend(backend: Optional[str], cfg: Optional[MPGNNConfig],
                         graph: HeteroGraph,
                         paths: Sequence[Sequence[int]]) -> str:
    """The aggregation of the batched evaluation of ``paths``: ``backend``,
    else ``cfg.backend``; 'auto' gives 'csr' where a relation of the paths
    has ``loops.CSR_EDGE_CUTOVER`` edges or more (read through the module,
    so that training and the evaluation route alike), else 'segment'."""
    backend = backend or (cfg.backend if cfg else "segment")
    if backend != "auto":
        return backend
    max_e = max((int(graph.rel_counts[int(r)]) for p in paths for r in p),
                default=0)
    return "csr" if max_e >= _loops.CSR_EDGE_CUTOVER else "segment"


def stacked_hop(graph: HeteroGraph, rels: Sequence[int], backend: str,
                device: torch.device) -> List[Tuple[Tuple[int, ...], tuple]]:
    """One hop's parts for ``models.mpgnn.stack_hop_aggregate``: candidate c
    aggregates relation ``rels[c]``. Segment: every candidate in one part.
    csr: the candidates whose both directions run K1 in one stacked part,
    each other candidate (K2) in a part of its own. Dense: the candidates
    of each relation in one grouped part with its bf16 operand."""
    if backend == "dense":
        members: Dict[int, List[int]] = {}
        for c, r in enumerate(rels):
            members.setdefault(int(r), []).append(c)
        return [(tuple(cs), ("grouped_dense", relation_operand(
            graph, r, "pallas", device)[1]))
            for r, cs in sorted(members.items())]
    ops = [relation_operand(graph, r, backend, device) for r in rels]
    everyone = tuple(range(len(rels)))
    if backend == "segment":
        src, dst, inv = stack_edge_lists([op[1:] for op in ops],
                                         graph.num_nodes)
        return [(everyone, ("segment", src, dst, inv))]
    stacked = tuple(c for c, op in enumerate(ops)
                    if isinstance(op[1], CsrBlocking)
                    and isinstance(op[2], CsrBlocking))
    parts = []
    if stacked:
        parts.append((stacked, (
            "csr", stack_blockings(ops[c][1] for c in stacked),
            stack_blockings(ops[c][2] for c in stacked))))
    return parts + [((c,), ops[c]) for c in everyone if c not in stacked]


def _chunk_cap(graph: HeteroGraph, group: List[List[int]], cfg: MPGNNConfig,
               backend: str, device: torch.device) -> int:
    """Most candidates of ``group`` one chunk trains: ``_FREE_FRACTION`` of
    the device's free memory (PyTorch's cache counted as free) over one
    candidate's working set, its [N, H] tensors and its stacked edges; on
    the CPU ``_CPU_BUDGET_BYTES``. Dense: the bf16 operands of the group's
    relations that are not built yet, 4 N^2 bytes each, come off the
    budget once (the built ones are already off the free memory). csr also
    keeps K1's int32 item count, C * (N + E), under 2^31. At least the
    sweep mesh's rank count, as the JAX package's caps."""
    return max(_memory_cap(graph, group, cfg, backend, device),
               sweep_devices())


def _memory_cap(graph: HeteroGraph, group: List[List[int]],
                cfg: MPGNNConfig, backend: str, device: torch.device) -> int:
    if _CHUNK_CAP is not None:
        return _CHUNK_CAP
    n, h = graph.num_nodes, cfg.hidden_dim
    length = len(group[0])
    if device.type == "cuda":
        budget = free_memory_bytes(device) * _FREE_FRACTION
    else:
        budget = _CPU_BUDGET_BYTES
    if backend == "dense":
        budget -= 4 * n * n * sum(
            not operand_cached(graph, r, "pallas", device)
            for r in {r for p in group for r in p})
        per = 4 * n * (graph.feat_dim
                       + (_NH_PER_HOP + _NH_PER_DENSE_HOP) * h * length)
        return max(1, int(budget // per))
    edges = max(sum(int(graph.rel_counts[r]) for r in p[1:]) for p in group)
    # an edge of the stacked hops: csr, a column and a weight each way;
    # segment, int64 src and dst, the gathered row and its gradient
    edge_bytes = 16 if backend == "csr" else 16 + 2 * 4 * h
    per = (4 * n * (graph.feat_dim + _NH_PER_HOP * h * length)
           + edge_bytes * edges)
    cap = max(1, int(budget // per))
    if backend == "csr":
        e_max = max((int(graph.rel_counts[r]) for p in group for r in p[1:]),
                    default=0)
        cap = min(cap, (2 ** 31 - 1) // (n + e_max))
    return cap


def init_stack(num_candidates: int, input_dim: int, hidden_dim: int,
               num_classes: int, length: int, seed: int,
               device) -> Tuple[MPNetmStack, int]:
    """(initial stack, dropout seed): ``train_mpgnn``'s initial parameters
    of a single metapath of ``length`` from ``seed``, for every candidate."""
    model, drop_seed = seeded_init(input_dim, hidden_dim, num_classes,
                                   [[0] * length], seed, device)
    return MPNetmStack.from_models([model] * num_candidates), drop_seed


def _stacked_nll(logp: torch.Tensor, idx: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """The sum over candidates of each one's mean NLL of ``logp[c, idx]``
    against ``y`` (``train_mpgnn``'s unweighted loss)."""
    c = logp.shape[0]
    per = -logp[:, idx].gather(2, y.expand(c, -1)[:, :, None])[:, :, 0]
    return (per.sum(dim=1) / per.shape[1]).sum()


def train_chunk(graph: HeteroGraph, chunk: List[List[int]], x: torch.Tensor,
                parts: Sequence[torch.Tensor], num_classes: int,
                cfg: MPGNNConfig, seed: int,
                backend: str) -> Tuple[List[float], MPNetmStack]:
    """Train one MPNetm per metapath of ``chunk`` (one length) together for
    ``cfg.epochs`` epochs: (the last epoch's validation macro-F1 of each,
    the trained stack)."""
    device = x.device
    n, length, c = graph.num_nodes, len(chunk[0]), len(chunk)
    with torch.no_grad():
        if backend == "dense":
            first = stack_hop_aggregate(
                x.expand(c, -1, -1),
                stacked_hop(graph, [p[0] for p in chunk], backend, device))
        else:
            first = torch.stack([
                hop_aggregate(x, relation_operand(graph, p[0], backend,
                                                  device), n)
                for p in chunk])
    hops = [stacked_hop(graph, [p[j] for p in chunk], backend, device)
            for j in range(1, length)]
    model, drop_seed = init_stack(c, x.shape[1], cfg.hidden_dim, num_classes,
                                  length, seed, device)
    generator = torch.Generator(device=device).manual_seed(drop_seed)
    opt = make_optimizer(model, cfg)
    train_idx, train_y, val_idx, val_y = parts[:4]
    for _ in range(cfg.epochs):
        opt.zero_grad(set_to_none=True)
        logp = model(x, hops, first, dropout_rate=cfg.dropout,
                     generator=generator, train=True)
        _stacked_nll(logp, train_idx, train_y).backward()
        opt.step()
    with torch.no_grad():
        preds = model(x, hops, first).argmax(dim=2)[:, val_idx]
        f1s = torch.stack([macro_f1(preds[k], val_y, num_classes)
                           for k in range(c)])
    return [float(v) for v in f1s.tolist()], model


def evaluate_candidates(
    graph: HeteroGraph,
    paths: Sequence[Sequence[int]],
    split: NodeSplit,
    num_classes: int,
    cfg: Optional[MPGNNConfig] = None,
    seed: int = 0,
    x_override: Optional[np.ndarray] = None,
    backend: Optional[str] = None,
    existing: Optional[Dict[str, float]] = None,
    sink: Optional[Callable[[Dict[str, float]], None]] = None,
    device=None,
) -> Dict[str, float]:
    """Train one single-metapath MPNetm per candidate, the candidates of
    each length together, on ``device`` (the GPU unless ``device='cpu'``);
    return ``{str(path): last-epoch validation macro-F1}`` in length order.

    Each length group is cut into chunks of at most ``_chunk_cap``
    candidates. A chunk whose every candidate is in ``existing`` is not
    trained again (its values are copied); ``sink``, if given, receives
    each trained chunk's results as it finishes, so that a search resumes
    after the last chunk it saved.

    ``backend`` is 'segment', 'csr', 'dense' or 'auto' (default
    ``cfg.backend``). 'auto' routes each length group by
    ``resolve_eval_backend``; a set whose groups route both ways is
    evaluated as two calls, 'csr' then 'segment', whose results are
    merged. A single-model backend ('pallas', 'ell', ...) is refused,
    whether named or from ``cfg.backend``: its candidates train one
    ``train_mpgnn`` each (``find_metapaths`` does that). The JAX package
    trains them with 'segment' instead, which on the card would put plain
    PyTorch where the caller asked for kernels.

    As the JAX package's, the candidates train as plain float32 convs
    whatever ``cfg.compute_dtype``, ``cfg.num_bases`` and ``cfg.num_blocks``
    say: its ``init_mpgnn`` calls omit the decompositions and its forwards
    the compute dtype (``mpgnn_tpu/train/batch_eval.py`` :190, :529,
    :1019, :1206)."""
    cfg = cfg or MPGNNConfig()
    backend = backend or cfg.backend
    by_len = _by_length(paths)
    if backend == "auto":
        routed: Dict[str, List[List[int]]] = {"csr": [], "segment": []}
        for _, group in sorted(by_len.items()):
            routed[resolve_eval_backend(backend, cfg, graph, group)].extend(
                group)
        if routed["csr"] and routed["segment"]:
            kw = dict(cfg=cfg, seed=seed, x_override=x_override,
                      existing=existing, sink=sink, device=device)
            out = evaluate_candidates(graph, routed["csr"], split,
                                      num_classes, backend="csr", **kw)
            out.update(evaluate_candidates(graph, routed["segment"], split,
                                           num_classes, backend="segment",
                                           **kw))
            return out
        backend = "csr" if routed["csr"] else "segment"
    if backend not in BATCH_BACKENDS:
        raise ValueError(f"batched candidate evaluation takes the backends "
                         f"'segment', 'csr', 'dense' and 'auto', not "
                         f"{backend!r} (a single-model backend: train each "
                         f"candidate with train_mpgnn)")
    check_config(cfg)
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(
        x_override if x_override is not None else graph.x, dtype=np.float32),
        device=device)
    parts = split_tensors(split, device)[:4]
    out: Dict[str, float] = {}
    for length, group in sorted(by_len.items()):
        cap = _chunk_cap(graph, group, cfg, backend, device)
        if len(group) > cap:
            log.info("eval len-%d group: %d candidates in chunks of %d",
                     length, len(group), cap)
        for off in range(0, len(group), cap):
            chunk = group[off:off + cap]
            keys = [str(p) for p in chunk]
            if existing and all(k in existing for k in keys):
                out.update((k, float(existing[k])) for k in keys)
                continue
            t0 = time.time()
            padded = pad_batch_list(chunk)
            sl = sweep_slice(len(padded))
            f1s, _ = train_chunk(graph, padded[sl], x, parts, num_classes,
                                 cfg, seed, backend)
            f1s = gather_sweep(torch.tensor(f1s, device=device),
                               len(padded)).tolist()
            done = dict(zip(keys, f1s))
            out.update(done)
            log.info("eval len-%d chunk of %d candidates (%s): %.1fs",
                     length, len(chunk), backend, time.time() - t0)
            if sink is not None:
                sink(done)
    if backend == "dense":
        # the bf16 operands live for the evaluation only, as the JAX
        # package's do; the greedy stage's float32 ones stay cached
        drop_operands(graph, "pallas")
    return out


def _by_length(paths: Sequence[Sequence[int]]) -> Dict[int, List[List[int]]]:
    """{length: the paths of that length, in order}."""
    by_len: Dict[int, List[List[int]]] = {}
    for p in paths:
        by_len.setdefault(len(p), []).append([int(r) for r in p])
    return by_len
