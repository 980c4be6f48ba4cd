"""The greedy metapath search engine.

Counterpart of ``mpgnn_tpu/search/engine.py`` (the reference's
``main(args)``, main.py:1191-1476), with the sweeps on the device:

  hop 0      score every candidate relation         -> one flat sweep
  select     elbow-gap cut on the final losses       (main.py:1336-1355)
  hops 1..3  per metapath: build bags, score every candidate relation under
             bag semantics (restarts), gap-cut, extend each survivor by
             prepending its relation, pseudo-relabel from the max-over-
             restart predictions, rebuild and clean the dictionaries
             (main.py:1381-1440)
  final      train an MPNetm per discovered metapath, the candidates of
             each length together (``train.batch_eval``; with
             ``batched_eval=False`` one ``train_mpgnn`` after another),
             rank by validation macro-F1, then grow the top-k joint model
             while test macro-F1 improves (main.py:1442-1476)
"""

from __future__ import annotations

import ast
import dataclasses
import logging
import os
import pickle
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mpgnn_tpu_torch.config import SearchConfig
from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.graph.hetero import HeteroGraph, NodeSplit
from mpgnn_tpu_torch.search import bags as bagmod
from mpgnn_tpu_torch.search.scoring import (
    retrain_bags_predictions,
    score_bag_tasks,
    score_relations_flat,
)
from mpgnn_tpu_torch.train.batch_eval import (
    BATCH_BACKENDS,
    evaluate_candidates,
)
from mpgnn_tpu_torch.train.loops import train_mpgnn

log = logging.getLogger("mpgnn_tpu_torch.search")


@dataclasses.dataclass
class MetapathState:
    """Search frontier entry (the reference's current_metapaths_dict value,
    main.py:1363-1370 / 1435: [loss, f1, edge_dict, dest_dict, data])."""

    path: List[int]
    score: float
    edge_dict: Dict[int, List[int]]
    dest_dict: Dict[int, List[float]]
    node_labels: np.ndarray         # node-indexed pseudo-labels
    source_nodes: List[int]


def _cap_frontier(survivors, cfg: SearchConfig, where: str, path_s: str):
    """Bounded-frontier beam (SearchConfig.max_extensions_per_state): keep
    the k lowest-loss gap-cut survivors per state, a documented divergence
    from the reference that makes many-relation searches finish."""
    k = cfg.max_extensions_per_state
    if k is None or len(survivors) <= k:
        return survivors
    kept = sorted(survivors, key=lambda rl: rl[1])[:k]
    log.info(
        "%s, path %s: frontier cap binds — keeping %d/%d lowest-loss "
        "extensions %s", where, path_s, k, len(survivors),
        [r for r, _ in kept],
    )
    return kept


@dataclasses.dataclass
class SearchResult:
    metapaths: List[List[int]]          # greedy-selected final set
    test_f1: float
    val_f1_by_path: Dict[str, float]    # all evaluated candidates
    discovered: List[List[int]]         # every metapath that entered final eval
    # wall seconds by stage of this call: 'hop0', 'hop1'.. (bag sweep of
    # each extension hop), 'final_eval', 'greedy'
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)


def find_metapaths(
    graph: HeteroGraph,
    binary_labels: np.ndarray,
    split: NodeSplit,
    num_classes: int,
    config: Optional[SearchConfig] = None,
    dataset: str = "synthetic",
    source_nodes: Optional[Sequence[int]] = None,
    x_features: Optional[np.ndarray] = None,
    seed: int = 0,
    batched_eval: bool = True,
    frontier_checkpoint: Optional[str] = None,
    backend: Optional[str] = None,
    device=None,
    warmer=None,
) -> SearchResult:
    """Run the full metapath search for one binary label vector on
    ``device`` (the GPU unless ``device='cpu'``).

    ``binary_labels`` is node-indexed for synthetic datasets; where only
    ``source_nodes`` carry labels it is aligned with that list
    (main.py:1214-1289). ``backend`` is the MPNetm aggregation of the final
    evaluation (default ``config.mpgnn.backend``). With ``batched_eval``
    the candidates of each length train together
    (``train.batch_eval.evaluate_candidates``) where the backend has a
    batched form ('segment', 'csr', 'dense', and 'auto', which routes each
    length group to 'csr' or 'segment'); without it, or with a
    single-model backend ('pallas', 'ell', 'ell2', 'onehot'), one after
    another through ``train_mpgnn``. Both give every candidate the same
    seed, so they compute the same validation F1s (up to the bf16 operands
    of the batched 'dense' form). The greedy stage trains through
    ``train_mpgnn``, which resolves 'auto' for each model.

    ``frontier_checkpoint``: optional pickle path; the frontier (current
    states and discovered paths) is saved after hop 0, after every
    extension hop and after every evaluated candidate, and a search that
    finds the file resumes from the last finished step (after every
    evaluated chunk of candidates, or every candidate).

    ``warmer`` (``utils.warm.ProgramWarmer``) pays first calls on its own
    threads where the JAX engine warms: each sweep's form before its
    chunks (which covers the retrain rounds' forms too) and one epoch of
    a length group's batched evaluation once the group is final."""
    cfg = config or SearchConfig()
    device = resolve_device(device)
    backend = backend or cfg.mpgnn.backend
    rng = np.random.default_rng(seed)
    x = np.asarray(graph.x if x_features is None else x_features, np.float32)
    N = graph.num_nodes
    stage_s: Dict[str, float] = {}

    # node-indexed label vector
    node_labels = np.zeros(N, dtype=np.float32)
    if source_nodes is not None:
        src_list = [int(v) for v in source_nodes]
        node_labels[np.asarray(src_list)] = np.asarray(binary_labels).reshape(-1)
    else:
        src_list = None
        node_labels[:] = np.asarray(binary_labels).reshape(-1)

    # ------------------------------------------------------ frontier resume
    resume = None
    if frontier_checkpoint and os.path.exists(frontier_checkpoint):
        with open(frontier_checkpoint, "rb") as f:
            resume = pickle.load(f)
        log.info(
            "resuming frontier from %s (hop %d, %d states, %d paths)",
            frontier_checkpoint, resume["hop"], len(resume["current"]),
            len(resume["final_paths"]),
        )

    eval_partial: Dict[str, float] = (
        dict(resume.get("eval_partial", {})) if resume else {}
    )

    def save_frontier(hop, current, final_paths):
        if not frontier_checkpoint:
            return
        tmp = frontier_checkpoint + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(
                {"hop": hop, "current": current, "final_paths": final_paths,
                 "eval_partial": eval_partial},
                f,
            )
        os.replace(tmp, frontier_checkpoint)

    def warm_eval(group, existing=None):
        warmer.warm_eval(graph, group, split, num_classes, cfg.mpgnn, seed,
                         x, existing=existing, backend=backend,
                         device=device)

    # ---------------------------------------------------------------- hop 0
    if resume is None:
        t0 = time.time()
        if dataset == "synthetic":
            candidates = bagmod.connected_relations(
                graph, node_labels=node_labels
            )
        else:
            candidates = bagmod.connected_relations(
                graph, source_nodes=src_list
            )
        log.info("hop-0 candidates: %s", candidates)
        flat = score_relations_flat(
            graph, candidates, node_labels, src_list, cfg.scorer, rng,
            device=device, warmer=warmer,
        )
        items = [(r, flat[r].loss) for r in candidates]
        survivors = bagmod.flat_gap_selection(items)
        survivors = _cap_frontier(survivors, cfg, "hop 0", "[]")
        stage_s["hop0"] = time.time() - t0
        log.info(
            "hop-0 losses: %s -> survivors %s (%.1fs)",
            {r: round(l, 4) for r, l in items},
            [r for r, _ in survivors],
            stage_s["hop0"],
        )

        current: List[MetapathState] = []
        for rel, loss in survivors:
            if src_list is None:
                srcs_r = np.unique(graph.rel_edges(rel)[0]).tolist()
            else:
                srcs_r = src_list
            edge_dict, dest_dict = bagmod.build_dictionaries(
                graph, rel, srcs_r, node_labels
            )
            current.append(
                MetapathState(
                    path=[rel],
                    score=loss,
                    edge_dict=edge_dict,
                    dest_dict=dest_dict,
                    node_labels=node_labels.copy(),
                    source_nodes=srcs_r,
                )
            )

        final_paths: List[List[int]] = [list(s.path) for s in current]
        start_hop = 0
        save_frontier(0, current, final_paths)
        # the length-1 group is final: warm its evaluation while the
        # extension hops run
        if warmer is not None and batched_eval and cfg.max_extension_hops:
            warm_eval([p for p in final_paths if len(p) == 1])
    else:
        current = resume["current"]
        final_paths = resume["final_paths"]
        start_hop = resume["hop"]
        # the groups final before the interruption, but those whose every
        # candidate has a saved result
        if warmer is not None and batched_eval:
            for length in range(1, start_hop + 2):
                warm_eval([p for p in final_paths if len(p) == length],
                          existing=eval_partial)

    # ------------------------------------------------------- hops 1..max
    for k in range(start_hop, cfg.max_extension_hops):
        next_states: List[MetapathState] = []
        # phase 1: every state's bags and candidate relations, then the
        # whole frontier swept as one batch per chunk and restart round
        # (the reference runs one MPI fan-out per metapath, main.py:1381-1408)
        t0 = time.time()
        hop_tasks = []
        state_info = {}
        for si, state in enumerate(current):
            bag_list, bag_labels = bagmod.create_bags(
                state.edge_dict, state.dest_dict, cfg.bags.positive_min_label
            )
            if not bag_list:
                continue
            members = sorted(set(m for b in bag_list for m in b))
            rels = bagmod.connected_relations(graph, bag_members=members)
            if not rels:
                continue
            hop_tasks.append((si, rels, bag_list, bag_labels))
            state_info[si] = (state, rels, bag_list, bag_labels)
        if not hop_tasks:
            current = []
            save_frontier(k + 1, current, final_paths)
            break
        all_scores = score_bag_tasks(
            graph, hop_tasks, cfg.scorer, rng, x=x, device=device,
            warmer=warmer,
        )
        stage_s[f"hop{k + 1}"] = time.time() - t0
        log.info(
            "hop %d: swept %d states / %d (state, relation) instances in %.1fs",
            k + 1, len(hop_tasks),
            sum(len(t[1]) for t in hop_tasks), stage_s[f"hop{k + 1}"],
        )

        # phase 2: per-state selection and extension
        for si, (state, rels, bag_list, bag_labels) in state_info.items():
            t0 = time.time()
            scores = all_scores[si]
            valid = [
                scores[r] for r in rels if not scores[r].degenerate
            ]
            survivors = bagmod.bag_gap_selection(
                [(s.relation, s.loss) for s in valid],
                inclusive=cfg.bag_gap_inclusive,
            )
            survivors = _cap_frontier(
                survivors, cfg, f"hop {k + 1}", str(state.path)
            )
            surv_rels = {r for r, _ in survivors}
            log.info(
                "hop %d, path %s: bag losses %s -> extend with %s (%.1fs)",
                k + 1,
                state.path,
                {s.relation: round(s.loss, 4) for s in valid},
                sorted(surv_rels),
                time.time() - t0,
            )
            for s in valid:
                if s.relation not in surv_rels:
                    continue
                new_path = [s.relation] + state.path
                if new_path not in final_paths:
                    final_paths.append(new_path)
                # extra restart for prediction collection (retrain_bags,
                # main.py:814-851 invoked at :1431)
                mv, rec = retrain_bags_predictions(
                    graph, s.relation, bag_list, bag_labels, cfg.scorer, rng,
                    x, device=device,
                )
                pred_max = np.where(
                    s.member_recorded, s.member_pred_max, -np.inf
                )
                pred_max = np.maximum(pred_max, np.where(rec, mv, -np.inf))
                recorded = s.member_recorded | rec
                new_sources, new_labels = bagmod.relabel_from_predictions(
                    pred_max, recorded, N, cfg.bags.relabel_threshold
                )
                edge_dict, dest_dict = bagmod.build_dictionaries(
                    graph, s.relation, new_sources, new_labels
                )
                edge_dict, dest_dict = bagmod.clean_dictionaries(
                    x, edge_dict, dest_dict, s.attribution,
                    cfg.bags.attribution_threshold,
                )
                next_states.append(
                    MetapathState(
                        path=new_path,
                        score=s.loss,
                        edge_dict=edge_dict,
                        dest_dict=dest_dict,
                        node_labels=new_labels,
                        source_nodes=new_sources,
                    )
                )
        current = next_states
        save_frontier(k + 1, current, final_paths)
        # this hop's new length (k + 2) is final: warm its evaluation
        if warmer is not None and batched_eval and current:
            warm_eval([p for p in final_paths if len(p) == k + 2])
        if not current:
            break

    # --------------------------------------------------------- final eval
    # one MPNetm per candidate (main.py:1444-1459); with a frontier
    # checkpoint every finished chunk (batched) or candidate is saved and a
    # re-run resumes after it
    if eval_partial:
        log.info(
            "final eval resuming: %d/%d candidate results already "
            "checkpointed", len(eval_partial), len(final_paths),
        )

    def eval_sink(results):
        eval_partial.update(results)
        save_frontier(cfg.max_extension_hops, current, final_paths)

    val_by_path, f_meta, old_macro, last_s = evaluate_and_select(
        graph, final_paths, split, num_classes, cfg, x, seed=seed,
        backend=backend, batched_eval=batched_eval, device=device,
        existing=eval_partial,
        sink=eval_sink if frontier_checkpoint else None)
    stage_s.update(last_s)
    return SearchResult(
        metapaths=f_meta,
        test_f1=old_macro,
        val_f1_by_path=val_by_path,
        discovered=final_paths,
        stage_s=stage_s,
    )


def evaluate_and_select(
    graph: HeteroGraph,
    final_paths: Sequence[Sequence[int]],
    split: NodeSplit,
    num_classes: int,
    cfg: SearchConfig,
    x: np.ndarray,
    seed: int = 0,
    backend: str = "auto",
    batched_eval: bool = True,
    device=None,
    existing: Optional[Dict[str, float]] = None,
    sink: Optional[Callable[[Dict[str, float]], None]] = None,
) -> Tuple[Dict[str, float], List[List[int]], float, Dict[str, float]]:
    """The search's last two stages, the ones ``backend`` routes: train one
    MPNetm per candidate of ``final_paths`` (batched, or one
    ``train_mpgnn`` each, as ``find_metapaths`` says), rank them by
    validation macro-F1, then grow the top ``cfg.top_k_final`` into one
    model while its test macro-F1 improves (main.py:1442-1476). Candidates
    in ``existing`` are not trained again; ``sink`` receives each trained
    chunk's or candidate's results. Returns (validation F1 by path, the
    selected metapaths, their test F1, wall seconds of 'final_eval' and
    'greedy')."""
    device = resolve_device(device)
    existing = existing or {}
    stage_s: Dict[str, float] = {}
    # the JAX engine trains a single-model backend's candidates batched
    # with 'segment'; here they keep their backend's kernels, one at a time
    batched_eval = batched_eval and (backend == "auto"
                                     or backend in BATCH_BACKENDS)
    t0 = time.time()
    if batched_eval:
        val_by_path = evaluate_candidates(
            graph, final_paths, split, num_classes, cfg.mpgnn, seed=seed,
            x_override=x, backend=backend, existing=existing or None,
            sink=sink, device=device,
        )
        for path_s, f1 in val_by_path.items():
            log.info("eval %s: val F1 %.4f", path_s, f1)
    else:
        val_by_path = {}
        for path in final_paths:
            if str(path) in existing:
                val_by_path[str(path)] = existing[str(path)]
                continue
            res = train_mpgnn(
                graph, [path], split, num_classes, cfg.mpgnn,
                seed=seed, x_override=x, backend=backend, device=device,
            )
            val_by_path[str(path)] = res.val_f1
            log.info("eval %s: val F1 %.4f", path, res.val_f1)
            if sink is not None:
                sink({str(path): res.val_f1})
    stage_s["final_eval"] = time.time() - t0
    log.info(
        "final eval of %d candidates: %.1fs", len(final_paths),
        stage_s["final_eval"],
    )

    ranked = sorted(val_by_path.items(), key=lambda kv: kv[1], reverse=True)
    top = [ast.literal_eval(k) for k, _ in ranked[: cfg.top_k_final]]

    # greedy accumulation while test F1 improves (main.py:1463-1476)
    t0 = time.time()
    test_meta: List[List[int]] = []
    f_meta: List[List[int]] = []
    old_macro = 0.0
    for path in top:
        test_meta.append(path)
        res = train_mpgnn(
            graph, test_meta, split, num_classes, cfg.mpgnn,
            seed=seed, x_override=x, backend=backend, device=device,
        )
        if res.test_f1 > old_macro:
            old_macro = res.test_f1
            f_meta.append(path)
        else:
            break
    stage_s["greedy"] = time.time() - t0
    log.info("final meta: %s test F1 %.4f (greedy %.1fs)", f_meta, old_macro,
             stage_s["greedy"])
    return val_by_path, f_meta, old_macro, stage_s
