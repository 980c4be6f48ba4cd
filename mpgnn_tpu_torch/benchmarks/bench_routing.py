"""The csr cutover on the traffic that 'auto' routes: a search's final
evaluation and greedy stage, segment against csr, on the card.

    python -m mpgnn_tpu_torch.benchmarks.bench_routing \
        [--edges 100000,1000000,10000000] [--epochs 150,1000] [--out FILE]

Its question: from how many edges a relation does a search finish sooner
with 'csr' (K1 and K2 over blockings built on the host) than with
'segment' (a gather and ``index_add_``)? That decides
``train.loops.CSR_EDGE_CUTOVER``. Past the dense budget, 'auto' routes a
search's last two stages by it (``search.engine.evaluate_and_select``: the
batched final evaluation through ``resolve_eval_backend``, each greedy
model through ``resolve_backend``); its relation-scoring sweeps do not
depend on the backend, so they are not run here.

The workload, a search class over a uniform random graph for each edge
count E: ``NODES`` = 200,000 nodes (``bench.py``'s 200k-node graph),
``RELATIONS`` = 4 relations of E edges each, F = 16 features and 3 random
classes (a seeded numpy generator); the 15 candidates of ``CANDIDATES``
over those relations, 4 of length 1, 6 of length 2 and 5 of length 3 (the
README's search discovers 15 for its class 0, 30 for the others); hidden
64, dropout 0.6, ``top_k_final`` 3, seed 0, the CLI's defaults.

For each E and backend, on a graph made anew so that nothing is built yet:
the operand of every relation (``train.loops.relation_operand``), timed as
``build_s``; then ``evaluate_and_select`` at each epoch count in turn on
that graph, which reuses those operands for every chunk and model, as a
search does. A run's ``total_s`` is the build plus its two stages (host
clock, the card synchronised). The kernels are built, and each backend run
once at 10^4 edges and 2 epochs, before anything is timed. The two backends run in turns, segment
first at even E indices and csr first at odd ones. Each run logs its kernel
launches (csr must launch K1), its greedy models and its selection.

Prints one JSON line a run, then one summary line with the card's name and
power limit and, for each epoch count, the backend that finished first at
each E; ``--out`` also writes the lines to a file. The engine's log lines
(each chunk of the evaluation, each stage) go to stderr. It refuses to run
without a card: a CPU run gives no time.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import time

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig, SearchConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.ops import _kernels, conv, csr
from mpgnn_tpu_torch.search.engine import evaluate_and_select
from mpgnn_tpu_torch.train.loops import relation_operand

NODES = 200_000
RELATIONS = 4
FEATURES = 16
CLASSES = 3
HIDDEN = 64
CANDIDATES = [[0], [1], [2], [3],
              [0, 1], [1, 2], [2, 3], [3, 0], [0, 2], [1, 3],
              [0, 1, 2], [1, 2, 3], [2, 3, 0], [3, 0, 1], [0, 2, 1]]
BACKENDS = ("segment", "csr")
WARM_EDGES = 10_000


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def make_arrays(edges: int, seed: int):
    """(x, src, dst, type) of ``RELATIONS`` uniform random relations of
    ``edges`` edges each over ``NODES`` nodes, and random labels."""
    rng = np.random.default_rng(seed)
    e = RELATIONS * edges
    arrays = (rng.normal(size=(NODES, FEATURES)).astype(np.float32),
              rng.integers(0, NODES, e), rng.integers(0, NODES, e),
              np.repeat(np.arange(RELATIONS), edges))
    return arrays, rng.integers(0, CLASSES, NODES)


def launches() -> dict:
    return {"csr_scatter": csr.SCATTER_LAUNCHES,
            "csr_dedup": csr.DEDUP_LAUNCHES,
            "dense_matmul": conv.MATMUL_LAUNCHES}


def run(arrays, split, backend: str, epochs_list, edges: int,
        show: bool = True) -> list:
    """The build, then ``evaluate_and_select`` at each epoch count, on a
    graph made anew; one record each, printed if ``show``."""
    dev = torch.device("cuda")
    graph = HeteroGraph(*arrays, num_relations=RELATIONS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(RELATIONS):
        relation_operand(graph, r, backend, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    recs = []
    for epochs in epochs_list:
        cfg = SearchConfig(top_k_final=3, mpgnn=MPGNNConfig(
            epochs=epochs, hidden_dim=HIDDEN))
        csr.SCATTER_LAUNCHES = csr.DEDUP_LAUNCHES = 0
        conv.MATMUL_LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        val, chosen, test_f1, stage_s = evaluate_and_select(
            graph, CANDIDATES, split, CLASSES, cfg, arrays[0], seed=0,
            backend=backend, device=dev)
        torch.cuda.synchronize()
        stages_s = time.perf_counter() - t0
        greedy_models = min(len(chosen) + 1, cfg.top_k_final)
        rec = dict(bench="routing", edges_per_relation=edges,
                   backend=backend, epochs=epochs, build_s=build_s,
                   stages_s=stages_s, total_s=build_s + stages_s,
                   final_eval_s=stage_s["final_eval"],
                   greedy_s=stage_s["greedy"], greedy_models=greedy_models,
                   selected=chosen, test_f1=test_f1,
                   val_f1=val, launches=launches(),
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        if show:
            print(json.dumps(rec), flush=True)
        recs.append(rec)
    del graph
    torch.cuda.empty_cache()
    return recs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--edges", default="100000,1000000,10000000",
                    help="edges a relation, comma-separated")
    ap.add_argument("--epochs", default="150,1000",
                    help="MPNetm epochs, comma-separated")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_routing: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    # the engine's and the evaluation's log lines (chunks, stage times)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    edges_list = [int(float(v)) for v in args.edges.split(",")]
    epochs_list = [int(v) for v in args.epochs.split(",")]
    smi = card()
    # the kernels' build and both backends' first calls, not timed
    _kernels.build_all()
    arrays, labels = make_arrays(WARM_EDGES, seed=99)
    for backend in BACKENDS:
        run(arrays, split_nodes(labels), backend, [2], WARM_EDGES, False)
    recs = []
    for i, edges in enumerate(edges_list):
        arrays, labels = make_arrays(edges, seed=i)
        split = split_nodes(labels)
        order = BACKENDS if i % 2 == 0 else BACKENDS[::-1]
        for backend in order:
            recs.extend(run(arrays, split, backend, epochs_list, edges))
        del arrays
    fastest = {}
    for epochs in epochs_list:
        for edges in edges_list:
            got = {r["backend"]: r["total_s"] for r in recs
                   if r["epochs"] == epochs
                   and r["edges_per_relation"] == edges}
            fastest[f"{epochs} epochs, {edges} edges"] = dict(
                got, fastest=min(got, key=got.get))
    summary = dict(bench="routing_summary", card=smi, nodes=NODES,
                   relations=RELATIONS, candidates=len(CANDIDATES),
                   hidden=HIDDEN, fastest=fastest)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in recs + [summary]:
                f.write(json.dumps(r) + "\n")
    return summary


if __name__ == "__main__":
    main()
