"""Training throughput at the 200k-node scale, float32 and bfloat16, on the
card.

    python -m mpgnn_tpu_torch.benchmarks.bench_train [--epochs 100]

Counterpart of ``bench.py``'s ``bench_train_at_scale`` (bench.py:608-725):
a uniform random graph of 200,000 nodes, 10M edges (average degree 50) in
4 relations, F = 16 features and random binary labels, all drawn from one
seeded numpy generator in that order; the metapath [0, 1], hidden 64,
dropout 0.6, 100 epochs of full-graph Adam. As the JAX bench runs its
whole-run program at both compute dtypes (``bench_jax``, bench.py:91), the
cells are each compute dtype crossed with 'auto' (resolved as
``train.loops.resolve_backend`` resolves it on the card: csr at this
size) and 'segment'.

A cell: the hop operands' build (host clock, ``build_s``; a graph's
operands are built once and shared by both dtypes, as a search shares
them), one untimed run of 2 epochs, then two timed runs of ``fit_mpgnn``
from the same seeded initial parameters, each ending when its losses and
F1s are on the host; the faster is kept (the JAX bench's ``min`` of two).
``edges_per_s`` = epochs x the path's edges / wall. Each cell records its
kernel launches: a bf16 csr cell must run K1's bf16 form.

Prints one JSON line: the card's name and power limit, the shape, and the
cells. It refuses to run without a card: a CPU run gives no time.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.ops import _kernels, conv, csr
from mpgnn_tpu_torch.train import loops

NODES = 200_000
AVG_DEG = 50
METAPATH = [0, 1]
HIDDEN = 64
DTYPES = ("float32", "bfloat16")
BACKENDS = ("auto", "segment")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def make_graph(n: int, avg_deg: int):
    """bench.py's graph and labels: src, dst, relation, x, labels drawn in
    that order from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    e = n * avg_deg
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, 4, e)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    labels = rng.integers(0, 2, n)
    return HeteroGraph(x, src, dst, rel, num_relations=4), labels


def launches() -> dict:
    return {"csr_scatter": csr.SCATTER_LAUNCHES,
            "csr_scatter_bf16": csr.SCATTER_BF16_LAUNCHES,
            "csr_dedup": csr.DEDUP_LAUNCHES,
            "csr_dedup_bf16": csr.DEDUP_BF16_LAUNCHES,
            "dense_conv": conv.CONV_LAUNCHES,
            "dense_matmul": conv.MATMUL_LAUNCHES}


def reset_launches() -> None:
    csr.SCATTER_LAUNCHES = csr.SCATTER_BF16_LAUNCHES = 0
    csr.DEDUP_LAUNCHES = csr.DEDUP_BF16_LAUNCHES = 0
    conv.CONV_LAUNCHES = conv.MATMUL_LAUNCHES = 0


def run_cell(graph, split, dtype: str, backend: str, epochs: int) -> dict:
    dev = torch.device("cuda")
    resolved = loops.resolve_backend(
        backend, graph, [METAPATH], loops.auto_dense_budget_bytes(dev))
    cfg = MPGNNConfig(epochs=epochs, hidden_dim=HIDDEN, compute_dtype=dtype)
    t0 = time.perf_counter()
    hop_ops = loops.build_hop_arrays(graph, [METAPATH], resolved, dev,
                                     dtype=loops.compute_dtype(cfg))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x = torch.as_tensor(graph.x, device=dev)
    parts = loops.split_tensors(split, dev)
    cw = torch.ones(2, device=dev)
    init, drop_seed = loops.seeded_init(x.shape[1], HIDDEN, 2, [METAPATH],
                                        0, dev)

    def fit(n):
        gen = torch.Generator(device=dev).manual_seed(drop_seed)
        out = loops.fit_mpgnn(copy.deepcopy(init), hop_ops, x, parts, cw,
                              MPGNNConfig(epochs=n, hidden_dim=HIDDEN,
                                          compute_dtype=dtype), gen, 2)
        torch.cuda.synchronize()
        return out

    fit(2)
    reset_launches()
    walls, res = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        res = fit(epochs)
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    edges = epochs * sum(int(graph.rel_counts[r]) for r in METAPATH)
    return dict(dtype=dtype, backend=backend, resolved=resolved,
                build_s=build_s, wall_s=wall, walls_s=walls,
                epoch_ms=wall / epochs * 1e3, edges_per_s=edges / wall,
                final_loss=res[3], train_f1=res[0], val_f1=res[1],
                launches_two_runs=launches())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_train: CUDA is not available", file=sys.stderr)
        return 2
    smi = card()
    _kernels.build_all()
    graph, labels = make_graph(NODES, AVG_DEG)
    split = split_nodes(labels)
    cells = [run_cell(graph, split, dtype, backend, args.epochs)
             for dtype in DTYPES for backend in BACKENDS]
    bad = [c for c in cells if c["resolved"] == "csr"
           and c["dtype"] == "bfloat16"
           and not c["launches_two_runs"]["csr_scatter_bf16"]]
    print(json.dumps({
        "bench": "train_at_scale", "card": smi,
        "device": torch.cuda.get_device_name(0), "nodes": graph.num_nodes,
        "edges": int(graph.rel_counts.sum()), "relations": 4, "features": 16,
        "metapath": METAPATH, "hidden": HIDDEN, "epochs": args.epochs,
        "edges_per_epoch": sum(int(graph.rel_counts[r]) for r in METAPATH),
        "cells": cells}), flush=True)
    if bad:
        print("bench_train: a bf16 csr cell did not launch K1's bf16 form",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
