"""Out-of-core clustered training at 100M-edge KG scale, on the card.

    python -m mpgnn_tpu_torch.benchmarks.bench_ooc [--folder DIR] \\
        [--generate] [--modes fused,streaming,full_graph]

Counterpart of the JAX package's ``examples/ooc_kg_100m.py``: it loads a
``write_npy_dir`` folder with ``load_npy_dir`` (memmaps), partitions it
(``--parts 32``), and trains the planted metapath with
``train_mpgnn_clustered`` (``--blocks_per_step 2``, ``--epochs 8``,
``--hidden_dim 64``, ``--backend csr``), fused by default (``--no_fused``
is ``--modes streaming``). ``--generate`` first writes the example's graph
(2,000,000 nodes, 100,000,000 edges, 16 relations, metapath length 2, seed
17) into ``--folder`` through ``python -m mpgnn_tpu_torch.generate
powerlaw --format npy`` in a child process, and times it (host clock,
``generate_s``).

``--modes`` runs several modes on one partitioned graph, in order:
``fused`` and ``streaming`` (``resident=False``) are clustered runs;
``full_graph`` is one resident full-graph ``train_mpgnn`` run with the
same backend and epochs, which records whether the whole graph fits the
card (``fits``, and the error if it does not).

Prints one JSON line: the card's name and power limit, the graph, the
load and partition walls, and per mode the walls (``prep_s``, ``train_s``,
``epoch_s``, ``eval_s``), the metapath edges per second over the training
(``mp_edges_per_s``) and over the epochs after the first
(``steady_mp_edges_per_s``), ``device_peak_bytes``, the kernels' launches
and the train/val/test macro-F1. It refuses to run without a card: a CPU
run gives no time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.generate import load_npy_dir
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.graph.partition import PartitionedHeteroGraph
from mpgnn_tpu_torch.ops import _kernels, csr
from mpgnn_tpu_torch.train.loops import train_mpgnn
from mpgnn_tpu_torch.train.stream import host_hop_ops, train_mpgnn_clustered

# the JAX example's graph (examples/ooc_kg_100m.py:12-14)
GENERATE = ["--num_nodes", "2000000", "--num_edges", "100000000",
            "--num_relations", "16", "--metapath_len", "2", "--seed", "17"]
MODES = ("fused", "streaming", "full_graph")
# K1/K2 against their plain versions, as chip_smoke.py's phase 3 holds them
# (float32 sums against a float64 sum rounded once)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def launches() -> dict:
    return {"csr_scatter": csr.SCATTER_LAUNCHES,
            "csr_dedup": csr.DEDUP_LAUNCHES}


def reset_launches() -> None:
    csr.SCATTER_LAUNCHES = csr.DEDUP_LAUNCHES = 0


def hold_group_kernels(pg, metapaths, report, group_ids, widths,
                       tol=KERNEL_TOL, seed=0) -> dict:
    """K1 and K2 on the blockings that a clustered csr run built for the
    groups ``group_ids`` of its ``report``, against their plain versions on
    the card: each group's subgraph is taken again and its blockings
    rebuilt by ``host_hop_ops``, as the run built them (at ``fused_rows``
    with dedup off in fused mode), and every direction of every relation,
    forward and backward, runs on random rows at each of ``widths``.

    Returns, per kernel, the blockings and launches checked, the largest
    absolute error, and whether every output was finite and within
    ``tol``. Its launches add to the kernels' counts: read those first."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pairs = {"csr_scatter": (csr.csr_scatter, csr.csr_scatter_plain),
             "csr_dedup": (csr.csr_dedup, csr.csr_dedup_plain)}
    out = {k: {"blockings": 0, "launches": 0, "max_abs_err": 0.0,
               "close": True} for k in pairs}
    for gi in group_ids:
        sub = pg.subgraph(report["groups"][gi]["blocks"],
                          halo_hops=report["halo_hops"],
                          halo_relations=report["halo_relations"])
        ops = host_hop_ops(sub, metapaths, "csr",
                           fused_rows=report.get("fused_rows"))
        for op in {id(op): op for row in ops for op in row}.values():
            for blk in (b.to(dev) for b in op[1:]):
                name = ("csr_dedup" if isinstance(blk, csr.DedupCsrBlocking)
                        else "csr_scatter")
                kernel, plain = pairs[name]
                rec = out[name]
                rec["blockings"] += 1
                for f in widths:
                    x = torch.randn(blk.num_cols, f, generator=gen,
                                    device=dev)
                    got, want = kernel(blk, x), plain(blk, x)
                    rec["launches"] += 1
                    rec["max_abs_err"] = max(
                        rec["max_abs_err"], float((got - want).abs().max()))
                    rec["close"] &= bool(torch.isfinite(got).all()) and \
                        torch.allclose(got, want, **tol)
    return out


def run_clustered(pg, planted, split, cfg, args, fused: bool) -> dict:
    report: dict = {}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_mpgnn_clustered(
        pg, [planted], split, 2, cfg, blocks_per_step=args.blocks_per_step,
        backend=args.backend, resident=False, report=report, fused=fused)
    wall = time.perf_counter() - t0
    counts = launches()
    mp_edges = report["mp_edges_per_epoch"]
    mp_sizes = [g["mp_edges"] for g in report["groups"]]
    node_sizes = [g["real_nodes"] for g in report["groups"]]
    steady = report["epoch_s"][1:] or report["epoch_s"]
    return {
        "mode": "fused" if fused else "streaming", "wall_s": wall,
        "prep_s": report["prep_s"], "train_s": report["train_s"],
        "epoch_s": report["epoch_s"], "eval_s": report["eval_s"],
        "stack_build_s": report.get("stack_build_s"),
        "upload_s": report.get("upload_s"),
        "mp_edges_per_epoch": mp_edges,
        "mp_edges_per_s": mp_edges * cfg.epochs / report["train_s"],
        "steady_mp_edges_per_s": mp_edges * len(steady) / sum(steady),
        "device_peak_bytes": report["device_peak_bytes"],
        "host_bytes": sum(g["host_bytes"] for g in report["groups"]),
        "stacked_bytes": report.get("stacked_bytes"),
        "groups": [{k: g[k] for k in ("real_nodes", "real_edges",
                                      "mp_edges")}
                   for g in report["groups"]],
        "launches": counts, "steps": report["steps"],
        "train_f1": res.train_f1, "val_f1": res.val_f1,
        "test_f1": res.test_f1, "final_loss": res.final_loss,
        # the largest group by metapath edges and the one with the fewest
        # nodes (the most empty trailing rows in fused mode)
        "kernels_vs_plain": hold_group_kernels(
            pg, [planted], report, sorted({
                int(np.argmax(mp_sizes)), int(np.argmin(node_sizes))}),
            (cfg.hidden_dim, pg.feat_dim)),
    }


def run_full_graph(meta, x, src, dst, rel, labels, planted, split, cfg,
                   args) -> dict:
    """One resident full-graph train_mpgnn run; ``fits`` says whether it
    ran to its end on the card."""
    t0 = time.perf_counter()
    graph = HeteroGraph(np.array(x), src, dst, rel,
                        num_relations=meta["num_relations"], labels=labels)
    out = {"mode": "full_graph", "graph_build_s": time.perf_counter() - t0}
    reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = train_mpgnn(graph, [planted], split, 2, cfg,
                          backend=args.backend)
    except torch.cuda.OutOfMemoryError as err:
        out.update(fits=False, error=str(err).splitlines()[0])
    else:
        out.update(fits=True, train_f1=res.train_f1, val_f1=res.val_f1,
                   test_f1=res.test_f1, final_loss=res.final_loss)
    torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t0,
               device_peak_bytes=int(torch.cuda.max_memory_allocated()),
               launches=launches(),
               mp_edges_per_epoch=int(sum(graph.rel_counts[r]
                                          for r in planted)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--folder", type=str, default="data/powerlaw_kg_100m")
    ap.add_argument("--generate", action="store_true",
                    help="write the example's graph into --folder first")
    ap.add_argument("--parts", type=int, default=32)
    ap.add_argument("--blocks_per_step", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--hidden_dim", type=int, default=64)
    ap.add_argument("--backend", type=str, default="csr")
    ap.add_argument("--modes", type=str, default="fused",
                    help=f"comma-separated, of {', '.join(MODES)}")
    ap.add_argument("--no_fused", dest="modes", action="store_const",
                    const="streaming", help="another way to write "
                    "--modes streaming")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    if set(modes) - set(MODES):
        ap.error(f"--modes takes {', '.join(MODES)}")
    if not torch.cuda.is_available():
        print("bench_ooc: CUDA is not available", file=sys.stderr)
        return 2
    out = {"bench": "ooc", "card": card(),
           "device": torch.cuda.get_device_name(0), "folder": args.folder}
    if args.generate:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "mpgnn_tpu_torch.generate",
                        "powerlaw", *GENERATE, "--out", args.folder,
                        "--format", "npy"], check=True)
        out["generate_s"] = time.perf_counter() - t0
    _kernels.build_all()

    t0 = time.perf_counter()
    meta, x, src, dst, rel, labels, label_nodes = load_npy_dir(args.folder)
    planted = [int(r) for r in meta["metapath_relations"]]
    out["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pg = PartitionedHeteroGraph(x, src, dst, rel, meta["num_relations"],
                                args.parts, labels=labels)
    out["partition_s"] = time.perf_counter() - t0
    lab_vals = np.asarray(labels)[np.asarray(label_nodes)].astype(np.int64)
    split = split_nodes(lab_vals, node_idx=np.asarray(label_nodes).tolist())
    out.update(nodes=meta["num_nodes"], edges=meta["num_edges"],
               relations=meta["num_relations"], planted=planted,
               parts=args.parts, blocks_per_step=args.blocks_per_step,
               epochs=args.epochs, hidden=args.hidden_dim,
               backend=args.backend,
               edge_cut_fraction=pg.edge_cut_fraction(args.blocks_per_step),
               labeled=len(label_nodes))
    cfg = MPGNNConfig(epochs=args.epochs, hidden_dim=args.hidden_dim)
    runs = []
    for mode in modes:
        if mode == "full_graph":
            runs.append(run_full_graph(meta, x, src, dst, rel, labels,
                                       planted, split, cfg, args))
        else:
            runs.append(run_clustered(pg, planted, split, cfg, args,
                                      fused=mode == "fused"))
        print(f"bench_ooc: {json.dumps(runs[-1])}", file=sys.stderr,
              flush=True)
        torch.cuda.empty_cache()
    out["runs"] = runs
    out["kernels_close"] = all(
        k["close"] for r in runs for k in r.get("kernels_vs_plain",
                                                {}).values())
    print(json.dumps(out), flush=True)
    return 0 if out["kernels_close"] else 1


if __name__ == "__main__":
    sys.exit(main())
