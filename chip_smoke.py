#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mpgnn_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. build the CUDA kernels from ``mpgnn_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and print each kernel's register report;
2. kernels: on the uniform graph (200k nodes / 10M edges / 4 relations,
   the 200k-node north-star shape of ``bench.py``) and the power-law KG
   (200k nodes / 2M edges / 237 relations / planted path of 3 / seed 5),
   run K1 (``csr_scatter``) on a uniform relation and K2 (``csr_dedup``) on
   the KG's largest relation at F = 16 and 64, hold each against its plain
   PyTorch version (rtol = atol = 1e-5: float32 sums in another order), and
   time it beside its byte bound, its plain version and one
   ``torch.sparse.mm`` call on the same CSR matrix (a yardstick the port
   never calls);
3. serve the uniform graph: ``MetapathPredictor`` with hidden 64, metapaths
   [[0, 1]] and seeded random parameters, ``backend='csr'`` against
   ``backend='segment'`` (atol 1e-4), and refresh() latency over 20 calls;
4. serve the power-law KG with [planted path, [largest, second largest
   relation]] the same way, and run ``python -m mpgnn_tpu_torch.serve`` on
   ``data/synthetic_multiclass`` with saved parameters;
5. profile 5 refreshes of each predictor (torch.profiler): device time by
   kernel and the device's busy share.

The launch counts of the kernels are set to 0 just before phase 3 and read
just after phase 4; both kernels must have launched there. The last lines
are the card's name and power limit, one JSON line with a record per
kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
SERVE_ATOL = 1e-4
REFRESH_CALLS = 20
HIDDEN = 64


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(**kv) -> None:
    print(json.dumps(kv), flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    warm-up (CUDA events; inputs stay warm in L2 as in serving)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(num_bytes: float, flops: float):
    """(least ms, 'bytes' or 'operations') at the published peaks."""
    t_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def uniform_graph(HeteroGraph, n=200_000, avg_deg=50):
    """The bench.py bench_train_at_scale graph: seed 0, 4 relations, F=16."""
    rng = np.random.default_rng(0)
    e = n * avg_deg
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, 4, e)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    return HeteroGraph(x, src, dst, rel, num_relations=4)


def powerlaw_graph(HeteroGraph, generate_powerlaw_kg):
    """examples/run_powerlaw_kg.py's KG, made in memory."""
    kg = generate_powerlaw_kg(200_000, 2_000_000, 237, metapath_len=3, seed=5)
    x = kg["node_features"].astype(np.float32)
    graph = HeteroGraph(x, kg["src"], kg["dst"], kg["rel"], num_relations=237)
    return graph, [int(r) for r in kg["metapath_relations"]]


def kernel_phase(torch, csr, graph_u, graph_k, rel_u, rel_k):
    """Hold K1 and K2 against their plain versions and time them."""
    dev = torch.device("cuda")
    n = graph_u.num_nodes
    s_u, d_u = graph_u.rel_edges(rel_u)
    s_k, d_k = graph_k.rel_edges(rel_k)
    fwd_u, _ = csr.build_csr_blocking(s_u, d_u, n)
    fwd_k, _ = csr.build_csr_blocking(s_k, d_k, graph_k.num_nodes)
    check(isinstance(fwd_u, csr.CsrBlocking),
          f"uniform relation {rel_u} did not route to K1")
    check(isinstance(fwd_k, csr.DedupCsrBlocking),
          f"hub relation {rel_k} did not route to K2")
    # the same relation as one CSR matrix: K1 on hub data and the yardstick
    csr_k, _ = csr.build_csr_blocking(s_k, d_k, graph_k.num_nodes,
                                      dedup="never")
    fwd_u, fwd_k, csr_k = fwd_u.to(dev), fwd_k.to(dev), csr_k.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    records = {"csr_scatter": [], "csr_dedup": []}
    for f in (16, 64):
        for name, blk, kernel, plain, mat_blk, cols in (
            ("csr_scatter", fwd_u, csr.csr_scatter, csr.csr_scatter_plain,
             fwd_u, d_u),
            ("csr_dedup", fwd_k, csr.csr_dedup, csr.csr_dedup_plain,
             csr_k, d_k),
        ):
            x = torch.randn(blk.num_cols, f, generator=gen, device=dev)
            got = kernel(blk, x)
            want = plain(blk, x)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()), f"{name} F={f}: non-finite")
            check(torch.allclose(got, want, **KERNEL_TOL),
                  f"{name} F={f}: max abs err {err} vs plain version")
            mat = torch.sparse_csr_tensor(
                mat_blk.row_ptr, mat_blk.col, mat_blk.weight,
                size=(mat_blk.num_rows, mat_blk.num_cols))
            # the yardstick sums in float32 in its own order: held loosely,
            # only to show it computes the same function
            lib_err = float((torch.sparse.mm(mat, x) - want).abs().max())
            check(lib_err < 1e-3, f"{name} F={f}: torch.sparse.mm off by "
                                  f"{lib_err}")
            e = len(cols)
            rows_read = len(np.unique(cols))
            if name == "csr_scatter":
                index_bytes = 8 * e + 4 * (blk.num_rows + 1)
                gathered = e
            else:
                index_bytes = 4 * sum(
                    t.numel() for t in (blk.block_tile_ptr, blk.tile_uniq_ptr,
                                        blk.uniq_col, blk.tile_seg_ptr,
                                        blk.seg_row, blk.seg_ptr, blk.slot,
                                        blk.scale))
                gathered = blk.uniq_col.numel()
            out_bytes = 4 * blk.num_rows * f
            # each input read once: the distinct rows of x the edges name
            b_ms, b_by = bound(4 * rows_read * f + index_bytes + out_bytes,
                               2.0 * e * f)
            # the row gather as the kernel does it, one row per edge (K1) or
            # per tile-unique column (K2)
            g_ms, _ = bound(4 * gathered * f + index_bytes + out_bytes, 0.0)
            rec = dict(
                F=f, edges=e, rows=blk.num_rows, max_abs_err=err,
                library_max_abs_err=lib_err,
                ms=cuda_ms(torch, lambda: kernel(blk, x), 50),
                plain_ms=cuda_ms(torch, lambda: plain(blk, x), 5),
                library_ms=cuda_ms(torch, lambda: torch.sparse.mm(mat, x), 20),
                bound_ms=b_ms, bound_by=b_by, gather_bound_ms=g_ms,
            )
            if name == "csr_dedup":
                rec["k1_same_data_ms"] = cuda_ms(
                    torch, lambda: csr.csr_scatter(csr_k, x), 50)
                rec["tile_unique_rows"] = gathered
                rec["dedup_ratio"] = e / gathered
            log(phase="kernels", kernel=name, **rec)
            records[name].append(rec)
    return records


def serve_phase(torch, csr, MetapathPredictor, init_mpgnn, graph, metapaths,
                tag):
    """csr against segment log-probs, and refresh() latency."""
    model = init_mpgnn(graph.feat_dim, HIDDEN, 2, metapaths,
                       generator=torch.Generator().manual_seed(0),
                       device="cuda")
    t0 = time.perf_counter()
    pred = MetapathPredictor(graph, metapaths, model, backend="csr",
                             device="cuda")
    setup_s = time.perf_counter() - t0
    lp = pred.log_probs()
    ref = MetapathPredictor(graph, metapaths, model, backend="segment",
                            device="cuda")
    lp_ref = ref.log_probs()
    check(lp.shape == (graph.num_nodes, 2), f"{tag}: shape {lp.shape}")
    check(bool(np.isfinite(lp).all()), f"{tag}: non-finite log-probs")
    check(np.allclose(np.exp(lp).sum(1), 1.0, atol=1e-4),
          f"{tag}: rows are not distributions")
    err = float(np.abs(lp - lp_ref).max())
    check(err <= SERVE_ATOL, f"{tag}: csr vs segment max abs err {err}")
    lat = np.array([pred.refresh() for _ in range(REFRESH_CALLS)]) * 1e3
    lat_ref = np.array([ref.refresh() for _ in range(REFRESH_CALLS)]) * 1e3
    rec = dict(
        phase="serve", graph=tag, metapaths=metapaths, hidden=HIDDEN,
        nodes=graph.num_nodes,
        edges_per_forward=int(sum(graph.rel_counts[r] for mp in metapaths
                                  for r in mp)),
        csr_vs_segment_max_abs_err=err, csr_setup_s=setup_s,
        refresh_p50_ms=float(np.percentile(lat, 50)),
        refresh_p99_ms=float(np.percentile(lat, 99)),
        segment_refresh_p50_ms=float(np.percentile(lat_ref, 50)),
        segment_refresh_p99_ms=float(np.percentile(lat_ref, 99)),
        relations={
            str(r): dict(
                edges=int(graph.rel_counts[r]),
                max_out_degree=int(graph.rel_degrees(r).max()),
                dedup_ratio=csr.dedup_ratio(*graph.rel_edges(r),
                                            csr.DEDUP_BLOCK_ROWS),
                route=type(op[1]).__name__)
            for mp, ops in zip(metapaths, pred._hop_ops)
            for r, op in zip(mp, ops)},
    )
    log(**rec)
    return pred


def cli_phase(torch, MetapathPredictor, init_mpgnn):
    """``python -m mpgnn_tpu_torch.serve`` on the shipped synthetic dataset
    with parameters saved by ``save_params``: its class counts equal the
    csr predictor's."""
    from mpgnn_tpu_torch.graph.io import load_dat_files
    from mpgnn_tpu_torch.serve import main as serve_main
    from mpgnn_tpu_torch.utils.checkpoint import save_params

    folder = os.path.join(ROOT, "data", "synthetic_multiclass")
    graph, _, _ = load_dat_files(*(os.path.join(folder, f) for f in
                                   ("node.dat", "link.dat", "label.dat")))
    paths = [[1, 0], [2, 3]]                 # metapath.dat, metapath2.dat
    model = init_mpgnn(graph.feat_dim, HIDDEN, 3, paths,
                       generator=torch.Generator().manual_seed(0),
                       device="cuda")
    with tempfile.TemporaryDirectory() as model_dir:
        save_params(model_dir, model)
        out = subprocess.run(
            [sys.executable, "-m", "mpgnn_tpu_torch.serve", "--model_dir",
             model_dir, "--metapaths", json.dumps(paths), "--folder", folder,
             "--num_classes", "3", "--device", "cuda"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"serve CLI failed:\n{out.stderr}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    preds = MetapathPredictor(graph, paths, model, backend="csr",
                              device="cuda").predict()
    want = {"num_nodes": len(preds), "class_counts": np.bincount(preds).tolist()}
    check(got == want, f"serve CLI gave {got}, the predictor {want}")
    log(phase="serve_cli", dataset="data/synthetic_multiclass", output=got)


def profile_phase(torch, pred, tag, calls=5):
    """Device time by kernel over ``calls`` refreshes (torch.profiler), and
    the device's busy share of the host wall time of those calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pred.refresh()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            pred.refresh()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel-level rows only: an operator's row repeats its kernels' time
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    log(phase="profile", graph=tag, calls=calls,
        wall_ms_per_refresh=wall_us / calls / 1e3,
        device_ms_per_refresh=busy_us / calls / 1e3,
        device_busy_share=busy_us / wall_us if rows else None,
        top=[dict(name=k[:80], ms_per_refresh=t / calls / 1e3,
                  launches_per_refresh=c / calls) for k, t, c in rows[:8]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mpgnn_tpu_torch.graph.generate import generate_powerlaw_kg
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph
    from mpgnn_tpu_torch.models.mpgnn import init_mpgnn
    from mpgnn_tpu_torch.ops import _kernels, csr
    from mpgnn_tpu_torch.serve import MetapathPredictor

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(phase="env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, card=smi)

    # 1. build
    t0 = time.perf_counter()
    _kernels.build_all()
    log(phase="build", seconds=time.perf_counter() - t0)
    for name in _kernels.SOURCES:
        for line in _kernels.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"[{name}] {line.strip()}")

    # 2. kernels
    t0 = time.perf_counter()
    graph_u = uniform_graph(HeteroGraph)
    graph_k, planted = powerlaw_graph(HeteroGraph, generate_powerlaw_kg)
    order = np.argsort(-graph_k.rel_counts, kind="stable")
    largest = [int(order[0]), int(order[1])]
    log(phase="graphs", seconds=time.perf_counter() - t0, planted=planted,
        largest=largest,
        largest_edges=[int(graph_k.rel_counts[r]) for r in largest])
    records = kernel_phase(torch, csr, graph_u, graph_k, 0, largest[0])

    # 3 and 4: the main path, through the entry points a user calls
    csr.SCATTER_LAUNCHES = 0
    csr.DEDUP_LAUNCHES = 0
    preds = {
        "uniform": serve_phase(torch, csr, MetapathPredictor, init_mpgnn,
                               graph_u, [[0, 1]], "uniform"),
        "powerlaw_kg": serve_phase(torch, csr, MetapathPredictor, init_mpgnn,
                                   graph_k, [planted, largest], "powerlaw_kg"),
    }
    cli_phase(torch, MetapathPredictor, init_mpgnn)
    launches = {"csr_scatter": csr.SCATTER_LAUNCHES,
                "csr_dedup": csr.DEDUP_LAUNCHES}
    check(all(v > 0 for v in launches.values()),
          f"a kernel did not launch on the main path: {launches}")

    # 5. where the refresh time goes
    for tag, pred in preds.items():
        profile_phase(torch, pred, tag)

    meta = {
        "csr_scatter": ("mpgnn_tpu_torch/csrc/csr_scatter.cu",
                        "mpgnn_tpu/ops/pallas_csr.py:372"),
        "csr_dedup": ("mpgnn_tpu_torch/csrc/csr_dedup.cu",
                      "mpgnn_tpu/ops/pallas_csr.py:434"),
    }
    kernels = []
    for name, recs in records.items():
        wide = recs[-1]                       # F = 64, the hidden width
        kernels.append(dict(
            name=name, route="cuda", source=meta[name][0],
            replaces=meta[name][1], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=wide["ms"], plain_ms=wide["plain_ms"],
            bound_ms=wide["bound_ms"], bound_by=wide["bound_by"],
            library_ms=wide["library_ms"],
        ))
    log(phase="done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
