#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mpgnn_tpu_torch``) once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [--package-root DIR]

Phases, each of which fails the run (non-zero exit) if it fails:

1. build the CUDA kernels from ``mpgnn_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and print each kernel's register report;
2. kernels: on the uniform graph (200k nodes / 10M edges / 4 relations,
   the 200k-node north-star shape of ``bench.py``) and the power-law KG
   (200k nodes / 2M edges / 237 relations / planted path of 3 / seed 5),
   run K1 (``csr_scatter``) on a uniform relation at F = 16 and 64 and K2
   (``csr_dedup``) on the KG's largest relation at F = 4 (serving hop 0),
   16 and 64 and on its second largest at F = 64 (hop 1), and each on the
   backward blocking that training gives it (uniform relation 1, the KG's
   second largest relation, K2 with its pre-scale) at F = 64, and K1 on
   the KG's planted relation 141, whose long rows (up to 1,851 edges) stay
   on K1, forward at F = 4 and 64 and backward at F = 64; hold each
   against its plain PyTorch version (rtol = atol = 1e-5: float32 sums in
   another order) and a second launch against the first (bitwise), and
   time it beside its byte bound, its plain version and one
   ``torch.sparse.mm`` call on the same CSR matrix (a yardstick the port
   never calls); time the host build of K2's layout of the largest
   relation. ``ms`` and ``library_ms`` are device time (CUDA events behind
   a GPU spin that lets the host enqueue every call first), with the time
   by kernel from torch.profiler (``kernel_us``); ``dispatch_ms`` is the
   time per call when the host enqueues as the card runs, as earlier PRs
   measured it;
3. serve the uniform graph: ``MetapathPredictor`` with hidden 64, metapaths
   [[0, 1]] and seeded random parameters, ``backend='csr'`` against
   ``backend='segment'`` (atol 1e-4), and refresh() latency over 20 calls;
4. serve the power-law KG with [planted path, [largest, second largest
   relation]] the same way, and run ``python -m mpgnn_tpu_torch.serve`` on
   ``data/synthetic_multiclass`` with saved parameters;
5. profile 5 refreshes of each predictor (torch.profiler): device time by
   kernel and the device's busy share;
6. kernels K3 (``dense_conv``) and K4 (``dense_matmul``): on relation 1 of
   ``data/synthetic_multiclass`` (N = 5,000) at F = 2 and 64, H = 64, and
   on a random graph at N = 32,768 (A = 2.1 GB bf16, far past the 50 MB
   L2) at F = 64, hold each against its plain version (rtol = atol = 1e-5:
   the same bf16 operands, float32 against float64 sums) and a second
   launch against the first (bitwise), and time it (device time, L2
   flushed before each launch, as training finds A, and by kernel with the
   profiler) beside its bound, its plain version and one cuBLAS call
   (``torch.mm`` over the same bf16 operands, plus the epilogue in torch for
   K3), which the port never calls;
7. hold the first training step's gradient of every parameter, on the
   three graphs below, against a reference (csr against segment on the
   card; pallas against the same autograd Function on the CPU, with the
   kernels' plain versions inside), relative to each gradient's largest
   entry within 1e-2, and show that csr with a zeroed backward fails that
   check; then train through ``train_mpgnn``, hidden 64, dropout 0.6, seed 0:
   (a) ``data/synthetic_multiclass``, metapaths [[1, 0], [2, 3]], 1000
   epochs, backends 'pallas', 'csr' and 'segment' (csr against segment and
   pallas against segment at the tolerances below; epoch time between CUDA
   events recorded after each optimizer step); (b) the uniform graph
   with ``bench.py``'s bench_train_at_scale labels and metapath [0, 1], 100
   epochs, 'csr' against 'segment'; (c) the power-law KG with the serving
   metapaths, 20 epochs, 'csr'. Then one torch.profiler window of 5 epochs
   of (a)-pallas and (b)-csr.

The launch counts of the kernels are set to 0 just before phase 3 and read
just after phase 4 (K1 and K2 must have launched there), and set to 0 again
after phase 7's gradient checks and read after its training runs (K1, K2,
K3, K4 and the csr backward must have launched there). The last lines are
the card's name and power limit, one JSON line with a record per kernel,
and
``{"ok": true, "device": {...}}``.

``--kernels-only`` runs phases 1, 2 and 6 alone and prints one JSON line
per kernel shape; ``--package-root DIR`` takes ``mpgnn_tpu_torch`` from the
checkout DIR (the parent of a change, say), so that two versions of the
kernels are timed by the same script on one card, in turns.
"""

from __future__ import annotations

import argparse
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
PEAK_BF16_FLOPS = 989e12                  # dense, tensor cores

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
SERVE_ATOL = 1e-4
REFRESH_CALLS = 20
HIDDEN = 64
SYNTH = os.path.join(ROOT, "data", "synthetic_multiclass")
SYNTH_PATHS = [[1, 0], [2, 3]]            # metapath.dat, metapath2.dat
# Phase 7, first step: every parameter's gradient, max abs error over the
# reference's largest entry. csr against segment and the card's pallas
# against the CPU's (plain versions, float64 sums) differ in float32 sum
# order, and where that moves a pre-activation across ReLU's kink, by one
# row's whole term: 1.0e-4 and 6.5e-4 in two runs on the 200k-node uniform
# graph, whose random labels make the weight gradients cancel. A control
# with the csr backward zeroed, slice 1's fault, reads 0.88-1.01. The limit
# sits between the two.
GRAD_RTOL = 1e-2
# Phase 7, after the run: csr and segment draw the same dropout masks from
# the same seed and differ only in float32 sum order, which 1000 Adam steps
# amplify; the pallas backend also rounds A and h to bf16, a different model
# function. These bound the drift of a whole run; the first-step gradients
# above are what hold the backward.
CSR_LOSS_ATOL = 1e-2
PALLAS_LOSS_ATOL = 5e-2
PALLAS_F1_ATOL = 3e-2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(**kv) -> None:
    print(json.dumps(kv), flush=True)


# A GPU spin of this many seconds per timed call is queued ahead of the
# first event, so the host has enqueued every call (a wrapper takes 40-100 us
# of host time) before the card reaches them: the events then time the
# device alone. At the H100's clock, 2e9 cycles a second at most; a slower
# clock only spins longer.
SPIN_S_PER_CALL = 300e-6
SPIN_HZ = 2e9


def cuda_ms(torch, fn, reps: int, spin: bool = True) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, after warm-up
    (CUDA events; inputs stay warm in L2 as in serving): device time behind
    a GPU spin, else, where the wrapper's host time exceeds its device time,
    the host's dispatch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(int(reps * SPIN_S_PER_CALL * SPIN_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(torch, fn, reps: int, flush, spin: bool = True) -> float:
    """Mean time of ``fn`` with the L2 cache flushed (a 256 MB write)
    before each call, each call between its own CUDA events: device time
    behind a GPU spin, else with the card idle while the host enqueues
    ``fn``, so that the wrapper's host time counts."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(int(SPIN_S_PER_CALL * SPIN_HZ))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_us(torch, fn, reps: int = 20) -> dict:
    """{kernel name: device us per call of ``fn``} (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {k[:60]: t / reps for k, t, _ in device_rows(prof)}


def bound(num_bytes: float, flops: float, bf16_flops: float = 0.0):
    """(least ms, 'bytes' or 'operations') at the published peaks: float32
    operations at the float32 rate, bf16 tensor-core operations at the bf16
    dense rate."""
    t_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def uniform_graph(HeteroGraph, n=200_000, avg_deg=50):
    """The bench.py bench_train_at_scale graph (seed 0, 4 relations, F=16)
    and its labels, drawn after x from the same stream."""
    rng = np.random.default_rng(0)
    e = n * avg_deg
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, 4, e)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    labels = rng.integers(0, 2, n)
    return HeteroGraph(x, src, dst, rel, num_relations=4), labels


def powerlaw_graph(HeteroGraph, generate_powerlaw_kg):
    """examples/run_powerlaw_kg.py's KG, made in memory."""
    kg = generate_powerlaw_kg(200_000, 2_000_000, 237, metapath_len=3, seed=5)
    x = kg["node_features"].astype(np.float32)
    graph = HeteroGraph(x, kg["src"], kg["dst"], kg["rel"], num_relations=237)
    return graph, [int(r) for r in kg["metapath_relations"]], kg


def kernel_phase(torch, csr, graph_u, graph_k, rels_u, rels_k, rel_p):
    """Hold K1 and K2 against their plain versions and time them, on the
    blockings the serving and training paths give them: forward on hop 0's
    relation (uniform ``rels_u[0]`` at F = 16 and 64, the KG hub
    ``rels_k[0]`` at F = 4, 16 and 64), forward on the KG's hop-1 relation
    ``rels_k[1]`` at F = 64, and backward, the destination-sorted blocking
    that training runs (K2 with its pre-scale), on hop 1's relation at
    F = 64; then K1 on the KG's planted relation ``rel_p``, forward at
    F = 4 (serving hop 0) and 64 and backward at F = 64."""
    dev = torch.device("cuda")
    n_u, n_k = graph_u.num_nodes, graph_k.num_nodes
    s_u, d_u = graph_u.rel_edges(rels_u[0])
    s_k, d_k = graph_k.rel_edges(rels_k[0])
    s_u1, d_u1 = graph_u.rel_edges(rels_u[1])
    s_k1, d_k1 = graph_k.rel_edges(rels_k[1])
    fwd_u, _ = csr.build_csr_blocking(s_u, d_u, n_u)
    t0 = time.perf_counter()
    fwd_k, _ = csr.build_csr_blocking(s_k, d_k, n_k)
    blocking_s = time.perf_counter() - t0
    _, bwd_u = csr.build_csr_blocking(s_u1, d_u1, n_u)
    fwd_k1, bwd_k = csr.build_csr_blocking(s_k1, d_k1, n_k)
    s_p, d_p = graph_k.rel_edges(rel_p)
    fwd_p, bwd_p = csr.build_csr_blocking(s_p, d_p, n_k)
    # the forward dedup layout of the largest relation alone, host numpy
    inv = 1.0 / np.maximum(np.bincount(s_k, minlength=n_k), 1)
    t0 = time.perf_counter()
    csr._build_one_direction_dedup(s_k, d_k, inv, n_k, n_k, False)
    log(phase="dedup_layout", relation=rels_k[0], edges=len(s_k),
        layout_build_s=time.perf_counter() - t0,
        both_directions_with_routing_s=blocking_s,
        passes=len(fwd_k.level_pieces) - 1, pieces=fwd_k.piece_dest.numel(),
        rows_without_edges=fwd_k.zero_rows.numel(),
        partials=fwd_k.num_partials)
    check(isinstance(fwd_u, csr.CsrBlocking),
          f"uniform relation {rels_u[0]} did not route to K1")
    check(isinstance(fwd_k, csr.DedupCsrBlocking),
          f"hub relation {rels_k[0]} did not route to K2")
    check(isinstance(fwd_k1, csr.DedupCsrBlocking),
          f"hub relation {rels_k[1]} did not route to K2")
    check(isinstance(bwd_u, csr.CsrBlocking),
          f"uniform relation {rels_u[1]} backward did not route to K1")
    check(isinstance(bwd_k, csr.DedupCsrBlocking) and bwd_k.scale_is_pre,
          f"hub relation {rels_k[1]} backward did not route to K2")
    check(isinstance(fwd_p, csr.CsrBlocking)
          and isinstance(bwd_p, csr.CsrBlocking),
          f"planted relation {rel_p} did not route to K1")
    # the hub relations as one CSR matrix: K1 on hub data and the yardstick
    csr_k, _ = csr.build_csr_blocking(s_k, d_k, n_k, dedup="never")
    csr_k1f, csr_k1 = csr.build_csr_blocking(s_k1, d_k1, n_k, dedup="never")
    fwd_u, fwd_k, fwd_k1, bwd_u, bwd_k, csr_k, csr_k1f, csr_k1, fwd_p, \
        bwd_p = (b.to(dev) for b in (fwd_u, fwd_k, fwd_k1, bwd_u, bwd_k,
                                     csr_k, csr_k1f, csr_k1, fwd_p, bwd_p))
    r_u, r_u1, r_k, r_k1 = rels_u[0], rels_u[1], rels_k[0], rels_k[1]
    # (kernel, direction, relation, blocking, yardstick's CSR matrix,
    # gathered columns, F)
    cases = [("csr_scatter", "fwd", r_u, fwd_u, fwd_u, d_u, f)
             for f in (16, 64)]
    cases += [("csr_dedup", "fwd", r_k, fwd_k, csr_k, d_k, f)
              for f in (4, 16, 64)]
    cases += [("csr_dedup", "fwd", r_k1, fwd_k1, csr_k1f, d_k1, 64),
              ("csr_scatter", "bwd", r_u1, bwd_u, bwd_u, s_u1, 64),
              ("csr_dedup", "bwd", r_k1, bwd_k, csr_k1, s_k1, 64)]
    cases += [("csr_scatter", "fwd", rel_p, fwd_p, fwd_p, d_p, f)
              for f in (4, 64)]
    cases += [("csr_scatter", "bwd", rel_p, bwd_p, bwd_p, s_p, 64)]
    gen = torch.Generator(device=dev).manual_seed(0)
    records = {"csr_scatter": [], "csr_dedup": []}
    for name, direction, rel, blk, mat_blk, cols, f in cases:
        kernel, plain = {
            "csr_scatter": (csr.csr_scatter, csr.csr_scatter_plain),
            "csr_dedup": (csr.csr_dedup, csr.csr_dedup_plain)}[name]
        tag = f"{name} {direction} rel {rel} F={f}"
        x = torch.randn(blk.num_cols, f, generator=gen, device=dev)
        got = kernel(blk, x)
        again = kernel(blk, x)
        want = plain(blk, x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
        check(torch.allclose(got, want, **KERNEL_TOL),
              f"{tag}: max abs err {err} vs plain version")
        check(torch.equal(got, again), f"{tag}: a second launch differs")
        mat = torch.sparse_csr_tensor(
            mat_blk.row_ptr, mat_blk.col, mat_blk.weight,
            size=(mat_blk.num_rows, mat_blk.num_cols))
        # the yardstick sums in float32 in its own order: held loosely,
        # only to show it computes the same function
        lib_err = float((torch.sparse.mm(mat, x) - want).abs().max())
        check(lib_err < 1e-3, f"{tag}: torch.sparse.mm off by {lib_err}")
        e = len(cols)
        rows_read = len(np.unique(cols))
        index_bytes = 4 * sum(t.numel() for _, t in blk.tensors())
        out_bytes = 4 * blk.num_rows * f
        # each input read once: the distinct rows of x the edges name
        b_ms, b_by = bound(4 * rows_read * f + index_bytes + out_bytes,
                           2.0 * e * f)
        # the row gather as the kernels do it, one row per edge
        g_ms, _ = bound(4 * e * f + index_bytes + out_bytes, 0.0)
        rec = dict(
            direction=direction, relation=rel, F=f, edges=e,
            rows=blk.num_rows, max_abs_err=err, bitwise_repeat=True,
            library_max_abs_err=lib_err,
            ms=cuda_ms(torch, lambda: kernel(blk, x), 50),
            dispatch_ms=cuda_ms(torch, lambda: kernel(blk, x), 50, False),
            plain_ms=cuda_ms(torch, lambda: plain(blk, x), 5),
            library_ms=cuda_ms(torch, lambda: torch.sparse.mm(mat, x), 20),
            library_dispatch_ms=cuda_ms(
                torch, lambda: torch.sparse.mm(mat, x), 20, False),
            bound_ms=b_ms, bound_by=b_by, gather_bound_ms=g_ms,
            kernel_us=kernel_us(torch, lambda: kernel(blk, x)),
        )
        if name == "csr_scatter":
            rec["longest_row"] = int(mat_blk.row_ptr.diff().max())
        if name == "csr_dedup":
            rec["k1_same_data_ms"] = cuda_ms(
                torch, lambda: csr.csr_scatter(mat_blk, x), 50)
            rec["passes"] = len(blk.level_pieces) - 1
            rec["partials"] = blk.num_partials
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

    folder = SYNTH
    graph, _, _ = load_dat_files(*(os.path.join(folder, f) for f in
                                   ("node.dat", "link.dat", "label.dat")))
    paths = SYNTH_PATHS
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


def device_rows(prof):
    """(name, device us, count) of every kernel and copy in a profile, the
    longest first. Kernel-level rows only: an operator's row, and a user
    range such as the optimizer step's, repeat their kernels' time."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=lambda r: -r[1])


def profile_phase(torch, pred, tag, calls=5):
    """Device time by kernel over ``calls`` refreshes (torch.profiler), and
    the device's busy share of the host wall time of those calls."""
    from torch.profiler import ProfilerActivity, profile

    pred.refresh()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            pred.refresh()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    log(phase="profile", graph=tag, calls=calls,
        wall_ms_per_refresh=wall_us / calls / 1e3,
        device_ms_per_refresh=busy_us / calls / 1e3,
        device_busy_share=busy_us / wall_us if rows else None,
        top=[dict(name=k[:80], ms_per_refresh=t / calls / 1e3,
                  launches_per_refresh=c / calls) for k, t, c in rows[:8]])


def dense_phase(torch, conv, graph_s):
    """Hold K3 and K4 against their plain versions and time them."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    s, d = graph_s.rel_edges(1)
    small = conv.build_dense_conv_operand(s, d, graph_s.num_nodes, dev)
    big_n = 32_768
    rng = np.random.default_rng(1)
    big_src, big_dst = rng.integers(0, big_n, 10 * big_n), \
        rng.integers(0, big_n, 10 * big_n)
    records = {"dense_conv": [], "dense_matmul": []}
    for tag, op, f in (("synthetic_multiclass rel 1", small, 2),
                       ("synthetic_multiclass rel 1", small, 64),
                       ("random N=32768", None, 64)):
        if op is None:
            op = conv.build_dense_conv_operand(big_src, big_dst, big_n, dev)
        n = op.num_rows
        h = torch.randn(n, f, generator=gen, device=dev)
        w = torch.randn(f, HIDDEN, generator=gen, device=dev) / f ** 0.5
        root = torch.randn(f, HIDDEN, generator=gen, device=dev) / f ** 0.5
        b = 0.1 * torch.randn(HIDDEN, generator=gen, device=dev)
        dz = torch.randn(n, f, generator=gen, device=dev)
        out, agg = conv.dense_conv_fwd(op.a, h, w, root, b)
        dh = conv.dense_matmul(op.a_t, dz)
        again_out, again_agg = conv.dense_conv_fwd(op.a, h, w, root, b)
        again_dh = conv.dense_matmul(op.a_t, dz)
        want_out, want_agg = conv.dense_conv_plain(op.a, h, w, root, b)
        want_dh = conv.dense_matmul_plain(op.a_t, dz)
        torch.cuda.synchronize()
        check(torch.equal(out, again_out) and torch.equal(agg, again_agg),
              f"dense_conv {tag} F={f}: a second launch differs")
        check(torch.equal(dh, again_dh),
              f"dense_matmul {tag} F={f}: a second launch differs")
        for name, got, want in (("dense_conv out", out, want_out),
                                ("dense_conv agg", agg, want_agg),
                                ("dense_matmul", dh, want_dh)):
            check(bool(torch.isfinite(got).all()), f"{name} {tag} F={f}: "
                                                   f"non-finite")
            check(torch.allclose(got, want, **KERNEL_TOL),
                  f"{name} {tag} F={f}: max abs err "
                  f"{float((got - want).abs().max())} vs plain version")

        def lib_conv():
            a_h = torch.mm(op.a, h.bfloat16()).float()
            return torch.relu(a_h @ w + h @ root + b)

        def lib_matmul():
            return torch.mm(op.a_t, dz.bfloat16())

        # the yardsticks round their product to bf16: held loosely, only to
        # show they compute the same function
        lib_err = max(float((lib_conv() - want_out).abs().max()),
                      float((lib_matmul().float() - want_dh).abs().max()))
        check(lib_err < 5e-2, f"{tag} F={f}: cuBLAS yardstick off by "
                              f"{lib_err}")
        a_bytes = 2.0 * n * n
        k3_bound = bound(a_bytes + 4.0 * (n * f * 2 + n * HIDDEN
                                          + 2 * f * HIDDEN + HIDDEN),
                         4.0 * n * f * HIDDEN, 2.0 * n * n * f)
        k4_bound = bound(a_bytes + 8.0 * n * f, 0.0, 2.0 * n * n * f)
        for name, kernel, plain, lib, (b_ms, b_by), err in (
            ("dense_conv", lambda: conv.dense_conv_fwd(op.a, h, w, root, b),
             lambda: conv.dense_conv_plain(op.a, h, w, root, b), lib_conv,
             k3_bound, max(float((out - want_out).abs().max()),
                           float((agg - want_agg).abs().max()))),
            ("dense_matmul", lambda: conv.dense_matmul(op.a_t, dz),
             lambda: conv.dense_matmul_plain(op.a_t, dz), lib_matmul,
             k4_bound, float((dh - want_dh).abs().max())),
        ):
            rec = dict(
                graph=tag, N=n, F=f, H=HIDDEN, max_abs_err=err,
                bitwise_repeat=True, library_max_abs_err=lib_err,
                ms=cuda_ms_cold(torch, kernel, 20, flush),
                warm_ms=cuda_ms(torch, kernel, 20),
                dispatch_ms=cuda_ms_cold(torch, kernel, 20, flush, False),
                plain_ms=cuda_ms(torch, plain, 3),
                library_ms=cuda_ms_cold(torch, lib, 20, flush),
                library_dispatch_ms=cuda_ms_cold(torch, lib, 20, flush,
                                                 False),
                bound_ms=b_ms, bound_by=b_by,
            )
            rec["splits"] = conv.matmul_splits(
                n, torch.cuda.get_device_properties(dev).multi_processor_count)
            rec["kernel_us"] = kernel_us(torch, kernel)
            log(phase="kernels", kernel=name, **rec)
            records[name].append(rec)
        del op
    del flush
    torch.cuda.empty_cache()
    return records


def first_step_grads(torch, graph, metapaths, split, num_classes, backend,
                     device, zero_csr_backward=False):
    """{parameter name: float64 CPU gradient} of ``fit_mpgnn``'s first step
    with dropout off, from the parameters of seed 0: hop 0 cached as
    ``fit_mpgnn`` caches it, the NLL over the train split. With
    ``zero_csr_backward`` every csr hop's backward blocking has zero weights:
    the kernels run and give a zero input gradient, slice 1's fault."""
    import dataclasses

    from mpgnn_tpu_torch.models.mpgnn import init_mpgnn, precompute_first_hop
    from mpgnn_tpu_torch.ops import csr
    from mpgnn_tpu_torch.train import build_hop_arrays
    from mpgnn_tpu_torch.train.loops import split_tensors, weighted_nll

    model = init_mpgnn(graph.feat_dim, HIDDEN, num_classes, metapaths,
                       device=device)
    hop_ops = build_hop_arrays(graph, metapaths, backend=backend,
                               device=device)
    if zero_csr_backward:
        def zeroed(b):
            field = "scale" if isinstance(b, csr.DedupCsrBlocking) else "weight"
            return dataclasses.replace(
                b, **{field: torch.zeros_like(getattr(b, field))})
        hop_ops = [[(op[0], op[1], zeroed(op[2])) for op in ops]
                   for ops in hop_ops]
    x = torch.as_tensor(np.asarray(graph.x, dtype=np.float32), device=device)
    idx, y = split_tensors(split, device)[:2]
    logp = model(x, hop_ops, first_hop_agg=precompute_first_hop(x, hop_ops))
    weighted_nll(logp, idx, y, torch.ones(len(idx), device=device)).backward()
    return {k: p.grad.detach().double().cpu()
            for k, p in model.named_parameters()}


def grad_rel_err(got, want, tag):
    """(largest error over the reference's largest entry, its parameter);
    fails if a reference gradient is all zero, where the ratio says
    nothing."""
    errs = {}
    for k, w in want.items():
        scale = float(w.abs().max())
        check(scale > 0.0, f"{tag}: the reference gradient of {k} is zero")
        errs[k] = float((got[k] - w).abs().max()) / scale
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def grad_phase(torch, cases):
    """Phase 7's first check: the first step's gradient of every parameter,
    through the training path's kernels (K1/K2 forward and backward, K3/K4)
    on the card, against the segment backend on the card (csr) or the same
    autograd Function on the CPU, with the kernels' plain versions inside
    (pallas). A control, csr with zeroed backward blockings, must fail the
    same comparison."""
    for tag, graph, metapaths, split, c, backend, ref_backend, ref_dev in cases:
        got = first_step_grads(torch, graph, metapaths, split, c, backend,
                               "cuda")
        want = first_step_grads(torch, graph, metapaths, split, c,
                                ref_backend, ref_dev)
        err, worst = grad_rel_err(got, want, f"{tag}/{backend}")
        rec = dict(phase="train_grads", graph=tag, backend=backend,
                   against=f"{ref_backend} on {ref_dev}", rtol=GRAD_RTOL,
                   max_rel_err=err, worst_param=worst)
        if backend == "csr":
            bad = first_step_grads(torch, graph, metapaths, split, c,
                                   backend, "cuda", zero_csr_backward=True)
            rec["control_zeroed_backward_rel_err"], _ = grad_rel_err(
                bad, want, f"{tag}/control")
        log(**rec)
        check(err <= GRAD_RTOL, f"{tag}: {backend} first-step gradient of "
                                f"{worst} off by {err} of its largest entry")
        if backend == "csr":
            check(rec["control_zeroed_backward_rel_err"] > GRAD_RTOL,
                  f"{tag}: the gradient check did not see a zeroed csr "
                  f"backward")
    torch.cuda.empty_cache()


def train_run(torch, tag, graph, metapaths, split, num_classes, epochs,
              backend):
    """One ``train_mpgnn`` run on the card. A CUDA event is recorded after
    every optimizer step (a global step hook, no synchronisation), so the
    epoch time is device-timeline time between the first and the last step,
    idle gaps included; the set-up is the rest of the host wall time."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.train import train_mpgnn

    events = []

    def after_step(*_):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    cfg = MPGNNConfig(epochs=epochs, hidden_dim=HIDDEN)
    torch.cuda.synchronize()
    hook = register_optimizer_step_post_hook(after_step)
    try:
        t0 = time.perf_counter()
        res = train_mpgnn(graph, metapaths, split, num_classes, cfg, seed=0,
                          backend=backend, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        hook.remove()
    check(len(events) == epochs, f"{tag}/{backend}: {len(events)} steps")
    epoch_ms = events[0].elapsed_time(events[-1]) / (epochs - 1)
    edges = int(sum(graph.rel_counts[r] for mp in metapaths for r in mp))
    rec = dict(
        phase="train", graph=tag, backend=backend, metapaths=metapaths,
        epochs=epochs, hidden=HIDDEN, nodes=graph.num_nodes,
        final_loss=res.final_loss, train_f1=res.train_f1,
        val_f1=res.val_f1, test_f1=res.test_f1, wall_s=wall,
        setup_s=wall - epochs * epoch_ms / 1e3, epoch_ms=epoch_ms,
        edges_per_epoch=edges, edges_per_s=edges / (epoch_ms / 1e3),
    )
    log(**rec)
    check(np.isfinite(res.final_loss), f"{tag}/{backend}: non-finite loss")
    check(all(0.0 <= v <= 1.0 for v in (res.train_f1, res.val_f1,
                                        res.test_f1)),
          f"{tag}/{backend}: F1 out of range")
    return rec


def train_phase(torch, graph_s, split_s, graph_u, split_u, graph_k, split_k,
                planted, largest):
    """(a), (b) and (c) of phase 7, with their cross-backend checks."""
    runs = {b: train_run(torch, "synthetic_multiclass", graph_s, SYNTH_PATHS,
                         split_s, 3, 1000, b)
            for b in ("pallas", "csr", "segment")}
    seg = runs["segment"]
    d_csr = abs(runs["csr"]["final_loss"] - seg["final_loss"])
    d_pal = abs(runs["pallas"]["final_loss"] - seg["final_loss"])
    d_f1 = abs(runs["pallas"]["test_f1"] - seg["test_f1"])
    log(phase="train_check", graph="synthetic_multiclass",
        csr_vs_segment_loss=d_csr, pallas_vs_segment_loss=d_pal,
        pallas_vs_segment_test_f1=d_f1)
    check(d_csr <= CSR_LOSS_ATOL, f"csr vs segment final loss {d_csr}")
    check(d_pal <= PALLAS_LOSS_ATOL, f"pallas vs segment final loss {d_pal}")
    check(d_f1 <= PALLAS_F1_ATOL, f"pallas vs segment test F1 {d_f1}")
    check(seg["test_f1"] > 0.9, f"segment test F1 {seg['test_f1']}")

    uni = {b: train_run(torch, "uniform", graph_u, [[0, 1]], split_u, 2, 100,
                        b)
           for b in ("csr", "segment")}
    d_uni = abs(uni["csr"]["final_loss"] - uni["segment"]["final_loss"])
    log(phase="train_check", graph="uniform", csr_vs_segment_loss=d_uni)
    check(d_uni <= CSR_LOSS_ATOL, f"uniform csr vs segment loss {d_uni}")

    train_run(torch, "powerlaw_kg", graph_k, [planted, largest], split_k, 2,
              20, "csr")
    return runs["pallas"]["epoch_ms"], uni["csr"]["epoch_ms"]


def train_profile(torch, tag, graph, metapaths, split, num_classes, backend,
                  epoch_ms, epochs=5):
    """Device time by kernel over ``epochs`` epochs of ``fit_mpgnn`` (the
    loop inside ``train_mpgnn``), and the device's busy share: of the
    profiled host wall time (which the profiler itself slows), and of
    ``epoch_ms``, the unprofiled epoch time of the same run in phase 7."""
    from torch.profiler import ProfilerActivity, profile

    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.models.mpgnn import init_mpgnn
    from mpgnn_tpu_torch.train import build_hop_arrays, fit_mpgnn
    from mpgnn_tpu_torch.train.loops import split_tensors

    dev = torch.device("cuda")
    model = init_mpgnn(graph.feat_dim, HIDDEN, num_classes, metapaths,
                       device=dev)
    hop_ops = build_hop_arrays(graph, metapaths, backend=backend, device=dev)
    x = torch.as_tensor(graph.x, device=dev)
    parts = split_tensors(split, dev)
    cw = torch.ones(num_classes, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def fit(n):
        return fit_mpgnn(model, hop_ops, x, parts, cw,
                         MPGNNConfig(epochs=n, hidden_dim=HIDDEN), gen,
                         num_classes)

    fit(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit(epochs)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    log(phase="train_profile", graph=tag, backend=backend, epochs=epochs,
        wall_ms_per_epoch=wall_us / epochs / 1e3,
        device_ms_per_epoch=busy_us / epochs / 1e3,
        device_busy_share=busy_us / wall_us if rows else None,
        unprofiled_epoch_ms=epoch_ms,
        device_share_of_unprofiled_epoch=busy_us / epochs / 1e3 / epoch_ms,
        top=[dict(name=k[:80], ms_per_epoch=t / epochs / 1e3,
                  launches_per_epoch=c / epochs) for k, t, c in rows[:10]])


def reset_counts(csr, conv) -> None:
    csr.SCATTER_LAUNCHES = csr.DEDUP_LAUNCHES = 0
    csr.CSR_BACKWARD_LAUNCHES = 0
    conv.CONV_LAUNCHES = conv.MATMUL_LAUNCHES = 0


def read_counts(csr, conv) -> dict:
    """Each kernel's launches, and the csr backward passes on the card
    (``csr_backward_passes``: each launched K1 or K2 once, already counted
    there)."""
    return {"csr_scatter": csr.SCATTER_LAUNCHES,
            "csr_dedup": csr.DEDUP_LAUNCHES,
            "csr_backward_passes": csr.CSR_BACKWARD_LAUNCHES,
            "dense_conv": conv.CONV_LAUNCHES,
            "dense_matmul": conv.MATMUL_LAUNCHES}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1, 2 and 6 alone")
    ap.add_argument("--package-root", default=ROOT,
                    help="checkout whose mpgnn_tpu_torch is driven")
    args = ap.parse_args()
    if os.path.abspath(args.package_root) != ROOT and not args.kernels_only:
        ap.error("--package-root drives the kernel phases only: add "
                 "--kernels-only")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.package_root))
    from mpgnn_tpu_torch.graph.generate import generate_powerlaw_kg
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph
    from mpgnn_tpu_torch.graph.io import load_dat_files, split_nodes
    from mpgnn_tpu_torch.models.mpgnn import init_mpgnn
    from mpgnn_tpu_torch.ops import _kernels, conv, csr
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
    graph_u, labels_u = uniform_graph(HeteroGraph)
    graph_k, planted, kg = powerlaw_graph(HeteroGraph, generate_powerlaw_kg)
    order = np.argsort(-graph_k.rel_counts, kind="stable")
    largest = [int(order[0]), int(order[1])]
    log(phase="graphs", seconds=time.perf_counter() - t0, planted=planted,
        largest=largest,
        largest_edges=[int(graph_k.rel_counts[r]) for r in largest])
    records = kernel_phase(torch, csr, graph_u, graph_k, [0, 1], largest,
                           planted[2])
    if args.kernels_only:
        graph_s, _, _ = load_dat_files(
            *(os.path.join(SYNTH, f) for f in ("node.dat", "link.dat",
                                               "label.dat")))
        dense_phase(torch, conv, graph_s)
        log(phase="done", seconds=time.perf_counter() - t_start,
            package_root=os.path.abspath(args.package_root))
        return 0

    # 3 and 4: the serving path, through the entry points a user calls
    reset_counts(csr, conv)
    preds = {
        "uniform": serve_phase(torch, csr, MetapathPredictor, init_mpgnn,
                               graph_u, [[0, 1]], "uniform"),
        "powerlaw_kg": serve_phase(torch, csr, MetapathPredictor, init_mpgnn,
                                   graph_k, [planted, largest], "powerlaw_kg"),
    }
    cli_phase(torch, MetapathPredictor, init_mpgnn)
    serve_launches = read_counts(csr, conv)
    log(phase="serve_launches", **serve_launches)
    check(serve_launches["csr_scatter"] > 0 and serve_launches["csr_dedup"] > 0,
          f"a kernel did not launch on the serving path: {serve_launches}")

    # 5. where the refresh time goes
    for tag, pred in preds.items():
        profile_phase(torch, pred, tag)
    del preds

    # 6. K3 and K4
    graph_s, labels_s, _ = load_dat_files(
        *(os.path.join(SYNTH, f) for f in ("node.dat", "link.dat",
                                           "label.dat")))
    records.update(dense_phase(torch, conv, graph_s))

    # 7. the training path: first-step gradients, then train_mpgnn
    split_s = split_nodes(labels_s)
    split_u = split_nodes(labels_u)
    split_k = split_nodes(kg["labels"][kg["label_nodes"]],
                          node_idx=kg["label_nodes"])
    grad_phase(torch, [
        ("synthetic_multiclass", graph_s, SYNTH_PATHS, split_s, 3, "csr",
         "segment", "cuda"),
        ("synthetic_multiclass", graph_s, SYNTH_PATHS, split_s, 3, "pallas",
         "pallas", "cpu"),
        ("uniform", graph_u, [[0, 1]], split_u, 2, "csr", "segment", "cuda"),
        ("powerlaw_kg", graph_k, [planted, largest], split_k, 2, "csr",
         "segment", "cuda"),
    ])
    reset_counts(csr, conv)
    pallas_ms, csr_ms = train_phase(torch, graph_s, split_s, graph_u, split_u,
                                    graph_k, split_k, planted, largest)
    train_launches = read_counts(csr, conv)
    log(phase="train_launches", **train_launches)
    check(all(v > 0 for v in train_launches.values()),
          f"a kernel did not launch on the training path: {train_launches}")
    train_profile(torch, "synthetic_multiclass", graph_s, SYNTH_PATHS,
                  split_s, 3, "pallas", pallas_ms)
    train_profile(torch, "uniform", graph_u, [[0, 1]], split_u, 2, "csr",
                  csr_ms)

    meta = {
        "csr_scatter": ("mpgnn_tpu_torch/csrc/csr_scatter.cu",
                        "mpgnn_tpu/ops/pallas_csr.py:372"),
        "csr_dedup": ("mpgnn_tpu_torch/csrc/csr_dedup.cu",
                      "mpgnn_tpu/ops/pallas_csr.py:434"),
        "dense_conv": ("mpgnn_tpu_torch/csrc/dense_matmul.cu",
                       "mpgnn_tpu/ops/pallas_conv.py:57"),
        "dense_matmul": ("mpgnn_tpu_torch/csrc/dense_matmul.cu",
                         "mpgnn_tpu/ops/pallas_conv.py:71"),
    }
    kernels = []
    for name, recs in records.items():
        # F = 64, the hidden width, forward; for K3/K4 on the training graph
        # (N = 5,000), the shape of the training path's hop 1
        wide = next(r for r in recs
                    if r["F"] == 64 and r.get("direction", "fwd") == "fwd")
        bwd = [r for r in recs if r.get("direction") == "bwd"]
        extra = dict(bwd_ms=bwd[0]["ms"], bwd_plain_ms=bwd[0]["plain_ms"],
                     bwd_bound_ms=bwd[0]["bound_ms"],
                     bwd_library_ms=bwd[0]["library_ms"],
                     bwd_max_abs_err=bwd[0]["max_abs_err"]) if bwd else {}
        if "gather_bound_ms" in wide:
            extra["gather_bound_ms"] = wide["gather_bound_ms"]
        if "splits" in wide:
            extra["splits"] = wide["splits"]
        if name == "csr_scatter":        # the planted relation's long rows
            kg = next(r for r in recs if r["relation"] == planted[2]
                      and r["F"] == 64 and r["direction"] == "fwd")
            extra.update(kg_relation=planted[2], kg_ms=kg["ms"],
                         kg_bound_ms=kg["bound_ms"],
                         kg_gather_bound_ms=kg["gather_bound_ms"],
                         kg_library_ms=kg["library_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=meta[name][0],
            replaces=meta[name][1],
            launches=serve_launches[name] + train_launches[name],
            launches_serve=serve_launches[name],
            launches_train=train_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=wide["ms"], plain_ms=wide["plain_ms"],
            bound_ms=wide["bound_ms"], bound_by=wide["bound_by"],
            library_ms=wide["library_ms"], dispatch_ms=wide["dispatch_ms"],
            library_dispatch_ms=wide["library_dispatch_ms"], **extra,
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
