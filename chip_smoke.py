#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mpgnn_tpu_torch``) once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [--package-root DIR]
    python3 chip_smoke.py --search-only
    python3 chip_smoke.py --ooc-only
    python3 chip_smoke.py --parallel-only
    python3 chip_smoke.py --attention-only

Phases, each of which fails the run (non-zero exit) if it fails:

1. build the CUDA kernels from ``mpgnn_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and print each kernel's register report; then the
   first-call costs the JAX package's warmer hides (``warm_costs``): the
   card's context, the first K1 launch after the build against the
   second, and a ``train_mpgnn`` run's first epoch against its second;
   then the main thread's first calls (the context, K1, a product, a
   backward, an Adam step, a flat sweep, a bag round and an epoch of the
   batched evaluation) in two fresh child processes, without the warmer
   and with it (``utils/warm.py``: ``poke_device`` and the stage warms
   started before the graph's load, as the CLI starts them, then waited
   for): no warm may fail, and K1 must launch from a warm thread; then
   the rest of the ops API (``ops.segment``'s masked mean, max, argmax and
   counts, ``ops.spmm.ell_max_gather`` and its gradient) on the card
   against the same ops on the CPU (exact; the mean within 1e-6);
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
   measured it. Then K5 (``dma_gather``) through its entry point, the
   gather probe ``python -m mpgnn_tpu_torch.benchmarks.bench_dma_gather``,
   in a child process whose launch count starts at 0: every probe shape
   (F = 128, 64, 16 and runs of 1, 4, 16 and 64 rows) must equal its
   plain version bitwise, and K5 must have launched; its rates are logged
   beside K1's gather on the uniform graph;
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
   K3), which the port never calls; then K3 and its bf16-h form at the
   widths past one main loop and past a whole-W epilogue
   (``wide_conv_phase``): (N, F, H) = (5,000, 334, 64), two main-loop
   slices, and (5,000, 256, 256), the same way, with the profiler's
   kernels of the forward K3's own;
7. hold the first training step's gradient of every parameter, on the
   three graphs below, against a reference (csr against segment on the
   card; pallas against the same autograd Function on the CPU, with the
   kernels' plain versions inside), relative to each gradient's largest
   entry within 1e-2, and show that csr with a zeroed backward fails that
   check; then train through ``train_mpgnn``, hidden 64, dropout 0.6, seed 0:
   (a) ``data/synthetic_multiclass``, metapaths [[1, 0], [2, 3]], 1000
   epochs, backends 'pallas', 'csr' and 'segment' (csr against segment and
   pallas against segment at the tolerances below; epoch time between CUDA
   events recorded after each optimizer step), then 'pallas' against
   'segment' at 334 seeded input columns and at hidden 256
   (``wide_train``, ``WIDE_EPOCHS``), K3 launched at every hop; (b) the
   uniform graph
   with ``bench.py``'s bench_train_at_scale labels and metapath [0, 1], 100
   epochs, 'csr' against 'segment'; (c) the power-law KG with the serving
   metapaths, 20 epochs, 'csr'. Then one torch.profiler window of 5 epochs
   of (a)-pallas and (b)-csr; (d) the new single-model kinds ('ell',
   'ell2', 'dense', 'onehot') on (a)'s graph, forward and first-step
   gradients against 'segment' (1e-5), and ``train_mpgnn(backend='auto')``
   on (b)'s graph, which must resolve as ``resolve_backend`` says and
   launch K1 where that is csr, and a batched 'auto' evaluation there
   (``resolve_eval_backend``, K1 where it says csr); (e) ``auto_routing``: whole
   ``train_mpgnn`` runs, set-up included, at 150 epochs and 1000
   extrapolated, segment against csr on one uniform relation of 200,000
   nodes at 10^4 to 10^7 edges and dense against csr and segment at N =
   5,000 (a's graph) and 8,192 to 32,768 (one random relation), with what
   the readings say of ``CSR_EDGE_CUTOVER`` and the dense budget beside
   the constants in use (the cutover itself is read from a search's
   routed stages, ``python -m mpgnn_tpu_torch.benchmarks.bench_routing``,
   where each operand serves many models); (f) ``mixed_precision``: (a)
   the bf16 forms of K1 and K2 (bf16 rows, float32 sums, one rounding a
   row) on phase 2's shapes (uniform relation 0 at F = 16 and 64 and its
   relation 1 backward; the KG's planted relation 141 at F = 1, 4, 64 and
   65, long rows cut across K1's shares and rows without edges, and its
   backward; the KG's hubs through K2 at F = 4, 16, 64 and backward) and
   K3 with a bf16 h at N = 5,000 (F = 2, 64) and 32,768, each against its
   plain version (``MP_KERNEL_TOL``, K3 1e-5) and a second launch
   (bitwise), timed beside the cast route (float32 kernels between two
   casts, the JAX package's), the float32 form, the bound at bf16 row
   widths, the plain version and the library call (``torch.sparse.mm`` in
   bf16 where it takes it, cuBLAS bf16 plus the epilogue for K3); (b)
   ``train_mpgnn`` with ``compute_dtype='bfloat16'`` against float32, the
   same seed, on the uniform graph (csr, segment; 100 epochs) and the KG
   (csr, K2 on its hubs; 20 epochs), float32, bf16, bf16, float32, within
   ``MP_LOSS_GAP`` and ``MP_F1_GAP``; (c) ``data/synthetic_multiclass``,
   'pallas' in bf16 with ``num_bases=2`` and with ``num_blocks=2``, each
   against 'segment' in the same config (``MP_SYNTH_EPOCHS``); (d) ``python
   -m mpgnn_tpu_torch.rgcn_baseline`` on ``data/synthetic_multiclass`` at
   hidden 64 in a child process, its F1s and epoch time;
8. the metapath search, whose final evaluation trains each length group
   of candidates at once (``train/batch_eval.py``): (a) ``python -m
   mpgnn_tpu_torch.run`` on ``data/synthetic_multiclass`` as users run it
   (hidden 64, the reference's 3 extension hops, ``--backend csr``, 3
   one-vs-rest classes, MPNetm cut from 1000 to 100 epochs, see
   ``SEARCH_EPOCHS``), in a child process: each class's metapaths, test
   F1, candidates and stage times (hop-0 sweep, each bag hop, final
   evaluation, greedy accumulation) from the engine's log lines, then the
   same line with ``--no_warm``, whose selections, test F1s, candidates
   and validation F1s must equal the warmed run's, both runs' stage times
   side by side; (b) class
   0 again in this process through ``find_metapaths``, csr batched and csr
   with ``batched_eval=False`` (one ``train_mpgnn`` a candidate), then
   ``backend='segment'``: each against (a), the same candidates in the same
   order, every candidate's validation F1 within 3e-2 (``PALLAS_F1_ATOL``),
   the same selected metapaths unless two of the top candidates lie within
   that bound, with both final-evaluation stage times; the batched
   evaluation of its candidates timed with each form of the stacked
   model's weight gradient (one batched product, one product a candidate:
   ``models/mpgnn.py`` ``SPLIT_ROWS``), in the order bmm, split, split,
   bmm; and two hop-0 sweeps bitwise equal; (c) the search on the power-law KG of phase 2
   (sources the labeled subset, beam 4, 2 extension hops,
   ``bag_gap_inclusive``, csr, MPNetm cut to 100 epochs), which must
   discover the planted path, then K1 on the stacked blockings of its
   final set (each length group's K1 relations a hop, forward and backward
   at F = 64) timed against the per-candidate launches of the same
   candidates, the final set's evaluation batched against one
   ``train_mpgnn`` a candidate (F1s within 3e-2, both timed) with a
   profile of its largest group, the same evaluation with each form of the
   weight gradient (split, bmm), and one restart round of the planted
   path's hop-1 bag sweep
   run twice from one seed, bitwise equal, the second under
   torch.profiler; (d) the README's line with no ``--backend`` ('auto') in
   a child process, its resolved backends and stage times beside (a)'s,
   against the same line with the final evaluation's resolved backend
   named (the same candidates, validation F1s within 3e-2, the same
   selection unless two top candidates lie within it); (e) class 0 with
   ``backend='dense'`` (the batched evaluation on K4's grouped products)
   against one float32 dense ``train_mpgnn`` a candidate (the same
   candidates, validation F1s within 8e-2), then K4 on every grouped
   product of its final set against its plain version and a second
   launch, the widest timed beside its bound and cuBLAS;
9. out-of-core training (``train/stream.py``): (a) phase 2's KG written by
   ``python -m mpgnn_tpu_torch.generate powerlaw --format npy`` in a child
   process and loaded back as memmaps, bitwise phase 2's arrays; (b) on
   those memmaps a ``PartitionedHeteroGraph`` of 8 blocks, groups of 2,
   the planted path trained with csr at hidden 64 (``OOC_EPOCHS``,
   dropout 0): streaming (``resident=False``), resident and fused, each
   run's K1 and K2 launches equal to what its groups and hops imply, and
   after the streaming and the fused run K1 and K2 on every group's
   blockings as that run built them (fused: at the common row count,
   dedup off), forward and backward at F = 64 and the features' width,
   against their plain versions (``KERNEL_TOL``);
   streaming bitwise resident, fused within ``OOC_FUSED_*`` of streaming,
   streaming's device peak below resident's; then streaming at dropout 0.6
   (``OOC_QUALITY_EPOCHS``), test F1 at least 0.9; a profile of a
   streaming run (host prep, training and evaluation walls; device time
   by kernel and copy); (c) ``python -m mpgnn_tpu_torch.run --trace_dir``
   on ``data/synthetic_multiclass`` (csr, ``OOC_CLI``) in a child
   process: a trace a class, naming K1's kernel; (d) the CLI with
   ``--dataset ACM`` on labels_{train,val,test}.dat written from
   ``data/synthetic_multiclass``, and with ``--dataset fb15k-237`` on
   ``data/fb15k-237-continent`` with an all-zero node.dat written beside
   it (each cut to ``OOC_CLI``);
10. multi-rank, ``parallel/`` on torch.distributed, correctness runs on
   the one card (several ranks share it; gloo stages CUDA tensors through
   pinned host memory, so no time here is a scaling number): (a) K1 on the
   rectangular blockings of every shard of the uniform graph's relations
   0 and 1 at P = 2 and 4, local and halo, forward and backward, F = 16
   and 64, against its plain version (``KERNEL_TOL``), local + halo
   against the full relation's mean (1e-5), each shard's launches timed at
   F = 64 beside bound, plain, ``torch.sparse.mm`` and the square K1; (b)
   ``train_mpgnn(backend='halo')`` on the uniform graph, [[0, 1]], hidden
   64, ``HALO_EPOCHS``, dropout 0, ``halo_local='csr'``, on 2 gloo ranks
   with 'a2a' and 'ppermute' (each rank's K1 launches equal to what its
   hops imply, its epoch and exchange ms) against the single-process csr
   run (``HALO_*`` bounds on the loss, the F1s and the parameters; the
   labels are planted on relation 1, so that the model learns), a bf16
   ``num_bases=2`` run against the single-process one, a control with one
   rank's halo zeroed that must fail the bounds, and a world-1 NCCL halo
   run equal to csr; (c) ``build_sharded_train_step`` on 4
   ranks as (data, model) = (2, 2), ``SHARDED_STEPS`` steps on
   ``data/synthetic_multiclass`` against the replicated step; (d)
   ``train_elastic`` 4 -> 2 ranks with a fault at step 5, and 4 -> 2 -> 1
   with another at step 9 (``bench_parallel.ELASTIC_*``), against the run
   without, and the seconds ``train_elastic``'s meshes take to build, the
   shrink meshes apart (``bench_parallel.mesh_setup_s``); (e) ``torchrun
   --nproc_per_node 2 -m mpgnn_tpu_torch.run --mesh 2`` at ``MESH_CLI``'s cut settings against the single-process
   CLI: the same selections and F1s; (f) the same line started without
   torchrun, ``--mesh 2 --retries 1``, rank 1 failing on its first attempt
   (``bench_parallel.RANK_SITE``): rc 0, one attempt logged, the same
   summary;
11. K6 (``csr_attention``, HGT's attention) on the mag_hgt.train cell's
   graph (``perfbench/graphgen.py`` under ``K6_SEED``), on the blockings
   the program derives (``hgt_baseline.attention_operands``): every row
   (1,939,743 rows, 42,222,014 edges: layers 0 and 1) and the train-row
   tail (629,571 rows: layer 2). Each pass (forward, the backward's row
   pass and column pass) runs twice (bitwise), is held against its plain
   version (``K6_TOL``, ``K6_EDGE_TOL``) on sampled target rows and
   stacked source rows (random ones, rows of several chunks, the longest
   row, rows without edges), beside a control that leaves out each row's
   last edge and must fail, and is timed beside its byte bound
   (``k6_bytes``) and by kernel; then the graph cut by ``K6_CUT``, every
   row held and the plain versions timed; then one training step there
   through ``setup_hgt``, which must launch K6 three times forward and six
   times backward.

The launch counts of the kernels are set to 0 just before phase 3 and read
just after phase 4 (K1 and K2 must have launched there), set to 0 again
after phase 7's gradient checks and read after its training runs (K1, K2,
K3, K4 and the csr backward must have launched there); 7 (d)'s 'auto' run
counts its own; 7 (f) sets them to 0 before its training runs (b) and (c)
and reads them after: K1's and K2's bf16 forms must have launched, and
K3 with a bf16 h. In phase 8 the
searches count their own: (a) and (d) in their child processes, which
start at 0 and print their counts when the CLI ends, (c) and (e) set to 0
just before them and read just after; K1
and the csr backward must have launched in (a) and (c), in (c) K2 too
where a candidate's relation routes to it, and K4 in (e). Phase 9 (b)
sets them to 0 before each clustered run and reads them after it; their
sum is the kernels line's ``launches_ooc``. Phase 10 (b)'s ranks set
theirs to 0 before each halo run and read them after it; their sum is
``launches_halo``. Phase 11 sets K6's counts to 0 just before it and
holds them to the calls it made (the kernels line's ``launches``). K5's
probe
counts its own in its child process, which starts at 0, and phase 1's
warmed child the K1 launches of its warm threads (``launches_warm``).
The last lines are the card's name and power limit, one JSON line with a
record per kernel, and ``{"ok": true, "device": {...}}``.

``--kernels-only`` runs phases 1, 2 and 6 alone and prints one JSON line
per kernel shape; ``--package-root DIR`` takes ``mpgnn_tpu_torch`` from the
checkout DIR (the parent of a change, say), so that two versions of the
kernels are timed by the same script on one card, in turns (K5's probe
runs where that checkout has it, the wide K3 shapes where its K3 takes
them); ``--bits-file FILE`` writes phase 6's output digests to FILE, or
holds them to the ones an earlier run wrote there: the parent's package
first, then this one's, in one call, and the kernels must give the
parent's bits.
``--search-only`` runs phases 1 and 8 alone, ``--ooc-only`` phases 1
and 9, ``--parallel-only`` phases 1 and 10, ``--attention-only`` the
build and phase 11 (and prints K6's record of the kernels line).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import re
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


def cuda_ms(torch, fn, reps: int, spin: bool = True,
            launches: int = 1) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, after warm-up
    (CUDA events; inputs stay warm in L2 as in serving): device time behind
    a GPU spin (long enough for ``launches`` wrapper calls a call), else,
    where the wrapper's host time exceeds its device time, the host's
    dispatch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(int(reps * launches * SPIN_S_PER_CALL * SPIN_HZ))
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
    """(least ms, 'bytes' or 'operations') at the published peaks: the
    largest of the bytes at the memory rate, the float32 operations at the
    float32 rate and the bf16 tensor-core operations at the bf16 dense rate
    (the CUDA cores and the tensor cores can run at once, so their times
    are not added)."""
    t_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FP32_FLOPS, bf16_flops / PEAK_BF16_FLOPS) * 1e3
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


# K5's probe in a child process, ``python -m
# mpgnn_tpu_torch.benchmarks.bench_dma_gather`` (runpy runs the module as
# ``-m`` does), then that process's own K5 launch count as the last line of
# its stderr.
_PROBE_CHILD = """\
import json, runpy, sys
from mpgnn_tpu_torch.ops import gather
sys.argv = ["bench_dma_gather"] + sys.argv[1:]
try:
    runpy.run_module("mpgnn_tpu_torch.benchmarks.bench_dma_gather",
                     run_name="__main__", alter_sys=True)
finally:
    print("LAUNCHES " + json.dumps({"dma_gather": gather.DMA_GATHER_LAUNCHES}),
          file=sys.stderr, flush=True)
"""
PROBE_SHAPES = 12                       # 3 widths x 4 run lengths


def gather_probe(k1_records, package_root):
    """K5 through its entry point, the gather probe, in a child process:
    every shape bitwise equal to its plain version and K5 launched there.
    Logs its rates and, for K1 on the uniform graph at F = 16 and 64, the
    probe's time to gather as many rows (one copy a row, and its fastest
    run length) beside K1's time and its modelled gather bound. Returns the
    probe's result with its launches, or None where another checkout
    (``--package-root``) has no probe."""
    probe = os.path.join(package_root, "mpgnn_tpu_torch", "benchmarks",
                         "bench_dma_gather.py")
    if package_root != ROOT and not os.path.exists(probe):
        log(phase="gather_probe", package_root=package_root,
            skipped="this checkout has no gather probe")
        return None
    out = subprocess.run([sys.executable, "-c", _PROBE_CHILD],
                         cwd=package_root, capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f"gather probe failed:\n{out.stderr[-3000:]}")
    launches = json.loads(out.stderr.strip().splitlines()[-1].split(
        "LAUNCHES ", 1)[1])["dma_gather"]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    shapes = res["shapes"]
    check(len(shapes) == PROBE_SHAPES
          and all(r["bitwise_equal"] for r in shapes),
          f"the gather probe's shapes {shapes}")
    check(launches > 0, "K5 did not launch in the gather probe")
    k1_gather = []
    for r in k1_records:
        if r["relation"] != 0 or r["direction"] != "fwd":
            continue                    # uniform relation 0, F = 16 and 64
        at_f = [p for p in shapes if p["F"] == r["F"]]
        one = next(p for p in at_f if p["rows_per_run"] == 1)
        best = min(at_f, key=lambda p: p["ms"])
        per_row = {k: v["ms"] / res["rows"] for k, v in
                   (("run1", one), ("best", best))}
        k1_gather.append(dict(
            F=r["F"], edges=r["edges"], k1_ms=r["ms"],
            modelled_gather_bound_ms=r["gather_bound_ms"],
            probe_run1_ms=r["edges"] * per_row["run1"],
            probe_best_ms=r["edges"] * per_row["best"],
            probe_best_rows_per_run=best["rows_per_run"],
            index_select_ms=r["edges"] * one["library_ms"] / res["rows"],
            share_of_probe_run1=r["edges"] * per_row["run1"] / r["ms"],
            share_of_probe_best=r["edges"] * per_row["best"] / r["ms"]))
    log(phase="gather_probe", launches=launches, card=res["card"],
        seconds=res["seconds"], dma_run1_vs_torch=res["dma_run1_vs_torch"],
        real_blocking_runs=res["real_blocking_runs"],
        shapes=[{k: p[k] for k in ("F", "rows_per_run", "ms", "mrows_s",
                                   "ns_per_descriptor", "bound_ms",
                                   "library_ms", "plain_ms")}
                for p in shapes],
        k1_gather=k1_gather)
    return dict(res, launches=launches, k1_gather=k1_gather)


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


def dense_phase(torch, conv, graph_s, bits: bool = False):
    """Hold K3 and K4 against their plain versions and time them; with
    ``bits``, also keep each output's digest (K3, K3 with a bf16 h, K4) for
    ``hold_bits``."""
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
        digests = {"dense_conv": digest(out, agg),
                   "dense_conv_bf16h": digest(*conv.dense_conv_fwd(
                       op.a, h.bfloat16(), w, root, b)),
                   "dense_matmul": digest(dh)} if bits else {}
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
            rec["bits"] = {k: v for k, v in digests.items()
                           if k.startswith(name)}
            log(phase="kernels", kernel=name, **rec)
            records[name].append(rec)
        del op
    del flush
    torch.cuda.empty_cache()
    return records


def digest(*ts) -> str:
    """sha1 of the tensors' bytes: a kernel's output bits, to hold one
    version of a kernel against another run on the same inputs."""
    import torch

    h = hashlib.sha1()
    for t in ts:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def hold_bits(records: dict, path: str) -> None:
    """``--bits-file``: write phase 6's output digests (K3, K3 with a bf16
    h and K4 at each of its shapes) to ``path`` if it does not exist, else
    hold them to the ones written there, shape by shape: a run of the
    parent's package first, then this one's, in one call, shows that the
    kernels give the parent's bits at every shape both run."""
    bits = {f"{k} {r['graph']} F={r['F']}": v
            for recs in records.values() for r in recs
            for k, v in r["bits"].items()}
    if not os.path.exists(path):
        with open(path, "w") as f:
            json.dump(bits, f)
        log(phase="bits_written", path=path, shapes=len(bits))
        return
    with open(path) as f:
        before = json.load(f)
    shared = sorted(set(bits) & set(before))
    differ = [k for k in shared if bits[k] != before[k]]
    log(phase="bits_held", path=path, shapes=shared, differ=differ)
    check(shared and not differ, f"bits differ from {path}: {differ}")


# Phase 6, K3 at widths the JAX kernel takes that need the slices and the
# chunked epilogue: F wider than one main loop (GTN's DBLP features, 334
# columns, at hidden 64) and F = H = 256 (hidden 256 after the first hop)
WIDE_CONV_SHAPES = ((334, 64), (256, 256))
K3_KERNELS = ("round_bf16_t_kernel", "dense_matmul_kernel",
              "conv_epilogue_kernel")


def wide_conv_phase(torch, conv, graph_s) -> list:
    """K3 and its bf16-h form at ``WIDE_CONV_SHAPES`` on relation 1 of
    ``data/synthetic_multiclass`` (N = 5,000): each against its plain
    version (``KERNEL_TOL``) and a second launch (bitwise), its device
    kernels read from the profiler (K3's own only: no GEMM of a library in
    the forward), timed as phase 6 times K3 (L2 flushed) beside its bound,
    its plain version and cuBLAS on the same bf16 operands plus the
    epilogue in torch (which the port never calls)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    s, d = graph_s.rel_edges(1)
    op = conv.build_dense_conv_operand(s, d, graph_s.num_nodes, dev)
    n = op.num_rows
    recs = []
    for f, hd in WIDE_CONV_SHAPES:
        h32 = torch.randn(n, f, generator=gen, device=dev)
        w = torch.randn(f, hd, generator=gen, device=dev) / f ** 0.5
        root = torch.randn(f, hd, generator=gen, device=dev) / f ** 0.5
        b = 0.1 * torch.randn(hd, generator=gen, device=dev)
        for name, h in (("dense_conv", h32),
                        ("dense_conv_bf16h", h32.bfloat16())):
            label = f"{name} N={n} F={f} H={hd}"

            def kernel(h=h):
                return conv.dense_conv_fwd(op.a, h, w, root, b)

            def lib(h=h):
                a_h = torch.mm(op.a, h.bfloat16()).float()
                return torch.relu(a_h @ w + h.float() @ root + b)

            out, agg = kernel()
            again = kernel()
            want_out, want_agg = conv.dense_conv_plain(op.a, h, w, root, b)
            torch.cuda.synchronize()
            check(torch.equal(out, again[0]) and torch.equal(agg, again[1]),
                  f"{label}: a second launch differs")
            err = max(float((out - want_out).abs().max()),
                      float((agg - want_agg).abs().max()))
            check(bool(torch.isfinite(out).all())
                  and torch.allclose(out, want_out, **KERNEL_TOL)
                  and torch.allclose(agg, want_agg, **KERNEL_TOL),
                  f"{label}: max abs err {err} vs plain version")
            lib_err = float((lib() - want_out).abs().max())
            check(lib_err < 5e-2, f"{label}: cuBLAS yardstick off by "
                                  f"{lib_err}")
            by_kernel = kernel_us(torch, kernel)
            check(any("conv_epilogue_kernel" in k for k in by_kernel)
                  and all(any(x in k for x in K3_KERNELS)
                          for k in by_kernel),
                  f"{label}: the forward ran {sorted(by_kernel)}")
            h_bytes = h.element_size()
            b_ms, b_by = bound(2.0 * n * n + h_bytes * n * f
                               + 4.0 * (n * f + n * hd + 2 * f * hd + hd),
                               4.0 * n * f * hd, 2.0 * n * n * f)
            rec = dict(
                kernel=name, graph="synthetic_multiclass rel 1", N=n, F=f,
                H=hd, max_abs_err=err, bitwise_repeat=True,
                library_max_abs_err=lib_err,
                ms=cuda_ms_cold(torch, kernel, 20, flush),
                warm_ms=cuda_ms(torch, kernel, 20),
                plain_ms=cuda_ms(torch, lambda h=h: conv.dense_conv_plain(
                    op.a, h, w, root, b), 3),
                library_ms=cuda_ms_cold(torch, lib, 20, flush),
                library_call="torch.mm bf16 + epilogue", bound_ms=b_ms,
                bound_by=b_by, kernel_us=by_kernel)
            log(phase="wide_conv", **rec)
            recs.append(rec)
    del op, flush
    torch.cuda.empty_cache()
    return recs


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
              backend, phase="train", hidden=HIDDEN, **cfg_kw):
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

    cfg = MPGNNConfig(epochs=epochs, hidden_dim=hidden, **cfg_kw)
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
        phase=phase, graph=tag, backend=backend, metapaths=metapaths,
        epochs=epochs, hidden=hidden, nodes=graph.num_nodes, **cfg_kw,
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

    wide = wide_train(torch, graph_s, split_s)

    uni = {b: train_run(torch, "uniform", graph_u, [[0, 1]], split_u, 2, 100,
                        b)
           for b in ("csr", "segment")}
    d_uni = abs(uni["csr"]["final_loss"] - uni["segment"]["final_loss"])
    log(phase="train_check", graph="uniform", csr_vs_segment_loss=d_uni)
    check(d_uni <= CSR_LOSS_ATOL, f"uniform csr vs segment loss {d_uni}")

    train_run(torch, "powerlaw_kg", graph_k, [planted, largest], split_k, 2,
              20, "csr")
    return runs["pallas"]["epoch_ms"], uni["csr"]["epoch_ms"], wide


# Phase 7 (a) at phase 6's wide K3 shapes: 'pallas' against 'segment' on
# data/synthetic_multiclass with WIDE_FEATURES seeded bag-of-words columns
# (the width of GTN's DBLP features, 5% of them 1; K3 at F = 334, H = 64 on
# hop 0) and at hidden 256 (K3 at F = H = 256 on hop 1, K4 at F = 256 in
# its backward), each held as 7 (a) holds its runs; cut from 7 (a)'s 1000
# epochs to WIDE_EPOCHS, as 7 (f) (c) is
WIDE_FEATURES = 334
WIDE_HIDDEN = 256
WIDE_EPOCHS = 300


def wide_train(torch, graph_s, split_s) -> dict:
    """7 (a) at the wide shapes: each 'pallas' run's K3 and K4 launches
    (at least one K3 a hop an epoch, one K4 a hop after the first), its
    final loss and test F1 against 'segment''s within ``PALLAS_LOSS_ATOL``
    and ``PALLAS_F1_ATOL``."""
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph
    from mpgnn_tpu_torch.ops import conv

    rng = np.random.default_rng(0)
    x = (rng.random((graph_s.num_nodes, WIDE_FEATURES)) < 0.05).astype(
        np.float32)
    graph_w = HeteroGraph(x, graph_s.edge_src, graph_s.edge_dst,
                          graph_s.edge_type,
                          num_relations=graph_s.num_relations)
    hops = sum(len(mp) for mp in SYNTH_PATHS)
    out = {}
    for tag, graph, hidden in ((f"features={WIDE_FEATURES}", graph_w, HIDDEN),
                               (f"hidden={WIDE_HIDDEN}", graph_s,
                                WIDE_HIDDEN)):
        runs = {}
        for backend in ("pallas", "segment"):
            before = (conv.CONV_LAUNCHES, conv.MATMUL_LAUNCHES)
            runs[backend] = train_run(
                torch, f"synthetic_multiclass {tag}", graph, SYNTH_PATHS,
                split_s, 3, WIDE_EPOCHS, backend, phase="wide_train",
                hidden=hidden)
            runs[backend].update(k3_launches=conv.CONV_LAUNCHES - before[0],
                                 k4_launches=conv.MATMUL_LAUNCHES - before[1])
        pal, seg = runs["pallas"], runs["segment"]
        d_loss = abs(pal["final_loss"] - seg["final_loss"])
        d_f1 = abs(pal["test_f1"] - seg["test_f1"])
        log(phase="wide_train_check", graph=tag,
            pallas_vs_segment_loss=d_loss, pallas_vs_segment_test_f1=d_f1,
            k3_launches=pal["k3_launches"], k4_launches=pal["k4_launches"],
            reduced=[f"epochs 1000 -> {WIDE_EPOCHS}"])
        check(pal["k3_launches"] >= WIDE_EPOCHS * hops
              and pal["k4_launches"] >= WIDE_EPOCHS * (hops - len(SYNTH_PATHS))
              and seg["k3_launches"] == 0,
              f"{tag}: K3/K4 launches {runs}")
        check(d_loss <= PALLAS_LOSS_ATOL,
              f"{tag}: pallas vs segment final loss {d_loss}")
        check(d_f1 <= PALLAS_F1_ATOL,
              f"{tag}: pallas vs segment test F1 {d_f1}")
        out[tag] = runs
    return out


def train_profile(torch, tag, graph, metapaths, split, num_classes, backend,
                  epoch_ms, epochs=5, **cfg_kw):
    """Device time by kernel over ``epochs`` epochs of ``fit_mpgnn`` (the
    loop inside ``train_mpgnn``), and the device's busy share: of the
    profiled host wall time (which the profiler itself slows), and of
    ``epoch_ms``, the unprofiled epoch time of the same run in phase 7."""
    from torch.profiler import ProfilerActivity, profile

    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.models.mpgnn import init_mpgnn
    from mpgnn_tpu_torch.train import build_hop_arrays, fit_mpgnn
    from mpgnn_tpu_torch.train.loops import compute_dtype, split_tensors

    dev = torch.device("cuda")
    model = init_mpgnn(graph.feat_dim, HIDDEN, num_classes, metapaths,
                       device=dev)
    cfg = MPGNNConfig(hidden_dim=HIDDEN, **cfg_kw)
    hop_ops = build_hop_arrays(graph, metapaths, backend=backend, device=dev,
                               dtype=compute_dtype(cfg))
    x = torch.as_tensor(graph.x, device=dev)
    parts = split_tensors(split, dev)
    cw = torch.ones(num_classes, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def fit(n):
        return fit_mpgnn(model, hop_ops, x, parts, cw,
                         dataclasses.replace(cfg, epochs=n), gen,
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
        **cfg_kw,
        wall_ms_per_epoch=wall_us / epochs / 1e3,
        device_ms_per_epoch=busy_us / epochs / 1e3,
        device_busy_share=busy_us / wall_us if rows else None,
        unprofiled_epoch_ms=epoch_ms,
        device_share_of_unprofiled_epoch=busy_us / epochs / 1e3 / epoch_ms,
        top=[dict(name=k[:80], ms_per_epoch=t / epochs / 1e3,
                  launches_per_epoch=c / epochs) for k, t, c in rows[:10]])


# Phase 8 (a) and (b): the MPNetm evaluation epochs, cut from the
# reference's 1000 so that phase 8 stays within about 6 minutes: at 1000,
# (a) took 655 s and (b) 178 s of host-bound training (75 and 15 candidates
# at 5-8 ms an epoch on an H100 80GB HBM3 at its 700 W limit), at 300 phase
# 8 took 472 s, at 150 356 s. Cut to 100 when phase 10 came, so that the
# whole script stays near half its 1200 s limit (607 s before phase 10).
# The sweeps do not depend on it.
SEARCH_EPOCHS = 100
# the README's line (its default --backend is 'auto'), at SEARCH_EPOCHS
SEARCH_LINE = ["--hidden_dim", str(HIDDEN), "--dataset", "synthetic",
               "--folder", SYNTH, "--node_file", "node.dat", "--link_file",
               "link.dat", "--label_file", "label.dat",
               "--epochs", str(SEARCH_EPOCHS)]
SEARCH_CLI = SEARCH_LINE + ["--backend", "csr"]
KG_SEARCH_EPOCHS = 100
# Phase 8 (a)'s child process: ``python -m mpgnn_tpu_torch.run`` (runpy runs
# the module as ``-m`` does), then that process's own launch counts as the
# last line of its stderr.
_CLI_CHILD = """\
import json, runpy, sys
from mpgnn_tpu_torch.ops import conv, csr
sys.argv = ["mpgnn_tpu_torch.run"] + sys.argv[1:]
try:
    runpy.run_module("mpgnn_tpu_torch.run", run_name="__main__",
                     alter_sys=True)
finally:
    print("LAUNCHES " + json.dumps({
        "csr_scatter": csr.SCATTER_LAUNCHES, "csr_dedup": csr.DEDUP_LAUNCHES,
        "csr_backward_passes": csr.CSR_BACKWARD_LAUNCHES,
        "dense_conv": conv.CONV_LAUNCHES,
        "dense_matmul": conv.MATMUL_LAUNCHES}), file=sys.stderr, flush=True)
"""
_STAGE_RES = (
    ("hop0", re.compile(r"hop-0 losses: .* \(([0-9.]+)s\)$")),
    ("hop", re.compile(r"hop (\d+): swept .* in ([0-9.]+)s$")),
    ("final_eval", re.compile(r"final eval of \d+ candidates: ([0-9.]+)s$")),
    ("greedy", re.compile(r"final meta: .* \(greedy ([0-9.]+)s\)$")),
)


def stage_times(stderr: str) -> list:
    """Per class, the engine's stage times (s) from its log lines."""
    classes, cur = [], {}
    for line in stderr.splitlines():
        for name, pat in _STAGE_RES:
            m = pat.search(line)
            if not m:
                continue
            if name == "hop":
                cur[f"hop{m.group(1)}"] = float(m.group(2))
            else:
                cur[name] = float(m.group(1))
            if name == "greedy":
                classes.append(cur)
                cur = {}
    return classes


def cli_search(argv) -> dict:
    """``python -m mpgnn_tpu_torch.run`` with ``argv`` in a child process
    whose launch counts start at 0: the per-class checkpoint (each class's
    candidates and their validation F1), the child's launches, its summary
    line, each class's stage times, the backends it resolved 'auto' to
    (``resolved``: the greedy stage's ``train_mpgnn`` runs and the final
    evaluation's chunks, counted) and its wall time."""
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "search.json")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", _CLI_CHILD, *argv, "--pickle_filename",
             ck], cwd=ROOT, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(out.returncode == 0,
              f"search CLI failed:\n{out.stderr[-3000:]}")
        with open(ck) as f:
            per_class = json.load(f)
    launches = json.loads(out.stderr.strip().splitlines()[-1].split(
        "LAUNCHES ", 1)[1])
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    stages = stage_times(out.stderr)
    check(set(summary) >= {"dataset", "classes", "wall_s"}
          and len(summary["classes"]) == 3 and len(stages) == 3,
          f"search CLI summary {summary}, stage times {stages}")
    for k, v in summary["classes"].items():
        check(0.0 <= v["test_f1"] <= 1.0 and v["metapaths"],
              f"class {k}: {v}")
    resolved = {}
    for pat, where in ((_TRAIN_AUTO_RE, "train_mpgnn"),
                       (_EVAL_CHUNK_RE, "final_eval")):
        for b in pat.findall(out.stderr):
            resolved[f"{where}:{b}"] = resolved.get(f"{where}:{b}", 0) + 1
    warms = [line.split("mpgnn_tpu_torch.warm ", 1)[1]
             for line in out.stderr.splitlines()
             if "mpgnn_tpu_torch.warm " in line]
    return dict(per_class=per_class, launches=launches, summary=summary,
                stages=stages, resolved=resolved, wall=wall, warms=warms)


_TRAIN_AUTO_RE = re.compile(r"train_mpgnn: backend 'auto' -> '(\w+)'")
_EVAL_CHUNK_RE = re.compile(r"eval len-\d+ chunk of \d+ candidates \((\w+)\)")


def search_cli_run() -> tuple:
    """Phase 8 (a): ``python -m mpgnn_tpu_torch.run`` on
    ``data/synthetic_multiclass`` as users run it (3 extension hops, csr,
    ``SEARCH_EPOCHS`` epochs), in a child process whose launch counts
    start at 0. Returns (the per-class checkpoint, which gives each
    class's candidates and their validation F1; the child's launches; the
    classes' stage times)."""
    run = cli_search(SEARCH_CLI)
    per_class, launches, summary = (run["per_class"], run["launches"],
                                    run["summary"])
    stages = run["stages"]
    # the same line without the warmer: the same decisions, bit for bit
    cold = cli_search(SEARCH_CLI + ["--no_warm"])
    same = (cold["per_class"] == per_class
            and cold["summary"]["classes"] == summary["classes"])
    log(phase="search_cli_no_warm", same_json=same,
        warms=run["warms"], process_wall_s=run["wall"],
        no_warm_process_wall_s=cold["wall"], stage_s=stages,
        no_warm_stage_s=cold["stages"],
        stages_total_s=[sum(c.values()) for c in stages],
        no_warm_stages_total_s=[sum(c.values()) for c in cold["stages"]],
        launches=launches, no_warm_launches=cold["launches"])
    check(same, "the warmed CLI's selections or F1s differ from --no_warm's:"
                f" {summary['classes']} against {cold['summary']['classes']}")
    check(run["warms"] and not any("failed" in w for w in run["warms"])
          and not cold["warms"],
          f"warm log lines: {run['warms']}; with --no_warm {cold['warms']}")
    log(phase="search_cli", dataset="data/synthetic_multiclass",
        epochs=SEARCH_EPOCHS,
        reduced=[f"MPNetm epochs 1000 -> {SEARCH_EPOCHS}"], max_hops=3,
        backend="csr", hidden=HIDDEN, process_wall_s=run["wall"],
        summary=summary,
        classes={k: dict(metapaths=summary["classes"][k]["metapaths"],
                         test_f1=summary["classes"][k]["test_f1"],
                         candidates=len(per_class[k]["discovered"]),
                         stage_s=stages[int(k)],
                         stages_total_s=sum(stages[int(k)].values()))
                 for k in summary["classes"]},
        launches=launches)
    check(launches["csr_scatter"] > 0 and launches["csr_backward_passes"] > 0,
          f"K1 or the csr backward did not launch in the CLI's search: "
          f"{launches}")
    return per_class, launches, stages


def search_check(torch, per_class) -> None:
    """Phase 8 (b): class 0's search in-process, csr batched, csr one
    candidate after another (``batched_eval=False``) and segment, each
    against (a)'s csr run; and two hop-0 sweeps on the card bitwise
    equal."""
    from mpgnn_tpu_torch.config import MPGNNConfig, SearchConfig
    from mpgnn_tpu_torch.graph.io import load_dat_files, split_nodes
    from mpgnn_tpu_torch.search import bags as bagmod
    from mpgnn_tpu_torch.search import find_metapaths, score_relations_flat

    graph, labels, binary = load_dat_files(
        *(os.path.join(SYNTH, f) for f in ("node.dat", "link.dat",
                                           "label.dat")))
    y0 = np.asarray(binary[0], dtype=np.float32)
    cands = bagmod.connected_relations(graph, node_labels=y0)
    sweeps = [score_relations_flat(graph, cands, y0, None,
                                   rng=np.random.default_rng(0),
                                   device="cuda") for _ in range(2)]
    for r in cands:
        check(sweeps[0][r].loss == sweeps[1][r].loss and np.array_equal(
            sweeps[0][r].weights, sweeps[1][r].weights),
            f"hop-0 sweeps differ on relation {r}")
    cfg = SearchConfig(mpgnn=MPGNNConfig(epochs=SEARCH_EPOCHS,
                                         hidden_dim=HIDDEN))
    csr_run = per_class["0"]
    rank_cli = sorted(csr_run["val_f1_by_path"].items(),
                      key=lambda kv: -kv[1])
    top = [v for _, v in rank_cli[: cfg.top_k_final + 1]]
    close = any(abs(a - b) <= PALLAS_F1_ATOL for a, b in zip(top, top[1:]))
    runs = {}
    for tag, backend, batched in (("csr_batched", "csr", True),
                                  ("csr_per_candidate", "csr", False),
                                  ("segment_batched", "segment", True)):
        t0 = time.perf_counter()
        res = find_metapaths(graph, y0, split_nodes(labels), 3, cfg,
                             dataset="synthetic", seed=0, backend=backend,
                             batched_eval=batched, device="cuda")
        wall = time.perf_counter() - t0
        check(res.discovered == csr_run["discovered"],
              f"{tag} discovered {res.discovered}, the CLI "
              f"{csr_run['discovered']}")
        d_val = {p: abs(res.val_f1_by_path[p] - v)
                 for p, v in csr_run["val_f1_by_path"].items()}
        worst = max(d_val, key=d_val.get)
        rank = sorted(res.val_f1_by_path.items(), key=lambda kv: -kv[1])
        runs[tag] = dict(
            wall_s=wall, stage_s=res.stage_s,
            final_eval_s=res.stage_s["final_eval"],
            max_val_f1_diff=d_val[worst], worst_path=worst,
            metapaths=res.metapaths, test_f1=res.test_f1,
            ranking=rank if close else None)
        check(d_val[worst] <= PALLAS_F1_ATOL,
              f"{tag}: val F1 of {worst} off the CLI's by {d_val[worst]}")
        check(close or res.metapaths == csr_run["metapaths"],
              f"{tag} selected {res.metapaths}, the CLI "
              f"{csr_run['metapaths']}")
    weight_grad_forms(torch, "synthetic_multiclass", graph,
                      csr_run["discovered"], split_nodes(labels), 3,
                      cfg.mpgnn, ("bmm", "split", "split", "bmm"))
    log(phase="search_check", dataset="data/synthetic_multiclass", cls=0,
        hop0_sweeps_bitwise_equal=True, candidates=len(csr_run["discovered"]),
        against="the CLI (a), csr batched", val_f1_atol=PALLAS_F1_ATOL,
        metapaths_cli=csr_run["metapaths"], test_f1_cli=csr_run["test_f1"],
        top_within_bound=close, ranking_cli=rank_cli if close else None,
        runs=runs)


def weight_grad_forms(torch, tag, graph, paths, split, num_classes, cfg,
                      order) -> None:
    """The batched evaluation of ``paths`` timed (host clock, synchronised)
    with each form of ``MPNetmStack``'s weight gradient
    (``models/mpgnn.py`` ``SPLIT_ROWS``): 'bmm', one batched product, and
    'split', one product a candidate, in ``order``. The two forms' F1s must
    agree within 3e-2."""
    from mpgnn_tpu_torch.models import mpgnn
    from mpgnn_tpu_torch.train import batch_eval

    default = mpgnn.SPLIT_ROWS
    times = {"bmm": [], "split": []}
    f1s = {}
    try:
        for form in order:
            mpgnn.SPLIT_ROWS = 1 if form == "split" else 1 << 62
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f1s[form] = batch_eval.evaluate_candidates(
                graph, paths, split, num_classes, cfg, device="cuda")
            torch.cuda.synchronize()
            times[form].append(time.perf_counter() - t0)
    finally:
        mpgnn.SPLIT_ROWS = default
    d_val = max(abs(f1s["bmm"][k] - v) for k, v in f1s["split"].items())
    log(phase="weight_grad_forms", graph=tag, nodes=graph.num_nodes,
        candidates=len(paths), epochs=cfg.epochs, split_rows=default,
        default_form="split" if graph.num_nodes >= default else "bmm",
        order=list(order), bmm_s=times["bmm"], split_s=times["split"],
        max_val_f1_diff=d_val)
    check(d_val <= PALLAS_F1_ATOL,
          f"{tag}: the weight gradient's forms part by {d_val} in val F1")


def kg_eval_check(torch, graph, discovered, split, cfg) -> None:
    """The KG final set's evaluation batched against one ``train_mpgnn`` a
    candidate, in this call: validation F1s within 3e-2 and both wall
    times; then device time by kernel over 3 epochs of its largest length
    group (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.train import batch_eval, train_mpgnn
    from mpgnn_tpu_torch.train.loops import split_tensors

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = batch_eval.evaluate_candidates(graph, discovered, split, 2, cfg,
                                             device=dev)
    batched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    each = {str(p): train_mpgnn(graph, [p], split, 2, cfg, device=dev).val_f1
            for p in discovered}
    each_s = time.perf_counter() - t0
    d_val = max(abs(batched[k] - v) for k, v in each.items())
    groups = {}
    for p in discovered:
        groups.setdefault(len(p), []).append(list(p))
    group = max(groups.values(), key=len)
    x = torch.as_tensor(graph.x, device=dev)
    parts = split_tensors(split, dev)[:4]
    three = MPGNNConfig(hidden_dim=cfg.hidden_dim, epochs=3)
    batch_eval.train_chunk(graph, group, x, parts, 2, three, 0, "csr")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch_eval.train_chunk(graph, group, x, parts, 2, three, 0, "csr")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    log(phase="search_kg_eval", candidates=len(discovered),
        epochs=cfg.epochs, batched_s=batched_s, per_candidate_s=each_s,
        max_val_f1_diff=d_val, val_f1_atol=PALLAS_F1_ATOL,
        profiled_group=dict(length=len(group[0]), candidates=len(group),
                            epochs=3),
        wall_ms_per_epoch=wall_us / 3e3, device_ms_per_epoch=busy_us / 3e3,
        device_busy_share=busy_us / wall_us,
        top=[dict(name=k[:80], ms_per_epoch=t / 3e3, launches_per_epoch=c / 3)
             for k, t, c in rows[:10]])
    check(d_val <= PALLAS_F1_ATOL,
          f"KG final set: batched val F1 off the per-candidate one by {d_val}")
    weight_grad_forms(torch, "powerlaw_kg", graph, discovered, split, 2, cfg,
                      ("split", "bmm"))


def stacked_k1(torch, csr, graph, discovered) -> dict:
    """K1 on the stacked blockings that the batched evaluation of the KG's
    final set runs (each length group's K1 relations at each hop after the
    first, forward and backward, F = 64), held against its plain version
    and the per-candidate launches (1e-5), and timed against those
    launches of the same candidates, one after another."""
    from mpgnn_tpu_torch.train.loops import relation_operand

    dev = torch.device("cuda")
    n, f = graph.num_nodes, HIDDEN
    gen = torch.Generator(device=dev).manual_seed(0)
    groups = {}
    for p in discovered:
        groups.setdefault(len(p), []).append(list(p))
    cases = []
    for length, group in sorted(groups.items()):
        for j in range(1, length):
            ops = [relation_operand(graph, p[j], "csr", dev) for p in group]
            ops = [op for op in ops if isinstance(op[1], csr.CsrBlocking)
                   and isinstance(op[2], csr.CsrBlocking)]
            if len(ops) < 2:
                continue
            for d, direction in ((1, "fwd"), (2, "bwd")):
                stacked = csr.stack_blockings(op[d] for op in ops)
                x = torch.randn(len(ops) * n, f, generator=gen, device=dev)
                xs = [x[i * n:(i + 1) * n] for i in range(len(ops))]
                got = csr.csr_scatter(stacked, x)
                each = torch.cat([csr.csr_scatter(op[d], xi)
                                  for op, xi in zip(ops, xs)])
                want = csr.csr_scatter_plain(stacked, x)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(torch.allclose(got, want, **KERNEL_TOL),
                      f"stacked K1 len {length} hop {j} {direction}: max "
                      f"abs err {err} vs plain version")
                check(torch.allclose(got, each, **KERNEL_TOL),
                      f"stacked K1 len {length} hop {j} {direction}: off "
                      f"the per-candidate launches")
                e = int(stacked.col.numel())
                # x's distinct gathered rows read, the output written, the
                # blocking read
                rows_read = int(torch.unique(stacked.col).numel())
                b_ms, _ = bound(4 * (rows_read * f + len(ops) * n * f
                                     + 2 * e + len(ops) * n + 1),
                                2.0 * e * f)
                # the yardstick: one CSR matrix of the same stacked
                # [C * N, C * N] operand
                mat = torch.sparse_csr_tensor(
                    stacked.row_ptr, stacked.col, stacked.weight,
                    size=(stacked.num_rows, stacked.num_cols))
                cases.append(dict(
                    length=length, hop=j, direction=direction,
                    candidates=len(ops), edges=e, max_abs_err=err,
                    ms=cuda_ms(torch, lambda: csr.csr_scatter(stacked, x),
                               20),
                    library_ms=cuda_ms(torch,
                                       lambda: torch.sparse.mm(mat, x), 20),
                    per_candidate_ms=cuda_ms(
                        torch, lambda: [csr.csr_scatter(op[d], xi)
                                        for op, xi in zip(ops, xs)],
                        20, launches=len(ops)),
                    bound_ms=b_ms))
    check(cases, f"the KG final set {discovered} has no hop that stacks two "
                 f"K1 candidates")
    rec = dict(phase="stacked_k1", graph="powerlaw_kg", F=f, cases=cases,
               ms=sum(c["ms"] for c in cases),
               per_candidate_ms=sum(c["per_candidate_ms"] for c in cases),
               library_ms=sum(c["library_ms"] for c in cases),
               launches=len(cases),
               per_candidate_launches=sum(c["candidates"] for c in cases),
               max_abs_err=max(c["max_abs_err"] for c in cases))
    log(**rec)
    return rec


def kg_search(torch, csr, conv, graph, planted, kg):
    """Phase 8 (c): the search on the 200k-node power-law KG, sources the
    labeled subset (examples/run_powerlaw_kg.py), beam 4, 2 extension hops,
    csr, the final evaluation batched, MPNetm cut to KG_SEARCH_EPOCHS
    epochs, its launch counts set to 0 before it and returned; K2 must
    launch where a candidate's relation routes to it. Then K1 on its final
    set's stacked blockings against per-candidate launches, and one restart
    round of a hop-1 state's bag sweep twice from the same seed, bitwise
    equal, the second under torch.profiler. Returns (launches, the stacked
    K1 record)."""
    from torch.profiler import ProfilerActivity, profile

    from mpgnn_tpu_torch.config import (
        MPGNNConfig,
        ScorerConfig,
        SearchConfig,
    )
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.search import bags as bagmod
    from mpgnn_tpu_torch.search import find_metapaths, score_bag_tasks
    from mpgnn_tpu_torch.train.loops import relation_operand

    ln = kg["label_nodes"]
    labels = kg["labels"][ln]
    cfg = SearchConfig(
        max_extension_hops=2, bag_gap_inclusive=True,
        max_extensions_per_state=4,
        mpgnn=MPGNNConfig(hidden_dim=HIDDEN, epochs=KG_SEARCH_EPOCHS,
                          backend="csr"))
    reset_counts(csr, conv)
    t0 = time.perf_counter()
    res = find_metapaths(graph, labels.astype(np.float32),
                         split_nodes(labels, node_idx=ln), 2, cfg,
                         source_nodes=ln, seed=0, device="cuda")
    wall = time.perf_counter() - t0
    launches = read_counts(csr, conv)
    found = planted in [list(p) for p in res.discovered]
    log(phase="search_kg", nodes=graph.num_nodes, edges=graph.num_edges,
        relations=graph.num_relations, labeled=len(ln), planted=planted,
        recovered=found, metapaths=res.metapaths, test_f1=res.test_f1,
        candidates=len(res.discovered), epochs=KG_SEARCH_EPOCHS,
        reduced=[f"MPNetm epochs 1000 -> {KG_SEARCH_EPOCHS}"], wall_s=wall,
        stage_s=res.stage_s, launches=launches)
    check(found, f"planted {planted} not in {res.discovered}")
    check(0.0 <= res.test_f1 <= 1.0, f"KG test F1 {res.test_f1}")
    check(launches["csr_scatter"] > 0 and launches["csr_backward_passes"] > 0,
          f"K1 or the csr backward did not launch in the KG search: "
          f"{launches}")
    hub_candidates = [p for p in res.discovered if any(
        isinstance(b, csr.DedupCsrBlocking)
        for r in p for b in relation_operand(
            graph, r, "csr", torch.device("cuda"))[1:])]
    log(phase="search_kg_k2", hub_candidates=hub_candidates,
        csr_dedup=launches["csr_dedup"])
    check(not hub_candidates or launches["csr_dedup"] > 0,
          f"K2 did not launch for the hub candidates {hub_candidates}")
    stacked = stacked_k1(torch, csr, graph, res.discovered)
    kg_eval_check(torch, graph, res.discovered,
                  split_nodes(labels, node_idx=ln), cfg.mpgnn)

    # one bag restart round of the planted path's hop-1 state
    node_labels = np.zeros(graph.num_nodes, np.float32)
    node_labels[ln] = labels
    ed, dd = bagmod.build_dictionaries(graph, planted[-1], ln, node_labels)
    bag_list, bag_labels = bagmod.create_bags(ed, dd)
    members = sorted(set(m for b in bag_list for m in b))
    tasks = [(0, bagmod.connected_relations(graph, bag_members=members),
              bag_list, bag_labels)]
    one = ScorerConfig(max_restarts=1)
    first = score_bag_tasks(graph, tasks, one, np.random.default_rng(0),
                            device="cuda")[0]
    torch.cuda.synchronize()
    stats = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        second = score_bag_tasks(graph, tasks, one, np.random.default_rng(0),
                                 stats=stats, device="cuda")[0]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(first.keys() == second.keys(), "bag rounds scored other relations")
    for r, a in first.items():
        b = second[r]
        check(a.loss == b.loss and a.degenerate == b.degenerate
              and a.num_restarts == b.num_restarts
              and all(np.array_equal(getattr(a, f), getattr(b, f))
                      for f in ("weights", "attribution", "member_pred_max",
                                "member_recorded")),
              f"two KG bag restart rounds differ on relation {r}")
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    log(phase="search_profile", graph="powerlaw_kg",
        state=[planted[-1]], instances=len(tasks[0][1]),
        bags=len(bag_list), chunks=[dict((k, s[k]) for k in (
            "mode", "R", "E", "C", "B", "M", "P")) for s in stats],
        epochs=one.epochs_bags, wall_ms=wall_us / 1e3,
        device_ms=busy_us / 1e3, device_busy_share=busy_us / wall_us,
        repeat_bitwise_equal=True,
        top=[dict(name=k[:80], ms=t / 1e3, launches=c)
             for k, t, c in rows[:10]])
    return launches, stacked


# ------------------------------------------- 'auto' routing and new kinds
# auto_routing times whole train_mpgnn runs, set-up included, at the
# search's epochs; the reference's 1000 are extrapolated from each run
# (its set-up plus 1000 epochs at its measured epoch time), so that the
# phase stays short.
ROUTING_EPOCHS = SEARCH_EPOCHS
REFERENCE_EPOCHS = 1000
ROUTING_NODES = 200_000
ROUTING_EDGES = (10_000, 100_000, 1_000_000, 10_000_000)
DENSE_NODES = (8_192, 16_384, 24_576, 32_768)
# the new kinds against segment on the card: forwards and first-step
# gradients, float32 sums in other orders
BACKENDS_ATOL = 1e-5
# the batched 'dense' evaluation (bf16 A and h) against float32 dense one
# candidate at a time: the JAX package's own dense-vs-segment bound
# (tests/test_train.py test_batched_eval_dense_matches_segment)
DENSE_EVAL_F1_ATOL = 8e-2


def random_relation(n, e, seed):
    """(x [n, 16], src, dst, type) of one relation of e uniform random
    edges over n nodes, and random binary labels, from a numpy seed."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(n, 16)).astype(np.float32),
              rng.integers(0, n, e), rng.integers(0, n, e),
              np.zeros(e, np.int64))
    return arrays, rng.integers(0, 2, n)


def auto_routing(torch, HeteroGraph, graph_s, split_s) -> dict:
    """Whole ``train_mpgnn`` runs (hidden 64, dropout 0.6, seed 0), each
    on a graph made anew so that its operands' build counts: segment
    against csr on one uniform relation of ``ROUTING_NODES`` nodes at each
    of ``ROUTING_EDGES`` edges (metapath [0, 0]), and dense against csr and
    segment on ``data/synthetic_multiclass`` (N = 5,000, its two metapaths)
    and one random relation of 10 N edges at each of ``DENSE_NODES``. Logs
    each run's set-up s, epoch ms and total s at ``ROUTING_EPOCHS`` and
    extrapolated to ``REFERENCE_EPOCHS``, what the readings say of the two
    constants, and the constants in use. It runs after ``backends_phase``,
    which has run every backend once in the process."""
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.train import loops

    rows = []

    def race(tag, arrays, metapaths, split, c, backends, turns, **extra):
        """Each backend's run ``turns`` times, in the order given and then
        reversed (a, b, b, a); each reading is the mean of its runs."""
        runs = {b: [] for b in backends}
        order = list(backends)
        for turn in range(turns):
            for b in (order if turn % 2 == 0 else order[::-1]):
                graph = HeteroGraph(*arrays,
                                    num_relations=int(arrays[3].max()) + 1)
                rec = train_run(torch, tag, graph, metapaths, split, c,
                                ROUTING_EPOCHS, b, phase="auto_routing_run")
                runs[b].append(dict(
                    setup_s=rec["setup_s"], epoch_ms=rec["epoch_ms"],
                    total_s=rec["wall_s"],
                    reference_s=rec["setup_s"]
                    + REFERENCE_EPOCHS * rec["epoch_ms"] / 1e3))
                del graph
                torch.cuda.empty_cache()
        runs = {b: {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}
                | {"turns": rs} for b, rs in runs.items()}
        for key in ("total_s", "reference_s"):
            extra[f"fastest_{key}"] = min(runs, key=lambda b: runs[b][key])
        rows.append(dict(graph=tag, runs=runs, **extra))

    for e in ROUTING_EDGES:
        arrays, labels = random_relation(ROUTING_NODES, e, 1)
        race(f"uniform, {e} edges", arrays, [[0, 0]], split_nodes(labels), 2,
             ("segment", "csr"), 1 if e >= 10 ** 6 else 2,
             nodes=ROUTING_NODES, edges=e)
        del arrays
    race("synthetic_multiclass", (graph_s.x, graph_s.edge_src,
                                   graph_s.edge_dst, graph_s.edge_type),
         SYNTH_PATHS, split_s, 3, ("dense", "csr", "segment"), 2,
         nodes=graph_s.num_nodes,
         dense_bytes=2 * 4 * graph_s.num_nodes ** 2 * 4)
    for n in DENSE_NODES:
        arrays, labels = random_relation(n, 10 * n, 2)
        race(f"random, {n} nodes", arrays, [[0, 0]], split_nodes(labels), 2,
             ("dense", "csr", "segment"), 2, nodes=n, edges=10 * n,
             dense_bytes=2 * n * n * 4)
    readings = {}
    for key in ("total_s", "reference_s"):
        csr_wins = [r["edges"] for r in rows if "dense_bytes" not in r
                    and r[f"fastest_{key}"] == "csr"]
        dense_wins = [r["dense_bytes"] for r in rows if "dense_bytes" in r
                      and r[f"fastest_{key}"] == "dense"]
        readings[key] = dict(csr_fastest_at_edges=csr_wins,
                             dense_fastest_at_bytes=dense_wins)
    rec = dict(phase="auto_routing", epochs=ROUTING_EPOCHS,
               reference_epochs=REFERENCE_EPOCHS,
               reference_extrapolated=True, hidden=HIDDEN, rows=rows,
               readings=readings,
               constants=dict(
                   CSR_EDGE_CUTOVER=loops.CSR_EDGE_CUTOVER,
                   AUTO_DENSE_BUDGET_BYTES=loops.AUTO_DENSE_BUDGET_BYTES,
                   AUTO_DENSE_FREE_FRACTION=loops.AUTO_DENSE_FREE_FRACTION,
                   card_budget_bytes=loops.auto_dense_budget_bytes("cuda")))
    log(**rec)
    return rec


def backends_phase(torch, csr, conv, graph_s, split_s, graph_u, split_u):
    """The new single-model kinds on the card: for 'ell', 'ell2', 'dense'
    and 'onehot', the forward of seeded parameters on
    ``data/synthetic_multiclass`` (hidden 64, its two metapaths) and the
    first step's gradient of every parameter, each against 'segment'
    within ``BACKENDS_ATOL``. Then one ``train_mpgnn(backend='auto')`` on
    the uniform graph, counted from 0: it must resolve as
    ``resolve_backend`` says for the card (csr where 2.5M edges reach
    ``CSR_EDGE_CUTOVER``) and launch K1 when it resolves to csr; and one
    batched ``evaluate_candidates(backend='auto')`` there (two length
    groups, 5 epochs), counted from 0, which must launch K1 where
    ``resolve_eval_backend`` says csr."""
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.models.mpgnn import init_mpgnn
    from mpgnn_tpu_torch.train import build_hop_arrays, loops, train_mpgnn
    from mpgnn_tpu_torch.train.batch_eval import (
        evaluate_candidates,
        resolve_eval_backend,
    )

    dev = torch.device("cuda")
    model = init_mpgnn(graph_s.feat_dim, HIDDEN, 3, SYNTH_PATHS, device=dev)
    x = torch.as_tensor(graph_s.x, device=dev)

    def forward(kind):
        with torch.no_grad():
            return model(x, build_hop_arrays(graph_s, SYNTH_PATHS, kind, dev))

    want = forward("segment")
    want_grads = first_step_grads(torch, graph_s, SYNTH_PATHS, split_s, 3,
                                  "segment", dev)
    kinds = {}
    for kind in ("ell", "ell2", "dense", "onehot"):
        got = forward(kind)
        grads = first_step_grads(torch, graph_s, SYNTH_PATHS, split_s, 3,
                                 kind, dev)
        kinds[kind] = dict(
            forward_max_abs_err=float((got - want).abs().max()),
            grad_max_abs_err=max(float((grads[k] - w).abs().max())
                                 for k, w in want_grads.items()))
    uni_edges = int(graph_u.rel_counts[[0, 1]].max())
    want_route = loops.resolve_backend(
        "auto", graph_u, [[0, 1]], loops.auto_dense_budget_bytes(dev))
    reset_counts(csr, conv)
    t0 = time.perf_counter()
    res = train_mpgnn(graph_u, [[0, 1]], split_u, 2,
                      MPGNNConfig(epochs=5, hidden_dim=HIDDEN),
                      backend="auto", device=dev)
    auto_s = time.perf_counter() - t0
    launches = read_counts(csr, conv)
    log(phase="backends", graph="synthetic_multiclass", atol=BACKENDS_ATOL,
        against="segment on the card", kinds=kinds,
        uniform_auto=dict(edges_per_relation=uni_edges,
                          cutover=loops.CSR_EDGE_CUTOVER, route=want_route,
                          epochs=5, wall_s=auto_s,
                          final_loss=res.final_loss, launches=launches))
    for kind, r in kinds.items():
        check(r["forward_max_abs_err"] <= BACKENDS_ATOL
              and r["grad_max_abs_err"] <= BACKENDS_ATOL,
              f"{kind} against segment on the card: {r}")
    check(want_route == ("csr" if uni_edges >= loops.CSR_EDGE_CUTOVER
                         else "segment"),
          f"'auto' on the uniform graph resolved to {want_route}")
    check(np.isfinite(res.final_loss), "'auto' on the uniform graph: loss")
    if want_route == "csr":
        check(launches["csr_scatter"] > 0
              and launches["csr_backward_passes"] > 0,
              f"'auto' resolved to csr but K1 did not launch: {launches}")
    else:
        check(launches["csr_scatter"] == 0,
              f"'auto' resolved to {want_route} but K1 launched")
    # the batched evaluation under 'auto' on the same graph: two length
    # groups, routed as resolve_eval_backend says, K1 where that is csr
    paths = [[0], [1], [0, 1], [1, 0]]
    eval_route = resolve_eval_backend("auto", None, graph_u, paths)
    reset_counts(csr, conv)
    t0 = time.perf_counter()
    f1s = evaluate_candidates(graph_u, paths, split_u, 2,
                              MPGNNConfig(epochs=5, hidden_dim=HIDDEN),
                              backend="auto", device=dev)
    eval_launches = read_counts(csr, conv)
    log(phase="backends_eval_auto", graph="uniform", paths=paths,
        route=eval_route, epochs=5, wall_s=time.perf_counter() - t0,
        val_f1=f1s, launches=eval_launches)
    check(sorted(f1s) == sorted(str(p) for p in paths)
          and all(np.isfinite(v) for v in f1s.values()),
          f"'auto' batched evaluation on the uniform graph: {f1s}")
    check((eval_launches["csr_scatter"] > 0) == (eval_route == "csr"),
          f"'auto' evaluation routed to {eval_route}, launches "
          f"{eval_launches}")
    torch.cuda.empty_cache()


def search_auto(cli_stages) -> dict:
    """Phase 8 (d): the README's line with no ``--backend`` (so 'auto'), in
    a child process, with each class's stage times beside (a)'s under csr
    and the backends 'auto' resolved to; then the same line with the final
    evaluation's resolved backend named, which must discover the same
    candidates with validation F1s within ``PALLAS_F1_ATOL`` and select the
    same metapaths (unless two of the top candidates lie within it).
    Returns the auto run's launches."""
    auto = cli_search(SEARCH_LINE)
    evals = sorted({k.split(":")[1] for k in auto["resolved"]
                    if k.startswith("final_eval:")})
    check(len(evals) == 1, f"'auto' evaluated with {evals}")
    named = cli_search(SEARCH_LINE + ["--backend", evals[0]])
    classes = {}
    for k in auto["summary"]["classes"]:
        a, b = auto["per_class"][k], named["per_class"][k]
        check(a["discovered"] == b["discovered"],
              f"class {k}: 'auto' discovered {a['discovered']}, "
              f"--backend {evals[0]} {b['discovered']}")
        d_val = max(abs(a["val_f1_by_path"][p] - v)
                    for p, v in b["val_f1_by_path"].items())
        top = sorted(b["val_f1_by_path"].values(), reverse=True)[:4]
        close = any(x - y <= PALLAS_F1_ATOL for x, y in zip(top, top[1:]))
        classes[k] = dict(
            metapaths=a["metapaths"], named_metapaths=b["metapaths"],
            test_f1=a["test_f1"], named_test_f1=b["test_f1"],
            max_val_f1_diff=d_val, top_within_bound=close,
            stage_s=auto["stages"][int(k)],
            csr_stage_s=cli_stages[int(k)],
            named_stage_s=named["stages"][int(k)])
        check(d_val <= PALLAS_F1_ATOL,
              f"class {k}: 'auto' val F1 off --backend {evals[0]} by {d_val}")
        check(close or a["metapaths"] == b["metapaths"],
              f"class {k}: 'auto' selected {a['metapaths']}, --backend "
              f"{evals[0]} {b['metapaths']}")
    log(phase="search_auto", dataset="data/synthetic_multiclass",
        epochs=SEARCH_EPOCHS, resolved=auto["resolved"],
        named_backend=evals[0], named_resolved=named["resolved"],
        process_wall_s=auto["wall"], named_process_wall_s=named["wall"],
        classes=classes, launches=auto["launches"],
        named_launches=named["launches"])
    return auto["launches"]


def grouped_k4(torch, conv, graph, discovered) -> dict:
    """K4 on the grouped products of the batched 'dense' evaluation of
    ``discovered`` (each length group one chunk; at each hop, each
    relation's candidates side by side, [N, G * F], F the input width at
    hop 0 and 64 after it), over ``a`` and ``a_t``: against its plain
    version (1e-5) and bitwise against a second launch; the widest product
    after hop 0 timed (L2 flushed, as an epoch finds A) beside its bound,
    its plain version and cuBLAS on the same bf16 operands."""
    from mpgnn_tpu_torch.train.loops import relation_operand

    dev = torch.device("cuda")
    n = graph.num_nodes
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = set()
    groups = {}
    for p in discovered:
        groups.setdefault(len(p), []).append(list(p))
    for group in groups.values():
        for j in range(len(group[0])):
            members = {}
            for p in group:
                members[p[j]] = members.get(p[j], 0) + 1
            f = graph.feat_dim if j == 0 else HIDDEN
            shapes.update((r, g * f) for r, g in members.items())
    err = 0.0
    for r, width in sorted(shapes):
        op = relation_operand(graph, r, "pallas", dev)[1]
        x = torch.randn(n, width, generator=gen, device=dev)
        for a in (op.a, op.a_t):
            got, again = conv.dense_matmul(a, x), conv.dense_matmul(a, x)
            want = conv.dense_matmul_plain(a, x)
            torch.cuda.synchronize()
            check(torch.allclose(got, want, **KERNEL_TOL),
                  f"grouped K4 rel {r} width {width}: max abs err "
                  f"{float((got - want).abs().max())} vs plain version")
            check(torch.equal(got, again),
                  f"grouped K4 rel {r} width {width}: a second launch differs")
            err = max(err, float((got - want).abs().max()))
    r, width = max(shapes, key=lambda rw: rw[1])
    op = relation_operand(graph, r, "pallas", dev)[1]
    x = torch.randn(n, width, generator=gen, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    b_ms, b_by = bound(2.0 * n * n + 8.0 * n * width, 0.0,
                       2.0 * n * n * width)
    rec = dict(
        phase="grouped_k4", graph="synthetic_multiclass", N=n,
        products=len(shapes) * 2, widths=sorted(w for _, w in shapes),
        max_abs_err=err, bitwise_repeat=True, relation=r, width=width,
        launches_per_product=-(-width // conv.MAX_WIDTH),
        ms=cuda_ms_cold(torch, lambda: conv.dense_matmul(op.a, x), 20, flush),
        plain_ms=cuda_ms(torch, lambda: conv.dense_matmul_plain(op.a, x), 3),
        library_ms=cuda_ms_cold(torch, lambda: torch.mm(op.a, x.bfloat16()),
                                20, flush),
        bound_ms=b_ms, bound_by=b_by)
    del flush
    log(**rec)
    return rec


def search_dense(torch, csr, conv, per_class) -> tuple:
    """Phase 8 (e): class 0 of ``data/synthetic_multiclass`` with
    ``backend='dense'`` (the batched evaluation on K4's grouped products),
    its launch counts set to 0 before it and read after it (K4 must have
    launched), against one float32 dense ``train_mpgnn`` a candidate: the
    same candidates as (a), validation F1s within ``DENSE_EVAL_F1_ATOL``.
    Then K4 on its grouped products (``grouped_k4``). Returns (launches,
    the grouped K4 record)."""
    from mpgnn_tpu_torch.config import MPGNNConfig, SearchConfig
    from mpgnn_tpu_torch.graph.io import load_dat_files, split_nodes
    from mpgnn_tpu_torch.search import find_metapaths
    from mpgnn_tpu_torch.train import train_mpgnn

    graph, labels, binary = load_dat_files(
        *(os.path.join(SYNTH, f) for f in ("node.dat", "link.dat",
                                           "label.dat")))
    split = split_nodes(labels)
    cfg = SearchConfig(mpgnn=MPGNNConfig(epochs=SEARCH_EPOCHS,
                                         hidden_dim=HIDDEN))
    reset_counts(csr, conv)
    t0 = time.perf_counter()
    res = find_metapaths(graph, np.asarray(binary[0], dtype=np.float32),
                         split, 3, cfg, dataset="synthetic", seed=0,
                         backend="dense", device="cuda")
    wall = time.perf_counter() - t0
    launches = read_counts(csr, conv)
    check(res.discovered == per_class["0"]["discovered"],
          f"dense discovered {res.discovered}, the CLI "
          f"{per_class['0']['discovered']}")
    check(launches["dense_matmul"] > 0,
          f"K4 did not launch in the dense search: {launches}")
    t0 = time.perf_counter()
    each = {str(p): train_mpgnn(graph, [p], split, 3, cfg.mpgnn, seed=0,
                                backend="dense", device="cuda").val_f1
            for p in res.discovered}
    each_s = time.perf_counter() - t0
    d_val = {p: abs(res.val_f1_by_path[p] - v) for p, v in each.items()}
    worst = max(d_val, key=d_val.get)
    grouped = grouped_k4(torch, conv, graph, res.discovered)
    log(phase="search_dense", dataset="data/synthetic_multiclass", cls=0,
        epochs=SEARCH_EPOCHS, candidates=len(res.discovered), wall_s=wall,
        stage_s=res.stage_s, per_candidate_f32_s=each_s,
        max_val_f1_diff=d_val[worst], worst_path=worst,
        val_f1_atol=DENSE_EVAL_F1_ATOL, metapaths=res.metapaths,
        test_f1=res.test_f1, launches=launches)
    check(d_val[worst] <= DENSE_EVAL_F1_ATOL,
          f"dense batched val F1 of {worst} off the float32 per-candidate "
          f"one by {d_val[worst]}")
    return launches, grouped


def search_phase(torch, csr, conv, graph_k, planted, kg):
    """Phase 8: (a) to (e). The searches (a), (c), (d) and (e) each count
    their own launches from 0; (a) and (c) must launch K1 and the csr
    backward, (e) K4. Returns (their sum, the stacked K1 record, the
    grouped K4 record)."""
    per_class, cli, cli_stages = search_cli_run()
    search_check(torch, per_class)
    kg_launches, stacked = kg_search(torch, csr, conv, graph_k, planted, kg)
    auto_launches = search_auto(cli_stages)
    dense_launches, grouped = search_dense(torch, csr, conv, per_class)
    launches = {k: cli[k] + kg_launches[k] + auto_launches[k]
                + dense_launches[k] for k in cli}
    log(phase="search_launches", cli=cli, kg=kg_launches,
        auto=auto_launches, dense=dense_launches, **launches)
    return launches, stacked, grouped


# 7 (f), mixed precision. The bf16 forms of K1 and K2 sum float32 and round
# once a row, their plain versions float64: the two can round to
# neighbouring bf16 values, one unit in the last place (2^-7 of a value at
# most).
MP_KERNEL_TOL = dict(rtol=2 ** -7, atol=1e-6)
# bf16 against float32 training, the same seed and dropout masks: bf16
# rounds every activation (2^-8 of a value), which moves the trajectory.
# On the uniform graph's random labels both runs sit at chance; on the KG
# and the synthetic graph both learn the planted labels. Bounds on the gap
# of the final loss and of the validation macro-F1.
MP_LOSS_GAP = 5e-2
MP_F1_GAP = 5e-2
MP_SYNTH_EPOCHS = 300


def mp_kernel_cases(torch, csr, graph_u, graph_k, rels_k, rel_p):
    """The blockings of phase 2's shapes for the bf16 forms: (kernel,
    direction, graph, relation, blocking, the CSR matrix of the yardstick,
    gathered columns, F)."""
    from mpgnn_tpu_torch.train.loops import relation_operand

    dev = torch.device("cuda")
    _, fwd_u, _ = relation_operand(graph_u, 0, "csr", dev)
    _, _, bwd_u = relation_operand(graph_u, 1, "csr", dev)
    s_p, d_p = graph_k.rel_edges(rel_p)
    fwd_p, bwd_p = (b.to(dev) for b in csr.build_csr_blocking(
        s_p, d_p, graph_k.num_nodes))
    s_k, d_k = graph_k.rel_edges(rels_k[0])
    s_k1, d_k1 = graph_k.rel_edges(rels_k[1])
    fwd_k = csr.build_csr_blocking(s_k, d_k, graph_k.num_nodes)[0].to(dev)
    bwd_k = csr.build_csr_blocking(s_k1, d_k1, graph_k.num_nodes)[1].to(dev)
    mat_k = csr.build_csr_blocking(s_k, d_k, graph_k.num_nodes,
                                   dedup="never")[0].to(dev)
    mat_k1 = csr.build_csr_blocking(s_k1, d_k1, graph_k.num_nodes,
                                    dedup="never")[1].to(dev)
    s_u, d_u = graph_u.rel_edges(0)
    s_u1, _ = graph_u.rel_edges(1)
    cases = [("csr_scatter", "fwd", "uniform", 0, fwd_u, fwd_u, d_u, f)
             for f in (16, 64)]
    cases += [("csr_scatter", "bwd", "uniform", 1, bwd_u, bwd_u, s_u1, 64)]
    cases += [("csr_scatter", "fwd", "powerlaw_kg", rel_p, fwd_p, fwd_p, d_p,
               f) for f in (1, 4, 64, 65)]
    cases += [("csr_scatter", "bwd", "powerlaw_kg", rel_p, bwd_p, bwd_p, s_p,
               64)]
    cases += [("csr_dedup", "fwd", "powerlaw_kg", rels_k[0], fwd_k, mat_k,
               d_k, f) for f in (4, 16, 64)]
    cases += [("csr_dedup", "bwd", "powerlaw_kg", rels_k[1], bwd_k, mat_k1,
               s_k1, 64)]
    return cases


def sparse_yardstick(torch, blk, x):
    """(one ``torch.sparse.mm`` call on x's CSR matrix, its name): bf16
    where the library takes it, else the float32 call on the cast input."""
    mat = torch.sparse_csr_tensor(blk.row_ptr, blk.col, blk.weight,
                                  size=(blk.num_rows, blk.num_cols))
    try:
        mat16 = mat.to(torch.bfloat16)
        torch.sparse.mm(mat16, x)
        torch.cuda.synchronize()
        return (lambda: torch.sparse.mm(mat16, x)), "torch.sparse.mm bf16"
    except RuntimeError:
        xf = x.float()
        return ((lambda: torch.sparse.mm(mat, xf)),
                "torch.sparse.mm float32 on the cast input")


def mp_csr_kernels(torch, csr, cases) -> list:
    """K1's and K2's bf16 forms against their plain versions (one ulp) and
    a second launch (bitwise), timed beside the cast route (the JAX
    package's: cast to float32, the float32 kernel, cast back), the
    float32 form alone, the bound at bf16 row widths, the plain version
    and the library call."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    recs = []
    for name, direction, tag, rel, blk, mat_blk, cols, f in cases:
        kernel = csr.csr_dedup if name == "csr_dedup" else csr.csr_scatter
        plain = (csr.csr_dedup_plain if name == "csr_dedup"
                 else csr.csr_scatter_plain)
        label = f"{name} bf16 {direction} {tag} rel {rel} F={f}"
        x = torch.randn(blk.num_cols, f, generator=gen,
                        device=dev).bfloat16()
        xf = x.float()
        got, again = kernel(blk, x), kernel(blk, x)
        want = plain(blk, x)
        cast = kernel(blk, xf).bfloat16()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(got.dtype == torch.bfloat16, f"{label}: out {got.dtype}")
        check(bool(torch.isfinite(got.float()).all()), f"{label}: non-finite")
        check(torch.allclose(got.float(), want.float(), **MP_KERNEL_TOL),
              f"{label}: max abs err {err} vs plain version")
        check(torch.allclose(cast.float(), want.float(), **MP_KERNEL_TOL),
              f"{label}: the cast route off the plain version")
        check(torch.equal(got, again), f"{label}: a second launch differs")
        lib, lib_name = sparse_yardstick(torch, mat_blk, x)
        e = len(cols)
        rows_read = len(np.unique(cols))
        index_bytes = 4 * sum(t.numel() for _, t in blk.tensors())
        b_ms, b_by = bound(2 * rows_read * f + index_bytes
                           + 2 * blk.num_rows * f, 2.0 * e * f)
        rec = dict(
            kernel=name + "_bf16", direction=direction, graph=tag,
            relation=rel, F=f, edges=e, rows=blk.num_rows,
            vec=csr.row_vec(x), max_abs_err=err, bitwise_repeat=True,
            cast_route_max_abs_err=float(
                (cast.float() - want.float()).abs().max()),
            ms=cuda_ms(torch, lambda: kernel(blk, x), 50),
            cast_route_ms=cuda_ms(torch,
                                  lambda: kernel(blk, x.float()).bfloat16(),
                                  50, launches=3),
            f32_form_ms=cuda_ms(torch, lambda: kernel(blk, xf), 50),
            plain_ms=cuda_ms(torch, lambda: plain(blk, x), 5),
            library_ms=cuda_ms(torch, lib, 20), library_call=lib_name,
            bound_ms=b_ms, bound_by=b_by)
        rec["faster_route"] = ("bf16" if rec["ms"] <= rec["cast_route_ms"]
                               else "cast")
        log(phase="mixed_precision_kernels", **rec)
        recs.append(rec)
    return recs


def mp_conv_kernel(torch, conv, graph_s) -> list:
    """K3 with a bf16 h against its plain version (1e-5: float32 out over
    the same bf16 operands) and a second launch, at N = 5,000 (synthetic
    relation 1, F = 2 and 64) and N = 32,768 (F = 64), timed with the L2
    flushed beside the cast route (K3's float32 form on float32(h), the
    same result), the plain version, the bound and cuBLAS on the same bf16
    operands plus the epilogue in torch."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    s, d = graph_s.rel_edges(1)
    rng = np.random.default_rng(1)
    big_n = 32_768
    recs = []
    for tag, f in (("synthetic_multiclass rel 1", 2),
                   ("synthetic_multiclass rel 1", 64),
                   ("random N=32768", 64)):
        op = (conv.build_dense_conv_operand(s, d, graph_s.num_nodes, dev)
              if tag.startswith("synthetic") else
              conv.build_dense_conv_operand(rng.integers(0, big_n, 10 * big_n),
                                            rng.integers(0, big_n, 10 * big_n),
                                            big_n, dev))
        n = op.num_rows
        h = torch.randn(n, f, generator=gen, device=dev).bfloat16()
        w = torch.randn(f, HIDDEN, generator=gen, device=dev) / f ** 0.5
        root = torch.randn(f, HIDDEN, generator=gen, device=dev) / f ** 0.5
        b = 0.1 * torch.randn(HIDDEN, generator=gen, device=dev)
        out, agg = conv.dense_conv_fwd(op.a, h, w, root, b)
        again = conv.dense_conv_fwd(op.a, h, w, root, b)
        want_out, want_agg = conv.dense_conv_plain(op.a, h, w, root, b)
        cast_out, _ = conv.dense_conv_fwd(op.a, h.float(), w, root, b)
        torch.cuda.synchronize()
        label = f"dense_conv bf16 h {tag} F={f}"
        check(out.dtype == agg.dtype == torch.float32, f"{label}: dtype")
        check(torch.equal(out, again[0]) and torch.equal(agg, again[1]),
              f"{label}: a second launch differs")
        err = max(float((out - want_out).abs().max()),
                  float((agg - want_agg).abs().max()))
        check(torch.allclose(out, want_out, **KERNEL_TOL)
              and torch.allclose(agg, want_agg, **KERNEL_TOL),
              f"{label}: max abs err {err} vs plain version")
        check(torch.equal(cast_out, out), f"{label}: the cast route differs")

        def lib():
            a_h = torch.mm(op.a, h).float()
            return torch.relu(a_h @ w + h.float() @ root + b)

        lib_err = float((lib() - want_out).abs().max())
        check(lib_err < 5e-2, f"{label}: cuBLAS yardstick off by {lib_err}")
        b_ms, b_by = bound(2.0 * n * n + 2.0 * n * f
                           + 4.0 * (n * f + n * HIDDEN + 2 * f * HIDDEN
                                    + HIDDEN),
                           4.0 * n * f * HIDDEN, 2.0 * n * n * f)
        rec = dict(
            kernel="dense_conv_bf16h", graph=tag, N=n, F=f, H=HIDDEN,
            max_abs_err=err, bitwise_repeat=True, library_max_abs_err=lib_err,
            ms=cuda_ms_cold(torch, lambda: conv.dense_conv_fwd(
                op.a, h, w, root, b), 20, flush),
            cast_route_ms=cuda_ms_cold(torch, lambda: conv.dense_conv_fwd(
                op.a, h.float(), w, root, b), 20, flush),
            plain_ms=cuda_ms(torch, lambda: conv.dense_conv_plain(
                op.a, h, w, root, b), 3),
            library_ms=cuda_ms_cold(torch, lib, 20, flush),
            library_call="torch.mm bf16 + epilogue", bound_ms=b_ms,
            bound_by=b_by)
        log(phase="mixed_precision_kernels", **rec)
        recs.append(rec)
        del op
    del flush
    torch.cuda.empty_cache()
    return recs


def mp_train(torch, csr, conv, graph_u, split_u, graph_k, split_k,
             graph_s, split_s, planted, largest) -> tuple:
    """(b) ``train_mpgnn`` in bf16 against float32, the same seed: the
    uniform graph, [0, 1], 100 epochs, csr and segment; the KG, the serving
    metapaths, 20 epochs, csr (K2 on its hubs); float32, bf16, bf16,
    float32 for each. (c) ``data/synthetic_multiclass``, 'pallas', bf16,
    with ``num_bases=2`` and with ``num_blocks=2``, each against 'segment'
    in the same config, ``MP_SYNTH_EPOCHS`` epochs. Counted from 0 over
    (b) and (c): the bf16 forms must launch where the route says bf16, K3
    with a bf16 h in (c). Returns (launches, records)."""
    reset_counts(csr, conv)
    recs = []
    for tag, graph, paths, split, c, epochs, backends in (
            ("uniform", graph_u, [[0, 1]], split_u, 2, 100,
             ("csr", "segment")),
            ("powerlaw_kg", graph_k, [planted, largest], split_k, 2, 20,
             ("csr",))):
        for backend in backends:
            runs = {dt: [] for dt in ("float32", "bfloat16")}
            for dt in ("float32", "bfloat16", "bfloat16", "float32"):
                runs[dt].append(train_run(torch, tag, graph, paths, split, c,
                                          epochs, backend,
                                          phase="mixed_precision_train",
                                          compute_dtype=dt))
            f32, bf = runs["float32"][0], runs["bfloat16"][0]
            rec = dict(graph=tag, backend=backend, epochs=epochs,
                       f32_epoch_ms=[r["epoch_ms"] for r in runs["float32"]],
                       bf16_epoch_ms=[r["epoch_ms"]
                                      for r in runs["bfloat16"]],
                       loss_gap=abs(f32["final_loss"] - bf["final_loss"]),
                       val_f1_gap=abs(f32["val_f1"] - bf["val_f1"]),
                       f32_val_f1=f32["val_f1"], bf16_val_f1=bf["val_f1"])
            log(phase="mixed_precision_check", **rec)
            check(rec["loss_gap"] <= MP_LOSS_GAP and
                  rec["val_f1_gap"] <= MP_F1_GAP,
                  f"{tag}/{backend}: bf16 against float32 {rec}")
            recs.append(rec)
            if tag == "uniform" and backend == "csr":
                # where the bf16 epoch's time goes, beside the float32 one
                for dt, key in (("float32", "f32_epoch_ms"),
                                ("bfloat16", "bf16_epoch_ms")):
                    train_profile(torch, tag, graph, paths, split, c,
                                  backend, float(np.mean(rec[key])),
                                  compute_dtype=dt)
    for kw in (dict(num_bases=2), dict(num_blocks=2)):
        runs = {b: train_run(torch, "synthetic_multiclass", graph_s,
                             SYNTH_PATHS, split_s, 3, MP_SYNTH_EPOCHS, b,
                             phase="mixed_precision_train",
                             compute_dtype="bfloat16", **kw)
                for b in ("pallas", "segment")}
        rec = dict(graph="synthetic_multiclass", compute_dtype="bfloat16",
                   **kw, epochs=MP_SYNTH_EPOCHS,
                   pallas_epoch_ms=runs["pallas"]["epoch_ms"],
                   segment_epoch_ms=runs["segment"]["epoch_ms"],
                   loss_gap=abs(runs["pallas"]["final_loss"]
                                - runs["segment"]["final_loss"]),
                   test_f1=[runs[b]["test_f1"] for b in ("pallas",
                                                         "segment")])
        log(phase="mixed_precision_check", **rec)
        check(rec["loss_gap"] <= PALLAS_LOSS_ATOL
              and abs(rec["test_f1"][0] - rec["test_f1"][1])
              <= PALLAS_F1_ATOL and min(rec["test_f1"]) > 0.9,
              f"decomposed pallas bf16 against segment: {rec}")
        recs.append(rec)
    launches = read_counts(csr, conv)
    log(phase="mixed_precision_launches", **launches)
    check(all(launches[k] > 0 for k in ("csr_scatter_bf16",
                                        "csr_dedup_bf16")),
          f"a bf16 form did not launch on the bf16 csr runs: {launches}")
    check(launches["dense_conv_bf16h"] > 0 and launches["dense_conv"] > 0
          and launches["dense_matmul"] > 0,
          f"K3/K4 did not launch on the bf16 pallas runs: {launches}")
    return launches, recs


def mp_baseline_cli() -> dict:
    """(d) ``python -m mpgnn_tpu_torch.rgcn_baseline`` on
    ``data/synthetic_multiclass`` at hidden 64 (its other flags the
    defaults: 3 layers, 1000 epochs), in a child process: its F1s and its
    epoch time from its log line."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "mpgnn_tpu_torch.rgcn_baseline", "--folder",
         SYNTH, "--hidden_dim", str(HIDDEN)], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"rgcn_baseline CLI failed:\n"
                               f"{out.stderr[-3000:]}")
    line = out.stdout.strip().splitlines()[-1].split()
    f1 = dict(train=float(line[2]), val=float(line[5]), test=float(line[8]),
              loss=float(line[10]))
    m = re.search(r"(\d+) epochs in ([\d.]+) s \(([\d.]+) ms an epoch",
                  out.stderr)
    check(m is not None, "rgcn_baseline CLI: no timing line")
    rec = dict(phase="mixed_precision_rgcn_baseline", dataset="synthetic",
               hidden=HIDDEN, epochs=int(m.group(1)),
               train_s=float(m.group(2)), epoch_ms=float(m.group(3)),
               process_wall_s=wall, **{f"{k}_f1" if k != "loss" else k: v
                                       for k, v in f1.items()})
    log(**rec)
    check(all(0.0 <= v <= 1.0 for v in (f1["train"], f1["val"], f1["test"]))
          and np.isfinite(f1["loss"]), f"rgcn_baseline CLI: {rec}")
    return rec


def mixed_precision(torch, csr, conv, graph_u, split_u, graph_k, split_k,
                    graph_s, split_s, planted, largest) -> tuple:
    """7 (f): (a) the new kernel forms against their plain versions, timed
    beside the cast route; (b), (c) bf16 training; (d) the RGCN baseline
    CLI. Returns (the kernels' records, launches of (b) and (c))."""
    t0 = time.perf_counter()
    cases = mp_kernel_cases(torch, csr, graph_u, graph_k, largest,
                            planted[2])
    recs = mp_csr_kernels(torch, csr, cases) + mp_conv_kernel(torch, conv,
                                                              graph_s)
    del cases
    torch.cuda.empty_cache()
    launches, _ = mp_train(torch, csr, conv, graph_u, split_u, graph_k,
                           split_k, graph_s, split_s, planted, largest)
    mp_baseline_cli()
    log(phase="mixed_precision_done", seconds=time.perf_counter() - t0)
    return recs, launches


# ------------------------------------------------- 9. out-of-core training
# The power-law KG of phase 2, generated by the port's CLI, partitioned into
# 8 blocks, trained in groups of 2 blocks on its planted path.
OOC_GENERATE = ["powerlaw", "--num_nodes", "200000", "--num_edges",
                "2000000", "--num_relations", "237", "--metapath_len", "3",
                "--seed", "5", "--format", "npy"]
OOC_PARTS = 8
OOC_BLOCKS_PER_STEP = 2
# dropout 0 for the mode comparisons, dropout 0.6 (the default) for the
# quality bar of tests/test_partition.py, test F1 >= 0.9
OOC_EPOCHS = 20
OOC_QUALITY_EPOCHS = 40
OOC_MIN_TEST_F1 = 0.9
# fused against streaming, dropout 0: fused runs K1 on blockings at the
# common row count where streaming runs K2 on a hub direction, so the two
# sum some rows in another float32 order. Two runs on the H100 read 6.7e-6
# on the parameters, 9.3e-8 on the final loss and 0 on the F1s; the
# bounds leave 15x, 10x and a few test nodes' predictions
OOC_FUSED_PARAM_ATOL = 1e-4
OOC_FUSED_LOSS_ATOL = 1e-6
OOC_FUSED_F1_ATOL = 1e-3
# 9 (c) and (d): the CLI's MPNetm epochs and extension hops, cut from 1000
# and 3 so that each run takes seconds
OOC_CLI = ["--hidden_dim", str(HIDDEN), "--epochs", "20", "--max_hops", "1",
           "--backend", "csr"]
FB15K = os.path.join(ROOT, "data", "fb15k-237-continent")


def cli_child(argv, timeout=600) -> dict:
    """``python -m mpgnn_tpu_torch.run`` with ``argv`` in a child process
    whose launch counts start at 0 (``_CLI_CHILD``): its summary line, its
    launches, its stderr and its wall time."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _CLI_CHILD, *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"CLI {argv} failed:\n{out.stderr[-3000:]}")
    launches = json.loads(out.stderr.strip().splitlines()[-1].split(
        "LAUNCHES ", 1)[1])
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    for k, v in summary["classes"].items():
        check(0.0 <= v["test_f1"] <= 1.0, f"class {k}: {v}")
    return dict(summary=summary, launches=launches, stderr=out.stderr,
                wall=wall)


def ooc_generate(tmp, kg, planted):
    """9 (a): the KG through ``python -m mpgnn_tpu_torch.generate powerlaw
    --format npy`` in a child process, loaded back as memmaps: bitwise
    phase 2's arrays."""
    from mpgnn_tpu_torch.graph.generate import load_npy_dir

    folder = os.path.join(tmp, "kg")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "mpgnn_tpu_torch.generate",
                          *OOC_GENERATE, "--out", folder], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    gen_s = time.perf_counter() - t0
    check(out.returncode == 0, f"generate failed:\n{out.stderr[-3000:]}")
    t0 = time.perf_counter()
    meta, x, src, dst, rel, labels, label_nodes = load_npy_dir(folder)
    load_s = time.perf_counter() - t0
    same = {
        "x": np.array_equal(x, kg["node_features"].astype(np.float32)),
        "src": np.array_equal(src, kg["src"].astype(np.int32)),
        "dst": np.array_equal(dst, kg["dst"].astype(np.int32)),
        "rel": np.array_equal(rel, kg["rel"].astype(np.int32)),
        "labels": np.array_equal(labels, kg["labels"].astype(np.int8)),
        "label_nodes": np.array_equal(label_nodes, kg["label_nodes"]),
        "planted": meta["metapath_relations"] == planted,
    }
    log(phase="ooc_generate", command=OOC_GENERATE, generate_s=gen_s,
        load_s=load_s, summary=out.stdout.strip(), bitwise=same,
        memmap=isinstance(x, np.memmap))
    check(all(same.values()) and isinstance(x, np.memmap),
          f"the generated KG is not phase 2's: {same}")
    return meta, x, src, dst, rel, labels, label_nodes


def ooc_expected_launches(csr, pg, planted, groups, epochs, fused):
    """(K1, K2) launches that a clustered csr run of ``epochs`` epochs over
    ``groups`` implies: each group visited once an epoch and once at
    evaluation, every hop's forward each time and, in training, the
    backward of every hop past the first (hop 0 reads x, which needs no
    gradient); a direction runs K2 where ``build_csr_blocking`` routes it
    (its ``dedup_ratio``), K1 else, and K1 alone in fused mode."""
    k1 = k2 = 0
    rels = sorted(set(planted))
    for blocks in groups:
        sub = pg.subgraph(blocks, halo_hops=len(planted),
                          halo_relations=rels)
        for h, r in enumerate(planted):
            s, d = sub.graph.rel_edges(r)
            for rows, cols, n in ((s, d, epochs + 1),
                                  (d, s, epochs if h else 0)):
                dedup = (not fused and len(s) > 0 and csr.dedup_ratio(
                    rows, cols, csr.DEDUP_BLOCK_ROWS) >= csr.DEDUP_MIN_RATIO)
                k2 += n * dedup
                k1 += n * (not dedup)
    return k1, k2


def ooc_train(torch, csr, conv, pg, planted, split):
    """9 (b): streaming, resident and fused csr runs at dropout 0 (streaming
    bitwise resident, fused within ``OOC_FUSED_*``), then a streaming run
    at dropout 0.6 (test F1 >= ``OOC_MIN_TEST_F1``); each run's K1 and K2
    launches against what its groups and hops imply. After the streaming
    and the fused run, K1 and K2 run on every group's blockings as that run
    built them, forward and backward, at the hidden and the features'
    width, against their plain versions (``KERNEL_TOL``); the resident and
    dropout runs build the streaming run's blockings."""
    from mpgnn_tpu_torch.benchmarks.bench_ooc import hold_group_kernels
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.train.stream import train_mpgnn_clustered

    runs, launches, held = {}, {}, {}
    for name, epochs, dropout, kw in (
            ("streaming", OOC_EPOCHS, 0.0, dict(resident=False)),
            ("resident", OOC_EPOCHS, 0.0, dict(resident=True)),
            ("fused", OOC_EPOCHS, 0.0, dict(fused=True)),
            ("streaming_dropout", OOC_QUALITY_EPOCHS, 0.6,
             dict(resident=False))):
        cfg = MPGNNConfig(epochs=epochs, hidden_dim=HIDDEN, dropout=dropout)
        rep = {}
        torch.cuda.empty_cache()
        reset_counts(csr, conv)
        t0 = time.perf_counter()
        res = train_mpgnn_clustered(
            pg, [planted], split, 2, cfg, blocks_per_step=OOC_BLOCKS_PER_STEP,
            seed=0, backend="csr", report=rep, **kw)
        wall = time.perf_counter() - t0
        counts = read_counts(csr, conv)
        want = ooc_expected_launches(
            csr, pg, planted, [g["blocks"] for g in rep["groups"]], epochs,
            kw.get("fused", False))
        got = (counts["csr_scatter"], counts["csr_dedup"])
        fused = kw.get("fused", False)
        if fused not in held:       # after the counts are read
            held[fused] = hold_group_kernels(
                pg, [planted], rep, range(len(rep["groups"])),
                (HIDDEN, pg.feat_dim), KERNEL_TOL)
        epoch_ms = sorted(1e3 * t for t in rep["epoch_s"])
        rec = dict(
            phase="ooc_train", mode=name, epochs=epochs, dropout=dropout,
            hidden=HIDDEN, parts=OOC_PARTS,
            blocks_per_step=OOC_BLOCKS_PER_STEP, wall_s=wall,
            prep_s=rep["prep_s"], train_s=rep["train_s"],
            eval_s=rep["eval_s"], stack_build_s=rep.get("stack_build_s"),
            upload_s=rep.get("upload_s"),
            epoch_ms_median=epoch_ms[len(epoch_ms) // 2],
            epoch_ms_first=1e3 * rep["epoch_s"][0],
            mp_edges_per_epoch=rep["mp_edges_per_epoch"],
            mp_edges_per_s=rep["mp_edges_per_epoch"] * epochs
            / rep["train_s"],
            device_peak_bytes=rep["device_peak_bytes"],
            host_bytes=sum(g["host_bytes"] for g in rep["groups"]),
            groups=[{k: g[k] for k in ("blocks", "real_nodes", "real_edges",
                                       "mp_edges")} for g in rep["groups"]],
            launches=dict(csr_scatter=got[0], csr_dedup=got[1],
                          csr_backward_passes=counts["csr_backward_passes"]),
            expected_launches=dict(csr_scatter=want[0], csr_dedup=want[1]),
            kernels_vs_plain=held[fused], fused_rows=rep.get("fused_rows"),
            widths=[HIDDEN, pg.feat_dim], tol=KERNEL_TOL,
            train_f1=res.train_f1, val_f1=res.val_f1, test_f1=res.test_f1,
            final_loss=res.final_loss)
        log(**rec)
        check(got == want and got[0] > 0,
              f"{name}: K1/K2 launches {got}, the groups and hops imply "
              f"{want}")
        for k, n in zip(("csr_scatter", "csr_dedup"), got):
            c = held[fused][k]
            check(c["close"] and (c["blockings"] > 0 or n == 0),
                  f"{name}: {k} on the run's blockings against its plain "
                  f"version: {c}, {n} launches in the run")
        runs[name], launches[name] = (res, rec), counts
    (st, st_rec), (re_, re_rec), (fu, fu_rec), (dr, dr_rec) = runs.values()
    bitwise = all(torch.equal(a, b) for a, b in zip(
        st.params.parameters(), re_.params.parameters()))
    fused_param = max(float((a - b).abs().max()) for a, b in zip(
        fu.params.parameters(), st.params.parameters()))
    fused_loss = abs(fu.final_loss - st.final_loss)
    fused_f1 = max(abs(getattr(fu, k) - getattr(st, k))
                   for k in ("train_f1", "val_f1", "test_f1"))
    log(phase="ooc_check", streaming_bitwise_resident=bitwise,
        fused_vs_streaming=dict(param_max_abs=fused_param, loss=fused_loss,
                                f1=fused_f1),
        bounds=dict(param=OOC_FUSED_PARAM_ATOL, loss=OOC_FUSED_LOSS_ATOL,
                    f1=OOC_FUSED_F1_ATOL),
        peak_bytes=dict(streaming=st_rec["device_peak_bytes"],
                        resident=re_rec["device_peak_bytes"],
                        fused=fu_rec["device_peak_bytes"]),
        dropout_test_f1=dr.test_f1)
    check(bitwise, "streaming is not bitwise equal to resident")
    check(fused_param <= OOC_FUSED_PARAM_ATOL
          and fused_loss <= OOC_FUSED_LOSS_ATOL
          and fused_f1 <= OOC_FUSED_F1_ATOL,
          f"fused against streaming: params {fused_param}, loss "
          f"{fused_loss}, F1 {fused_f1}")
    check(st_rec["device_peak_bytes"] < re_rec["device_peak_bytes"],
          "streaming's device peak is not below resident's")
    check(dr.test_f1 >= OOC_MIN_TEST_F1,
          f"clustered training at dropout 0.6: test F1 {dr.test_f1}")
    total = {k: sum(c[k] for c in launches.values())
             for k in ("csr_scatter", "csr_dedup")}
    return total


def ooc_profile(torch, pg, planted, split, epochs=5) -> None:
    """Where a streaming clustered run's time goes: the report's host prep,
    training and evaluation walls, and torch.profiler's device time by
    kernel and copy over the whole call (the profiler slows the host, so
    the busy share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.train.stream import train_mpgnn_clustered

    rep = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_mpgnn_clustered(
            pg, [planted], split, 2,
            MPGNNConfig(epochs=epochs, hidden_dim=HIDDEN),
            blocks_per_step=OOC_BLOCKS_PER_STEP, backend="csr",
            resident=False, report=rep)
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    copy_us = sum(r[1] for r in rows if "HtoD" in r[0])
    steps_s = rep["train_s"] + rep["eval_s"]
    log(phase="ooc_profile", mode="streaming", epochs=epochs,
        prep_s=rep["prep_s"], train_s=rep["train_s"], eval_s=rep["eval_s"],
        device_ms=busy_us / 1e3, copy_htod_ms=copy_us / 1e3,
        device_busy_share_of_steps=busy_us / 1e6 / steps_s,
        top=[dict(name=k[:80], ms=t / 1e3, count=c) for k, t, c in rows[:10]])


def ooc_trace(tmp) -> dict:
    """9 (c): the search CLI with ``--trace_dir`` in a child process: one
    trace a class (each with its spans file beside it), K1's kernel named
    in them."""
    trace_dir = os.path.join(tmp, "trace")
    run = cli_child(["--dataset", "synthetic", "--folder", SYNTH,
                     "--node_file", "node.dat", "--link_file", "link.dat",
                     "--label_file", "label.dat", *OOC_CLI, "--trace_dir",
                     trace_dir])
    names = sorted(n for n in os.listdir(trace_dir)
                   if n.startswith("trace-"))
    k1 = 0
    for name in names:
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        k1 += sum(1 for e in events if e.get("cat") == "kernel"
                  and "csr_scatter_kernel" in e.get("name", ""))
    rec = dict(phase="ooc_trace", dataset="data/synthetic_multiclass",
               cli=OOC_CLI, traces=names,
               trace_bytes=sum(os.path.getsize(os.path.join(trace_dir, n))
                               for n in names),
               k1_kernel_events=k1, launches=run["launches"],
               process_wall_s=run["wall"],
               reduced=["MPNetm epochs 1000 -> 20", "extension hops 3 -> 1"])
    log(**rec)
    check(len(names) == 3 and k1 > 0,
          f"--trace_dir wrote {names}, {k1} K1 kernel events")
    return run["launches"]


def ooc_clis(tmp) -> list:
    """9 (d): ``--dataset ACM`` on labels_{train,val,test}.dat written from
    ``data/synthetic_multiclass``, and ``--dataset fb15k-237`` on
    ``data/fb15k-237-continent`` with an all-zero node.dat."""
    from mpgnn_tpu_torch.graph.io import read_labels

    acm = os.path.join(tmp, "acm")
    os.makedirs(acm)
    for name in ("node.dat", "link.dat"):
        os.symlink(os.path.join(SYNTH, name), os.path.join(acm, name))
    ids, labels = read_labels(os.path.join(SYNTH, "label.dat"))
    order = np.random.default_rng(0).permutation(len(ids))
    cut = [0, len(ids) * 6 // 10, len(ids) * 8 // 10, len(ids)]
    for k, split in enumerate(("train", "val", "test")):
        with open(os.path.join(acm, f"labels_{split}.dat"), "w") as f:
            for i in order[cut[k]: cut[k + 1]]:
                f.write(f"{ids[i]}\t{labels[i]}\n")
    fb = os.path.join(tmp, "fb15k")
    os.makedirs(fb)
    num_nodes = 0
    for name in ("link.dat", "label.dat"):
        os.symlink(os.path.join(FB15K, name), os.path.join(fb, name))
        with open(os.path.join(FB15K, name)) as f:
            for line in f:
                ids = line.split()
                num_nodes = max(num_nodes, int(ids[0]) + 1,
                                int(ids[-1]) + 1 if name == "link.dat"
                                else 0)
    with open(os.path.join(fb, "node.dat"), "w") as f:
        for i in range(num_nodes):
            f.write(f"{i}\t0.0\t0.0\t\n")
    recs = []
    for dataset, folder, label_file, reduced in (
            ("ACM", acm, "unused.dat",
             ["MPNetm epochs 1000 -> 20", "extension hops 3 -> 1"]),
            ("fb15k-237", fb, "label.dat",
             ["MPNetm epochs 1000 -> 20", "extension hops 3 -> 1",
              "node.dat: 2 all-zero columns, where the preprocessing "
              "writes 1 + the label relation's destinations (the features "
              "are all zero either way)"])):
        run = cli_child(["--dataset", dataset, "--folder", folder,
                         "--node_file", "node.dat", "--link_file",
                         "link.dat", "--label_file", label_file, *OOC_CLI])
        rec = dict(phase="ooc_cli", dataset=dataset, cli=OOC_CLI,
                   classes=run["summary"]["classes"],
                   launches=run["launches"], process_wall_s=run["wall"],
                   reduced=reduced)
        log(**rec)
        check(run["summary"]["dataset"] == dataset
              and len(run["summary"]["classes"]) >= 2,
              f"{dataset}: {run['summary']}")
        recs.append(rec)
    return recs


def ooc_phase(torch, csr, conv, kg, planted) -> dict:
    """Phase 9: out-of-core training. Returns the K1/K2 launches of the
    clustered runs, each counted from 0 (9 (b))."""
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.graph.partition import PartitionedHeteroGraph

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        meta, x, src, dst, rel, labels, label_nodes = ooc_generate(
            tmp, kg, planted)
        t0 = time.perf_counter()
        pg = PartitionedHeteroGraph(x, src, dst, rel, meta["num_relations"],
                                    OOC_PARTS, labels=labels)
        log(phase="ooc_partition", seconds=time.perf_counter() - t0,
            graph=repr(pg),
            edge_cut=pg.edge_cut_fraction(OOC_BLOCKS_PER_STEP))
        lab = np.asarray(labels)[np.asarray(label_nodes)].astype(np.int64)
        split = split_nodes(lab, node_idx=np.asarray(label_nodes).tolist())
        launches = ooc_train(torch, csr, conv, pg, planted, split)
        ooc_profile(torch, pg, planted, split)
        del pg, x, src, dst, rel
        ooc_trace(tmp)
        ooc_clis(tmp)
    log(phase="ooc_done", seconds=time.perf_counter() - t_start,
        launches=launches)
    return launches


# 10. multi-rank: parallel/ on torch.distributed
#
# Every multi-rank run of phase 10 is a correctness run on ONE card: two or
# four ranks share its SMs and its memory, and gloo stages each CUDA tensor
# through pinned host memory, so its times say what an exchange costs, not
# how training scales.
HALO_EPOCHS = 20
HALO_BF16_EPOCHS = 5
SHARDED_STEPS = 10
# the node-sharded runs hold to the single-process csr run from the same
# seed within bench_parallel's HALO_* bounds (dropout 0; the readings and
# margins are written there), and the zeroed-halo control must not;
# one rank over NCCL: its halo is empty, so its K1 launches sum what the
# single-process run's do, in the same order, plus an empty halo blocking:
# loss and parameters bitwise equal in every reading, and held so
HALO_WORLD1_ATOL = 0.0
# the (2, 2) sharded step against the replicated single-process step:
# float32 sums split over other ranks. Read (the same run): 1.6e-7
# relative at most; the bound leaves 60x (the elastic runs are held by
# bench_parallel.judge_elastic)
SHARDED_LOSS_RTOL = 1e-5
# 10 (e): the search CLI on 2 ranks against one process, cut from 1000
# epochs and 3 extension hops so that each takes seconds; 'auto' resolves
# to dense (K4) on this 5,000-node graph, whose products of one candidate
# do not depend on the others beside it
MESH_CLI = ["--hidden_dim", str(HIDDEN), "--dataset", "synthetic",
            "--folder", SYNTH, "--node_file", "node.dat", "--link_file",
            "link.dat", "--label_file", "label.dat", "--epochs", "50",
            "--max_hops", "1"]


def warm_costs(torch, csr, load_dat_files, split_nodes) -> dict:
    """The first-call costs the JAX package's warmer (``utils/warm.py``)
    hides there, here in a fresh process: the card's context and first
    allocation, the first K1 launch after the build (the library's load
    included) against the second, and two ``train_mpgnn`` runs on fresh
    copies of ``data/synthetic_multiclass`` (none of whose operands a later
    phase finds built), the process's first and its second: each one's
    set-up to its model's first forward and its first three epochs (host
    clock, synchronised after each step)."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.train import train_mpgnn

    rec = {}

    def first(name, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rec[name] = time.perf_counter() - t0

    first("context_s", lambda: torch.zeros(1, device="cuda"))
    # what a first run touches once, one at a time: the device generator,
    # a cuBLAS product, autograd's device thread, an Adam step
    first("generator_s", lambda: torch.rand(
        4, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0)))
    a = torch.ones(64, 64, device="cuda", requires_grad=True)
    first("matmul_s", lambda: a @ a)
    first("backward_s", lambda: (a @ a).sum().backward())
    first("adam_s", lambda: torch.optim.Adam([a], lr=0.01).step())
    files = [os.path.join(SYNTH, f) for f in ("node.dat", "link.dat",
                                              "label.dat")]
    graph, labels, _ = load_dat_files(*files)
    s, d = graph.rel_edges(1)
    blk, _ = csr.build_csr_blocking(s, d, graph.num_nodes)
    blk = blk.to("cuda")
    x = torch.ones(graph.num_nodes, HIDDEN, device="cuda")
    for i in (1, 2):
        t0 = time.perf_counter()
        csr.csr_scatter(blk, x)
        torch.cuda.synchronize()
        rec[f"k1_call{i}_ms"] = 1e3 * (time.perf_counter() - t0)
    for run in (1, 2):
        graph, labels, _ = load_dat_files(*files)
        marks = []

        def mark(*_):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        pre = torch.nn.modules.module.register_module_forward_pre_hook(
            lambda m, _: None if marks else mark())
        hook = register_optimizer_step_post_hook(mark)
        try:
            t0 = time.perf_counter()
            train_mpgnn(graph, SYNTH_PATHS, split_nodes(labels), 3,
                        MPGNNConfig(epochs=3, hidden_dim=HIDDEN),
                        backend="csr")
        finally:
            pre.remove()
            hook.remove()
        rec[f"run{run}_set_up_s"] = marks[0] - t0
        rec[f"run{run}_epoch_ms"] = [1e3 * (b - a) for a, b in
                                     zip(marks[:-1], marks[1:])]
    log(phase="warm", **rec)
    return rec


# Phase 1's fresh child: with the warmer (argv[1] == "1") it starts
# ``poke_device`` and the stage warms before the graph's load, as the CLI
# does, loads ``data/synthetic_multiclass`` and waits for the warms; then,
# with or without, the main thread's first calls one at a time (host
# clock, synchronised): the context, K1, a product, a backward, an Adam
# step, and the warms' own tiny flat sweep, bag round and batched
# evaluation epoch. Its last line is one JSON object.
_WARM_CHILD = """\
import json, os, sys, time
import torch
warmed = sys.argv[1] == "1"
t0 = time.perf_counter()
from mpgnn_tpu_torch.utils import warm
from mpgnn_tpu_torch.config import MPGNNConfig
warmer = warm.get_warmer(enabled=warmed)
dev = torch.device("cuda", 0)
cfg = MPGNNConfig(hidden_dim=64, backend="csr")
if warmer is not None:
    warmer.poke_device(dev)
    for mode in ("ell", "seg"):
        warmer.warm_flat_signature(1, 8, 2, 100, 0.1, mode=mode, C=8,
                                   device=dev)
        warmer.warm_bag_signature(1, 8, 2, 2, 2, 2, 50, 0.1, mode=mode,
                                  C=8, P=4, device=dev)
from mpgnn_tpu_torch.graph.io import load_dat_files
from mpgnn_tpu_torch.ops import csr
folder = sys.argv[2]
graph, labels, _ = load_dat_files(*(os.path.join(folder, f) for f in (
    "node.dat", "link.dat", "label.dat")))
if warmer is not None:
    warmer.warm_eval(graph, [[1, 0]], None, 3, cfg, 0, None, device=dev)
rec = dict(warmed=warmed, load_s=time.perf_counter() - t0)
t1 = time.perf_counter()
if warmer is not None:
    warmer.wait(600)
rec["wait_s"] = time.perf_counter() - t1
rec["warm_k1_launches"] = csr.SCATTER_LAUNCHES
rec["failures"] = [] if warmer is None else [
    [str(k), m] for k, m in warmer.failures]
def first(name, fn):
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    rec[name] = time.perf_counter() - t
first("context_s", lambda: torch.zeros(1, device=dev))
s, d = graph.rel_edges(1)
blk = csr.build_csr_blocking(s, d, graph.num_nodes)[0].to(dev)
x = torch.ones(graph.num_nodes, 64, device=dev)
first("k1_s", lambda: csr.csr_scatter(blk, x))
a = torch.ones(64, 64, device=dev, requires_grad=True)
first("matmul_s", lambda: a @ a)
first("backward_s", lambda: (a @ a).sum().backward())
first("adam_s", lambda: torch.optim.Adam([a], lr=0.01).step())
first("flat_sweep_s", lambda: warm._flat(dev, "ell", 0.1, {}))
first("bag_round_s", lambda: warm._bag(dev, "ell", 0.1, dict(F=2)))
first("eval_epoch_s", lambda: warm._eval(dev, "csr", 2, graph.feat_dim, 3,
                                         cfg, 0))
rec["total_s"] = time.perf_counter() - t0
print(json.dumps(rec), flush=True)
"""


def warm_child_costs(card: str) -> dict:
    """Phase 1, in two fresh processes: the main thread's first calls
    without the warmer and with it (``_WARM_CHILD``). With it, no warm may
    fail and K1 must have launched from a warm thread. Returns {'cold':
    ..., 'warm': ...}."""
    out = {}
    for tag, flag in (("cold", "0"), ("warm", "1")):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", _WARM_CHILD, flag, SYNTH],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        check(run.returncode == 0,
              f"warm child ({tag}) failed:\n{run.stderr[-3000:]}")
        out[tag] = json.loads(run.stdout.strip().splitlines()[-1])
        out[tag]["process_wall_s"] = time.perf_counter() - t0
    w = out["warm"]
    check(not w["failures"], f"a warm failed: {w['failures']}")
    check(w["warm_k1_launches"] > 0, "K1 did not launch from a warm thread")
    log(phase="warm_child", card=card, **out)
    return out


# The rest of the ops API (``ops.segment``, ``ops.spmm.ell_max_gather``;
# PyTorch ops, no kernel of their own) on the card against the same ops on
# the CPU: one uniform relation's 2.5M edges into 200,000 segments, F = 16
# for the means and row maxima; the scorer's [200,000, 16] neighbour table
# with weights on 5 levels, so that most rows hold ties.
OPS_ROWS, OPS_ENTRIES, OPS_F, OPS_D = 200_000, 2_500_000, 16, 16
OPS_MEAN_TOL = dict(rtol=1e-6, atol=1e-6)


def ops_api_check(torch) -> dict:
    """max, argmax, counts and ``ell_max_gather`` (values, winners, the
    gradient of sum(value * c) with whole-number c) exactly; the masked
    mean within ``OPS_MEAN_TOL``."""
    from mpgnn_tpu_torch.ops import segment as seg
    from mpgnn_tpu_torch.ops.spmm import ell_max_gather

    rng = np.random.default_rng(7)
    ids = rng.integers(0, OPS_ROWS - 1000, OPS_ENTRIES)  # 1,000 empty rows
    data = rng.normal(size=(OPS_ENTRIES, OPS_F)).astype(np.float32)
    ties = (rng.integers(0, 5, OPS_ENTRIES) / 4).astype(np.float32)
    mask = rng.random(OPS_ENTRIES) > 0.3
    nbr = rng.integers(0, OPS_ROWS, (OPS_ROWS, OPS_D))
    nmask = rng.random((OPS_ROWS, OPS_D)) > 0.3
    nmask[:100] = False                                  # rows without one
    w = (rng.integers(0, 5, OPS_ROWS) / 4).astype(np.float32)
    c = rng.integers(-4, 5, OPS_ROWS).astype(np.float32)

    def run(dev):
        t = {k: torch.as_tensor(v, device=dev) for k, v in dict(
            ids=ids, data=data, ties=ties, mask=mask, nbr=nbr, nmask=nmask,
            w=w, c=c).items()}
        wg = t["w"].clone().requires_grad_()
        v, win = ell_max_gather(wg, t["nbr"], t["nmask"])
        (v * t["c"]).sum().backward()
        t0 = time.perf_counter()
        out = dict(
            mean=seg.masked_segment_mean(t["data"], t["ids"], t["mask"],
                                         OPS_ROWS),
            max=seg.segment_max(t["data"], t["ids"], OPS_ROWS),
            max_masked=seg.segment_max(t["ties"], t["ids"], OPS_ROWS,
                                       t["mask"], fill=-1.0),
            argmax=seg.segment_argmax(t["ties"], t["ids"], OPS_ROWS,
                                      t["mask"]),
            count=seg.segment_count(t["ids"], OPS_ROWS),
            ell=(v.detach(), win, wg.grad))
        if dev == "cuda":
            torch.cuda.synchronize()
        flat = {}
        for k, val in out.items():
            vals = val if isinstance(val, tuple) else (val,)
            for i, a in enumerate(vals):
                flat[f"{k}{i}"] = a.cpu().numpy()
        return flat, time.perf_counter() - t0

    got, card_s = run("cuda")
    want, cpu_s = run("cpu")
    rec = dict(rows=OPS_ROWS, entries=OPS_ENTRIES, F=OPS_F, D=OPS_D,
               card_host_s=card_s, cpu_s=cpu_s)
    for k in want:
        if k.startswith("mean"):
            np.testing.assert_allclose(got[k], want[k], **OPS_MEAN_TOL)
        else:
            check(np.array_equal(got[k], want[k]),
                  f"{k}: the card's result differs from the CPU's")
        d = np.abs(got[k].astype(np.float64) - want[k].astype(np.float64))
        rec[f"{k}_max_abs_err"] = float(np.nanmax(np.where(
            np.isinf(want[k]), 0.0, d)))
    check(np.isneginf(want["ell0"][:100]).all(), "masked rows not -inf")
    log(phase="ops_api", **rec)
    return rec


def halo_kernels(torch, csr, HeteroGraph) -> list:
    """10 (a): K1 on the rectangular blockings of every shard of the
    uniform graph's relations 0 and 1 at P = 2 and 4 ('a2a' plans), the
    local and the halo blocking, forward and backward, at F = 16 and 64,
    against ``csr_scatter_plain`` (``KERNEL_TOL``); local + halo against
    the full relation's square K1 mean (1e-5), padded rows 0. At F = 64 on
    relation 0 each shard's launches are timed (device ms) beside their
    bound, ``torch.sparse.mm`` on the same CSR and the square K1."""
    from mpgnn_tpu_torch.parallel.halo import (
        build_halo_csr_operands,
        build_halo_plan,
    )

    dev = torch.device("cuda")
    graph, _ = uniform_graph(HeteroGraph)
    n = graph.num_nodes
    gen = torch.Generator(device=dev).manual_seed(10)
    records = []
    for rel in (0, 1):
        s, d = graph.rel_edges(rel)
        square, _ = csr.build_csr_blocking(s, d, n)
        check(isinstance(square, csr.CsrBlocking),
              f"uniform relation {rel} did not route to K1")
        square = square.to(dev)
        for p_count in (2, 4):
            plan = build_halo_plan(s, d, n, p_count)
            S = plan.block
            for p in range(p_count):
                lf, lb, hf, hb = (b.to(dev) for b in
                                  build_halo_csr_operands(plan, p))
                ids = np.concatenate(
                    [plan.halo_ids(q, p) for q in plan.recv_order(p)])
                ids = torch.as_tensor(ids, device=dev)
                for f in (16, 64):
                    x = torch.randn(p_count * S, f, generator=gen,
                                    device=dev)
                    x[n:] = 0.0
                    g = torch.randn(S, f, generator=gen, device=dev)
                    xl, xh = x[p * S:(p + 1) * S], x[ids].contiguous()
                    cases = (("local fwd", lf, xl), ("halo fwd", hf, xh),
                             ("local bwd", lb, g), ("halo bwd", hb, g))
                    outs = {}
                    for tag, blk, inp in cases:
                        got = csr.csr_scatter(blk, inp)
                        want = csr.csr_scatter_plain(blk, inp)
                        torch.cuda.synchronize()
                        err = float((got - want).abs().max()) if got.numel() \
                            else 0.0
                        check(torch.allclose(got, want, **KERNEL_TOL),
                              f"halo K1 {tag} rel {rel} P={p_count} shard "
                              f"{p} F={f}: max abs err {err}")
                        outs[tag] = (got, err)
                    full = csr.csr_scatter(square, x[:n].contiguous())
                    rows = full[p * S:min((p + 1) * S, n)]
                    mean = outs["local fwd"][0] + outs["halo fwd"][0]
                    mean_err = float((mean[:len(rows)] - rows).abs().max())
                    check(mean_err <= 1e-5 and bool(
                        (mean[len(rows):] == 0).all()),
                          f"halo K1 rel {rel} P={p_count} shard {p} F={f}: "
                          f"local + halo off the mean by {mean_err}")
                    rec = dict(relation=rel, P=p_count, shard=p, F=f,
                               rows=S, halo_rows=int(ids.numel()),
                               local_edges=int(lf.col.numel()),
                               halo_edges=int(hf.col.numel()),
                               max_abs_err=max(e for _, e in outs.values()),
                               mean_max_abs_err=mean_err)
                    if rel == 0 and f == 64:
                        rec.update(_time_halo_k1(torch, csr, cases, f))
                        rec["square_ms"] = cuda_ms(
                            torch, lambda: csr.csr_scatter(
                                square, x[:n].contiguous()), 50)
                    log(phase="halo_kernels", **rec)
                    records.append(rec)
    return records


def _time_halo_k1(torch, csr, cases, f) -> dict:
    """Device ms of each of a shard's four K1 launches, with its bound
    (bytes: the gathered operand's distinct rows, the CSR, the output),
    its plain version's ms and ``torch.sparse.mm``'s on the same CSR."""
    out = {}
    for tag, blk, inp in cases:
        key = tag.replace(" ", "_")
        e = blk.col.numel()
        rows_read = int(torch.unique(blk.col).numel()) if e else 0
        index_bytes = 4 * sum(t.numel() for _, t in blk.tensors())
        b_ms, b_by = bound(4 * rows_read * f + index_bytes
                           + 4 * blk.num_rows * f, 2.0 * e * f)
        out[f"{key}_ms"] = cuda_ms(torch, lambda: csr.csr_scatter(blk, inp),
                                   50)
        out[f"{key}_bound_ms"], out[f"{key}_bound_by"] = b_ms, b_by
        out[f"{key}_plain_ms"] = cuda_ms(
            torch, lambda: csr.csr_scatter_plain(blk, inp), 3)
        if blk.num_rows and blk.num_cols:
            mat = torch.sparse_csr_tensor(blk.row_ptr, blk.col, blk.weight,
                                          size=(blk.num_rows, blk.num_cols))
            out[f"{key}_library_ms"] = cuda_ms(
                torch, lambda: torch.sparse.mm(mat, inp), 20)
        else:
            out[f"{key}_library_ms"] = None
    return out


def parallel_phase(torch, csr, HeteroGraph) -> dict:
    """Phase 10: (a) ``halo_kernels``; (b) node-sharded training of the
    uniform graph on 2 gloo ranks of the card, each exchange, against the
    single-process csr run of a world-1 NCCL rank beside a world-1 halo
    run there, each rank's K1 launches equal to what its hops imply, a
    bf16 ``num_bases=2`` run and the zeroed-halo control
    (``bench_parallel.judge``);
    (c) the (data, model) = (2, 2) sharded step against the replicated
    step; (d) ``train_elastic`` 4 -> 2 and 4 -> 2 -> 1 ranks against the
    run without (``bench_parallel.judge_elastic``); (e) the search CLI under
    ``torchrun --nproc_per_node 2 ... --mesh 2`` against one process."""
    from mpgnn_tpu_torch.benchmarks import bench_parallel
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.graph.io import load_dat_files, split_nodes
    from mpgnn_tpu_torch.parallel.mesh import spawn_ranks
    from mpgnn_tpu_torch.train import loops

    t_phase = time.perf_counter()
    out = {"kernels": halo_kernels(torch, csr, HeteroGraph)}
    log(phase="halo_kernels_done", seconds=time.perf_counter() - t_phase)

    # (b) node-sharded training
    t0 = time.perf_counter()
    ranks = spawn_ranks(bench_parallel.halo_train_rank, 2,
                        (HALO_EPOCHS, HALO_BF16_EPOCHS), backend="gloo",
                        device="cuda", timeout_s=600)
    w1 = spawn_ranks(bench_parallel.world1_rank, 1,
                     (HALO_EPOCHS, HALO_BF16_EPOCHS), backend="nccl",
                     device="cuda", timeout_s=600)[0]
    check(w1["backend"] == "nccl", f"world-1 run on {w1['backend']}")
    failed = bench_parallel.judge(ranks, w1)
    ref = w1["csr"]
    for run in [w1["halo"]] + [r for rk in ranks for r in rk["runs"]]:
        r_ref = w1["csr_bf16"] if run["dtype"] == "bfloat16" else ref
        log(phase="halo_train", **run, ref_loss=r_ref["final_loss"],
            ref_val_f1=r_ref["val_f1"], ref_test_f1=r_ref["test_f1"],
            ref_epoch_ms=r_ref["epoch_ms"])
    log(phase="halo_noise_floor", segment=w1["segment"],
        ref_loss=ref["final_loss"])
    for f in failed:
        check(False, f)
    launches = w1["halo"]["k1_launches"] + sum(
        r["k1_launches"] for rk in ranks for r in rk["runs"])
    world1 = w1["halo"]
    check(abs(world1["final_loss"] - ref["final_loss"]) <= HALO_WORLD1_ATOL
          and world1["param_max_abs_diff"] <= HALO_WORLD1_ATOL
          and all(world1[k] == ref[k] for k in ("val_f1", "test_f1")),
          f"world-1 NCCL halo run {world1} against csr {ref}")
    log(phase="halo_train_done", seconds=time.perf_counter() - t0,
        k1_launches_halo=launches)
    out.update(launches_halo=launches, train=ranks, world1=w1)

    # (c) and (d): the sharded step and elastic recovery, 4 gloo ranks
    t0 = time.perf_counter()
    files = [os.path.join(SYNTH, f) for f in ("node.dat", "link.dat",
                                              "label.dat")]
    with tempfile.TemporaryDirectory() as ckpt:
        se = spawn_ranks(
            bench_parallel.sharded_elastic_rank, 4,
            (files, SYNTH_PATHS, SHARDED_STEPS,
             bench_parallel.ELASTIC_FAULTS, bench_parallel.ELASTIC_STEPS,
             bench_parallel.ELASTIC_EVERY, ckpt), backend="gloo",
            device="cuda", timeout_s=600)
    graph_s, labels_s, _ = load_dat_files(*files)
    split_s = split_nodes(labels_s)
    cfg = MPGNNConfig(hidden_dim=HIDDEN, dropout=0.0)
    model, _ = loops.seeded_init(graph_s.feat_dim, HIDDEN, 3, SYNTH_PATHS, 0,
                                 "cuda")
    hop_ops = loops.build_hop_arrays(graph_s, SYNTH_PATHS, device="cuda")
    opt = loops.make_optimizer(model, cfg)
    parts = loops.split_tensors(split_s, "cuda")
    x = torch.as_tensor(graph_s.x, device="cuda")
    w = torch.ones(len(split_s.train_y), device="cuda")
    replicated = [float(loops.train_step(
        model, opt, x, hop_ops, None, parts[0], parts[1], w, cfg, None,
        torch.float32).detach()) for _ in range(SHARDED_STEPS)]
    sharded = se[0]["sharded"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(sharded, replicated))
    log(phase="sharded_step", mesh="data=2,model=2", sharded=sharded,
        replicated=replicated, max_rel_diff=rel)
    check(all(r["sharded"] == sharded for r in se) and
          rel <= SHARDED_LOSS_RTOL,
          f"sharded step off the replicated one by {rel}")
    failed, records = bench_parallel.judge_elastic(se)
    mesh_setup = bench_parallel.mesh_setup_record(se)
    log(phase="elastic_mesh_setup", backend="gloo", **mesh_setup)
    for rec in records:
        log(phase="elastic", **rec, no_fault=se[0]["no_fault"],
            seconds=time.perf_counter() - t0)
    for f in failed:
        check(False, f)
    out.update(sharded=sharded, replicated=replicated, elastic=se[0]["fault"],
               elastic_twice=se[0]["twice"], elastic_mesh_setup=mesh_setup)

    # (e) the search fan-out under torchrun
    t0 = time.perf_counter()
    single = cli_child(MESH_CLI)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "mpgnn_tpu_torch.run", *MESH_CLI,
           "--mesh", "2"]
    t1 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    mesh_wall = time.perf_counter() - t1
    check(res.returncode == 0, f"torchrun --mesh 2 failed:\n"
          f"{res.stderr[-3000:]}")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    check(len(lines) == 1, f"torchrun printed {len(lines)} summary lines")
    summary = json.loads(lines[0])
    log(phase="mesh_cli", single=single["summary"], mesh=summary,
        single_wall_s=single["wall"], mesh_wall_s=mesh_wall,
        resolved=sorted(set(_TRAIN_AUTO_RE.findall(res.stderr)
                            + _EVAL_CHUNK_RE.findall(res.stderr))),
        seconds=time.perf_counter() - t0)
    check(summary["classes"] == single["summary"]["classes"],
          f"--mesh 2 {summary['classes']} against one process "
          f"{single['summary']['classes']}")

    # (f) the same line from one command, without torchrun: the CLI starts
    # its 2 ranks itself and, with --retries 1, starts them again after
    # rank 1 fails on its first attempt
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        marker = os.path.join(tmp, "failed_once")
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
        env.update(bench_parallel.rank_site_env(tmp, MPGNN_FAIL_ONCE=marker))
        rc, stdout, stderr = bench_parallel.run_session(
            [sys.executable, "-m", "mpgnn_tpu_torch.run", *MESH_CLI,
             "--mesh", "2", "--retries", "1"], env, 600)
        failed_once = os.path.exists(marker)
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    attempts = re.findall(r"\[supervisor\] attempt \d+ exited rc=-?\d+.*",
                          stderr)
    log(phase="mesh_cli_retries", rc=rc, failed_once=failed_once,
        attempts=attempts, summaries=len(lines),
        seconds=time.perf_counter() - t0)
    check(rc == 0 and failed_once and len(attempts) == 1
          and len(lines) == 1, f"--mesh 2 --retries 1: rc {rc}, "
          f"{attempts}, {len(lines)} summaries:\n{stderr[-3000:]}")
    check(json.loads(lines[0])["classes"] == single["summary"]["classes"],
          f"--mesh 2 --retries 1 {lines[0]} against one process "
          f"{single['summary']['classes']}")
    log(phase="parallel_done", seconds=time.perf_counter() - t_phase)
    return out


# Phase 11: K6 (csr_attention) against its plain versions (float64 sums,
# one rounding) at the mag_hgt.train cell's shapes. The kernel sums in
# float32 (the online softmax over chunks of at most 256 edges, their
# partials folded in order): values of order 1 at rtol = atol = 1e-5, p and
# ds per edge (under 1) at atol 1e-6, as tests/test_torch_hgt_cuda.py holds
# them. A kernel that left out one edge of every row misses by 1e-2 and
# more (the control: the plain forward without each row's last edge).
K6_TOL = dict(rtol=1e-5, atol=1e-5)
K6_EDGE_TOL = dict(rtol=1e-5, atol=1e-6)
K6_SEED = 2750000031           # the cell's graph under this seed
K6_CUT = 20.0                  # the cut graph: nodes and edges / 20
K6_SAMPLE = 4096               # random rows held at the full shapes
K6_LONG = 64                   # and rows of several chunks among them
K6_LONGEST = 2 ** 20           # the longest row too, up to this many edges


def k6_bytes(t: int, m: int, e: int) -> dict:
    """Each K6 pass's least bytes over ``t`` target rows, ``m`` stacked
    source rows and ``e`` edges at width 256 in 8 heads (float32 rows,
    int32 CSRs): the forward reads q, kt, vt and the CSR and writes out
    and lse; the row pass reads q, out, dout, kt, vt, lse and the CSR and
    writes p, ds and dq; the column pass reads q, dout, p, ds and the
    transposed CSR and writes dkt and dvt."""
    row, lse, pe = 4 * 256, 4 * 8, 4 * 8
    csr = 4 * (e + t + 1)
    return {"fwd": 2 * t * row + 2 * m * row + csr + t * lse,
            "bwd_rows": 4 * t * row + 2 * m * row + t * lse + csr
            + 2 * pe * e,
            "bwd_cols": 2 * t * row + 2 * pe * e + 4 * (2 * e + m + 1)
            + 2 * m * row}


def _edge_ranges(torch, ptr, rows):
    """(the positions of rows ``rows``' edges in the CSR ``ptr``, row by
    row; the rows' offsets among them)."""
    start = ptr.long()[rows]
    deg = ptr.long()[rows + 1] - start
    off = torch.zeros(rows.numel() + 1, dtype=torch.long, device=ptr.device)
    torch.cumsum(deg, 0, out=off[1:])
    e = int(off[-1])
    return (torch.arange(e, device=ptr.device) + torch.repeat_interleave(
        start - off[:-1], deg, output_size=e)), off


def _k6_sample(torch, ptr, gen, chunk):
    """Ascending rows of the CSR ``ptr`` to hold at full size:
    ``K6_SAMPLE`` at random, ``K6_LONG`` of those longer than a chunk, the
    longest row (up to ``K6_LONGEST`` edges) and up to 64 rows without
    edges."""
    deg = ptr.long().diff()
    dev = ptr.device
    pick = [torch.randint(deg.numel(), (K6_SAMPLE,), generator=gen,
                          device=dev),
            (deg == 0).nonzero().flatten()[:64]]
    long = ((deg > chunk) & (deg <= 2 ** 16)).nonzero().flatten()
    if long.numel():
        pick.append(long[torch.randint(long.numel(), (K6_LONG,),
                                       generator=gen, device=dev)])
    top = deg.argmax()
    if int(deg[top]) <= K6_LONGEST:
        pick.append(top.view(1))
    return torch.unique(torch.cat(pick))


def _hold(torch, got, want, tol, what) -> float:
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    ok = torch.allclose(got.double(), want.double(), **tol)
    check(ok, f"K6 {what}: max abs err {err:.3g} against the plain version")
    return err


def attention_case(torch, A, tag, blk, gen, calls, plain_whole=False):
    """K6's three passes on ``blk``: a second launch of each against the
    first (bitwise); each against its plain version on sampled rows (on
    every row with ``plain_whole``), beside the control that must fail;
    each timed (device time behind a GPU spin, and by kernel) beside its
    byte bound, the plain versions' time with ``plain_whole``. ``calls``
    counts the wrappers' calls on the card."""
    import dataclasses

    dev, h, d = blk.col.device, A.KERNEL_HEADS, A.KERNEL_WIDTH
    t, m, e = blk.num_rows, blk.num_sources, blk.num_edges

    def randn(rows):
        return 0.3 * torch.randn(rows, d, generator=gen, device=dev)

    q, dout, kt, vt = randn(t), randn(t), randn(m), randn(m)

    def fwd():
        calls["fwd"] += 1
        return A.csr_attention(blk, q, kt, vt, h)

    def rows_pass():
        calls["bwd"] += 1
        return A.csr_attention_bwd_rows(blk, q, kt, vt, out, dout, lse, h)

    def cols_pass():
        calls["bwd"] += 1
        return A.csr_attention_bwd_cols(blk, q, dout, p, ds, h)

    out, lse = fwd()
    dq, p, ds = rows_pass()
    dkt, dvt = cols_pass()
    for got, want in zip(fwd(), (out, lse)):
        check(torch.equal(got, want), f"K6 {tag}: forward repeat differs")
        del got
    for got, want in zip(rows_pass(), (dq, p, ds)):
        check(torch.equal(got, want), f"K6 {tag}: row pass repeat differs")
        del got
    for got, want in zip(cols_pass(), (dkt, dvt)):
        check(torch.equal(got, want), f"K6 {tag}: column pass repeat "
              "differs")
        del got
    rec = {"case": tag, "rows": t, "stacked_sources": m, "edges": e,
           "max_row_edges": int(blk.row_ptr.long().diff().max()),
           "max_source_edges": int(blk.t_row_ptr.long().diff().max())}
    # the plain versions on sampled target rows, then on sampled sources
    rows = (torch.arange(t, device=dev) if plain_whole
            else _k6_sample(torch, blk.row_ptr, gen, A.CHUNK))
    eid, off = _edge_ranges(torch, blk.row_ptr, rows)
    view = dataclasses.replace(blk, row_ptr=off.int(), col=blk.col[eid],
                               rows=None)
    w_out, w_lse = A.attention_plain(view, q[rows], kt, vt, h)
    err = {"fwd": max(_hold(torch, out[rows], w_out, K6_TOL, f"{tag} out"),
                      _hold(torch, lse[rows], w_lse, K6_TOL, f"{tag} lse"))}
    # the control: every row's last edge left out must fail the tolerance
    deg = off.diff()
    keep = torch.ones(eid.numel(), dtype=torch.bool, device=dev)
    keep[(off[1:] - 1)[deg > 0]] = False
    coff = torch.zeros_like(off)
    torch.cumsum((deg - 1).clamp_min(0), 0, out=coff[1:])
    c_out, _ = A.attention_plain(dataclasses.replace(
        view, row_ptr=coff.int(), col=view.col[keep]), q[rows], kt, vt, h)
    control = float((out[rows].double() - c_out.double()).abs().max())
    check(not torch.allclose(out[rows].double(), c_out.double(), **K6_TOL),
          f"K6 {tag}: the control (each row's last edge left out) passed")
    del c_out, w_out, w_lse
    w_dq, w_p, w_ds = A.attention_bwd_rows_plain(
        view, q[rows], kt, vt, out[rows], dout[rows], lse[rows], h)
    err["bwd_rows"] = max(
        _hold(torch, dq[rows], w_dq, K6_TOL, f"{tag} dq"),
        _hold(torch, p[eid], w_p, K6_EDGE_TOL, f"{tag} p"),
        _hold(torch, ds[eid], w_ds, K6_EDGE_TOL, f"{tag} ds"))
    rec.update(sampled_rows=rows.numel(), sampled_edges=eid.numel())
    del w_dq, w_p, w_ds, view, eid
    srcs = (torch.arange(m, device=dev) if plain_whole
            else _k6_sample(torch, blk.t_row_ptr, gen, A.CHUNK))
    teid, toff = _edge_ranges(torch, blk.t_row_ptr, srcs)
    # col: the column pass's plain version reads only its length, the
    # view's edge count
    cview = dataclasses.replace(
        blk, t_row_ptr=toff.int(), t_col=blk.t_col[teid],
        t_eid=blk.t_eid[teid], src_node=blk.src_node[srcs],
        col=blk.t_eid[teid])
    w_dkt, w_dvt = A.attention_bwd_cols_plain(cview, q, dout, p, ds, h)
    err["bwd_cols"] = max(
        _hold(torch, dkt[srcs], w_dkt, K6_TOL, f"{tag} dkt"),
        _hold(torch, dvt[srcs], w_dvt, K6_TOL, f"{tag} dvt"))
    rec.update(sampled_sources=srcs.numel(), sampled_source_edges=
               teid.numel(), control_max_abs_err=control)
    del w_dkt, w_dvt, cview, teid
    torch.cuda.empty_cache()
    least = k6_bytes(t, m, e)
    plain = {"fwd": lambda: A.attention_plain(blk, q, kt, vt, h),
             "bwd_rows": lambda: A.attention_bwd_rows_plain(
                 blk, q, kt, vt, out, dout, lse, h),
             "bwd_cols": lambda: A.attention_bwd_cols_plain(
                 blk, q, dout, p, ds, h)}
    for name, fn in (("fwd", fwd), ("bwd_rows", rows_pass),
                     ("bwd_cols", cols_pass)):
        r = {"ms": cuda_ms(torch, fn, 10),
             "bound_ms": bound(least[name], 0.0)[0],
             "kernels_us": kernel_us(torch, fn, 5),
             "max_abs_err": err[name]}
        if plain_whole:
            r["plain_ms"] = cuda_ms(torch, plain[name], 2, spin=False)
        rec[name] = r
    log(phase="attention_kernels", **rec)
    return rec


def attention_phase(torch) -> dict:
    """Phase 11: K6 on the mag_hgt.train cell's graph
    (``perfbench/graphgen.py`` under ``K6_SEED``), on the blockings the
    program derives for it (``hgt_baseline.attention_operands``): every
    row (layer 0 and 1) and the train-row tail (layer 2), each pass held
    against its plain version on sampled rows, repeated bitwise and timed
    beside its bound; the graph cut by ``K6_CUT``, every row held and the
    plain versions timed; one training step there through ``setup_hgt``
    launching K6 three times forward and six times backward. The launch
    counts are set to 0 just before the phase and must equal the calls it
    made."""
    t_phase = time.perf_counter()
    sys.path.insert(0, ROOT)
    from perfbench import graphgen, harness
    from perfbench.drivers.train import hetero_graph
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.hgt_baseline import attention_operands, setup_hgt, \
        type_order
    from mpgnn_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    bench = harness.load_benchmark(harness.ROOT.parent)
    cfg = harness.config_of(bench, "mag_hgt_h256", harness.ROOT.parent)
    types = len(cfg["graph"]["node_types"])
    A.ATTENTION_LAUNCHES = A.ATTENTION_BACKWARD_LAUNCHES = 0
    calls = {"fwd": 0, "bwd": 0}
    gen = torch.Generator(device=dev).manual_seed(K6_SEED)

    def operands(gcfg):
        g = graphgen.generate(gcfg, K6_SEED, dev)
        het = hetero_graph(g)
        _, relabel, _ = type_order(g.node_type, types, dev)
        rows = torch.sort(relabel[g.labeled[g.split["train"]]]).values
        return g, het, attention_operands(het, relabel, rows, dev)

    out = {}
    t0 = time.perf_counter()
    g, het, (blk, tail) = operands(cfg["graph"])
    log(phase="attention_operands", seconds=time.perf_counter() - t0)
    del g, het
    out["mag_layer0"] = attention_case(torch, A, "mag_layer0", blk, gen,
                                       calls)
    del blk
    torch.cuda.empty_cache()
    out["mag_tail"] = attention_case(torch, A, "mag_tail", tail, gen, calls)
    del tail
    torch.cuda.empty_cache()
    g, het, (blk, _) = operands(graphgen.scaled(cfg["graph"], K6_CUT))
    out["cut"] = attention_case(torch, A, f"cut_{K6_CUT:g}", blk, gen, calls,
                                plain_whole=True)
    del blk
    check((A.ATTENTION_LAUNCHES, A.ATTENTION_BACKWARD_LAUNCHES)
          == (calls["fwd"], calls["bwd"]),
          f"K6 launches {A.ATTENTION_LAUNCHES} forward, "
          f"{A.ATTENTION_BACKWARD_LAUNCHES} backward, against the phase's "
          f"calls {calls}")
    out["launches"] = {"fwd": calls["fwd"], "bwd": calls["bwd"]}
    # the program's own step on the cut graph: 3 layers, each one forward
    # and a row and a column pass backward
    m = cfg["model"]
    tr = g.split["train"]
    prog = setup_hgt(het, g.x, g.node_type, g.labeled[tr], g.labels[tr],
                     int(cfg["graph"]["num_classes"]), m["layers"],
                     MPGNNConfig(lr=m["lr"], weight_decay=m["weight_decay"],
                                 hidden_dim=m["hidden_dim"]),
                     heads=m["heads"], device=dev)
    prog.step()
    before = (A.ATTENTION_LAUNCHES, A.ATTENTION_BACKWARD_LAUNCHES)
    loss = float(prog.step().detach())
    step = (A.ATTENTION_LAUNCHES - before[0],
            A.ATTENTION_BACKWARD_LAUNCHES - before[1])
    check(step == (m["layers"], 2 * m["layers"]) and np.isfinite(loss),
          f"an HGT step launched K6 {step} (forward, backward), loss {loss}")
    out["launches"]["train_step"] = list(step)
    out["launches"]["total"] = (A.ATTENTION_LAUNCHES
                                + A.ATTENTION_BACKWARD_LAUNCHES)
    log(phase="attention_done", launches=out["launches"],
        seconds=time.perf_counter() - t_phase)
    del prog, g, het
    torch.cuda.empty_cache()
    return out


def attention_kernel_record(att: dict) -> dict:
    """The kernels line's K6 record: the forward at mag's layer 0, the
    backward's passes beside it, the tail and the cut graph (with the
    plain versions' times), the launches of phase 11."""
    full, cut = att["mag_layer0"], att["cut"]
    rec = dict(name="csr_attention", route="cuda",
               source="mpgnn_tpu_torch/csrc/csr_attention.cu",
               replaces=None, launches=att["launches"]["total"],
               launches_attention=att["launches"],
               max_abs_err=max(c[p]["max_abs_err"] for c in (
                   full, att["mag_tail"], cut)
                   for p in ("fwd", "bwd_rows", "bwd_cols")),
               rows=full["rows"], edges=full["edges"],
               ms=full["fwd"]["ms"], bound_ms=full["fwd"]["bound_ms"])
    for p in ("bwd_rows", "bwd_cols"):
        rec.update({f"{p}_ms": full[p]["ms"],
                    f"{p}_bound_ms": full[p]["bound_ms"]})
    for tag in ("mag_tail", "cut"):
        c = att[tag]
        rec[tag] = {"rows": c["rows"], "edges": c["edges"], **{
            f"{p}_{k}": c[p][k] for p in ("fwd", "bwd_rows", "bwd_cols")
            for k in ("ms", "bound_ms", "plain_ms") if k in c[p]}}
    return rec


def wide_shapes(recs: list, name: str) -> dict:
    """The kernels line's record of phase 6's wide K3 shapes of kernel
    ``name``: each shape's time, bound, plain and library times and
    error."""
    return {"wide": {f"N={r['N']} F={r['F']} H={r['H']}": {
        k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "max_abs_err")}
        for r in recs if r["kernel"] == name}}


def reset_counts(csr, conv) -> None:
    csr.SCATTER_LAUNCHES = csr.DEDUP_LAUNCHES = 0
    csr.SCATTER_BF16_LAUNCHES = csr.DEDUP_BF16_LAUNCHES = 0
    csr.CSR_BACKWARD_LAUNCHES = 0
    conv.CONV_LAUNCHES = conv.MATMUL_LAUNCHES = 0
    conv.CONV_BF16H_LAUNCHES = 0


# the float32 forms and the csr backward, which every training run of
# phase 7 (a)-(c) launches; the bf16 forms launch in 7 (f)
F32_FORMS = ("csr_scatter", "csr_dedup", "csr_backward_passes", "dense_conv",
             "dense_matmul")


def read_counts(csr, conv) -> dict:
    """Each kernel's launches, and the csr backward passes on the card
    (``csr_backward_passes``: each launched K1 or K2 once, already counted
    there)."""
    return {"csr_scatter": csr.SCATTER_LAUNCHES,
            "csr_dedup": csr.DEDUP_LAUNCHES,
            "csr_backward_passes": csr.CSR_BACKWARD_LAUNCHES,
            "dense_conv": conv.CONV_LAUNCHES,
            "dense_matmul": conv.MATMUL_LAUNCHES,
            "csr_scatter_bf16": csr.SCATTER_BF16_LAUNCHES,
            "csr_dedup_bf16": csr.DEDUP_BF16_LAUNCHES,
            "dense_conv_bf16h": conv.CONV_BF16H_LAUNCHES}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1, 2 and 6 alone")
    ap.add_argument("--search-only", action="store_true",
                    help="run phases 1 and 8 alone")
    ap.add_argument("--ooc-only", action="store_true",
                    help="run phases 1 and 9 alone")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run phases 1 and 10 alone")
    ap.add_argument("--attention-only", action="store_true",
                    help="build the kernels and run phase 11 alone")
    ap.add_argument("--package-root", default=ROOT,
                    help="checkout whose mpgnn_tpu_torch is driven")
    ap.add_argument("--bits-file", default=None,
                    help="with --kernels-only: write phase 6's output "
                         "digests here, or hold them to the ones written "
                         "there by an earlier run (the parent's package)")
    args = ap.parse_args()
    if (os.path.abspath(args.package_root) != ROOT
            or args.bits_file) and not args.kernels_only:
        ap.error("--package-root and --bits-file drive the kernel phases "
                 "only: add --kernels-only")
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
    if args.attention_only:
        att = attention_phase(torch)
        log(phase="done", seconds=time.perf_counter() - t_start)
        print(smi)
        print(json.dumps({"kernels": [attention_kernel_record(att)]}))
        return 0
    graph_s, labels_s, _ = load_dat_files(
        *(os.path.join(SYNTH, f) for f in ("node.dat", "link.dat",
                                           "label.dat")))
    split_s = split_nodes(labels_s)
    warm_costs(torch, csr, load_dat_files, split_nodes)
    warm_child = None
    if os.path.abspath(args.package_root) == ROOT:
        warm_child = warm_child_costs(smi)
        ops_api_check(torch)
    if args.parallel_only:
        parallel_phase(torch, csr, HeteroGraph)
        log(phase="done", seconds=time.perf_counter() - t_start)
        return 0

    # 2. kernels
    t0 = time.perf_counter()
    graph_u, labels_u = uniform_graph(HeteroGraph)
    graph_k, planted, kg = powerlaw_graph(HeteroGraph, generate_powerlaw_kg)
    order = np.argsort(-graph_k.rel_counts, kind="stable")
    largest = [int(order[0]), int(order[1])]
    log(phase="graphs", seconds=time.perf_counter() - t0, planted=planted,
        largest=largest,
        largest_edges=[int(graph_k.rel_counts[r]) for r in largest])
    if args.search_only:
        t0 = time.perf_counter()
        search_phase(torch, csr, conv, graph_k, planted, kg)
        log(phase="done", seconds=time.perf_counter() - t_start,
            search_s=time.perf_counter() - t0)
        return 0
    if args.ooc_only:
        ooc_phase(torch, csr, conv, kg, planted)
        log(phase="done", seconds=time.perf_counter() - t_start)
        return 0
    records = kernel_phase(torch, csr, graph_u, graph_k, [0, 1], largest,
                           planted[2])
    probe = gather_probe(records["csr_scatter"],
                         os.path.abspath(args.package_root))
    if args.kernels_only:
        dense = dense_phase(torch, conv, graph_s, bool(args.bits_file))
        if not hasattr(conv, "MAX_EPILOGUE_WEIGHTS"):  # K3 at every width
            wide_conv_phase(torch, conv, graph_s)
        if args.bits_file:
            hold_bits(dense, args.bits_file)
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

    # 6. K3 and K4, then K3 at the wide shapes
    records.update(dense_phase(torch, conv, graph_s))
    wide_recs = wide_conv_phase(torch, conv, graph_s)

    # 7. the training path: first-step gradients, then train_mpgnn
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
    pallas_ms, csr_ms, wide_runs = train_phase(
        torch, graph_s, split_s, graph_u, split_u, graph_k, split_k, planted,
        largest)
    train_launches = read_counts(csr, conv)
    log(phase="train_launches", **train_launches)
    check(all(train_launches[k] > 0 for k in F32_FORMS),
          f"a kernel did not launch on the training path: {train_launches}")
    train_profile(torch, "synthetic_multiclass", graph_s, SYNTH_PATHS,
                  split_s, 3, "pallas", pallas_ms)
    train_profile(torch, "uniform", graph_u, [[0, 1]], split_u, 2, "csr",
                  csr_ms)
    # the other single-model kinds and 'auto' on the card, then the
    # readings behind 'auto''s constants
    backends_phase(torch, csr, conv, graph_s, split_s, graph_u, split_u)
    # 7 (f): bf16, the decomposed convs, the RGCN baseline
    mp_records, mp_launches = mixed_precision(
        torch, csr, conv, graph_u, split_u, graph_k, split_k, graph_s,
        split_s, planted, largest)
    del graph_u, split_u
    torch.cuda.empty_cache()
    auto_routing(torch, HeteroGraph, graph_s, split_s)

    # 8. the search: the CLI, csr against segment, the KG
    t0 = time.perf_counter()
    search_launches, stacked, grouped = search_phase(torch, csr, conv,
                                                     graph_k, planted, kg)
    log(phase="search_done", seconds=time.perf_counter() - t0)

    # 9. out-of-core training
    del graph_k
    torch.cuda.empty_cache()
    ooc_launches = ooc_phase(torch, csr, conv, kg, planted)

    # 10. multi-rank: node-sharded, sharded, elastic, the search fan-out
    par = parallel_phase(torch, csr, HeteroGraph)

    # 11. K6, HGT's attention, at the mag_hgt.train cell's shapes
    att = attention_phase(torch)

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
        if name == "dense_conv":         # the wide shapes and runs
            extra.update(wide_shapes(wide_recs, name), wide_train_launches={
                tag: runs["pallas"]["k3_launches"]
                for tag, runs in wide_runs.items()})
        if name == "dense_matmul":       # the batched dense evaluation's
            extra.update({f"grouped_{k}": grouped[k] for k in (
                "width", "launches_per_product", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "max_abs_err")})
        if name == "csr_scatter":        # the planted relation's long rows
            kg = next(r for r in recs if r["relation"] == planted[2]
                      and r["F"] == 64 and r["direction"] == "fwd")
            extra.update(kg_relation=planted[2], kg_ms=kg["ms"],
                         kg_bound_ms=kg["bound_ms"],
                         kg_gather_bound_ms=kg["gather_bound_ms"],
                         kg_library_ms=kg["library_ms"],
                         stacked_kg_final_set_ms=stacked["ms"],
                         stacked_per_candidate_ms=stacked["per_candidate_ms"],
                         stacked_library_ms=stacked["library_ms"],
                         stacked_launches=stacked["launches"],
                         stacked_per_candidate_launches=stacked[
                             "per_candidate_launches"],
                         stacked_max_abs_err=stacked["max_abs_err"],
                         probe_k1_gather=probe["k1_gather"])
        ooc = ooc_launches.get(name, 0)
        halo_k1 = par["launches_halo"] if name == "csr_scatter" else 0
        # phase 1's fresh child: K1 from the warm threads
        warm_k1 = (warm_child["warm"]["warm_k1_launches"]
                   if name == "csr_scatter" else 0)
        if warm_k1:
            extra["launches_warm"] = warm_k1
        if name == "csr_scatter":        # 10 (a): a shard's four launches
            at = [r for r in par["kernels"] if "local_fwd_ms" in r]
            extra.update(launches_halo=halo_k1, halo_shards={
                f"P={r['P']} shard {r['shard']}": {
                    k: r[k] for k in r if k.endswith(("_ms", "_by"))}
                for r in at}, halo_max_abs_err=max(
                    r["max_abs_err"] for r in par["kernels"]))
        kernels.append(dict(
            name=name, route="cuda", source=meta[name][0],
            replaces=meta[name][1],
            launches=(serve_launches[name] + train_launches[name]
                      + search_launches[name] + ooc + halo_k1 + warm_k1),
            launches_serve=serve_launches[name],
            launches_train=train_launches[name],
            launches_search=search_launches[name],
            **({"launches_ooc": ooc} if name in ooc_launches else {}),
            max_abs_err=max(r["max_abs_err"] for r in recs + [
                w for w in wide_recs if w["kernel"] == name]),
            ms=wide["ms"], plain_ms=wide["plain_ms"],
            bound_ms=wide["bound_ms"], bound_by=wide["bound_by"],
            library_ms=wide["library_ms"], dispatch_ms=wide["dispatch_ms"],
            library_dispatch_ms=wide["library_dispatch_ms"], **extra,
        ))
    # the bf16 forms (7 (f)): at F = 64 forward, K1 on the uniform
    # relation, K2 on the KG's hub, K3 at N = 5,000; launches from 7 (f)'s
    # bf16 training, counted from 0
    for name, source, replaces in (
            ("csr_scatter_bf16", "mpgnn_tpu_torch/csrc/csr_scatter.cu",
             "mpgnn_tpu/ops/pallas_csr.py:372"),
            ("csr_dedup_bf16", "mpgnn_tpu_torch/csrc/csr_dedup.cu",
             "mpgnn_tpu/ops/pallas_csr.py:434"),
            ("dense_conv_bf16h", "mpgnn_tpu_torch/csrc/dense_matmul.cu",
             "mpgnn_tpu/ops/pallas_conv.py:57")):
        recs = [r for r in mp_records if r["kernel"] == name]
        wide = next(r for r in recs if r["F"] == 64
                    and r.get("direction", "fwd") == "fwd")
        extra = {}
        if name == "dense_conv_bf16h":
            extra.update(wide_shapes(wide_recs, name))
        else:
            bwd = next(r for r in recs if r["direction"] == "bwd")
            extra = dict(bwd_ms=bwd["ms"], bwd_cast_route_ms=bwd[
                "cast_route_ms"], bwd_bound_ms=bwd["bound_ms"],
                bwd_library_ms=bwd["library_ms"],
                routes={f"{r['direction']} {r['graph']} rel {r['relation']} "
                        f"F={r['F']}": [r["ms"], r["cast_route_ms"]]
                        for r in recs})
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=mp_launches[name], launches_train=mp_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in recs + [
                w for w in wide_recs if w["kernel"] == name]),
            ms=wide["ms"], plain_ms=wide["plain_ms"],
            bound_ms=wide["bound_ms"], bound_by=wide["bound_by"],
            library_ms=wide["library_ms"], library_call=wide["library_call"],
            cast_route_ms=wide["cast_route_ms"], graph=wide["graph"],
            F=wide["F"], **extra))
    # K5: its probe's shapes at F = 128 (the JAX probe's width), one copy a
    # row and runs of 64 rows
    at = {p["rows_per_run"]: p for p in probe["shapes"] if p["F"] == 128}
    kernels.append(dict(
        name="dma_gather", route="cuda",
        source="mpgnn_tpu_torch/csrc/dma_gather.cu",
        replaces="benchmarks/bench_dma_gather.py:53",
        launches=probe["launches"], launches_probe=probe["launches"],
        F=128, rows_per_run=1,
        max_abs_err=max(p["max_abs_err"] for p in probe["shapes"]),
        ms=at[1]["ms"],
        plain_ms=at[1]["plain_ms"], bound_ms=at[1]["bound_ms"],
        bound_by=at[1]["bound_by"], library_ms=at[1]["library_ms"],
        r64_ms=at[64]["ms"], r64_plain_ms=at[64]["plain_ms"],
        r64_bound_ms=at[64]["bound_ms"], r64_library_ms=at[64]["library_ms"],
        dma_run1_vs_torch=probe["dma_run1_vs_torch"]))
    kernels.append(attention_kernel_record(att))
    log(phase="done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
