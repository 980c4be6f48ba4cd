"""Gather-rate probe: K5, one bulk copy per run of rows, against torch's
row gather, on the card.

    python -m mpgnn_tpu_torch.benchmarks.bench_dma_gather [--out FILE]

Counterpart of ``benchmarks/bench_dma_gather.py`` (a TPU probe). Its
question here: how fast can the card gather rows when every contiguous run
of ``R`` rows is one copy, at R = 1 (one copy a row, the copy rate) up to
R = 64, against ``torch.index_select``? The answer is a measured gather
ceiling for K1 (``csrc/csr_scatter.cu``), which gathers one row of x an
edge: what share of it does K1 reach at F = 16 and 64?

Shapes, as the JAX probe has them: x [500,000, F] float32 (random), 2,097,152
rows gathered a call, tiles of 256 runs, run starts drawn uniformly from a
seeded numpy generator, R in {1, 4, 16, 64}; F = 128 as there (512-byte
rows), and F = 16 and 64, the widths at which K1 gathers rows. For each
shape K5's whole output is held against its plain version bitwise (a gather
is a copy), then timed with CUDA events over 10 launches after a warm-up,
beside ``bound_ms`` (each gathered row read once and written once, plus the
run starts, at 3.35 TB/s), ``library_ms`` (one ``torch.index_select`` on a
precomputed index) and ``plain_ms`` (the index build plus that call).
``real_blocking_runs``: the run structure of the forward gather columns of
``build_csr_blocking(..., dedup='never')`` on the JAX probe's uniform graph
(E = 10M over the same 500,000 nodes, sources sorted).

Prints one JSON line (with the card's name and power limit); ``--out``
also writes it to a file. It refuses to run without a card: a CPU run gives
no time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from mpgnn_tpu_torch.ops import gather
from mpgnn_tpu_torch.ops.csr import build_csr_blocking

N_ROWS = 500_000
TOTAL_ROWS = 2_097_152
RUNS_PER_TILE = 256
RUN_ROWS = (1, 4, 16, 64)
WIDTHS = (128, 64, 16)
ITERS = 10
REAL_EDGES = 10_000_000
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet


def event_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls after
    one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def probe_shape(x: torch.Tensor, rows_per_run: int,
                rng: np.random.Generator) -> dict:
    """K5 at one (F, R): checked bitwise against its plain version on the
    whole output, then timed beside its bound, index_select and the plain
    version."""
    n, f = x.shape
    runs = TOTAL_ROWS // rows_per_run
    starts = torch.from_numpy(rng.integers(
        0, n - rows_per_run, (runs // RUNS_PER_TILE, RUNS_PER_TILE)
    ).astype(np.int32)).to(x.device)
    got = gather.dma_gather(x, starts, rows_per_run)
    want = gather.dma_gather_plain(x, starts, rows_per_run)
    if not torch.equal(got, want):
        bad = int((got != want).any(dim=1).sum())
        raise RuntimeError(f"K5 at F={f}, R={rows_per_run}: {bad} rows differ "
                           f"from index_select")
    del got, want
    idx = gather.run_rows(starts, rows_per_run)
    ms = event_ms(lambda: gather.dma_gather(x, starts, rows_per_run,
                                            check=False))
    library_ms = event_ms(lambda: torch.index_select(x, 0, idx))
    plain_ms = event_ms(lambda: gather.dma_gather_plain(x, starts,
                                                        rows_per_run))
    moved = 2.0 * TOTAL_ROWS * f * 4 + runs * 4
    rec = dict(
        F=f, rows_per_run=rows_per_run, runs=runs, row_bytes=4 * f,
        bitwise_equal=True, max_abs_err=0.0, ms=ms,
        mrows_s=TOTAL_ROWS / ms / 1e3,
        ns_per_descriptor=ms * 1e6 / runs,
        bound_ms=moved / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=library_ms, library_mrows_s=TOTAL_ROWS / library_ms / 1e3,
        plain_ms=plain_ms,
    )
    print(f"  F={f} R={rows_per_run}: {ms:.4f} ms ({rec['mrows_s']:.0f} "
          f"Mrows/s, {rec['ns_per_descriptor']:.2f} ns/copy), bound "
          f"{rec['bound_ms']:.4f} ms, index_select {library_ms:.4f} ms",
          file=sys.stderr, flush=True)
    return rec


def real_blocking_runs(rng: np.random.Generator) -> dict:
    """Run lengths of K1's forward gather columns on the JAX probe's
    uniform graph."""
    src = np.sort(rng.integers(0, N_ROWS, size=REAL_EDGES))
    dst = rng.integers(0, N_ROWS, size=REAL_EDGES)
    fwd, _ = build_csr_blocking(src, dst, N_ROWS, dedup="never")
    lens = gather.run_lengths(fwd.col.numpy())
    return dict(edges=int(fwd.col.numel()),
                mean_run_len=float(lens.mean()),
                pct_rows_in_runs_ge4=100.0 * float(lens[lens >= 4].sum())
                / max(int(fwd.col.numel()), 1))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_dma_gather needs a CUDA device: a CPU run "
                         "gives no time")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = dict(n=N_ROWS, rows=TOTAL_ROWS, runs_per_tile=RUNS_PER_TILE,
               iters=ITERS, device=torch.cuda.get_device_name(0),
               card=card(), shapes=[])
    t0 = time.perf_counter()
    for f in WIDTHS:
        x = torch.randn(N_ROWS, f, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(f))
        for r in RUN_ROWS:
            out["shapes"].append(probe_shape(x, r, rng))
        del x
        torch.cuda.empty_cache()
    run1 = {s["F"]: s for s in out["shapes"] if s["rows_per_run"] == 1}
    out["dma_run1_vs_torch"] = {f: run1[f]["library_ms"] / run1[f]["ms"]
                                for f in WIDTHS}
    out["real_blocking_runs"] = real_blocking_runs(rng)
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
