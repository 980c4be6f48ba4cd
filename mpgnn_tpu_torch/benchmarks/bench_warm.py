"""The search CLI with and without the first-call warmer, in turns, on the
card.

    python -m mpgnn_tpu_torch.benchmarks.bench_warm

Runs ``python -m mpgnn_tpu_torch.run`` on ``data/synthetic_multiclass``
(hidden 64, 3 extension hops, ``--backend csr``, ``EPOCHS`` MPNetm
epochs: the line of ``chip_smoke.py`` phase 8 (a)) in fresh child
processes, with the warmer (``utils/warm.py``) and with ``--no_warm``, in
the order warm, cold, cold, warm, ... (``PAIRS`` of each). Each run is a
fresh process, so each pays the first calls that the warmer takes off the
main thread; the host's load drifts from run to run, so the paired
differences are read beside the medians. A run's record: its process wall
(host clock, the interpreter's start included), the CLI's own ``wall_s``,
and each class's stage times from the engine's log lines (``hop0``,
``hop1``.., ``final_eval``, ``greedy``). Every run must print the same
summary (selections and test F1s): the warmer takes no decision.

Prints one JSON line: the card's name and power limit, the line, the runs,
each variant's medians and the paired differences (warm - cold). It
refuses to run without a card: a CPU run gives no time.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from mpgnn_tpu_torch.benchmarks.bench_train import card
from mpgnn_tpu_torch.ops import _kernels

ROOT = Path(__file__).resolve().parents[2]
SYNTH = ROOT / "data" / "synthetic_multiclass"
EPOCHS = 100
# A CLI's wall spreads by 5-12 s from run to run on a one-card host (H100
# 80GB HBM3, 700 W), more than a warmer could gain: five pairs in turns.
PAIRS = 5
SEARCH_LINE = ["--hidden_dim", "64", "--dataset", "synthetic", "--folder",
               str(SYNTH), "--node_file", "node.dat", "--link_file",
               "link.dat", "--label_file", "label.dat", "--epochs",
               str(EPOCHS), "--backend", "csr"]
STAGE_RES = (
    ("hop0", re.compile(r"hop-0 losses: .* \(([0-9.]+)s\)$")),
    ("hop", re.compile(r"hop (\d+): swept .* in ([0-9.]+)s$")),
    ("final_eval", re.compile(r"final eval of \d+ candidates: ([0-9.]+)s$")),
    ("greedy", re.compile(r"final meta: .* \(greedy ([0-9.]+)s\)$")),
)


def stage_times(stderr: str) -> list:
    """Per class, the engine's stage times (s) from its log lines."""
    classes, cur = [], {}
    for line in stderr.splitlines():
        for name, pat in STAGE_RES:
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


def run_order(pairs: int) -> list:
    """'warm' and 'cold' in the order warm, cold, cold, warm, ..."""
    return [v for i in range(pairs)
            for v in (("warm", "cold") if i % 2 == 0 else ("cold", "warm"))]


def run_cli(argv: list, variant: str) -> dict:
    """One CLI run in a fresh process; its record."""
    extra = ["--no_warm"] if variant == "cold" else []
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "mpgnn_tpu_torch.run", *argv, *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if out.returncode:
        raise RuntimeError(f"the CLI failed:\n{out.stderr[-3000:]}")
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    stages = stage_times(out.stderr)
    return dict(variant=variant, process_wall_s=wall,
                wall_s=summary["wall_s"], classes=summary["classes"],
                stage_s=stages,
                stages_total_s=[sum(c.values()) for c in stages],
                warm_lines=out.stderr.count("mpgnn_tpu_torch.warm "))


def medians(runs: list) -> dict:
    """A variant's medians: process wall, the CLI's wall, each class's
    stage total and each of class 0's stages."""
    med = statistics.median
    return dict(
        process_wall_s=med(r["process_wall_s"] for r in runs),
        wall_s=med(r["wall_s"] for r in runs),
        stages_total_s=[med(r["stages_total_s"][k] for r in runs)
                        for k in range(len(runs[0]["stages_total_s"]))],
        class0_stage_s={s: med(r["stage_s"][0][s] for r in runs)
                        for s in runs[0]["stage_s"][0]})


def main(argv=None) -> int:
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_warm: CUDA is not available", file=sys.stderr)
        return 2
    smi = card()
    _kernels.build_all()           # no run pays the kernels' build
    runs = [run_cli(SEARCH_LINE, v) for v in run_order(PAIRS)]
    by = {v: [r for r in runs if r["variant"] == v] for v in ("warm", "cold")}
    pairs = [dict(process_wall_s=w["process_wall_s"] - c["process_wall_s"],
                  class0_total_s=w["stages_total_s"][0]
                  - c["stages_total_s"][0])
             for w, c in zip(by["warm"], by["cold"])]
    same = all(r["classes"] == runs[0]["classes"] for r in runs)
    warmed = all(r["warm_lines"] > 0 for r in by["warm"]) and not any(
        r["warm_lines"] for r in by["cold"])
    print(json.dumps({
        "bench": "warm", "card": smi,
        "device": torch.cuda.get_device_name(0), "line": SEARCH_LINE,
        "order": run_order(PAIRS), "same_summary": same,
        "runs": runs, "medians": {v: medians(rs) for v, rs in by.items()},
        "pairs": pairs,
        "median_pair_diff": {k: statistics.median(p[k] for p in pairs)
                             for k in pairs[0]}}), flush=True)
    if not (same and warmed):
        print(f"bench_warm: same summary {same}, warm log lines as expected "
              f"{warmed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
