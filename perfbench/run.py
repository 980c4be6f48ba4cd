"""The benchmark of the PyTorch and CUDA port (``mpgnn_tpu_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout on a machine with the cards the cell
asks for. It looks the cell up in ``BENCHMARK.json``, loads its
configuration (``perfbench/configs/``) and traffic mix
(``perfbench/traffic/``), hands both to the traffic's driver
(``perfbench/drivers/``), and prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, each
read by ``perfbench/metrics/<name>.py``), ``device``, ``breakdown`` with
``--trace 1``, and ``compared``, each number held against the reference
beside its limit; those numbers are also the last lines of standard
error. A line before it, ``perfbench info``, gives the card, what the
program resolved and built, and the run's spans (set-up by phase among
them).

The kernels' libraries (``mpgnn_tpu_torch/build/``) and every cache go
inside the checkout, so only a checkout's first run compiles.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / "perfbench" / ".cache"


def _cache_env() -> None:
    """Fixed cache directories inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def _card() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return {"nvidia_smi": out.stdout.strip().splitlines()}


def _build_kernels() -> float:
    """Build the port's kernel libraries missing from the checkout (its
    first run only) and return the seconds it took."""
    from mpgnn_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    if not all(_kernels.library_path(s).exists() for s in _kernels.SOURCES):
        _kernels.build_all()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(CHECKOUT))
    from perfbench import harness

    t_start = harness.process_start_time()
    bench = harness.load_benchmark(CHECKOUT)
    cell = harness.cell(bench, args.workload)
    config = harness.config_of(bench, cell["config"], CHECKOUT)
    traffic = harness.traffic_of(cell["traffic"])
    _cache_env()

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2

    compile_s = _build_kernels()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.Run(workload=args.workload, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=device, cell=cell, config=config,
                      traffic=traffic, t_start=t_start)
    run.info["compile_s"] = compile_s
    harness.load_module("drivers", traffic["driver"]).run(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {bad}", file=sys.stderr)
        return 3
    run.info.update(_card())
    run.info["memory_peak_bytes"] = run.counters["memory_peak_bytes"]
    run.info["spans"] = run.spans
    run.info["counters"] = run.counters
    print("perfbench info " + json.dumps(run.info), flush=True)
    print(json.dumps(harness.result_line(run, bench, int(cell["chips"]))),
          flush=True)
    harness.report_checks(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
