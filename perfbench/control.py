"""Readings that set a cell's limits, at the cell's own size, without the
program: the control (the reference put in the program's place, in the
precision below the one the configuration states) and, for a training
cell, the half-batch fault (the reference's steps with half the train
rows left out, the mean over the rest), each held against the reference
by the same comparison a run makes.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--reading control|half_batch]

prints one JSON line a seed. The benchmark's own runs never run it. The
control is the reference in float32 with TF32 products (the
configurations state float32, TF32 off)."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def reading_of(run, reading: str) -> dict:
    """The gaps of ``reading`` ('control' or 'half_batch') against the
    reference, as a run's ``drivers.train.gaps``."""
    import torch

    from perfbench import graphgen, harness, params as P
    from perfbench.drivers.train import gaps

    cfg = run.config
    graph = graphgen.generate(cfg["graph"], run.seed, run.device)
    run.drop_seed = P.drop_seed(run.seed)
    mod = harness.load_module("models", cfg["model"]["name"])
    params0 = P.make(mod.param_spec(cfg, graph.x.shape[1],
                                    int(cfg["graph"]["num_classes"])),
                     run.seed + 1, run.device)
    steps = run.traffic["checked_steps"]
    ref = mod.reference(run, graph, params0, steps, "float64")
    if reading == "control":
        got = mod.reference(run, graph, params0, steps, "tf32")
    else:
        got = mod.reference(run, graph, params0, steps, "float64", rows=0.5)
    out = gaps(got["losses"], got["grad1"], got["delta"], ref)
    del graph
    torch.cuda.empty_cache() if run.device.type == "cuda" else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--reading", choices=("control", "half_batch"),
                    default="control")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    from perfbench import harness
    from perfbench.run import _cache_env

    bench = harness.load_benchmark(CHECKOUT)
    cell = harness.cell(bench, args.workload)
    config = harness.config_of(bench, cell["config"], CHECKOUT)
    traffic = harness.traffic_of(cell["traffic"])
    _cache_env()
    import torch

    dev = torch.device("cuda")
    for seed in args.seeds:
        run = harness.Run(workload=args.workload, seed=seed, seconds=0.0,
                          trace=False, device=dev, cell=cell, config=config,
                          traffic=traffic, t_start=0.0)
        out = reading_of(run, args.reading)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": args.reading, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
