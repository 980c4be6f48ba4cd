"""Shared set-up of the harness's tests: a cell's run at a reduced size on
the CPU, without the harness's look for a card."""

from __future__ import annotations

import time

import torch

from perfbench import graphgen, harness

CHECKOUT = harness.ROOT.parent
# node, edge and split counts divided by this in the CPU tests
FACTOR = 2000.0


def make_run(workload: str, seed: int = 2 ** 31 + 7, factor: float = FACTOR,
             device: str = "cpu", seconds: float = 0.2,
             backend: str = "csr") -> harness.Run:
    bench = harness.load_benchmark(CHECKOUT)
    cell = harness.cell(bench, workload)
    cfg = harness.config_of(bench, cell["config"], CHECKOUT)
    cfg["graph"] = graphgen.scaled(cfg["graph"], factor)
    if "backend" in cfg["model"]:
        # 'auto' picks 'dense' for a graph this small; the cell's size
        # resolves to 'csr'
        cfg["model"]["backend"] = backend
    traffic = harness.traffic_of(cell["traffic"])
    return harness.Run(workload=workload, seed=seed, seconds=seconds,
                       trace=False, device=torch.device(device), cell=cell,
                       config=cfg, traffic=traffic, t_start=time.time())


def drive(run: harness.Run) -> harness.Run:
    harness.load_module("drivers", run.traffic["driver"]).run(run)
    return run
