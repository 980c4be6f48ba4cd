"""The harness finds every configuration, traffic mix, driver, model and
metric by the names in BENCHMARK.json, and the file keeps the contract's
shape."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import harness
from perfbench.tests.perfbench_helpers import CHECKOUT

BENCH = harness.load_benchmark(CHECKOUT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    cell = harness.cell(BENCH, workload)
    cfg = harness.config_of(BENCH, cell["config"], CHECKOUT)
    traffic = harness.traffic_of(cell["traffic"])
    driver = harness.load_module("drivers", traffic["driver"])
    assert callable(driver.run)
    if traffic["driver"] == "train":
        model = harness.load_module("models", cfg["model"]["name"])
        for fn in ("param_spec", "build", "reference", "epoch_work"):
            assert callable(getattr(model, fn))
    assert cfg["name"] == cell["config"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module("metrics", metric)
    assert callable(mod.read)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_the_contract_asks(workload):
    e2e = [m["name"] for m in harness.metrics_for(BENCH, workload, False)]
    layer = harness.metrics_for(BENCH, workload, True)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in e2e


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and 0 < len(x) <= 200 for x in layers)
    for c in BENCH["configs"]:
        with open(CHECKOUT / c["file"]) as f:
            json.load(f)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024
