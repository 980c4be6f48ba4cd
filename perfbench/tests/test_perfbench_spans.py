"""The readers of the program's spans on a reduced mag.train run on the
CPU: the set-up's host readings come out, and sum as the program's spans
nest; the step's device readings need the card's events and return None
here, as every reader does where the program has no spans."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests.perfbench_helpers import drive, make_run

SPAN_READERS = ("fwd_ms.train", "bwd_ms.train", "opt_ms.train",
                "csr_route_s", "csr_build_s", "setup_unspanned_s")
DEVICE = ("fwd_ms.train", "bwd_ms.train", "opt_ms.train")


@pytest.fixture
def traced_run():
    from mpgnn_tpu_torch.utils import prof

    prof.reset_spans()
    run = drive(make_run("mag.train"))
    run.trace = True
    run.counters["memory_peak_bytes"] = 0
    yield run
    prof.reset_spans()


def test_span_readers_on_a_cpu_run(traced_run):
    bench = harness.load_benchmark(harness.ROOT.parent)
    line = harness.metric_values(traced_run, bench)
    assert set(SPAN_READERS) - set(DEVICE) <= set(line)
    assert not set(DEVICE) & set(line)
    value = {k: v["value"] for k, v in line.items()}
    assert 0.0 < value["csr_route_s"] + value["csr_build_s"] \
        <= value["operand_build_s"]
    phase = traced_run.spans["at_program_s"] - traced_run.spans["at_hetero_s"]
    assert 0.0 <= value["setup_unspanned_s"] < phase


@pytest.mark.parametrize("name", SPAN_READERS)
def test_reader_without_spans_returns_none(name, monkeypatch):
    """A program without the registry (the parent of the spans) or without
    the span read leaves the metric out."""
    from mpgnn_tpu_torch.utils import prof

    run = make_run("mag.train")
    run.spans.update(at_hetero_s=1.0, at_program_s=2.0)
    reader = harness.load_module("metrics", name)
    monkeypatch.setattr(prof, "spans", lambda: {})
    assert reader.read(run) is None
    monkeypatch.delattr(prof, "spans")
    assert reader.read(run) is None
