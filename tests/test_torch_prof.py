"""mpgnn_tpu_torch.utils.prof on the CPU: ``PhaseTimer`` as the JAX
package's (the same summary layout), and ``device_trace`` writing one
torch.profiler Chrome trace JSON that names the ops run inside it, with
the spans timed inside it beside it, and doing nothing without a
directory."""

import json
import os
import time

import torch

from mpgnn_tpu.utils.prof import PhaseTimer as JPhaseTimer
from mpgnn_tpu_torch.utils.prof import PhaseTimer, device_trace, span


def test_phase_timer_matches_jax(monkeypatch):
    """On a clock that advances only by the phases' own durations, both
    timers give the same totals, counts and order (longest first)."""
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    timers = (PhaseTimer(), JPhaseTimer())
    for t in timers:
        for name, dur, reps in (("a", 0.002, 3), ("b", 0.01, 1),
                                ("c", 0.003, 2)):
            for _ in range(reps):
                with t.phase(name):
                    clock[0] += dur
    got, want = (t.summary() for t in timers)
    assert got == want
    assert list(got) == ["b", "a", "c"]
    assert got["a"] == {"total_s": 0.006, "count": 3}
    assert json.loads(timers[0].dump()) == got
    try:
        with timers[0].phase("d"):
            clock[0] += 1.0
            raise KeyError("x")
    except KeyError:
        pass
    assert timers[0].counts["d"] == 1 and timers[0].totals["d"] == 1.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with span("outside.trace"):
        pass
    with device_trace(d) as path:
        x = torch.ones(64, 64)
        with span("inside.trace"):
            (x @ x).sum()
    name = os.path.basename(path)
    spans_name = "spans-" + name[len("trace-"):]
    assert os.path.dirname(path) == d
    assert sorted(os.listdir(d)) == sorted([name, spans_name])
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names and "inside.trace" in names
    with open(os.path.join(d, spans_name)) as f:
        spans = json.load(f)
    assert spans["inside.trace"]["traced_calls"] == 1
    assert spans["outside.trace"]["traced_calls"] == 0
    with device_trace(None) as nothing:
        torch.ones(2).sum()
    assert nothing is None
    with device_trace("") as nothing:
        pass
    assert nothing is None
    assert sorted(os.listdir(d)) == sorted([name, spans_name])
