"""Each cell's run driven on the CPU at a reduced size, without the
harness's look for a card: sound, it comes out correct; with its control
(the reference in the precision below the configuration's) or with the
timed path broken underneath, not."""

from __future__ import annotations

import pytest
import torch

from perfbench import control, harness
from perfbench.tests.perfbench_helpers import drive, make_run

TRAIN = ("mag.train",)


@pytest.mark.parametrize("workload", TRAIN)
def test_sound_run_is_correct(workload):
    run = drive(make_run(workload))
    assert run.correct, run.checks
    assert run.attempted >= 1


@pytest.mark.parametrize("workload", TRAIN)
def test_control_fails_a_limit(workload):
    run = make_run(workload)
    got = control.reading_of(run, "control")
    limits = run.config["limits"]["train"]
    assert any(got[k] > v for k, v in limits.items()), got


@pytest.mark.parametrize("workload", TRAIN)
def test_half_batch_fault_fails_a_limit(workload):
    run = make_run(workload)
    got = control.reading_of(run, "half_batch")
    limits = run.config["limits"]["train"]
    assert any(got[k] > v for k, v in limits.items()), got


def test_the_configured_dtype_holds():
    run = make_run("mag.train")
    run.config["model"]["dtype"] = "float64"
    with pytest.raises(ValueError, match="float64"):
        drive(run)


def test_a_number_without_a_limit_is_read_and_not_held():
    run = make_run("mag.train")
    del run.config["limits"]["train"]["loss_gap"]
    drive(run)
    assert [name for name, _, _ in run.checks] == ["grad1_gap", "delta_gap"]
    assert set(run.info["not_held"]) == {"loss_gap"}


# ------------------------------------------------------- broken programs
@pytest.mark.parametrize("workload", TRAIN)
def test_step_that_leaves_its_state_unchanged(workload, monkeypatch):
    step = torch.optim.Adam.step

    def unchanged(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        kept = [p.detach().clone() for p in params]
        step(self, closure)
        with torch.no_grad():
            for p, k in zip(params, kept):
                p.copy_(k)

    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)
    assert not drive(make_run(workload)).correct


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out(workload, monkeypatch):
    from mpgnn_tpu_torch.train import loops

    nll = loops.weighted_nll

    def half(logp, idx, y, w):
        k = max(1, idx.numel() // 2)
        return nll(logp, idx[:k], y[:k], w[:k])

    monkeypatch.setattr(loops, "weighted_nll", half)
    assert not drive(make_run(workload)).correct


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TRAIN)
def test_control_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = make_run(workload, factor=20.0, device="cuda", backend="auto")
    got = control.reading_of(run, "control")
    limits = run.config["limits"]["train"]
    assert any(got[k] > v for k, v in limits.items()), got
    assert drive(make_run(workload, factor=20.0, device="cuda",
                          backend="auto")).correct


def test_result_line_keys():
    run = drive(make_run("mag.train"))
    run.counters["memory_peak_bytes"] = 0
    bench = harness.load_benchmark(harness.ROOT.parent)
    line = harness.metric_values(run, bench)
    assert set(line) == {"epoch_ms", "setup_s"}
