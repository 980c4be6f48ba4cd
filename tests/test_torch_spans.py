"""The span registry of mpgnn_tpu_torch.utils.prof on the CPU, and the
spans the program opens: off the profiler a span only counts and times;
under ``torch.profiler`` it is a ``user_annotation`` range around its ops
and counts as traced; each name keeps its first enclosing span as its
parent. ``train_step``, ``build_hop_arrays(backend='csr')`` and
``score_relations_flat`` open their spans once per piece of work. The
device time of traced spans is checked on the card only."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpgnn_tpu_torch.config import MPGNNConfig, ScorerConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.models.mpgnn import init_mpgnn, precompute_first_hop
from mpgnn_tpu_torch.search import scoring
from mpgnn_tpu_torch.train import loops
from mpgnn_tpu_torch.utils import prof
from mpgnn_tpu_torch.utils.prof import PhaseTimer


@pytest.fixture
def fresh():
    """The process-wide registry, empty before and after the test."""
    prof.reset_spans()
    yield prof
    prof.reset_spans()


def _graph(rels: int, n: int = 60, e: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return HeteroGraph(x, rng.integers(0, n, e), rng.integers(0, n, e),
                       rng.integers(0, rels, e), num_relations=rels)


@pytest.mark.parametrize("reps", [1, 3])
def test_span_off_the_profiler_counts_and_times_only(reps, monkeypatch):
    def refused(*a, **k):
        raise AssertionError("no range or event off the profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    t = PhaseTimer()
    for _ in range(reps):
        with t.span("a"):
            torch.ones(8, 8).sum()
    got = t.spans()["a"]
    assert got["calls"] == reps and got["host_s"] > 0.0
    assert got["traced_calls"] == 0 and got["traced_host_s"] == 0.0
    assert got["device_s"] == 0.0 and got["parent"] is None


def test_span_under_the_profiler_is_a_range_around_its_ops(tmp_path):
    t = PhaseTimer()
    x = torch.ones(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with t.span("t.outer"):
            with t.span("t.mm"):
                x @ x
    with t.span("t.mm"):                    # off the profiler: not traced
        x @ x
    path = str(tmp_path / "trace.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (rng,) = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == "t.mm"]
    mm = [e for e in events if e["name"] == "aten::mm"]
    assert any(rng["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= rng["ts"] + rng["dur"] for e in mm)
    got = t.spans()
    assert got["t.mm"]["calls"] == 2 and got["t.mm"]["traced_calls"] == 1
    assert 0.0 < got["t.mm"]["traced_host_s"] <= got["t.mm"]["host_s"]
    assert got["t.mm"]["parent"] == "t.outer"
    assert got["t.outer"]["parent"] is None
    assert got["t.outer"]["traced_calls"] == 1


def test_start_and_stop_across_functions():
    t = PhaseTimer()
    a = t.start("x")
    with t.span("y"):
        pass
    t.stop(a)
    b, c = t.start("p"), t.start("q")
    t.stop(b)                               # closed out of order
    t.stop(c)
    with t.span("z"):
        pass
    got = t.spans()
    assert {k: (v["calls"], v["parent"]) for k, v in got.items()} == {
        "x": (1, None), "y": (1, "x"), "p": (1, None), "q": (1, "p"),
        "z": (1, None)}


def test_parents_are_per_thread_and_no_call_is_lost():
    """Threads share the registry's counts (a lock) and keep their own
    stacks of open spans."""
    t = PhaseTimer()
    threads, reps = 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            with t.span(f"outer.{i}"):
                for _ in range(reps):
                    with t.span("inner"):
                        pass
        pool = [threading.Thread(target=work, args=(i,))
                for i in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    got = t.spans()
    assert got["inner"]["calls"] == threads * reps
    assert got["inner"]["parent"].startswith("outer.")
    assert all(got[f"outer.{i}"]["parent"] is None for i in range(threads))


def test_reset_forgets_every_name(fresh):
    with fresh.span("r.a"):
        with fresh.span("r.b"):
            pass
    assert set(fresh.spans()) == {"r.a", "r.b"}
    fresh.reset_spans()
    assert fresh.spans() == {}
    with fresh.span("r.b"):                 # a parent is a first call's
        pass
    assert fresh.spans()["r.b"]["parent"] is None


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_opens_its_three_phases_once_a_step(fresh, steps):
    g = _graph(2)
    mps = [[0, 1], [1]]
    hop_ops = loops.build_hop_arrays(g, mps, backend="csr", device="cpu")
    model = init_mpgnn(4, 8, 3, mps, device="cpu")
    cfg = MPGNNConfig(hidden_dim=8, dropout=0.5)
    opt = loops.make_optimizer(model, cfg)
    x = torch.as_tensor(g.x)
    first = precompute_first_hop(x, hop_ops)
    idx = torch.arange(20)
    y = idx % 3
    gen = torch.Generator().manual_seed(0)
    fresh.reset_spans()
    for _ in range(steps):
        loops.train_step(model, opt, x, hop_ops, first, idx, y,
                         torch.ones(20), cfg, gen, torch.float32)
    got = fresh.spans()
    assert {k: v["calls"] for k, v in got.items()} == {
        "train.step": steps, "train_step.forward": steps,
        "train_step.backward": steps, "train_step.optimizer": steps}
    for phase in ("forward", "backward", "optimizer"):
        assert got[f"train_step.{phase}"]["parent"] == "train.step"
    assert got["train.step"]["parent"] is None


@pytest.mark.parametrize("epochs", [1, 4])
def test_row_tail_opens_once_a_step_and_never_outside_training(
        fresh, epochs, monkeypatch):
    """``model.row_tail`` counts the training steps of ``fit_mpgnn`` that
    ran the tail on the loss's rows, one a step (the floor on the rows it
    drops taken down to this small graph); ``fit_mpgnn``'s evaluation and
    a predictor's refresh run the full forward."""
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.serve import MetapathPredictor

    g = _graph(2, n=90, e=600)
    mps = [[0], [0, 1]]
    split = split_nodes(np.arange(60) % 3, node_idx=range(60))
    assert len(split.train_idx) <= loops.ROW_TAIL_SHARE * 90
    monkeypatch.setattr(loops, "ROW_TAIL_MIN_DROP", 0)
    model = init_mpgnn(4, 8, 3, mps, device="cpu")
    cfg = MPGNNConfig(hidden_dim=8, epochs=epochs)
    loops.fit_mpgnn(model, loops.build_hop_arrays(g, mps, "csr",
                                                  device="cpu"),
                    torch.as_tensor(g.x), loops.split_tensors(split, "cpu"),
                    torch.ones(3), cfg, torch.Generator().manual_seed(0), 3,
                    track_best=True)
    got = fresh.spans()
    assert got["model.row_tail"]["calls"] == got["train.step"]["calls"] \
        == epochs
    assert got["model.row_tail"]["parent"] == "train_step.forward"
    fresh.reset_spans()
    MetapathPredictor(g, mps, model, backend="csr", device="cpu").refresh()
    loops.evaluate_mpgnn(g, mps, model, split.test_idx, split.test_y, 3,
                         device="cpu")
    assert "model.row_tail" not in fresh.spans()


@pytest.mark.parametrize("rels", [1, 2, 3])
def test_csr_operands_route_and_build_each_direction(fresh, rels):
    g = _graph(rels)
    mps = [[r] for r in range(rels)] + [[0, rels - 1]]
    loops.build_hop_arrays(g, mps, backend="csr", device="cpu")
    got = fresh.spans()
    assert got["csr.route"]["calls"] == 2 * rels
    assert got["csr.build"]["calls"] == 2 * rels
    assert got["operand.upload"]["calls"] == rels
    for name in ("csr.route", "csr.build", "operand.upload"):
        assert got[name]["parent"] == "train.build_hop_arrays"
    fresh.reset_spans()
    loops.build_hop_arrays(g, mps, backend="csr", device="cpu")  # cached
    assert set(fresh.spans()) == {"train.build_hop_arrays"}


@pytest.mark.parametrize("budget", [None, 3000])
def test_flat_sweep_opens_the_four_score_spans(fresh, monkeypatch, budget):
    """Both forms of the hop-0 sweep: ELL (the CPU's default budget) and
    the compact segment form (a small budget)."""
    monkeypatch.setattr(scoring, "_MEM_BUDGET_ENTRIES", budget)
    g = _graph(3, n=200, e=1600)
    labels = np.random.default_rng(1).random(200).astype(np.float32)
    modes = {c[0] for c in scoring._chunks([0, 1, 2], g)}
    assert modes == ({"ell"} if budget is None else {"seg"})
    scoring.score_relations_flat(g, [0, 1, 2], labels, None,
                                 ScorerConfig(epochs_flat=3),
                                 np.random.default_rng(0), device="cpu")
    got = fresh.spans()
    for name in ("score.operands", "score.upload", "score.epochs",
                 "score.gather"):
        assert got[name]["calls"] >= 1, name


@pytest.mark.cuda
def test_traced_span_times_the_card(fresh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(1024, 1024, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with fresh.span("card.mm"):
            for _ in range(10):
                x = x @ x
                x = x / x.norm()
    with fresh.span("card.mm"):             # off the profiler
        x @ x
    got = fresh.spans()["card.mm"]
    assert got["calls"] == 2 and got["traced_calls"] == 1
    assert got["device_s"] > 0.0
