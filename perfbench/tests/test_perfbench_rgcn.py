"""The R-GCN cell's own pieces: its configuration reads and names the
program's parameters, its run on the CPU at a reduced size comes out
correct and its control and broken steps do not, its readers leave their
metrics out without a trace, and the shapes they read come from the
graph."""

from __future__ import annotations

import pytest
import torch

from perfbench import control, harness
from perfbench.tests.perfbench_helpers import CHECKOUT, drive, make_run

BENCH = harness.load_benchmark(CHECKOUT)
READERS = ("rel_agg_ms.rgcn", "agg_roofline.rgcn")
SETUP = ("operand_build_s", "csr_route_s", "csr_build_s", "setup_unspanned_s")
CELL = "mag_rgcn.train"


def test_the_cell_and_its_configuration():
    cell = harness.cell(BENCH, "mag_rgcn.train")
    cfg = harness.config_of(BENCH, cell["config"], CHECKOUT)
    assert cell["chips"] == 1 and cell["traffic"] == "train"
    assert cfg["name"] == "mag_rgcn_h64" and cfg["reduced"] == []
    mpnetm = harness.config_of(BENCH, "mag_mpnetm_h64", CHECKOUT)
    assert cfg["graph"] == mpnetm["graph"]
    m = cfg["model"]
    assert (m["name"], m["hidden_dim"], m["output_dim"], m["layers"]) == \
        ("rgcn", 64, 64, 3)
    assert (m["dtype"], m["tf32"], m["dropout"]) == ("float32", False, 0.0)
    assert len(m["relations"]) == 8
    for name in READERS:
        entry = next(x for x in BENCH["per_layer"] if x["name"] == name)
        assert entry["workloads"] == ["mag_rgcn.train"]


def test_param_spec_names_the_programs_parameters():
    from mpgnn_tpu_torch.models.mpgnn import RgcnNet

    cfg = harness.config_of(BENCH, "mag_rgcn_h64", CHECKOUT)
    mod = harness.load_module("models", "rgcn")
    spec = mod.param_spec(cfg, 128, 349)
    net = RgcnNet(128, 64, 8, 64, 349, device="cpu")
    assert [(n, tuple(s)) for n, s, _ in spec] == \
        [(n, tuple(p.shape)) for n, p in net.named_parameters()]


def test_a_configuration_that_is_not_the_net_is_refused():
    run = make_run("mag_rgcn.train")
    run.config["model"]["dropout"] = 0.5
    with pytest.raises(ValueError, match="no dropout"):
        drive(run)
    run = make_run("mag_rgcn.train")
    run.config["model"]["relations"] = run.config["model"]["relations"][:4]
    with pytest.raises(ValueError, match="every relation"):
        drive(run)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_a_trace_return_none(name, monkeypatch):
    from mpgnn_tpu_torch.utils import prof

    run = drive(make_run("mag_rgcn.train"))
    reader = harness.load_module("metrics", name)
    assert reader.read(run) is None                    # not traced
    monkeypatch.setattr(prof, "spans", lambda: {})
    assert reader.read(run) is None
    monkeypatch.delattr(prof, "spans")
    assert reader.read(run) is None


def test_a_traced_cpu_run_reads_the_shapes_and_no_device_time():
    run = make_run("mag_rgcn.train")
    run.trace = True
    drive(run)
    run.counters["memory_peak_bytes"] = 0
    rels = run.shapes["relations"]
    assert len(rels) == 8 and all(r["edges"] > 0 for r in rels)
    # the forward and reverse of a relation swap rows and columns
    for a, b in zip(rels[:4], rels[4:]):
        assert (a["edges"], a["rows"], a["cols"]) == \
            (b["edges"], b["cols"], b["rows"])
    line = harness.metric_values(run, BENCH)
    assert not set(READERS) & set(line)                # no card here
    assert "mfu.train" in line and run.work.flops > 0


def test_the_set_up_metrics_read_the_cells_operand_build():
    """The hop operands' metrics read the build inside ``setup_rgcn``:
    its host seconds enclose the routing's and the blockings'."""
    from mpgnn_tpu_torch.utils import prof

    run = make_run("mag_rgcn.train")
    run.trace = True                       # per-layer metrics: --trace 1
    prof.reset_spans()
    try:
        drive(run)
        line = harness.metric_values(run, BENCH)
    finally:
        prof.reset_spans()
    got = {k: line[k]["value"] for k in SETUP}
    assert got["operand_build_s"] >= got["csr_route_s"] + got["csr_build_s"]
    assert got["setup_unspanned_s"] >= 0.0
    for name in SETUP:
        entry = next(x for x in BENCH["per_layer"] if x["name"] == name)
        assert entry["workloads"] == ["mag.train", "mag_rgcn.train"]


def test_the_roofline_counts_every_aggregating_layer():
    mod = harness.load_module("metrics", "agg_roofline.rgcn")
    rel = {"edges": 5, "rows": 3, "cols": 2}
    shapes = {"num_nodes": 10, "hidden": 8, "output": 4, "layers": 3,
              "relations": [rel, {"edges": 0, "rows": 0, "cols": 0}]}
    one = (4 * (2 + 10) + 4 * (3 + 10)) * 4 + 2 * 4 * (5 + 10 + 1)
    two = (4 * (2 + 10) + 4 * (3 + 10)) * 8 + 2 * 4 * (5 + 10 + 1)
    assert mod.epoch_bytes(shapes) == one + two
    assert mod.epoch_bytes(dict(shapes, layers=1)) == 0


def test_reference_runs_at_its_block_edges(monkeypatch):
    """Blocks of the per-edge products give the one-block answer."""
    from perfbench.reference import rgcn as ref

    gen = torch.Generator().manual_seed(3)
    h = torch.randn(50, 4, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(4, 3, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    src = torch.randint(50, (97,), generator=gen)
    dst = torch.randint(50, (97,), generator=gen)
    s, d, c = ref.relation_edges(src, dst, 50, torch.float64)
    outs = []
    for block in (1 << 21, 10):
        monkeypatch.setattr(ref, "EDGE_BLOCK", block)
        y = ref._RelationTerm.apply(h, w, s, d, c, 50, "float64")
        gh, gw = torch.autograd.grad((y * y).sum(), (h, w))
        outs.append((y.detach(), gh, gw))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b)


# ------------------------------------------ the run, its control, faults
def _fails_a_limit(run, reading):
    got = control.reading_of(run, reading)
    limits = run.config["limits"]["train"]
    return any(got[k] > v for k, v in limits.items()), got


def test_sound_run_is_correct():
    run = drive(make_run(CELL))
    assert run.correct, run.checks
    assert run.attempted >= 1
    assert {name for name, _, _ in run.checks} == \
        set(run.config["limits"]["train"])


@pytest.mark.parametrize("reading", ("control", "half_batch"))
def test_control_and_half_batch_fail_a_limit(reading):
    failed, got = _fails_a_limit(make_run(CELL), reading)
    assert failed, got


def test_step_that_leaves_its_state_unchanged(monkeypatch):
    step = torch.optim.Adam.step

    def unchanged(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        kept = [p.detach().clone() for p in params]
        step(self, closure)
        with torch.no_grad():
            for p, k in zip(params, kept):
                p.copy_(k)

    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)
    assert not drive(make_run(CELL)).correct


def test_half_the_batch_left_out(monkeypatch):
    """The R-GCN step runs its head at the loss's rows and passes no index:
    the fault keeps the first half of those rows."""
    from mpgnn_tpu_torch.train import loops

    nll = loops.weighted_nll

    def half(logp, idx, y, w):
        k = max(1, y.numel() // 2)
        if idx is None:                   # logp's rows are the loss's
            return nll(logp[:k], None, y[:k], w[:k])
        return nll(logp, idx[:k], y[:k], w[:k])

    monkeypatch.setattr(loops, "weighted_nll", half)
    assert not drive(make_run(CELL)).correct


@pytest.mark.cuda
def test_control_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = make_run(CELL, factor=20.0, device="cuda", backend="auto")
    failed, got = _fails_a_limit(run, "control")
    assert failed, got
    assert drive(make_run(CELL, factor=20.0, device="cuda",
                          backend="auto")).correct


# ------------------------------------------------------------ the count
def test_rgcn_epoch_by_hand():
    """Two layers, N=10, F=4, hidden = output = 2, C=3, 6 train rows, one
    relation: layer 0 on all rows, its aggregation a constant; the last
    layer and the head at the 6 train rows, over the relation's edges from
    them."""
    from perfbench.reference import rgcn

    rel = {"edges": 5, "rows": 3, "cols": 4}
    tail = {"edges": 2, "rows": 2, "cols": 2}
    w = rgcn.step_work(10, 4, 2, 2, 3, 2, 6, [rel], [tail], num_params=50)
    layer0 = 2 * 2 * 3 * 4 * 2 + 2 * 2 * 10 * 4 * 2 + 2 * 2 * 20 + 2 * 6
    layer1 = (3 * 2 * 2 * 2 * 2 + 2 * 2 * 2 * 2) + 3 * 2 * 6 * 2 * 2 \
        + 2 * 2 * 12 + 2 * 4
    head = 3 * 2 * 6 * 2 * 3 + 2 * 5 * 18 + 2 * 3 * 6 + 14 * 50
    assert w.flops == layer0 + layer1 + head
    assert w.bytes == 4 * 4 * (10 + 3) + 4 * (2 + 10 + 1) * 2 \
        + 6 * 20 + 4 * 7 * 50
    # a relation into 1 destination from 9 sources: its product there,
    # then the sum over the edges, both every epoch, beat the product on
    # 9 rows of the constant aggregation
    few = {"edges": 5, "rows": 9, "cols": 1}
    w2 = rgcn.step_work(10, 4, 2, 2, 3, 2, 6, [few], [tail], num_params=50)
    product_9 = 2 * 2 * 9 * 4 * 2
    transform_first = 2 * 2 * 1 * 4 * 2 + 2 * 2 * 5 * 2
    assert transform_first < product_9
    assert w2.flops == w.flops - 2 * 2 * 3 * 4 * 2 + transform_first \
        - 2 * 6 + 2 * 18
    assert w2.bytes == w.bytes + 4 * 4 * 6 + 2 * 4 * (5 + 10 + 1)
