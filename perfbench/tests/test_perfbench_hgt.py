"""The HGT cell's own pieces: its configuration keeps the paper's widths
and the R-GCN cell's graph and names the program's parameters; its run on
the CPU at a reduced size comes out correct and its control, half batch
and broken steps do not; its readers leave their metrics out without a
trace; the plain reference's blocked attention is its per-edge equations;
the counts the roofline and the peaks read, by hand."""

from __future__ import annotations

import pytest
import torch

from perfbench import control, harness
from perfbench.reference import hgt as ref
from perfbench.tests.perfbench_helpers import CHECKOUT, drive, make_run

BENCH = harness.load_benchmark(CHECKOUT)
CELL = "mag_hgt.train"
READERS = ("attn_ms.hgt", "typed_ms.hgt", "attn_roofline.hgt")
SHARED = ("epoch_ms", "mfu.train", "device_idle.train", "fwd_ms.train",
          "bwd_ms.train", "opt_ms.train")


def test_the_cell_and_its_configuration():
    cell = harness.cell(BENCH, CELL)
    cfg = harness.config_of(BENCH, cell["config"], CHECKOUT)
    assert cell["chips"] == 1 and cell["traffic"] == "train"
    assert cfg["name"] == "mag_hgt_h256" and cfg["reduced"] == []
    assert cfg["source"] == "https://arxiv.org/abs/2003.01332"
    assert cfg["graph"] == harness.config_of(BENCH, "mag_rgcn_h64",
                                             CHECKOUT)["graph"]
    m = cfg["model"]
    assert (m["name"], m["hidden_dim"], m["heads"], m["layers"]) == \
        ("hgt", 256, 8, 3)
    assert (m["dtype"], m["tf32"], m["dropout"], m["lr"],
            m["weight_decay"]) == ("float32", False, 0.0, 1e-3, 0.0)
    assert len(m["relations"]) == 8
    for name in READERS:
        entry = next(x for x in BENCH["per_layer"] if x["name"] == name)
        assert entry["workloads"] == [CELL] and entry["moves"] == "epoch_ms"
    for name in SHARED:
        entry = next(x for x in BENCH["end_to_end"] + BENCH["per_layer"]
                     if x["name"] == name)
        assert CELL in entry["workloads"]


def test_param_spec_names_the_programs_parameters():
    from mpgnn_tpu_torch.models.hgt import HgtNet

    cfg = harness.config_of(BENCH, "mag_hgt_h256", CHECKOUT)
    spec = harness.load_module("models", "hgt").param_spec(cfg, 128, 349)
    net = HgtNet(128, 256, 4, 8, 349, 3, 8, device="meta")
    assert [(n, tuple(s)) for n, s, _ in spec] == \
        [(n, tuple(p.shape)) for n, p in net.named_parameters()]
    kinds = {n.split(".")[-1]: k for n, _, k in spec}
    assert kinds["mu"] == kinds["skip"] == "linear_bias:1"
    assert kinds["att"] == kinds["msg"] == kinds["k_w"] == "glorot"


def test_a_configuration_that_is_not_hgt_is_refused():
    run = make_run(CELL)
    run.config["model"]["dropout"] = 0.5
    with pytest.raises(ValueError, match="no dropout"):
        drive(run)
    run = make_run(CELL)
    run.config["model"]["relations"] = run.config["model"]["relations"][:4]
    with pytest.raises(ValueError, match="every relation"):
        drive(run)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_a_trace_return_none(name, monkeypatch):
    from mpgnn_tpu_torch.utils import prof

    run = drive(make_run(CELL))
    reader = harness.load_module("metrics", name)
    assert reader.read(run) is None                    # not traced
    monkeypatch.setattr(prof, "spans", lambda: {})
    assert reader.read(run) is None
    monkeypatch.delattr(prof, "spans")
    assert reader.read(run) is None


def test_a_traced_cpu_run_reads_the_shapes_and_no_device_time():
    from mpgnn_tpu_torch.utils import prof

    run = make_run(CELL)
    run.trace = True
    prof.reset_spans()
    try:
        drive(run)
        run.counters["memory_peak_bytes"] = 0
        line = harness.metric_values(run, BENCH)
        spans = prof.spans()
    finally:
        prof.reset_spans()
    layers = run.shapes["attention"]
    assert len(layers) == 3 and layers[0] == layers[1]
    assert layers[2]["rows"] == run.config["graph"]["split"]["train"]
    assert 0 < layers[2]["edges"] < layers[0]["edges"]
    assert [a["edges"] for a in run.info["attention"]] == \
        [s["edges"] for s in layers]
    assert not set(READERS) & set(line)                # no card here
    assert "mfu.train" in line and run.work.flops > 0
    # three attentions and one row tail a step, in every traced step
    steps = spans["train.step"]["calls"]
    assert spans["hgt.attention"]["calls"] == 3 * steps
    assert spans["model.row_tail"]["calls"] == steps


# ------------------------------------------------------------ the reference
def _edges(n=40, e=300, rels=3, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return {r: (torch.randint(n, (e,), generator=gen),
                torch.randint(n, (e,), generator=gen)) for r in range(rels)}


@pytest.mark.parametrize("softmax", ["node", "relation"])
def test_the_blocked_attention_is_its_per_edge_equations(softmax,
                                                          monkeypatch):
    """The reference's attention, in blocks of 7 edges with its own
    backward, against the same equations in plain autograd."""
    n, heads, dk = 40, 2, 4
    edges = _edges(n)
    t, s, group, segs = ref.relation_edges(edges, 3, softmax)
    gen = torch.Generator().manual_seed(2)

    def r(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
    q, k, v = r(n, 8), r(n, 8), r(n, 8)
    w_att, w_msg = r(3, heads, dk, dk), r(3, heads, dk, dk)
    monkeypatch.setattr(ref, "EDGE_BLOCK", 7)
    got = ref._Attention.apply(q, k, v, w_att, w_msg, t, s, group, segs, n,
                               heads, "float64")
    rel = torch.cat([torch.full((hi - lo,), rr) for rr, lo, hi in segs])
    kw = torch.einsum("ehd,ehdf->ehf", k.view(n, heads, dk)[s], w_att[rel])
    score = (kw * q.view(n, heads, dk)[t]).sum(-1)
    want = torch.zeros(n, heads, dk, dtype=torch.float64)
    msg = torch.einsum("ehd,ehdf->ehf", v.view(n, heads, dk)[s], w_msg[rel])
    for gid in torch.unique(group):
        at = group == gid
        a = torch.softmax(score[at], 0)
        want = want.index_add(0, t[at], a[..., None] * msg[at])
    want = want.view(n, 8)
    torch.testing.assert_close(got, want)
    g = torch.randn(n, 8, generator=gen, dtype=torch.float64)
    args = (q, k, v, w_att, w_msg)
    for a, b in zip(torch.autograd.grad((got * g).sum(), args),
                    torch.autograd.grad((want * g).sum(), args)):
        torch.testing.assert_close(a, b)


def test_a_softmax_per_relation_is_another_model():
    n = 40
    edges = _edges(n)
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(n, 8, generator=gen, dtype=torch.float64)
               for _ in range(3))
    w = torch.randn(3, 2, 4, 4, generator=gen, dtype=torch.float64)
    outs = [ref._Attention.apply(q, k, v, w, w, *ref.relation_edges(
        edges, 3, sm), n, 2, "float64") for sm in ("node", "relation")]
    assert float((outs[0] - outs[1]).abs().max()) > 1e-2


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
    run = drive(make_run(CELL))
    assert not run.correct
    assert dict((n, v) for n, v, _ in run.checks)["delta_gap"] == 1.0


def test_half_the_batch_left_out(monkeypatch):
    """The HGT step's loss takes the tail's rows in their order and passes
    no index: the fault keeps the first half of them."""
    from mpgnn_tpu_torch.train import loops

    nll = loops.weighted_nll

    def half(logp, idx, y, w):
        k = max(1, y.numel() // 2)
        return nll(logp[:k], None, y[:k], w[:k])

    monkeypatch.setattr(loops, "weighted_nll", half)
    assert not drive(make_run(CELL)).correct


@pytest.mark.cuda
def test_control_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = make_run(CELL, factor=20.0, device="cuda")
    failed, got = _fails_a_limit(run, "control")
    assert failed, got
    assert drive(make_run(CELL, factor=20.0, device="cuda")).correct


# ------------------------------------------------------------ the count
def test_attention_bytes_by_hand():
    # 5 target rows, 20 edges, 4 source nodes, width 8 in 2 heads
    fwd = 4 * (5 * 8 + 2 * 4 * 8) + 4 * (20 + 5 + 1) + 4 * 5 * (8 + 2)
    bwd = 4 * (3 * 5 * 8 + 5 * 2 + 2 * 4 * 8) + 4 * (20 + 5 + 1) \
        + 4 * (5 * 8 + 2 * 4 * 8)
    assert ref.attention_bytes(5, 20, 4, 8, 2) == fwd + bwd
    mod = harness.load_module("metrics", "attn_roofline.hgt")
    one = {"rows": 5, "edges": 20, "sources": 4}
    shapes = {"hidden": 8, "heads": 2, "attention": [one, one]}
    assert mod.epoch_bytes(shapes) == 2 * (fwd + bwd)


def test_hgt_epoch_by_hand():
    """N=10, F=4, D=4 in 2 heads, C=3, 2 layers, the last at 6 rows."""
    full = {"rows": 10, "edges": 30, "sources": 9, "rel_rows": 12}
    tail = {"rows": 6, "edges": 14, "sources": 7, "rel_rows": 9}
    w = ref.step_work(10, 4, 4, 2, 3, [full, tail], num_params=100)
    mm = 2 * 2 * 10 * 4 * 4                                  # input Linear
    for sh in (full, tail):
        mm += 3 * 2 * 10 * 4 * 4 * 2                         # K, V
        mm += 3 * 2 * sh["rows"] * 4 * 4 * 2                 # Q, A
        mm += 2 * 2 * sh["rel_rows"] * 4 * 2 * 3             # W^ATT, W^MSG
        mm += 2 * 4 * sh["edges"] * 6                        # per edge
    elem = 2 * 10 * 4                                        # ReLU
    for sh in (full, tail):
        elem += 2 * 5 * sh["edges"] * 2 + 2 * 8 * sh["rows"] * 4 \
            + 2 * 3 * sh["rows"] * 4
    head = 3 * 2 * 6 * 4 * 3 + 2 * 5 * 18 + 2 * 2 * 6
    assert w.flops == pytest.approx(mm + elem + head + 14 * 100)
    csr = sum(4 * (sh["edges"] + sh["rows"] + 1)
              + 4 * (sh["edges"] + sh["sources"] + 1) for sh in (full, tail))
    assert w.bytes == 4 * 4 * 10 + csr + 6 * 16 + 4 * 7 * 100


def test_layer_shapes_from_the_edges():
    edges = {0: (torch.tensor([0, 0, 1, 2]), torch.tensor([3, 4, 3, 3])),
             1: (torch.tensor([2, 5]), torch.tensor([0, 0]))}
    full = ref.layer_shapes(edges, 6)
    assert full == {"rows": 6, "edges": 6, "sources": 3,
                    "rel_rows": min(3, 2) + min(2, 1)}
    tail = ref.layer_shapes(edges, 6, torch.tensor([2, 5]))
    assert tail == {"rows": 2, "edges": 3, "sources": 2,
                    "rel_rows": 1 + 1}
