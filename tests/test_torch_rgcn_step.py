"""The R-GCN baseline on the port's normal path, on the CPU: ``RgcnNet`` on
the relations' row-term blockings (``rgcn_baseline.rgcn_operands``,
``ops.csr.RowTermBlockings``) and the shared step skeleton
(``train.loops.optimizer_step``) against the plain reference of the
benchmark (``perfbench/reference/rgcn.py``, float64, per edge), the
baseline's loss against the JAX-parity aggregation ``rgcn_aggregate``, the
CLI, and MPNetm's step unchanged by the shared skeleton.

The graphs are seeded random typed graphs of four kinds (``KINDS``):
'partial', 4 relations whose sources are drawn from a part of the nodes
only, so that some nodes have no edges in some relations (no term of
theirs), with repeated edges (counted in 1/c_{i,r}), and a fifth relation
with no edge at all (no blocking); 'every_row', a relation that reaches
every row; 'hub_k2', a relation whose edges all point at a few hubs, so
that ``build_csr_blocking`` routes its forward to K2 and ``rgcn_operands``
builds its K1 forward from its edges; 'isolated', nodes with no edge at
all and a relation of one edge. A graph with no edge at all has no
blockings.

Tolerances, with their reasons:
* log-probabilities, the loss and the first gradients: the program sums
  and multiplies in float32 where the reference does in float64, in
  another order (aggregate, then one product a relation, against a
  product per edge); values of order 1 over sums of up to ~100 terms keep
  a float32 error under 1e-6, so rtol 1e-5, atol 1e-6 (a float32 run of
  the reference's equations with any term left out or any relation's
  normalization changed misses by more than 1e-3).
* 3 Adam steps: the losses as above; each leaf's change atol 1e-4 (Adam
  divides a gradient by its running RMS, so an element that float32
  rounding dominates moves by up to lr a step: ``tests/test_torch_train.
  py``'s reason) and the norms of the first decayed gradients rtol 1e-5.
* the baseline's loss against ``rgcn_aggregate``'s forward: both float32,
  the same terms in another order: atol 1e-6.
* MPNetm's step through the shared skeleton: bitwise, the same operations
  in the same order.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpgnn_tpu_torch import rgcn_baseline
from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.models.mpgnn import (
    init_rgcn_net,
    precompute_first_hop,
    precompute_rgcn_rows,
)
from mpgnn_tpu_torch.models.relconv import rgcn_aggregate, rgcn_edges
from mpgnn_tpu_torch.ops import csr
from mpgnn_tpu_torch.train import loops
from mpgnn_tpu_torch.utils import prof
from perfbench.reference import rgcn as ref

ROOT = Path(__file__).resolve().parent.parent
N, F, H, C, R = 60, 6, 8, 3, 5
LAYERS = 3
RTOL, ATOL = 1e-5, 1e-6
DELTA_ATOL = 1e-4
VARIANTS = [{}, dict(num_bases=2), dict(num_blocks=2)]


def _typed(rng, src, dst, num_relations):
    """A HeteroGraph of N nodes from per-relation edge arrays."""
    return HeteroGraph(rng.normal(size=(N, F)).astype(np.float32),
                       np.concatenate(src).astype(np.int64),
                       np.concatenate(dst).astype(np.int64),
                       np.concatenate([np.full(len(s), r)
                                       for r, s in enumerate(src)]),
                       num_relations=num_relations)


def _partial():
    rng = np.random.default_rng(11)
    src, dst = [], []
    for r in range(R - 1):               # relation R - 1 has no edge
        e = 40 + 15 * r
        src.append(rng.integers(0, 25 + 8 * r, e))
        dst.append(rng.integers(0, N, e))
    return _typed(rng, src, dst, R)


def _every_row():
    """Relation 0 reaches every row, 1 a few rows, 2 most rows."""
    rng = np.random.default_rng(13)
    src = [np.arange(N), rng.integers(0, 6, 20), rng.integers(0, N, 70)]
    return _typed(rng, src, [rng.integers(0, N, len(s)) for s in src], 3)


def _hub_k2():
    """Relation 1's 150 edges point at 3 hubs: its forward routes to K2."""
    rng = np.random.default_rng(14)
    src = [rng.integers(0, 40, 50), rng.integers(0, N, 150),
           rng.integers(10, N, 45)]
    dst = [rng.integers(0, N, 50), rng.integers(0, 3, 150),
           rng.integers(0, N, 45)]
    return _typed(rng, src, dst, 3)


def _isolated():
    """Nodes 30-59 have no edge; relation 1 has one edge, relation 2
    none."""
    rng = np.random.default_rng(15)
    src = [rng.integers(0, 30, 40), np.array([4]), np.zeros(0, np.int64)]
    dst = [rng.integers(0, 30, 40), np.array([17]), np.zeros(0, np.int64)]
    return _typed(rng, src, dst, 3)


KINDS = {"partial": _partial, "every_row": _every_row, "hub_k2": _hub_k2,
         "isolated": _isolated}


@pytest.fixture(scope="module")
def graph():
    return _partial()


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(12)
    idx = rng.permutation(N)[:36]
    return torch.from_numpy(idx), torch.from_numpy(rng.integers(0, C, 36))


def _edges(g):
    return {r: tuple(torch.from_numpy(a.astype(np.int64))
                     for a in g.rel_edges(r))
            for r in range(g.num_relations)}


def _setup(g, rows, kw, backend="auto"):
    cfg = MPGNNConfig(hidden_dim=H, lr=0.01, weight_decay=5e-4, **kw)
    return rgcn_baseline.setup_rgcn(g, torch.from_numpy(g.x), *rows, C,
                                    LAYERS, cfg, backend, seed=5,
                                    device="cpu")


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _ref_loss(g, rows, p, precision="float64"):
    """The reference's weighted NLL from the parameters ``p`` (leaves)."""
    dt = ref.dtype_of(precision)
    rels = {r: ref.relation_edges(s, d, N, dt)
            for r, (s, d) in _edges(g).items() if s.numel()}
    idx, y = rows
    logp = ref.forward(torch.from_numpy(g.x).to(dt), rels, p, LAYERS,
                       precision, idx)
    w = ref.balanced_weights(y, C, dt)
    per = -logp.gather(1, y[:, None])[:, 0]
    return logp, (per * w).sum() / w.sum()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kw", VARIANTS, ids=["plain", "bases", "blocks"])
def test_forward_loss_and_gradients_match_the_reference(rows, kind, kw):
    graph = KINDS[kind]()
    run = _setup(graph, rows, kw)
    present = graph.present_relations()
    assert run.backend == "csr" and run.blk.rels == tuple(present)
    assert [op is not None for op in run.rel_ops] == [
        r in present for r in range(graph.num_relations)]
    logp = run.model(run.x, run.blk, LAYERS, first=run.first,
                     rows=run.train_idx)
    loss = loops.weighted_nll(logp, None, run.train_y, run.w)
    loss.backward()
    p = {k: v.double().requires_grad_(True)
         for k, v in _params(run.model).items()}
    want_logp, want = _ref_loss(graph, rows, p)
    want.backward()
    np.testing.assert_allclose(logp.detach().numpy(),
                               want_logp.detach().numpy(), RTOL, ATOL)
    assert abs(float(loss.detach()) - float(want.detach())) \
        <= ATOL + RTOL * abs(float(want.detach()))
    for k, q in run.model.named_parameters():
        np.testing.assert_allclose(q.grad.numpy(), p[k].grad.numpy(),
                                   RTOL, ATOL, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kw", VARIANTS, ids=["plain", "bases", "blocks"])
def test_three_adam_steps_match_the_reference(rows, kind, kw):
    graph = KINDS[kind]()
    run = _setup(graph, rows, kw)
    p0 = _params(run.model)
    losses = []
    for t in range(3):
        losses.append(float(run.step().detach()))
        if t == 0:
            g1 = {k: float((run.opt.state[q]["exp_avg"] / 0.1).norm())
                  for k, q in run.model.named_parameters()}
    want = ref.train_steps(torch.from_numpy(graph.x), _edges(graph), p0,
                           LAYERS, *rows, C, 0.01, 5e-4, steps=3)
    np.testing.assert_allclose(losses, want["losses"], RTOL, ATOL)
    for k, q in run.model.named_parameters():
        assert g1[k] == pytest.approx(want["grad1"][k], rel=RTOL, abs=ATOL)
        assert abs(float((q.detach() - p0[k]).norm()) - want["delta"][k]) \
            <= DELTA_ATOL, k


def test_the_reference_tells_a_wrong_step(graph, rows):
    """The comparison above is tight enough: the reference's equations in
    float32 are within it, with a relation left out or a mean taken over
    all of a node's edges (not its r-edges) they are not."""
    run = _setup(graph, rows, {})
    p = {k: v.double() for k, v in _params(run.model).items()}
    _, good = _ref_loss(graph, rows, p)
    p32 = {k: v.float() for k, v in p.items()}
    rels = {r: ref.relation_edges(s, d, N, torch.float32)
            for r, (s, d) in _edges(graph).items() if s.numel()}
    idx, y = rows
    w = ref.balanced_weights(y, C, torch.float32)

    def gap(rels):
        logp = _plain32(graph, rels, p32, idx)
        per = -logp.gather(1, y[:, None])[:, 0]
        return abs(float((per * w).sum() / w.sum()) - float(good))

    assert gap(rels) <= ATOL
    assert gap({r: v for r, v in rels.items() if r != 1}) > 1e-3
    src = torch.cat([v[0] for v in rels.values()])
    deg = torch.zeros(N).index_add_(0, src, torch.ones(src.numel()))
    assert gap({r: (s, d, 1.0 / deg[s])
                for r, (s, d, _) in rels.items()}) > 1e-3


def _plain32(graph, rels, p, idx):
    """The reference's forward in plain float32 products."""
    h = torch.from_numpy(graph.x)
    for layer in range(LAYERS):
        conv = "conv1" if layer == 0 else "conv2"
        w = ref.effective_weights(p, conv)
        z = h @ p[f"{conv}.root"] + p[f"{conv}.bias"]
        for r, (s, d, coef) in rels.items():
            z = z.index_add(0, s, (h[d] @ w[r]) * coef[:, None])
        h = torch.relu(z)
    return torch.log_softmax(h[idx] @ p["linear.weight"].T
                             + p["linear.bias"], dim=1)


def test_each_layer_sums_its_relations_under_one_span(graph, rows):
    run = _setup(graph, rows, {})
    prof.reset_spans()
    try:
        run.step()
        got = prof.spans()
    finally:
        prof.reset_spans()
    assert got["rgcn.relations"]["calls"] == LAYERS
    assert got["rgcn.relations"]["parent"] == "train_step.forward"
    for name in ("train.step", "train_step.forward", "train_step.backward",
                 "train_step.optimizer"):
        assert got[name]["calls"] == 1, name


def _mean(x, s, d):
    out = np.zeros_like(x, dtype=np.float64)
    cnt = np.zeros(len(x))
    np.add.at(out, s, x[d])
    np.add.at(cnt, s, 1)
    return out / np.maximum(cnt, 1)[:, None]


@pytest.mark.parametrize("kw", VARIANTS, ids=["plain", "bases", "blocks"])
def test_baseline_loss_matches_rgcn_aggregate(graph, kw):
    """``train_rgcn_baseline``'s first loss equals the loss of the
    JAX-parity aggregation ``rgcn_aggregate`` on the same parameters."""
    labels = np.random.default_rng(3).integers(0, C, N)
    split = split_nodes(labels)
    cfg = MPGNNConfig(epochs=1, hidden_dim=H, **kw)
    model = init_rgcn_net(F, H, R, H, C, generator=torch.Generator()
                          .manual_seed(4), device="cpu", **kw)
    edges = rgcn_edges(graph.sorted_src, graph.sorted_dst, graph.sorted_type,
                       N, R)
    x = torch.from_numpy(graph.x)
    with torch.no_grad():
        h = x
        for layer in range(LAYERS):
            conv = model.conv1 if layer == 0 else model.conv2
            agg = rgcn_aggregate(h, conv.effective_weights(), edges)
            h = torch.relu(agg + h @ conv.root + conv.bias)
        logp = torch.log_softmax(model.linear(h), dim=1)
        idx, y = (torch.as_tensor(a, dtype=torch.int64)
                  for a in (split.train_idx, split.train_y))
        w = torch.from_numpy(rgcn_baseline.balanced_class_weights(
            np.asarray(split.train_y), C))[y]
        want = float(loops.weighted_nll(logp, idx, y, w))
    got = rgcn_baseline.train_rgcn_baseline(
        graph, labels, split, C, LAYERS, cfg, device="cpu",
        model=init_rgcn_net(F, H, R, H, C, generator=torch.Generator()
                            .manual_seed(4), device="cpu", **kw))
    assert abs(got["final_loss"] - want) <= ATOL


def test_cli_on_a_tiny_dat_folder(capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = rgcn_baseline.main([
            "--folder", str(ROOT / "data" / "synthetic_multiclass"),
            "--metapath_length", "2", "--hidden_dim", "8", "--epochs", "3",
            "--platform", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "train F1 ")
    assert np.isfinite(res["final_loss"])


def test_set_up_refuses_a_backend_other_than_the_row_terms(graph, rows):
    """'auto' and 'csr' name the one path; the benchmark passes 'auto'."""
    for backend in ("segment", "pallas", "halo"):
        with pytest.raises(ValueError, match="not '" + backend):
            _setup(graph, rows, {}, backend=backend)
    assert _setup(graph, rows, {}, backend="csr").backend == "csr"


def _old_train_step(model, opt, x, hop_ops, first, train_idx, train_y, w,
                    cfg, generator, dt):
    """``train_step``'s body before the shared skeleton, single device."""
    t, n = train_idx.numel(), x.shape[0]
    tail = (t <= loops.ROW_TAIL_SHARE * n
            and n - t >= loops.ROW_TAIL_MIN_DROP)
    opt.zero_grad(set_to_none=True)
    logp = model(x, hop_ops, dropout_rate=cfg.dropout, generator=generator,
                 train=True, first_hop_agg=first, compute_dtype=dt,
                 rows=train_idx if tail else None)
    loss = loops.weighted_nll(logp, None if tail else train_idx, train_y, w)
    loss.backward()
    opt.step()
    return loss


@pytest.mark.parametrize("tail", [False, True], ids=["full", "row_tail"])
def test_mpnetm_step_bitwise_as_before(graph, rows, tail, monkeypatch):
    if tail:
        monkeypatch.setattr(loops, "ROW_TAIL_MIN_DROP", 0)
    metapaths = [[0], [1, 2]]
    cfg = MPGNNConfig(hidden_dim=H)
    hop_ops = loops.build_hop_arrays(graph, metapaths, "csr", "cpu")
    x = torch.from_numpy(graph.x)
    first = precompute_first_hop(x, hop_ops)
    idx, y = rows
    w = torch.ones(idx.numel())
    losses = []
    for step in (loops.train_step, _old_train_step):
        model, drop_seed = loops.seeded_init(F, H, C, metapaths, 9, "cpu")
        opt = loops.make_optimizer(model, cfg)
        gen = torch.Generator().manual_seed(drop_seed)
        losses.append(torch.stack([
            step(model, opt, x, hop_ops, first, idx, y, w, cfg, gen,
                 torch.float32).detach() for _ in range(3)]))
        losses.append(torch.cat([q.detach().flatten()
                                 for q in model.parameters()]))
    assert torch.equal(losses[0], losses[2])
    assert torch.equal(losses[1], losses[3])


def test_the_reference_imports_nothing_of_either_package():
    text = (ROOT / "perfbench" / "reference" / "rgcn.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(mpgnn_tpu|jax)", text, re.M)
    assert "mpgnn_tpu" not in text


@pytest.mark.parametrize("kind", KINDS)
def test_operands_are_the_row_terms_of_the_k1_forwards(kind):
    """``rgcn_operands`` equals, bitwise, ``row_term_blockings`` of every
    relation's K1 forward built from its edges; a forward routed to K2 is
    built anew as K1's."""
    g = KINDS[kind]()
    present = g.present_relations()
    fwds = [hop[0][1] for hop in loops.build_hop_arrays(
        g, [[r] for r in present], "csr", "cpu")]
    assert any(isinstance(b, csr.DedupCsrBlocking) for b in fwds) == (
        kind == "hub_k2")
    got = rgcn_baseline.rgcn_operands(g, "cpu")
    want = csr.row_term_blockings(present, [
        csr.build_csr_blocking(*g.rel_edges(r), N, dedup="never")[0]
        for r in present])
    assert (got.rels, got.offsets) == (want.rels, want.offsets)
    for name in ("fwd", "take", "place", "bwd"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a.num_rows, a.num_cols) == (b.num_rows, b.num_cols)
        for (field, t), (_, u) in zip(a.tensors(), b.tensors()):
            assert t.dtype == u.dtype and torch.equal(t, u), (name, field)
    reach = np.diff(got.offsets)
    if kind == "every_row":
        assert reach[0] == N
    if kind == "isolated":
        assert list(reach[1:]) == [1]


def test_a_graph_without_edges_is_its_roots_and_biases(rows):
    """No relation has an edge: no blockings, every layer ``h @ root +
    bias``; the log-probabilities, the loss and the gradients match the
    reference's (the relations' weights get none), and the step takes
    that loss."""
    rng = np.random.default_rng(16)
    none = np.zeros(0, np.int64)
    g = HeteroGraph(rng.normal(size=(N, F)).astype(np.float32), none, none,
                    none, num_relations=2)
    assert rgcn_baseline.rgcn_operands(g, "cpu") is None
    run = _setup(g, rows, {})
    assert run.blk is None and run.first is None
    assert run.rel_ops == [None, None]
    logp = run.model(run.x, None, LAYERS, rows=run.train_idx)
    loss = loops.weighted_nll(logp, None, run.train_y, run.w)
    loss.backward()
    p = {k: v.double().requires_grad_(True)
         for k, v in _params(run.model).items()}
    want_logp, want = _ref_loss(g, rows, p)
    want.backward()
    np.testing.assert_allclose(logp.detach().numpy(),
                               want_logp.detach().numpy(), RTOL, ATOL)
    for k, q in run.model.named_parameters():
        if p[k].grad is None:
            assert q.grad is None or not q.grad.any(), k
        else:
            np.testing.assert_allclose(q.grad.numpy(), p[k].grad.numpy(),
                                       RTOL, ATOL, err_msg=k)
    assert float(run.step().detach()) == float(loss.detach())


def test_layer_zero_input_holds_each_relations_rows(graph):
    """Layer 0's input is the relations' means of x on the rows they
    reach, side by side in relation order: each relation's rows are its
    sources, ascending."""
    blk = rgcn_baseline.rgcn_operands(graph, "cpu")
    first = precompute_rgcn_rows(torch.from_numpy(graph.x), blk)
    assert blk.rels == tuple(range(R - 1))
    assert first.shape == (blk.offsets[-1], F)
    for i, r in enumerate(blk.rels):
        s, d = graph.rel_edges(r)
        rows = blk.take.col[blk.offsets[i]:blk.offsets[i + 1]].numpy()
        np.testing.assert_array_equal(rows, np.unique(s))
        np.testing.assert_allclose(
            first[blk.offsets[i]:blk.offsets[i + 1]].numpy(),
            _mean(graph.x, s, d)[rows], rtol=RTOL, atol=ATOL)


def _dense(blk):
    """A K1 blocking as a dense float64 matrix (repeated edges summed)."""
    rows = torch.repeat_interleave(torch.arange(blk.num_rows),
                                   blk.row_ptr.diff().long())
    return torch.zeros(blk.num_rows, blk.num_cols, dtype=torch.float64) \
        .index_put_((rows, blk.col.long()), blk.weight.double(),
                    accumulate=True)


def test_row_term_blockings_transpose_and_place(graph):
    """``take`` picks each stacked row's node (one 1 a row), ``place``
    and ``bwd`` are the transposes of ``take`` and ``fwd``, and ``fwd`` is
    each relation's square forward on its rows."""
    ops = [hop[0] for hop in loops.build_hop_arrays(
        graph, [[r] for r in range(R - 1)], "csr", "cpu")]
    blk = csr.row_term_blockings(range(R - 1), [op[1] for op in ops])
    m = blk.offsets[-1]
    want = torch.zeros(m, N, dtype=torch.float64)
    want[torch.arange(m), blk.take.col.long()] = 1.0
    assert torch.equal(_dense(blk.take), want)
    assert torch.equal(_dense(blk.place), want.T)
    assert torch.equal(_dense(blk.bwd), _dense(blk.fwd).T)
    for i, op in enumerate(ops):
        rows = slice(blk.offsets[i], blk.offsets[i + 1])
        assert torch.equal(_dense(blk.fwd)[rows],
                           _dense(op[1])[blk.take.col[rows].long()])


def _step_pair(g, rows, kw, layers=LAYERS):
    """Two runs from the same parameters: the set-up's (its last layer on
    the train rows alone, ``tail``) and one whose step runs every layer on
    every row (``tail`` None)."""
    cfg = MPGNNConfig(hidden_dim=H, lr=0.01, weight_decay=5e-4, **kw)
    return [rgcn_baseline.setup_rgcn(g, torch.from_numpy(g.x), *rows, C,
                                     layers, cfg, seed=5, device="cpu")
            for _ in range(2)]


def _all_rows(run):
    return loops.rgcn_train_step(run.model, run.opt, run.x, run.blk,
                                 run.first, run.metapath_length,
                                 run.train_idx, run.train_y, run.w)


def _assert_cut_is_all_rows(cut, full):
    """The cut step's log-probabilities at the train rows, loss and every
    gradient, then 3 Adam steps, against the all-row step's."""
    assert cut.tail is not None and cut.tail.root
    logps = []
    for run, tail in ((cut, cut.tail), (full, None)):
        logp = run.model(run.x, run.blk, run.metapath_length,
                         first=run.first, rows=run.train_idx, tail=tail,
                         tail_first=run.tail_first)
        loops.weighted_nll(logp, None, run.train_y, run.w).backward()
        logps.append(logp.detach())
    torch.testing.assert_close(logps[0], logps[1], rtol=RTOL, atol=ATOL)
    for (k, p), q in zip(cut.model.named_parameters(),
                         full.model.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=RTOL, atol=ATOL,
                                   msg=k)
        p.grad = q.grad = None
    p0 = _params(cut.model)
    got = [float(cut.step().detach()) for _ in range(3)]
    want = [float(_all_rows(full).detach()) for _ in range(3)]
    np.testing.assert_allclose(got, want, RTOL, ATOL)
    for (k, p), q in zip(cut.model.named_parameters(),
                         full.model.parameters()):
        assert abs(float((p.detach() - p0[k]).norm())
                   - float((q.detach() - p0[k]).norm())) <= DELTA_ATOL, k


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kw", VARIANTS, ids=["plain", "bases", "blocks"])
def test_the_cut_step_equals_the_all_row_step(rows, kind, kw):
    """The last layer on the train rows alone (``tail``) gives what every
    layer on every row gives there: the log-probabilities, the loss, every
    gradient and 3 Adam steps, within float32 rounding (the root's term is
    summed with the relations' in another order)."""
    _assert_cut_is_all_rows(*_step_pair(KINDS[kind](), rows, kw))


@pytest.mark.parametrize("layers", [1, 3])
def test_the_cut_step_on_rows_some_relations_miss(layers):
    """Train rows among relation 0's none (its sources are 0-24) and
    among the others' some: relation 0 drops out of the last layer, a
    train row without an r-edge has no r-term, and the cut step still
    equals the all-row step, also where the last layer is layer 0 (its
    aggregations given once, ``tail_first``)."""
    g = _partial()
    rng = np.random.default_rng(21)
    idx = torch.from_numpy(rng.permutation(np.arange(25, N))[:30])
    rows = idx, torch.from_numpy(rng.integers(0, C, 30))
    cut, full = _step_pair(g, rows, {}, layers)
    assert 0 not in cut.tail.rels and cut.blk.rels[0] == 0
    for i, r in enumerate(cut.tail.rels):
        assert cut.tail.offsets[i + 1] - cut.tail.offsets[i] < 30, r
    assert (cut.tail_first is None) == (layers != 1)
    if layers == 1:
        torch.testing.assert_close(
            cut.tail_first, precompute_rgcn_rows(cut.x, cut.tail))
    _assert_cut_is_all_rows(cut, full)


@pytest.mark.parametrize("kind", KINDS)
def test_tail_blockings_hold_the_full_rows_of_the_train_nodes(rows, kind):
    """``row_term_tail``: each relation keeps, in order, the full
    blockings' rows whose node is a train row, each with its edges in
    order (bitwise); a relation reaching none drops out; the root's block
    gathers each train row's node; ``place`` puts output k at
    ``rows[k]``'s terms, ``take`` and ``bwd`` are the transposes of
    ``place`` and ``fwd``."""
    g = KINDS[kind]()
    blk = rgcn_baseline.rgcn_operands(g, "cpu")
    idx = rows[0]
    tail = csr.row_term_tail(blk, idx)
    assert tail.root and not blk.root
    wanted = np.isin(blk.take.col.numpy(), idx.numpy())
    ptr, tptr = blk.fwd.row_ptr.long(), tail.fwd.row_ptr.long()
    got_rels, j = [], 0
    for i, r in enumerate(blk.rels):
        full = [k for k in range(blk.offsets[i], blk.offsets[i + 1])
                if wanted[k]]
        if not full:
            continue
        got_rels.append(r)
        for k in full:
            assert int(tail.take.col[j]) == int(
                (idx == blk.take.col[k]).nonzero())
            a, b = slice(ptr[k], ptr[k + 1]), slice(tptr[j], tptr[j + 1])
            assert torch.equal(tail.fwd.col[b], blk.fwd.col[a])
            assert torch.equal(tail.fwd.weight[b], blk.fwd.weight[a])
            j += 1
    assert tail.rels == tuple(got_rels)
    t = idx.numel()
    assert tail.offsets[-2:] == (j, j + t) and tail.fwd.num_rows == j + t
    root = slice(tptr[j], tptr[j + t])
    assert torch.equal(tptr[j:].diff(), torch.ones(t, dtype=torch.int64))
    assert torch.equal(tail.fwd.col[root].long(), idx)
    assert torch.equal(tail.fwd.weight[root], torch.ones(t))
    assert torch.equal(tail.take.col[j:].long(), torch.arange(t))
    node = torch.cat([blk.take.col[torch.from_numpy(wanted)].long(), idx])
    want = (node[None, :] == idx[:, None]).double()
    assert torch.equal(_dense(tail.place), want)
    assert torch.equal(_dense(tail.take), want.T)
    assert torch.equal(_dense(tail.bwd), _dense(tail.fwd).T)
    with pytest.raises(ValueError, match="distinct"):
        csr.row_term_tail(blk, torch.cat([idx, idx[:1]]))


def test_the_row_tail_span_counts_the_cut_steps(graph, rows):
    """``model.row_tail`` opens once a training step, inside the last
    layer's ``rgcn.relations``, and never in ``predict``; each layer
    keeps its one ``rgcn.relations``."""
    run = _setup(graph, rows, {})
    prof.reset_spans()
    try:
        run.step()
        run.step()
        got = prof.spans()
        prof.reset_spans()
        run.predict()
        pred = prof.spans()
    finally:
        prof.reset_spans()
    assert got["train.step"]["calls"] == 2
    assert got["model.row_tail"]["calls"] == 2
    assert got["model.row_tail"]["parent"] == "rgcn.relations"
    assert got["rgcn.relations"]["calls"] == 2 * LAYERS
    assert "model.row_tail" not in pred
    assert pred["rgcn.relations"]["calls"] == LAYERS
