"""The R-GCN baseline on the port's normal path, on the CPU: ``RgcnNet`` on
the relations' hop operands (``rgcn_baseline.rgcn_operands``) and the
shared step skeleton (``train.loops.optimizer_step``) against the plain
reference of the benchmark (``perfbench/reference/rgcn.py``, float64, per
edge), the baseline's loss against the JAX-parity aggregation
``rgcn_aggregate``, the CLI, and MPNetm's step unchanged by the shared
skeleton.

The graph is a seeded random typed graph of 4 relations whose sources are
drawn from a part of the nodes only, so that some nodes have no edges in
some relations (no term of theirs), with repeated edges (counted in
1/c_{i,r}), and a fifth relation with no edge at all (no operand). On
'csr' every relation's term runs on the rows it reaches ('csr_rows'
operands, ``ops.csr.RowTermBlockings``); 'csr_stacked' holds the same
blockings through the stacked product, and a layer where the two paths
mix is held against both.

Tolerances, with their reasons:
* log-probabilities, the loss and the first gradients: the program sums
  and multiplies in float32 where the reference does in float64, in
  another order (aggregate, then one product a relation or one stacked
  product, against a product per edge); values of order 1 over sums of
  up to ~100 terms keep a float32 error under 1e-6, so rtol 1e-5, atol
  1e-6 (the row terms and the stacked product, both float32, are held to
  each other the same way; a float32 run of the reference's equations
  with any term left out or any relation's normalization changed misses
  by more than 1e-3).
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
    ROW_OPERAND,
    RgcnInput,
    init_rgcn_net,
    precompute_first_hop,
    precompute_rgcn_input,
    rgcn_input,
)
from mpgnn_tpu_torch.models.relconv import rgcn_aggregate, rgcn_edges
from mpgnn_tpu_torch.train import loops
from mpgnn_tpu_torch.utils import prof
from perfbench.reference import rgcn as ref

ROOT = Path(__file__).resolve().parent.parent
N, F, H, C, R = 60, 6, 8, 3, 5
LAYERS = 3
RTOL, ATOL = 1e-5, 1e-6
DELTA_ATOL = 1e-4
VARIANTS = [{}, dict(num_bases=2), dict(num_blocks=2)]
BACKENDS = ("csr", "segment")
# 'csr' runs every relation's term on its rows ('csr_rows' operands);
# 'csr_stacked' the same blockings through the stacked product
PATHS = BACKENDS + ("csr_stacked",)


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(11)
    src, dst, rel = [], [], []
    for r in range(R - 1):               # relation R - 1 has no edge
        e = 40 + 15 * r
        src.append(rng.integers(0, 25 + 8 * r, e))
        dst.append(rng.integers(0, N, e))
        rel.append(np.full(e, r))
    x = rng.normal(size=(N, F)).astype(np.float32)
    return HeteroGraph(x, np.concatenate(src), np.concatenate(dst),
                       np.concatenate(rel), num_relations=R)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(12)
    idx = rng.permutation(N)[:36]
    return torch.from_numpy(idx), torch.from_numpy(rng.integers(0, C, 36))


def _edges(g):
    return {r: tuple(torch.from_numpy(a.astype(np.int64))
                     for a in g.rel_edges(r)) for r in range(R)}


def _setup(g, rows, backend, kw, seed=5):
    cfg = MPGNNConfig(hidden_dim=H, lr=0.01, weight_decay=5e-4, **kw)
    return rgcn_baseline.setup_rgcn(g, torch.from_numpy(g.x), *rows, C,
                                    LAYERS, cfg, backend, seed=seed,
                                    device="cpu")


def _path(backend, monkeypatch):
    """The backend of a path of ``PATHS``; 'csr_stacked' keeps the csr
    operands out of the row terms."""
    if backend != "csr_stacked":
        return backend
    monkeypatch.setattr(rgcn_baseline, "row_term_operands",
                        lambda ops, rels: ops)
    return "csr"


def _kinds(run):
    return {op[0] for op in run.rel_ops if op is not None}


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


@pytest.mark.parametrize("backend", PATHS)
@pytest.mark.parametrize("kw", VARIANTS, ids=["plain", "bases", "blocks"])
def test_forward_loss_and_gradients_match_the_reference(graph, rows,
                                                        backend, kw,
                                                        monkeypatch):
    path = _path(backend, monkeypatch)
    run = _setup(graph, rows, path, kw)
    assert run.rel_ops[R - 1] is None and all(run.rel_ops[:R - 1])
    assert run.backend == path
    assert _kinds(run) == {ROW_OPERAND if backend == "csr" else path}
    logp = run.model(run.x, run.rel_ops, LAYERS, first=run.first,
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


@pytest.mark.parametrize("backend", PATHS)
@pytest.mark.parametrize("kw", VARIANTS, ids=["plain", "bases", "blocks"])
def test_three_adam_steps_match_the_reference(graph, rows, backend, kw,
                                              monkeypatch):
    run = _setup(graph, rows, _path(backend, monkeypatch), kw)
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
    run = _setup(graph, rows, "segment", {})
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
    run = _setup(graph, rows, "csr", {})
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


def test_layer_zero_input_is_the_aggregations_then_x(graph):
    ops = rgcn_baseline.rgcn_operands(graph, "segment", "cpu")
    x = torch.from_numpy(graph.x)
    first = precompute_rgcn_input(x, ops)
    assert first.shape == (N, R * F)          # 4 relations with edges, x
    np.testing.assert_array_equal(rgcn_input(x, ops).numpy(),
                                  first.numpy())
    np.testing.assert_array_equal(first[:, -F:].numpy(), graph.x)
    for r in range(R - 1):
        np.testing.assert_allclose(first[:, r * F:(r + 1) * F].numpy(),
                                   _mean(graph.x, *graph.rel_edges(r)),
                                   rtol=RTOL, atol=ATOL)


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
    for backend in BACKENDS:
        got = rgcn_baseline.train_rgcn_baseline(
            graph, labels, split, C, LAYERS, cfg, device="cpu",
            model=init_rgcn_net(F, H, R, H, C, generator=torch.Generator()
                                .manual_seed(4), device="cpu", **kw),
            backend=backend)
        assert abs(got["final_loss"] - want) <= ATOL, backend


@pytest.mark.parametrize("backend", ["auto", "csr", "segment"])
def test_cli_on_a_tiny_dat_folder(backend, capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = rgcn_baseline.main([
            "--folder", str(ROOT / "data" / "synthetic_multiclass"),
            "--metapath_length", "2", "--hidden_dim", "8", "--epochs", "3",
            "--backend", backend, "--platform", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "train F1 ")
    assert np.isfinite(res["final_loss"])


def test_backends_without_a_separate_aggregation_are_refused(graph, rows):
    for backend in ("pallas", "halo"):
        with pytest.raises(ValueError, match="RGCN baseline takes"):
            _setup(graph, rows, backend, {})


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


def _grads(model, x, ops, idx):
    """logp on ``idx`` and every gradient of the mean NLL of class 0."""
    model.zero_grad(set_to_none=True)
    logp = model(x, ops, LAYERS, first=precompute_rgcn_input(x, ops),
                 rows=idx)
    (-logp[:, 0]).mean().backward()
    return [logp.detach()] + [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("kw", VARIANTS, ids=["plain", "bases", "blocks"])
def test_row_terms_and_the_stacked_product_mix(kw):
    """A layer whose relations take both paths: relation 0 reaches every
    row and stays in the stacked product, relations 1-3 reach a few rows
    each and run on them (``row_term_operands``); the log-probabilities
    and gradients equal the all-stacked and the all-rows runs'."""
    rng = np.random.default_rng(21)
    src = [np.arange(N)] + [rng.integers(0, 6, 30) for _ in range(3)]
    dst = [rng.integers(0, N, len(s)) for s in src]
    g = HeteroGraph(rng.normal(size=(N, F)).astype(np.float32),
                    np.concatenate(src), np.concatenate(dst),
                    np.concatenate([np.full(len(s), r)
                                    for r, s in enumerate(src)]),
                    num_relations=4)
    ops = [hop[0] for hop in loops.build_hop_arrays(
        g, [[r] for r in range(4)], "csr", "cpu")]
    mixed = rgcn_baseline.row_term_operands(ops, [1, 2, 3])
    assert [op[0] for op in mixed] == ["csr"] + [ROW_OPERAND] * 3
    model = init_rgcn_net(F, H, 4, H, C, generator=torch.Generator()
                          .manual_seed(6), device="cpu", **kw)
    x, idx = torch.from_numpy(g.x), torch.arange(0, N, 2)
    want = _grads(model, x, ops, idx)
    for got in (_grads(model, x, mixed, idx), _grads(
            model, x, rgcn_baseline.row_term_operands(ops, [0, 1, 2, 3]),
            idx)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), RTOL, ATOL)


@pytest.mark.parametrize("backend", ["csr", "segment", "dense"])
def test_row_terms_span_counts_each_engaged_layer(graph, rows, backend):
    """``rgcn.row_terms``: one call a layer with row terms, inside
    ``rgcn.relations``; the segment and dense backends have none."""
    run = _setup(graph, rows, backend, {})
    prof.reset_spans()
    try:
        run.step()
        got = prof.spans()
    finally:
        prof.reset_spans()
    assert got["rgcn.relations"]["calls"] == LAYERS
    if backend != "csr":
        assert "rgcn.row_terms" not in got
        return
    assert got["rgcn.row_terms"]["calls"] == LAYERS
    assert got["rgcn.row_terms"]["parent"] == "rgcn.relations"


def test_layer_zero_input_holds_each_relations_rows(graph):
    """With row terms, layer 0's input is x and the relations' means on
    the rows they reach, side by side in relation order: each relation's
    rows are its sources, ascending."""
    ops = rgcn_baseline.rgcn_operands(graph, "csr", "cpu")
    x = torch.from_numpy(graph.x)
    first = precompute_rgcn_input(x, ops)
    assert isinstance(first, RgcnInput) and first.stacked is x
    blk = ops[0][3]
    assert blk.rels == tuple(range(R - 1))
    assert all(op[3] is blk for op in ops[:R - 1])
    assert first.rows.shape == (blk.offsets[-1], F)
    for i, r in enumerate(blk.rels):
        s, d = graph.rel_edges(r)
        rows = blk.take.col[blk.offsets[i]:blk.offsets[i + 1]].numpy()
        np.testing.assert_array_equal(rows, np.unique(s))
        np.testing.assert_allclose(
            first.rows[blk.offsets[i]:blk.offsets[i + 1]].numpy(),
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
    blk = rgcn_baseline.row_term_operands(ops, list(range(R - 1)))[0][3]
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
