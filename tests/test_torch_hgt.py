"""HGT on the port's normal path, on the CPU: ``models.hgt.HgtNet`` on the
attention blockings of ``ops.attention`` (K6's plain versions here), set
up by ``hgt_baseline.setup_hgt`` and stepped by
``train.loops.hgt_train_step`` through the shared skeleton, against the
benchmark's plain reference (``perfbench/reference/hgt.py``: float64, per
edge, from the paper's equations), on seeded random weights.

The graph (``_graph``): 4 node types numbered out of order, 5 relations;
relation 3's edges all start at nodes of type 3, so it reaches no train
row (the train rows are type 0); relation 4 has no edge at all; node
N - 1 has no edge; repeated edges. mu and skip are drawn in (-1, 1), so
the softmax is far from uniform, as the benchmark draws them.

Tolerances, with their reasons:
* log-probabilities, the loss and every leaf's first gradient: the
  program multiplies in float32 where the reference does in float64 (the
  attention's plain versions sum in float64 and round once), in another
  order (each relation's matrices on the stacked source rows, against a
  product per edge); values of order 1 through 3 layers keep a float32
  error under 1e-6, so rtol 1e-5, atol 1e-6 (a softmax taken per relation
  misses by more than 1e-3; ``test_a_softmax_per_relation_fails``).
* 3 Adam steps: the losses as above; each leaf's change atol 1e-4 (Adam
  divides a gradient by its running RMS, so an element that float32
  rounding dominates moves by up to lr a step) and the norms of the first
  decayed gradients rtol 1e-5.
* the attention's and the typed Linears' gradients by finite differences:
  ``torch.autograd.gradcheck`` in float64, its own tolerances.
* the last layer at the train rows against every row: the same operations
  on the same rows in the same order, so bitwise; two runs of the same
  steps: bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.hgt_baseline import row_types, setup_hgt, type_order
from mpgnn_tpu_torch.models import hgt as M
from mpgnn_tpu_torch.ops import attention as A
from mpgnn_tpu_torch.ops.csr import build_csr_blocking, build_csr_forward, \
    csr_scatter
from mpgnn_tpu_torch.train import loops
from mpgnn_tpu_torch.utils import prof
from perfbench.reference import hgt as ref

N, F, D, HEADS, C, TYPES, R = 60, 6, 16, 2, 3, 4, 5
LAYERS = 3
RTOL, ATOL = 1e-5, 1e-6
DELTA_ATOL = 1e-4
LR = 1e-3


def _graph(seed: int = 21):
    rng = np.random.default_rng(seed)
    node_type = rng.permutation(np.arange(N) % TYPES)
    node_type[N - 1] = 2
    of = [np.flatnonzero(node_type[:N - 1] == t) for t in range(TYPES)]
    src, dst, rel = [], [], []
    for r in range(R - 1):
        e = 45 + 10 * r
        s = (rng.choice(of[3], e) if r == 3
             else rng.integers(0, N - 1, e))
        d = rng.integers(0, N - 1, e)
        s[:3], d[:3] = s[0], d[0]            # a repeated edge
        src.append(s)
        dst.append(d)
        rel.append(np.full(e, r))
    g = HeteroGraph(rng.normal(size=(N, F)).astype(np.float32),
                    np.concatenate(src), np.concatenate(dst),
                    np.concatenate(rel), num_relations=R)
    train = rng.permutation(of[0])[:12]
    y = rng.integers(0, C, train.size)
    return g, node_type, train, y


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _model(seed: int = 3):
    model = M.init_hgt_net(F, D, TYPES, R, C, LAYERS, HEADS,
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("mu", "skip")):
                p.copy_(torch.rand(p.shape, generator=gen) * 2.0 - 1.0)
            elif name.endswith("_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return model


def _setup(graph, model=None):
    g, node_type, train, y = graph
    return setup_hgt(g, torch.from_numpy(g.x), node_type,
                     torch.from_numpy(train), torch.from_numpy(y), C, LAYERS,
                     MPGNNConfig(hidden_dim=D, lr=LR, weight_decay=0.0),
                     heads=HEADS, model=model or _model(), device="cpu")


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _edges(g):
    return {r: tuple(torch.from_numpy(a.astype(np.int64))
                     for a in g.rel_edges(r))
            for r in range(g.num_relations)}


def _ref_logp(graph, p, rows, precision="float64", softmax="node"):
    g, node_type, _, _ = graph
    edges = _edges(g)
    rel = ref.relation_edges(edges, R, softmax)
    rel_rows = ref.relation_edges(edges, R, softmax, rows, N)
    return ref.forward(torch.from_numpy(g.x).to(ref.dtype_of(precision)),
                       torch.from_numpy(node_type), TYPES, rel, rel_rows, p,
                       LAYERS, HEADS, precision, rows)


def _loss_rows(run):
    """The train rows in the order the program's loss takes them, as the
    graph's node ids, and their labels."""
    return run.order[run.tail.rows], run.train_y


# --------------------------------------------------------------- operands
def test_blockings_hold_every_edge_node_major(graph):
    g, node_type, train, _ = graph
    run = _setup(graph)
    blk = run.blk
    assert blk.rels == (0, 1, 2, 3) and blk.num_rows == N
    assert run.offsets == tuple(np.cumsum([0] + [int((node_type == t).sum())
                                                 for t in range(TYPES)]))
    # every edge once, in the layer's ids, grouped by relation in each row
    rows = torch.repeat_interleave(torch.arange(N),
                                   blk.row_ptr.diff().long())
    col = blk.col.long()
    rel = torch.searchsorted(torch.tensor(blk.offsets), col, right=True) - 1
    got = sorted(zip(rows.tolist(), rel.tolist(),
                     blk.src_node[col].tolist()))
    want = sorted((int(run.relabel[s]), r, int(run.relabel[d]))
                  for r in range(R) for s, d in zip(*g.rel_edges(r)))
    assert got == want
    for t in range(N):
        a, b = blk.row_ptr[t:t + 2].tolist()
        assert rel[a:b].tolist() == sorted(rel[a:b].tolist())
    # relation i's stacked sources: its distinct sources, ascending
    for i, r in enumerate(blk.rels):
        src = blk.src_node[blk.offsets[i]:blk.offsets[i + 1]]
        want = torch.unique(run.relabel[torch.from_numpy(
            g.rel_edges(r)[1].astype(np.int64))])
        assert torch.equal(src, want)
    # the transpose: each stacked source's edges, ascending positions
    trow = torch.repeat_interleave(torch.arange(blk.num_sources),
                                   blk.t_row_ptr.diff().long())
    eid = blk.t_eid.long()
    assert torch.equal(col[eid], trow)
    assert torch.equal(rows[eid], blk.t_col.long())
    assert torch.equal(torch.sort(eid).values, torch.arange(col.numel()))
    # place sums each node's stacked rows
    z = torch.randn(blk.num_sources, 3, dtype=torch.float64)
    want = torch.zeros(N, 3, dtype=torch.float64).index_add_(
        0, blk.src_node, z)
    torch.testing.assert_close(csr_scatter(blk.place, z), want)


def test_the_tail_keeps_the_edges_into_the_train_rows(graph):
    g, node_type, train, _ = graph
    run = _setup(graph)
    tail = run.tail
    new = torch.sort(run.relabel[torch.from_numpy(train)]).values
    assert torch.equal(tail.rows, new)
    assert tail.num_rows == train.size
    # relation 3 reaches no train row: no stacked source of its own
    i3 = tail.rels.index(3)
    assert tail.offsets[i3] == tail.offsets[i3 + 1]
    at = {int(n): k for k, n in enumerate(new)}
    got = sorted(zip(torch.repeat_interleave(
        torch.arange(tail.num_rows), tail.row_ptr.diff().long()).tolist(),
        tail.src_node[tail.col.long()].tolist()))
    want = sorted((at[int(run.relabel[s])], int(run.relabel[d]))
                  for r in range(R) for s, d in zip(*g.rel_edges(r))
                  if int(run.relabel[s]) in at)
    assert got == want
    assert run.tail_offsets == row_types(run.offsets, new)
    assert run.tail_offsets[1] == train.size        # all of type 0


@pytest.mark.parametrize("kind", ["random", "hub", "empty"])
def test_the_forward_built_alone_is_build_csr_blockings(kind):
    """``build_csr_forward`` is ``build_csr_blocking``'s K1 forward bit for
    bit, repeated edges and rows without edges included."""
    rng = np.random.default_rng(7)
    n, e = 50, 0 if kind == "empty" else 400
    src, dst = rng.integers(0, n - 3, e), rng.integers(0, n, e)
    if kind == "hub":
        src[:200], dst[:5] = 4, dst[0]
    want = build_csr_blocking(src, dst, n, dedup="never")[0]
    got = build_csr_forward(src, dst, n, "cpu")
    assert (got.num_rows, got.num_cols) == (want.num_rows, want.num_cols)
    for name, t in want.tensors():
        assert getattr(got, name).dtype == t.dtype, name
        assert torch.equal(getattr(got, name), t), name


def test_set_up_derives_its_operands_from_the_forwards(graph):
    """``setup_hgt``'s blockings are ``attention_blockings`` of the
    relations' ``build_csr_blocking`` forwards, bit for bit."""
    g, _, train, _ = graph
    run = _setup(graph)
    present = g.present_relations()
    fwds = [build_csr_blocking(*g.rel_edges(r), N, dedup="never")[0]
            for r in present]
    for got, rows in ((run.blk, None), (run.tail, run.tail.rows)):
        want = A.attention_blockings(present, fwds, run.relabel, rows)
        for f in ("row_ptr", "col", "t_row_ptr", "t_col", "t_eid",
                  "src_node"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert got.offsets == want.offsets


def test_type_order_numbers_the_nodes_type_by_type():
    nt = np.array([2, 0, 1, 0, 2, 2, 3])
    order, relabel, offsets = type_order(nt, 4, "cpu")
    assert order.tolist() == [1, 3, 2, 0, 4, 5, 6]
    assert offsets == (0, 2, 3, 6, 7)
    assert torch.equal(relabel[order], torch.arange(7))


@pytest.mark.parametrize("size", [1, 3, 256])
def test_chunks_cut_long_rows_in_order(size):
    deg = torch.tensor([0, 7, 1, 0, 3, 12])
    ptr = torch.cat([torch.zeros(1, dtype=torch.long), torch.cumsum(deg, 0)])
    ch = A.chunk_rows(ptr.int(), size)
    p, row, slot = ch.ptr.long(), ch.row.long(), ch.slot.long()
    assert int(p[-1]) == int(ptr[-1]) and bool((p.diff() >= 0).all())
    assert int(p.diff().max()) <= size
    n = (deg + size - 1) // size
    n = n.clamp_min(1)
    assert torch.equal(torch.bincount(row, minlength=6), n)
    assert bool((p[:-1] >= ptr[row]).all() and (p[1:] <= ptr[row + 1]).all())
    long = torch.nonzero(n > 1).flatten()
    assert torch.equal(ch.long_row.long(), long)
    assert ch.num_slots == int(n[long].sum())
    assert torch.equal(slot[slot >= 0], torch.arange(ch.num_slots))
    assert bool((slot[torch.isin(row, long, invert=True)] == -1).all())
    assert torch.equal(ch.slot_ptr.long().diff(), n[long])


def test_head_products_and_their_weight_gradient(graph, monkeypatch):
    run = _setup(graph)
    blk = run.blk
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(blk.num_sources, D, generator=gen, dtype=torch.float64)
    g = torch.randn(blk.num_sources, D, generator=gen, dtype=torch.float64)
    w = torch.randn(R, HEADS, D // HEADS, D // HEADS, generator=gen,
                    dtype=torch.float64)
    want = torch.empty_like(x)
    want_gw = torch.zeros_like(w)
    for i, r in enumerate(blk.rels):
        a, b = blk.offsets[i], blk.offsets[i + 1]
        xr = x[a:b].view(b - a, HEADS, -1)
        want[a:b] = torch.einsum("nhd,hde->nhe", xr, w[r]).reshape(b - a, D)
        want_gw[r] = torch.einsum("nhd,nhe->hde", xr,
                                  g[a:b].view(b - a, HEADS, -1))
    torch.testing.assert_close(A.head_products(x, w, blk), want)
    for split in (4, 4096):               # blocks of rows, and none
        monkeypatch.setattr(A, "SPLIT_ROWS", split)
        torch.testing.assert_close(A.head_weight_grad(x, g, w, blk),
                                   want_gw)


def _tiny_blockings(seed=5, n=9, rels=2):
    rng = np.random.default_rng(seed)
    fwds = []
    for _ in range(rels):
        s, d = rng.integers(0, n - 1, 20), rng.integers(0, n, 20)
        fwds.append(build_csr_blocking(s, d, n, dedup="never")[0])
    return A.attention_blockings(list(range(rels)), fwds)


@pytest.mark.parametrize("rows", [None, [1, 4, 5, 8]])
def test_attention_gradients_by_finite_differences(rows):
    fwds_blk = _tiny_blockings()
    if rows is not None:
        rng = np.random.default_rng(5)
        fwds = []
        for _ in range(2):
            s, d = rng.integers(0, 8, 20), rng.integers(0, 9, 20)
            fwds.append(build_csr_blocking(s, d, 9, dedup="never")[0])
        fwds_blk = A.attention_blockings([0, 1], fwds,
                                         rows=torch.tensor(rows))
    blk = fwds_blk
    gen = torch.Generator().manual_seed(6)

    def r(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
    q, k, v = r(blk.num_rows, 8), r(9, 8), r(9, 8)
    w_att, w_msg = r(2, 2, 4, 4), r(2, 2, 4, 4)
    assert torch.autograd.gradcheck(
        lambda *a: A.hgt_attention(*a, blk), (q, k, v, w_att, w_msg))


def test_typed_linear_and_gate_by_finite_differences():
    gen = torch.Generator().manual_seed(7)

    def r(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
    offsets = (0, 3, 3, 7, 10)                   # an empty type
    h, w, b = r(10, 5), r(4, 5, 6), r(4, 6)
    assert torch.autograd.gradcheck(
        lambda *a: M.typed_linear(*a, offsets), (h, w, b))
    a, hh, skip = r(10, 6), r(10, 6), r(4)
    assert torch.autograd.gradcheck(
        lambda *x: M._Gate.apply(*x, offsets), (a, hh, skip))


def test_attention_plain_by_the_equations():
    """K6's plain forward against a softmax written per target row."""
    blk = _tiny_blockings(seed=9)
    gen = torch.Generator().manual_seed(10)
    q = torch.randn(blk.num_rows, 8, generator=gen)
    kt = torch.randn(blk.num_sources, 8, generator=gen)
    vt = torch.randn(blk.num_sources, 8, generator=gen)
    out, lse = A.csr_attention(blk, q, kt, vt, 2)
    for t in range(blk.num_rows):
        a, b = blk.row_ptr[t:t + 2].tolist()
        c = blk.col[a:b].long()
        for h in range(2):
            cols = slice(4 * h, 4 * h + 4)
            if a == b:
                assert float(lse[t, h]) == -np.inf
                assert bool((out[t, cols] == 0).all())
                continue
            s = (kt[c, cols].double() * q[t, cols].double()).sum(1)
            p = torch.softmax(s, 0)
            torch.testing.assert_close(
                out[t, cols], (p[:, None] * vt[c, cols].double()).sum(0)
                .float())
            torch.testing.assert_close(lse[t, h],
                                       torch.logsumexp(s, 0).float())


# ------------------------------------------- the step against the reference
def test_forward_loss_and_gradients_match_the_reference(graph):
    run = _setup(graph)
    rows, y = _loss_rows(run)
    logp = run.model(run.x, run.layer_blockings, run.offsets,
                     run.tail_offsets)
    loss = loops.weighted_nll(logp, None, y, run.w)
    loss.backward()
    p = {k: v.double().requires_grad_(True)
         for k, v in _params(run.model).items()}
    want_logp = _ref_logp(graph, p, rows)
    want = -want_logp.gather(1, y[:, None])[:, 0].mean()
    want.backward()
    np.testing.assert_allclose(logp.detach().numpy(),
                               want_logp.detach().numpy(), RTOL, ATOL)
    assert abs(float(loss.detach()) - float(want.detach())) \
        <= ATOL + RTOL * abs(float(want.detach()))
    for k, q in run.model.named_parameters():
        np.testing.assert_allclose(q.grad.numpy(), p[k].grad.numpy(),
                                   RTOL, ATOL, err_msg=k)
        assert float(p[k].grad.abs().max()) > 0.0, k


def test_three_adam_steps_match_the_reference(graph):
    g, node_type, train, y = graph
    run = _setup(graph)
    p0 = _params(run.model)
    losses = []
    for t in range(3):
        losses.append(float(run.step().detach()))
        if t == 0:
            g1 = {k: float((run.opt.state[q]["exp_avg"] / 0.1).norm())
                  for k, q in run.model.named_parameters()}
    want = ref.train_steps(torch.from_numpy(g.x), torch.from_numpy(node_type),
                           TYPES, _edges(g), R, p0, LAYERS, HEADS,
                           torch.from_numpy(train), torch.from_numpy(y),
                           LR, 0.0, steps=3)
    np.testing.assert_allclose(losses, want["losses"], RTOL, ATOL)
    for k, q in run.model.named_parameters():
        assert g1[k] == pytest.approx(want["grad1"][k], rel=RTOL, abs=ATOL)
        assert abs(float((q.detach() - p0[k]).norm()) - want["delta"][k]) \
            <= DELTA_ATOL, k


def test_a_softmax_per_relation_fails(graph):
    """The comparison tells the paper's softmax over every relation of a
    node from PyG's (up to 2.2) over each relation apart: the reference
    with the latter misses the program by far more than the tolerance,
    with the former it does not."""
    run = _setup(graph)
    rows, y = _loss_rows(run)
    logp = run.model(run.x, run.layer_blockings, run.offsets,
                     run.tail_offsets).detach().double()
    p = {k: v.double() for k, v in _params(run.model).items()}
    with torch.no_grad():
        node = _ref_logp(graph, p, rows)
        per_rel = _ref_logp(graph, p, rows, softmax="relation")
    assert float((logp - node).abs().max()) <= ATOL + RTOL
    assert float((logp - per_rel).abs().max()) > 1e-3


def test_the_last_layer_at_the_train_rows_is_every_rows_at_them(graph):
    run = _setup(graph)
    with torch.no_grad():
        cut = run.model(run.x, run.layer_blockings, run.offsets,
                        run.tail_offsets)
        full = run.model(run.x, [run.blk] * LAYERS, run.offsets)
    assert torch.equal(cut, full[run.tail.rows])


def test_steps_repeat_bitwise(graph):
    a, b = _setup(graph), _setup(graph)
    la = [a.step() for _ in range(2)]
    lb = [b.step() for _ in range(2)]
    assert [float(x.detach()) for x in la] == [float(x.detach()) for x in lb]
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k


def test_spans_of_a_step_and_of_a_prediction(graph):
    run = _setup(graph)
    prof.reset_spans()
    try:
        run.step()
        got = prof.spans()
        prof.reset_spans()
        pred = run.predict()
        pred_spans = prof.spans()
    finally:
        prof.reset_spans()
    assert got["train.step"]["calls"] == 1
    assert got["hgt.attention"]["calls"] == LAYERS
    assert got["model.row_tail"]["calls"] == 1
    assert got["hgt.typed"]["calls"] == 1 + 2 * LAYERS
    assert got["hgt.attention"]["parent"] == "train_step.forward"
    assert pred_spans["hgt.attention"]["calls"] == LAYERS
    assert "model.row_tail" not in pred_spans
    # the prediction in the graph's node ids
    with torch.no_grad():
        full = run.model(run.x, [run.blk] * LAYERS, run.offsets)
    assert torch.equal(pred[run.order], full.argmax(1))


def test_a_model_of_its_own_starts_pyhgts_way(graph):
    g, node_type, train, y = graph
    run = setup_hgt(g, torch.from_numpy(g.x), node_type, train, y, C,
                    LAYERS, MPGNNConfig(hidden_dim=D), heads=HEADS,
                    device="cpu")
    for layer in run.model.layers:
        assert bool((layer.mu == 1).all() and (layer.skip == 1).all())
        assert bool((layer.k_b == 0).all())
    assert np.isfinite(float(run.step().detach()))


def test_set_up_refuses_a_graph_without_edges():
    g = HeteroGraph(np.zeros((4, 2), np.float32), np.zeros(0, np.int64),
                    np.zeros(0, np.int64), np.zeros(0, np.int64),
                    num_relations=2)
    with pytest.raises(ValueError, match="no"):
        setup_hgt(g, torch.zeros(4, 2), np.zeros(4, np.int64), [0], [0], 2,
                  device="cpu")
