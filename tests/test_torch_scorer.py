"""The port's relation scorer (mpgnn_tpu_torch.models.scorer) on the CPU
against the JAX package's (mpgnn_tpu.models.scorer).

Tolerances, with their reasons:
* the sweeps' batched forwards (ELL and segment form), inits, clamp and
  freeze against the single-relation JAX functions: equal arrays (the
  same gathers, comparisons and float32 products), except the bag
  forward's values, rtol 1e-6: ``x . u`` sums its F products in another
  order than XLA's dot (the winners are equal);
* gradients of the sweeps' written-out backward against ``jax.grad``:
  rtol 1e-6, atol 1e-7 (float32 products and sums of the same terms; where
  a weight is several sources' winner its terms are summed in one order
  in both);
* ``Adam`` against ``optax.adam`` scanned over 60 epochs of 3 relations,
  the form the sweeps run it in: bitwise.
Ties are planted (equal weights, weights clamped to exactly 0 or 1):
argmax must take the first in file order on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.models import scorer as jsc
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.models import scorer as sc
from mpgnn_tpu_torch.search.scoring import (
    _flat_ids,
    _relation_ell_stack,
    _relation_segment_stack_compact,
    _segment_has,
)
from mpgnn_tpu_torch.weights import scorer_params_from_jax

GRAD_TOL = dict(rtol=1e-6, atol=1e-7)


def _graph(seed, n=60, e=240, rels=2, feat=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n // 2, e)
    dst = rng.integers(n // 2, n, e)
    rel = rng.integers(0, rels, e)
    x = rng.random((n, feat)).astype(np.float32)
    return (HeteroGraph(x, src, dst, rel, num_relations=rels),
            JGraph(x, src, dst, rel, num_relations=rels))


def _tied_weights(rng, n):
    """Weights with many exact ties: a few levels, plus exact 0 and 1."""
    return rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), n).astype(
        np.float32)


def test_ell_table_matches_jax():
    g, jg = _graph(0)
    for r in range(2):
        for md in (None, 2):
            nbr, mask = g.neighbor_table(r, md)
            jn, jm = jg.neighbor_table(r, md)
            np.testing.assert_array_equal(nbr, jn)
            np.testing.assert_array_equal(mask, jm)
        np.testing.assert_array_equal(g.rel_endpoint_nodes(r),
                                      jg.rel_endpoint_nodes(r))
        assert g.rel_max_degree(r) == jg.rel_max_degree(r)



def test_init_and_reinit_draws_match_jax():
    dst = np.array([3, 7, 9])
    mins = np.array([1.0, 0.0, 1.0], np.float32)
    p = sc.init_scorer_params(np.random.default_rng(4), 12, 5, dst, mins)
    jp = jsc.init_scorer_params(np.random.default_rng(4), 12, 5, dst, mins)
    np.testing.assert_array_equal(p.w, np.asarray(jp.w))
    np.testing.assert_array_equal(p.u, np.asarray(jp.u))
    q = scorer_params_from_jax(jp, device="cpu")
    np.testing.assert_array_equal(q.w.numpy(), p.w)
    np.testing.assert_array_equal(q.u.numpy(), p.u)
    prev = np.linspace(0, 1, 12).astype(np.float32)
    frozen = np.arange(12) % 3 == 0
    np.testing.assert_array_equal(
        sc.reinitialize_scorer_weights(np.random.default_rng(1), prev, frozen),
        jsc.reinitialize_scorer_weights(np.random.default_rng(1), prev,
                                        frozen))


def test_clamp_and_freeze_match_jax():
    w = np.float32([-0.5, 0.5, 1.5, 0.0])
    u = np.float32([2.0, -1.0])
    got = sc.clamp_params(sc.ScorerParams(torch.tensor(w), torch.tensor(u)))
    want = jsc.clamp_params(jsc.ScorerParams(jnp.asarray(w), jnp.asarray(u)))
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    np.testing.assert_array_equal(got.u.numpy(), np.asarray(want.u))
    fm = np.array([True, False, True, False])
    fv = np.float32([9, 9, 9, 9])
    got = sc.apply_freeze(got, torch.tensor(fm), torch.tensor(fv))
    want = jsc.apply_freeze(want, jnp.asarray(fm), jnp.asarray(fv))
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forwards_match_jax_with_ties(seed):
    """The sweeps' batched ELL forwards, two relations on the R axis,
    against the JAX package's single-relation forwards."""
    g, jg = _graph(seed)
    rng = np.random.default_rng(seed)
    N = g.num_nodes
    nbr, mask = _relation_ell_stack(g, [0, 1])
    w = np.stack([_tied_weights(rng, N) for _ in range(2)])
    u = rng.random((2, g.feat_dim)).astype(np.float32)
    nbr_f = _flat_ids(nbr, N, "cpu")
    m = torch.tensor(mask)
    has = m.any(-1)
    pred, win = sc.flat_forward_ell(torch.tensor(w), nbr_f, m, has)

    bags = np.array([[0, 3, 5], [7, 7, 0], [11, 2, 9], [4, 0, 0]])
    valid = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 1], [0, 0, 0]], bool)
    bmask = valid & mask.any(-1)[:, bags]                   # [2, B, M]
    bags_f = _flat_ids(np.broadcast_to(bags, (2,) + bags.shape).copy(), N,
                       "cpu")
    bm = torch.tensor(bmask)
    fwd = sc.bag_forward_ell(torch.tensor(w), torch.tensor(u),
                             torch.tensor(g.x), nbr_f, m, has, bags_f, bm,
                             bm.any(-1))
    bag_win = fwd.member_winner.reshape(-1)[fwd.bag_member] % N
    for r in range(2):
        jp = jsc.ScorerParams(jnp.asarray(w[r]), jnp.asarray(u[r]))
        jpred, jwin = jsc.scorer_forward_flat(
            jp, jnp.asarray(nbr[r]), jnp.asarray(mask[r]), jnp.arange(N),
            jnp.ones(N))
        np.testing.assert_array_equal(pred[r].numpy(), np.asarray(jpred))
        np.testing.assert_array_equal(win[r].numpy() - r * N,
                                      np.asarray(jwin))
        want = jsc.scorer_forward_bags(
            jp, jnp.asarray(g.x), jnp.asarray(nbr[r]), jnp.asarray(mask[r]),
            jnp.asarray(bags), jnp.asarray(bmask[r]))
        np.testing.assert_array_equal(bag_win[r].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(fwd.member_winner[r].numpy() - r * N,
                                      np.asarray(want[3]))
        # x . u sums F products in another order than XLA's dot
        np.testing.assert_allclose(fwd.pred[r].numpy(), np.asarray(want[0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(fwd.member_value[r].numpy(),
                                   np.asarray(want[2]), rtol=1e-6)


def _flat_loss_jax(w, nbr, mask, lmask, y):
    params = jsc.ScorerParams(w=w, u=jnp.zeros(1))
    n = nbr.shape[0]
    pred, _ = jsc.scorer_forward_flat(params, nbr, mask, jnp.arange(n),
                                      jnp.ones(n))
    return jnp.sum((pred - y) ** 2 * lmask) / jnp.maximum(lmask.sum(), 1.0)


@pytest.mark.parametrize("form", ["ell", "seg"])
def test_flat_gradient_matches_jax_grad(form):
    g, _ = _graph(3, n=80, e=400, rels=1)
    rng = np.random.default_rng(3)
    R, N = 2, g.num_nodes
    ws = np.stack([_tied_weights(rng, N) for _ in range(R)])
    y = rng.random(N).astype(np.float32)
    lmask = (rng.random((R, N)) < 0.7).astype(np.float32)
    nbr, mask = g.neighbor_table(0)
    denom = np.maximum(lmask.sum(1), 1.0).astype(np.float32)
    want = [np.asarray(jax.grad(_flat_loss_jax)(
        jnp.asarray(ws[i]), jnp.asarray(nbr), jnp.asarray(mask),
        jnp.asarray(lmask[i]), jnp.asarray(y))) for i in range(R)]
    dn = torch.tensor(denom)
    if form == "ell":
        has = torch.tensor(np.broadcast_to(mask.any(-1), (R, N)).copy())
        nbr_f = _flat_ids(np.broadcast_to(nbr, (R,) + nbr.shape).copy(), N,
                          "cpu")
        m = torch.tensor(np.broadcast_to(mask, (R,) + mask.shape).copy())
        w = torch.tensor(ws)
        pred, win = sc.flat_forward_ell(w, nbr_f, m, has)
        lm = torch.tensor(lmask)
        got = sc.flat_grad(w, pred, win, has, torch.tensor(y),
                           (1.0 / dn)[:, None] * lm).numpy()
        got_pred = pred.numpy()
    else:
        # compact space: gather into it, take the gradient back out
        cpad = 128
        s, d, em, nodes = _relation_segment_stack_compact(g, [0, 0], 512,
                                                          cpad)
        nd = nodes[0]
        src_f, dst_f = _flat_ids(s, cpad, "cpu"), _flat_ids(d, cpad, "cpu")
        emt = torch.tensor(em)
        has = _segment_has(src_f, emt, cpad)
        wc = np.zeros((R, cpad), np.float32)
        wc[:, : len(nd)] = ws[:, nd]
        yc = np.zeros((R, cpad), np.float32)
        yc[:, : len(nd)] = y[nd]
        lc = np.zeros((R, cpad), np.float32)
        lc[:, : len(nd)] = lmask[:, nd]
        w = torch.tensor(wc)
        pred, win = sc.flat_forward_seg(w, src_f, dst_f, emt, has)
        gc = sc.flat_grad(w, pred, win, has, torch.tensor(yc),
                          (1.0 / dn)[:, None] * torch.tensor(lc)).numpy()
        got = np.zeros((R, N), np.float32)
        got[:, nd] = gc[:, : len(nd)]
        assert not gc[:, len(nd):].any()
        got_pred = np.zeros((R, N), np.float32)
        got_pred[:, nd] = pred.numpy()[:, : len(nd)]
    for i in range(R):
        jpred, _ = jsc.scorer_forward_flat(
            jsc.ScorerParams(jnp.asarray(ws[i]), jnp.zeros(1)),
            jnp.asarray(nbr), jnp.asarray(mask), jnp.arange(N), jnp.ones(N))
        np.testing.assert_array_equal(got_pred[i], np.asarray(jpred))
        assert np.count_nonzero(want[i]) > 3
        np.testing.assert_allclose(got[i], want[i], **GRAD_TOL)


def _bag_loss_jax(params, x, nbr, mask, bags, bmask, labels, keep):
    pred, _, _, _ = jsc.scorer_forward_bags(
        jsc.ScorerParams(*params), x, nbr, mask, bags, bmask)
    return jnp.sum((pred - labels) ** 2 * keep) / jnp.maximum(keep.sum(), 1.0)


@pytest.mark.parametrize("form", ["ell", "seg"])
def test_bag_gradient_matches_jax_grad(form):
    from mpgnn_tpu_torch.search.scoring import _Chunk, _flat_members

    g, _ = _graph(5, n=80, e=400, rels=1, feat=4)
    rng = np.random.default_rng(5)
    N, F = g.num_nodes, g.feat_dim
    w = _tied_weights(rng, N)
    u = rng.random(F).astype(np.float32)
    bag_list = [[0, 3, 5], [7, 30], [11, 2, 9, 3], [4], [31, 39]]
    labels = np.float32([1, 0, 1, 0, 1, 0, 0, 0])
    B, M = 8, 4
    nbr, mask = g.neighbor_table(0)
    bags = np.zeros((B, M), np.int64)
    valid = np.zeros((B, M), bool)
    for i, b in enumerate(bag_list):
        bags[i, : len(b)] = b
        valid[i, : len(b)] = True
    bmask = valid & mask.any(-1)[bags]
    keep = bmask.any(-1).astype(np.float32)
    jw, ju = jax.grad(_bag_loss_jax)(
        (jnp.asarray(w), jnp.asarray(u)), jnp.asarray(g.x),
        jnp.asarray(nbr), jnp.asarray(mask), jnp.asarray(bags),
        jnp.asarray(bmask), jnp.asarray(labels), jnp.asarray(keep))
    mode = "ell" if form == "ell" else "seg"
    cpad = 128 if form == "seg" else N
    inst = dict(bags=bags, valid=valid, labels=labels,
                members=_flat_members(bag_list, B, 16))
    ch = _Chunk(g, mode, None if form == "ell" else 512, cpad, [0], [inst],
                g.x, B, "cpu")
    if form == "ell":
        wt = torch.tensor(w)[None]
    else:
        wc = np.zeros((1, cpad), np.float32)
        wc[0, : len(ch.nodes[0])] = w[ch.nodes[0]]
        wt = torch.tensor(wc)
    ut = torch.tensor(u)[None]
    fwd = ch.forward(wt, ut)
    # x . u sums F products in another order than XLA's dot
    jpred = jsc.scorer_forward_bags(
        jsc.ScorerParams(jnp.asarray(w), jnp.asarray(u)), jnp.asarray(g.x),
        jnp.asarray(nbr), jnp.asarray(mask), jnp.asarray(bags),
        jnp.asarray(bmask))[0]
    np.testing.assert_allclose(fwd.pred.numpy()[0], np.asarray(jpred),
                               rtol=1e-6)
    denom = ch.keep.sum(1).clamp_min(1.0)
    gw, gu = sc.bag_grads(wt, fwd, ch.x, ch.labels,
                          (1.0 / denom)[:, None] * ch.keep, ch.bag_has,
                          ch.has)
    gw = gw.numpy()[0]
    if form == "seg":
        full = np.zeros(N, np.float32)
        full[ch.nodes[0]] = gw[: len(ch.nodes[0])]
        gw = full
    assert np.count_nonzero(np.asarray(jw)) >= 2
    np.testing.assert_allclose(gw, np.asarray(jw), **GRAD_TOL)
    np.testing.assert_allclose(gu.numpy()[0], np.asarray(ju), **GRAD_TOL)


def test_adam_bitwise_against_optax():
    rng = np.random.default_rng(0)
    R, N, T = 3, 4000, 60
    gs = (rng.normal(size=(T, R, N)) * 0.05).astype(np.float32)
    gs[:, :, :200] = 0.0            # zero gradients: the update is exactly 0
    w0 = rng.random((R, N)).astype(np.float32)
    opt = optax.adam(0.1)

    @jax.jit
    def run(w0, gs):
        def one(w0, g):
            def step(c, g):
                w, st = c
                upd, st = opt.update(g, st)
                w = jnp.clip(optax.apply_updates(w, upd), 0.0, 1.0)
                return (w, st), None
            (w, _), _ = jax.lax.scan(step, (w0, opt.init(w0)), g)
            return w
        return jax.vmap(one, in_axes=(0, 1))(w0, gs)

    want = np.asarray(run(w0, gs))
    w = torch.tensor(w0)
    adam = sc.Adam([w], 0.1)
    for t in range(T):
        w = adam.update([w], [torch.tensor(gs[t])])[0].clamp(0.0, 1.0)
    np.testing.assert_array_equal(w.numpy(), want)
    assert adam.count == T
