"""The port's other aggregation backends (ops/spmm.py 'ell', 'ell2',
'dense'; ops/onehot.py 'onehot'; the batched 'dense' evaluation's grouped
product, ops/conv.py) on the CPU against the JAX package's functions, the
same numpy-seeded inputs through both.

Tolerances, with their reasons:
* operands: index-identical, and the weights and adjacencies bitwise (the
  same float32 counts and divisions); JAX's onehot blocking after its lane
  layout [nb, EB/128, 128] is undone and its extra lanes, which hold zeros,
  are cut off.
* forwards and ``torch.autograd`` gradients against JAX's and ``jax.grad``:
  atol 1e-5, float32 sums in other orders (tests/test_segment_ops.py and
  tests/test_pallas_spmm.py hold the JAX ones against dense references at
  1e-5 and 1e-4).
* the grouped dense product: atol 1e-5. Both sides multiply the same bf16
  operands; JAX sums in float32, the CPU path (K4's plain version) in
  float64, rounded once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgnn_tpu.ops import pallas_spmm as jonehot
from mpgnn_tpu.ops import spmm as jspmm
from mpgnn_tpu.train.batch_eval import _grouped_dense_agg
from mpgnn_tpu_torch.models.mpgnn import hop_aggregate, stack_hop_aggregate
from mpgnn_tpu_torch.native import build_ell
from mpgnn_tpu_torch.ops import conv, onehot, spmm

ATOL = 1e-5
SHAPES = [(40, 150, 6), (300, 900, 8), (800, 3200, 16)]


def _relation(n, e, seed):
    """One relation's edges: sources from the first two thirds of the
    nodes only (the rest are empty rows), destinations anywhere; features
    and an upstream gradient."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, max(1, 2 * n // 3), e)
    dst = rng.integers(0, n, e)
    return src, dst, rng


def _both(fn_t, fn_j, h, g):
    """(forward, gradient of sum(out * g)) of the torch and JAX functions
    of h."""
    ht = torch.from_numpy(h).requires_grad_(True)
    out_t = fn_t(ht)
    (out_t * torch.from_numpy(g)).sum().backward()
    hj = jnp.asarray(h)
    out_j = fn_j(hj)
    grad_j = jax.grad(lambda v: jnp.sum(fn_j(v) * jnp.asarray(g)))(hj)
    return ((out_t.detach().numpy(), ht.grad.numpy()),
            (np.asarray(out_j), np.asarray(grad_j)))


def _assert_pair(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n,e,f", SHAPES)
def test_ell_matches_jax(n, e, f):
    src, dst, rng = _relation(n, e, 0)
    d_max = max(int(np.bincount(src, minlength=n).max()), 1)
    nbr, mask, _ = build_ell(src, dst, n, d_max)
    h = rng.normal(size=(n, f)).astype(np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)
    got, want = _both(
        lambda v: spmm.ell_mean_aggregate(
            v, torch.from_numpy(nbr.astype(np.int64)),
            torch.from_numpy(mask)),
        lambda v: jspmm.ell_mean_aggregate(v, jnp.asarray(nbr),
                                           jnp.asarray(mask)), h, g)
    _assert_pair(got, want)
    assert np.all(got[0][2 * n // 3:] == 0)


@pytest.mark.parametrize("n,e,f", SHAPES)
def test_ell2_matches_jax(n, e, f):
    src, dst, rng = _relation(n, e, 1)
    op = spmm.build_ell2_operand(src, dst, n)
    jop = jspmm.build_ell2_operand(src, dst, n)
    for a, b in zip(op, jop):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    h = rng.normal(size=(n, f)).astype(np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)
    got, want = _both(lambda v: spmm.ell2_mean_aggregate(op, v),
                      lambda v: jspmm.ell2_mean_aggregate(jop, v), h, g)
    _assert_pair(got, want)
    assert np.all(got[0][2 * n // 3:] == 0)


@pytest.mark.parametrize("n,e,f", SHAPES)
def test_dense_matches_jax(n, e, f):
    src, dst, rng = _relation(n, e, 2)
    a, a_t = spmm.dense_adjacency(src, dst, n, device="cpu")
    ja, ja_t = jspmm.dense_adjacency(src, dst, n)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(ja_t))
    assert a_t.is_contiguous()
    h = rng.normal(size=(n, f)).astype(np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)
    got, want = _both(lambda v: spmm.dense_mean_aggregate(a, a_t, v),
                      lambda v: jspmm.dense_mean_aggregate(ja, ja_t, v),
                      h, g)
    _assert_pair(got, want)


def test_dense_product_ignores_a_tf32_setting():
    """The dense backend's product is full float32 whatever the process
    set, and the setting is restored after it."""
    src, dst, rng = _relation(64, 300, 3)
    a, a_t = spmm.dense_adjacency(src, dst, 64, device="cpu")
    h = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        out = spmm.dense_mean_aggregate(a, a_t, h)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    torch.testing.assert_close(out, a @ h, rtol=0, atol=0)


def _undo_lanes(blocking):
    """JAX's [nb, EB/128, 128] per-edge arrays as [nb, EB]."""
    nb = blocking.dst.shape[0]
    return [np.asarray(t).reshape(nb, -1)
            for t in (blocking.dst, blocking.local_row, blocking.weight)]


@pytest.mark.parametrize("n,e,f,bm", [(300, 900, 8, 64), (200, 600, 4, 64),
                                      (800, 3200, 16, 128), (8, 2, 4, 8)])
def test_onehot_matches_jax(n, e, f, bm):
    src, dst, rng = _relation(n, e, 4)
    blk = onehot.build_spmm_blocking(src, dst, n, block_rows=bm)
    jblk = jonehot.build_spmm_blocking(src, dst, n, block_rows=bm)
    for side, jside in zip(blk, jblk):
        eb = side.dst.shape[1]
        for got, want in zip((side.dst, side.local_row, side.weight),
                             _undo_lanes(jside)):
            np.testing.assert_array_equal(got.numpy(), want[:, :eb])
            assert not want[:, eb:].any()
        inc = np.asarray(jside.incidence)
        np.testing.assert_array_equal(side.incidence.numpy(),
                                      inc[:, :, :eb])
        assert not inc[:, :, eb:].any()
        assert (side.num_rows, side.block_rows) == (n, bm)
    h = rng.normal(size=(n, f)).astype(np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)
    got, want = _both(lambda v: onehot.onehot_spmm_mean(*blk, v),
                      lambda v: jonehot.onehot_spmm_mean(*jblk, v), h, g)
    _assert_pair(got, want)
    assert np.all(got[0][max(1, 2 * n // 3):] == 0)


@pytest.mark.parametrize("kind", ["ell", "ell2", "dense", "onehot"])
def test_hop_aggregate_kinds_equal_segment(kind):
    """Every kind through ``hop_aggregate`` computes the segment mean."""
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph
    from mpgnn_tpu_torch.train.loops import relation_op

    src, dst, rng = _relation(500, 2000, 5)
    graph = HeteroGraph(rng.normal(size=(500, 3)), src, dst,
                        np.zeros(2000, np.int64))
    h = torch.from_numpy(rng.normal(size=(500, 7)).astype(np.float32))
    want = hop_aggregate(h, relation_op(graph, 0, "segment", "cpu"), 500)
    got = hop_aggregate(h, relation_op(graph, 0, kind, "cpu"), 500)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("rels", [[0, 1, 0, 2, 1], [2, 2, 2]])
@pytest.mark.parametrize("f", [2, 16])
def test_grouped_dense_matches_jax(rels, f):
    """The batched 'dense' evaluation's hop: each unique relation's
    candidates through one grouped product (K4's plain version here),
    forward and gradient, against JAX's ``_grouped_dense_agg``."""
    n = 300
    rng = np.random.default_rng(6)
    ops, mats = [], []
    for r in range(3):
        src, dst, _ = _relation(n, 1200, 10 + r)
        ops.append(conv.build_dense_conv_operand(src, dst, n, "cpu"))
        a, _ = jspmm.dense_adjacency(src, dst, n)
        mats.append(np.asarray(a))
    adj = jnp.asarray(np.stack(mats), jnp.bfloat16)
    adj_t = jnp.asarray(np.ascontiguousarray(
        np.stack(mats).transpose(0, 2, 1)), jnp.bfloat16)
    members = {}
    for c, r in enumerate(rels):
        members.setdefault(r, []).append(c)
    groups = tuple((r, tuple(cs)) for r, cs in sorted(members.items()))
    parts = [(cs, ("grouped_dense", ops[r])) for r, cs in groups]
    h = rng.normal(size=(len(rels), n, f)).astype(np.float32)
    g = rng.normal(size=(len(rels), n, f)).astype(np.float32)
    got, want = _both(lambda v: stack_hop_aggregate(v, parts),
                      lambda v: _grouped_dense_agg(adj, adj_t, v, groups),
                      h, g)
    _assert_pair(got, want)
