"""The port's sorted-CSR aggregation (mpgnn_tpu_torch/ops/csr.py, plain
path on the CPU) against the JAX package's csr_mean_aggregate (Pallas in
interpret mode) and ref_mean, on the classic and the dedup side.

Tolerance rtol = atol = 1e-5: both sides sum float32 values in different
orders, and the JAX kernel feeds the MXU a hi/lo bf16 split of each float32
value (about 2^-16 relative per term), both well inside 1e-5 at these
sizes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgnn_tpu.ops import pallas_csr as jcsr
from mpgnn_tpu_torch.ops import csr as tcsr

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand_graph(n, e, f, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    if skew:
        # power-law-ish: a few rows and a few columns carry most edges
        src = (n * rng.random(e) ** 3).astype(np.int64)
        dst = (n * rng.random(e) ** 4).astype(np.int64)
    else:
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
    x = rng.standard_normal((n, f)).astype(np.float32)
    return src, dst, x


CASES = [
    # n, e, f, bm, skew: the shapes of tests/test_pallas_csr.py plus
    # skewed degrees
    (100, 400, 8, 32, False),
    (257, 1000, 16, 64, False),     # n not a multiple of bm
    (64, 0, 4, 32, False),          # edgeless relation
    (500, 3000, 16, 128, False),
    (2000, 9000, 16, 512, False),
    (300, 5000, 8, 64, True),       # skewed degrees, zero-degree rows
    (1500, 6000, 7, 1024, True),    # odd width, n not a multiple of bm
]


@pytest.mark.parametrize("dedup", ["never", "always"])
@pytest.mark.parametrize("n,e,f,bm,skew", CASES)
def test_csr_matches_jax(n, e, f, bm, skew, dedup):
    src, dst, x = _rand_graph(n, e, f, skew=skew)
    jf, jb = jcsr.build_csr_blocking(src, dst, n, bm=bm, dedup=dedup)
    want = np.asarray(jcsr.csr_mean_aggregate(jnp.asarray(x), jf, jb))
    ref = np.asarray(jcsr.ref_mean(jnp.asarray(x), src.astype(np.int32),
                                   dst.astype(np.int32), n)) if e else \
        np.zeros((n, f), np.float32)

    fwd, bwd = tcsr.build_csr_blocking(src, dst, n, bm=bm, dedup=dedup)
    kind = tcsr.DedupCsrBlocking if dedup == "always" and e else \
        tcsr.CsrBlocking
    assert isinstance(fwd, kind) and isinstance(bwd, kind)
    got = tcsr.csr_mean_aggregate(torch.from_numpy(x), fwd, bwd).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(
        got, tcsr.ref_mean(torch.from_numpy(x), src, dst, n).numpy(), **TOL)
    assert not got[np.bincount(src, minlength=n) == 0].any()


@pytest.mark.parametrize("skew", [False, True])
def test_backward_blocking_matches_transposed_mean(skew):
    """The backward blocking computes dx[d] = sum over edges (s, d) of
    g[s] / deg(s) on both sides (the gradient of csr_mean_aggregate runs
    it; tests/test_torch_conv.py holds that gradient against JAX)."""
    n, e, f = 400, 4000, 8
    src, dst, g = _rand_graph(n, e, f, seed=2, skew=skew)
    deg = np.maximum(np.bincount(src, minlength=n), 1).astype(np.float64)
    want = np.zeros((n, f))
    np.add.at(want, dst, g[src] / deg[src, None])
    for dedup in ("never", "always"):
        _, bwd = tcsr.build_csr_blocking(src, dst, n, bm=64, dedup=dedup)
        got = tcsr._apply_direction(bwd, torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("skew", [False, True])
def test_auto_routing_picks_the_jax_side(skew):
    """'auto' sends a hub-skewed relation to the dedup tiles and a uniform
    one to the classic kernel, as the JAX package does."""
    n = 2000
    rng = np.random.default_rng(5)
    if skew:
        # every row block hits a small set of hub columns many times
        e = 20000
        src = rng.integers(0, n, e)
        dst = (rng.zipf(1.5, e) - 1) % 300
    else:
        e = 2000
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
    jf, jb = jcsr.build_csr_blocking(src, dst, n, dedup="auto")
    tf, tb = tcsr.build_csr_blocking(src, dst, n, dedup="auto")
    for j, t in ((jf, tf), (jb, tb)):
        assert isinstance(j, jcsr.DedupCsrBlocking) == \
            isinstance(t, tcsr.DedupCsrBlocking)
    assert isinstance(tf, tcsr.DedupCsrBlocking) == skew


def test_dedup_tiles_hold_at_most_uniq_columns():
    """The dedup layout's bounds: every piece sums 1 to DEDUP_PIECE items,
    the pieces of one row differ in length by at most one, so no serial
    chain runs long; the pieces tile the items in order, and every output
    row (by a piece, or as a row without edges) and every partial slot is
    written once."""
    src, dst, _ = _rand_graph(2000, 30000, 1, seed=4, skew=True)
    fwd, _ = tcsr.build_csr_blocking(src, dst, 2000, bm=1024, dedup="always")
    ptr = fwd.piece_ptr.numpy()
    dest = fwd.piece_dest.numpy()
    lens = np.diff(ptr)
    assert ptr[0] == 0 and ptr[-1] == len(src) + fwd.num_partials
    assert lens.min() >= 1 and lens.max() <= tcsr.DEDUP_PIECE
    edge_row = np.sort(src)
    first = ptr[:fwd.level_pieces[1]]
    row_of_piece = edge_row[first]
    for r in np.unique(row_of_piece):
        mine = lens[:fwd.level_pieces[1]][row_of_piece == r]
        assert mine.max() - mine.min() <= 1
    deg = np.bincount(src, minlength=2000)
    assert np.array_equal(fwd.zero_rows.numpy(), np.flatnonzero(deg == 0))
    written = np.bincount(np.concatenate([dest[dest >= 0],
                                          fwd.zero_rows.numpy()]),
                          minlength=2000)
    assert (written == 1).all()
    assert np.array_equal(np.sort(-1 - dest[dest < 0]),
                          np.arange(fwd.num_partials))
    assert fwd.level_pieces[-1] == len(dest)


def _walk(blk):
    """Follow the pieces in numpy: the output row that each edge's gathered
    row ends up in, the output row of each piece, and the passes' item
    ranges."""
    ptr, dest = blk.piece_ptr.numpy(), blk.piece_dest.numpy()
    e = blk.col.shape[0]
    item_piece = np.repeat(np.arange(len(dest)), np.diff(ptr))
    final = np.empty(len(dest), np.int64)
    for p in range(len(dest) - 1, -1, -1):    # a later pass's pieces last
        final[p] = dest[p] if dest[p] >= 0 else \
            final[item_piece[e - 1 - dest[p]]]
    lp = blk.level_pieces
    items = [(ptr[a], ptr[b]) for a, b in zip(lp[:-1], lp[1:])]
    return final[item_piece[:e]], items, final


@pytest.mark.parametrize("case", ["uniform", "skew", "hub", "tiny"])
def test_dedup_pieces_match_numpy_walk(case):
    """Every host table of the dedup layout against a numpy oracle built
    from the edge list: edges in (row, column) order; each edge summed into
    its own row; each row cut into ceil(deg / DEDUP_PIECE) pass-0 pieces,
    the rows without edges listed apart; pass l + 1 reading exactly the
    slots pass l wrote; the forward post-scale 1/deg(row), the backward
    pre-scale 1/deg(source)."""
    n = {"uniform": 500, "skew": 3000, "hub": 3000, "tiny": 5}[case]
    e = {"uniform": 4000, "skew": 40000, "hub": 70000, "tiny": 3}[case]
    src, dst, _ = _rand_graph(n, e, 1, seed=7, skew=case != "uniform")
    if case == "hub":
        src[:60000] = 11                     # one row of 60k edges
    fwd, bwd = tcsr.build_csr_blocking(src, dst, n, dedup="always")
    deg = np.bincount(src, minlength=n)
    for blk, rows, cols in ((fwd, src, dst), (bwd, dst, src)):
        order = np.lexsort((cols, rows))
        assert np.array_equal(blk.col.numpy(), cols[order])
        edge_row, items, final = _walk(blk)
        assert np.array_equal(edge_row, rows[order])
        first = np.asarray(blk.piece_ptr.numpy())
        p0 = blk.level_pieces[1]
        count = np.bincount(rows, minlength=n)
        assert np.array_equal(np.bincount(final[:p0], minlength=n),
                              -(-count // tcsr.DEDUP_PIECE))
        assert np.array_equal(blk.zero_rows.numpy(),
                              np.flatnonzero(count == 0))
        assert items[0] == (0, e)
        for (_, hi), (lo, nxt) in zip(items[:-1], items[1:]):
            assert lo == hi and nxt > lo
        assert first[-1] == e + blk.num_partials
        want_scale = 1.0 / np.maximum(deg, 1)
        np.testing.assert_array_equal(blk.scale.numpy(),
                                      want_scale.astype(np.float32))
    assert not fwd.scale_is_pre and bwd.scale_is_pre
    if case == "hub":
        assert len(fwd.level_pieces) - 1 == 3    # 60k -> 938 -> 15 -> 1


def test_wrappers_count_no_launch_on_cpu():
    src, dst, x = _rand_graph(200, 800, 4)
    before = (tcsr.SCATTER_LAUNCHES, tcsr.DEDUP_LAUNCHES)
    for dedup in ("never", "always"):
        fwd, bwd = tcsr.build_csr_blocking(src, dst, 200, dedup=dedup)
        tcsr.csr_mean_aggregate(torch.from_numpy(x), fwd, bwd)
    assert (tcsr.SCATTER_LAUNCHES, tcsr.DEDUP_LAUNCHES) == before
