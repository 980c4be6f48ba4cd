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


@pytest.mark.parametrize("n,e,bm,skew", [
    (500, 4000, 1, False), (3000, 40000, 1, True), (257, 1000, 64, True),
    (5, 3, 1, False), (64, 0, 1, False), (64, 3000, 1, "huge ids")])
def test_sort_block_col_is_lexsort(n, e, bm, skew):
    """The blockings' edge order, one sort of a combined key, is
    np.lexsort((cols, rows // bm)) exactly, repeated edges included; node
    ids too large for the index to join the key take a stable sort."""
    from mpgnn_tpu_torch.native import sort_block_col

    src, dst, _ = _rand_graph(n, e, 1, seed=n, skew=skew is True)
    if skew == "huge ids":                   # ids up to 2^31: key * e > 2^63
        src, dst = src * (2 ** 25), dst * (2 ** 25)
    for rows, cols in ((src, dst), (dst, src)):
        assert np.array_equal(sort_block_col(rows, cols, bm),
                              np.lexsort((cols, rows // bm)))


@pytest.mark.parametrize("n,e,bm,skew", [
    (2000, 20000, 1024, True), (2000, 2000, 1024, False), (5, 3, 1, False),
    (300, 5000, 64, True), (64, 0, 32, False)])
def test_dedup_ratio_matches_jax(n, e, bm, skew):
    """Edges per distinct (row block, column) pair, counted by a sort: the
    JAX package's ratio (np.unique there) in both directions."""
    src, dst, _ = _rand_graph(n, e, 1, seed=e, skew=skew)
    for rows, cols in ((src, dst), (dst, src)):
        assert tcsr.dedup_ratio(rows, cols, bm) == \
            jcsr.dedup_ratio(rows, cols, bm)


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


def _path_search(ends, d, lo, hi):
    """csrc/csr_scatter.cu's path_search: how many rows end among the first
    d items of the merged list, row r ending at item r + ends[r]."""
    while lo < hi:
        mid = (lo + hi) // 2
        if ends[mid] <= d - mid - 1:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merge_path_walk(blk, x, share):
    """K1 in numpy, share by share as csrc/csr_scatter.cu runs it, summing
    in float64: the first pass (a row of at most ``share`` edges summed
    whole by the share where it begins, a longer one cut: its part in the
    share where it ends written to out, earlier parts to carry slots), then
    the carry pass. Unwritten entries are NaN, so reading one shows. Returns
    (out, how often the first pass wrote each row, the rows the carry pass
    completed, each share's (x0, y0), the most items a share walked)."""
    rp = blk.row_ptr.numpy().astype(np.int64)
    col, w = blk.col.numpy(), blk.weight.numpy().astype(np.float64)
    n, e, f = blk.num_rows, len(col), x.shape[1]
    total = n + e
    shares = -(-total // share)
    out = np.full((n, f), np.nan)
    carry = np.full((shares, f), np.nan)
    written = np.zeros(n, np.int64)
    starts, share_row, most = [], [], 0
    deg = np.diff(rp)
    for s in range(shares):
        d0, d1 = s * share, min((s + 1) * share, total)
        x0 = _path_search(rp[1:], d0, max(0, d0 - e), min(d0, n))
        x1 = _path_search(rp[1:], d1, max(0, d1 - e), min(d1, n))
        y0, y1 = d0 - x0, d1 - x1
        starts.append((x0, y0))
        began = x0 < n and x0 + rp[x0] < d0
        first_done = began and deg[x0] <= share
        own_tail = (x1 < n and x1 + rp[x1] >= d0 and rp[x1] < y1
                    and deg[x1] <= share)
        share_row.append(x0 if began and not first_done and x0 < x1 else -1)
        r_end = x1 + 1 if own_tail else x1
        y_end = rp[x1 + 1] if own_tail else y1
        r = x0 + 1 if first_done else x0
        y_begin = min(rp[x0 + 1], y1) if first_done else y0
        most = max(most, y_end - y_begin + max(r_end - r, 0))
        acc = np.zeros(f)
        for ed in range(y_begin, y_end):
            while ed >= (rp[r + 1] if r < r_end else y_end):
                out[r], acc, written[r] = acc, np.zeros(f), written[r] + 1
                r += 1
            acc = acc + w[ed] * x[col[ed]]
        while r < r_end:
            out[r], acc, written[r] = acc, np.zeros(f), written[r] + 1
            r += 1
        if not own_tail and x1 < n and y1 > max(y_begin, rp[x1]):
            carry[s] = acc
    completed = []
    for s, r in enumerate(share_row if e > share else []):
        if r >= 0:
            first = (r + rp[r]) // share
            out[r] = carry[first:s].sum(0) + out[r]
            completed.append(r)
    return out, written, completed, starts, most


def _k1_case(case, share):
    """(src, dst, n) of a relation: one hub row; rows that fill exactly one
    share, or end on a share's first item, or span two; mostly rows without
    edges; no edges at all; uniform."""
    rng = np.random.default_rng(11)
    if case == "hub":
        n = 400
        src = np.concatenate([np.full(3000, 17), rng.integers(0, n, 2000)])
    elif case == "share_edges":
        # rows 0-9: share - 1 edges + its end = one share each; row 10:
        # share edges, its end the next share's first item; row 11: two
        # shares' worth
        deg = [share - 1] * 10 + [share, 2 * share - 1, 0, 0, 5]
        n = len(deg) + 20
        src = np.repeat(np.arange(len(deg)), deg)
    elif case == "edgeless_rows":
        n = 3000
        src = rng.integers(0, n, 300)
    elif case == "no_edges":
        n = 100
        src = np.zeros(0, np.int64)
    else:
        n = 500
        src = rng.integers(0, n, 4000)
    return src, rng.integers(0, n, len(src)), n


@pytest.mark.parametrize("f", [1, 5])        # shares of 16 and 64 items
@pytest.mark.parametrize("case", ["hub", "share_edges", "edgeless_rows",
                                  "no_edges", "uniform"])
def test_k1_merge_path_matches_numpy_walk(case, f):
    """K1's merge-path partition and carry order, walked in numpy, against
    csr_scatter_plain in both directions; each share's start against the
    merged list built explicitly; every row written once by the first pass,
    no share walking more than two shares' worth of items, and exactly the
    rows longer than a share completed by the carry pass."""
    _, share = tcsr.k1_layout(f, 1)
    assert share == {1: 16, 5: 64}[f]
    src, dst, n = _k1_case(case, share)
    x = np.random.default_rng(3).standard_normal((n, f)).astype(np.float32)
    fwd, bwd = tcsr.build_csr_blocking(src, dst, n, dedup="never")
    for blk in (bwd, fwd):                # the forward's tables stay below
        assert isinstance(blk, tcsr.CsrBlocking)
        out, written, completed, starts, most = _merge_path_walk(blk, x,
                                                                 share)
        want = tcsr.csr_scatter_plain(blk, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)
        assert (written == 1).all() and most <= 2 * share
        rp = blk.row_ptr.numpy().astype(np.int64)
        ends = np.arange(n) + rp[1:]                 # item of each row's end
        for s, (x0, y0) in enumerate(starts):
            assert x0 == np.searchsorted(ends, s * share)
            assert x0 + y0 == s * share
        long_rows = np.flatnonzero(np.diff(rp) > share)
        assert completed == long_rows.tolist()
    if case == "share_edges":
        assert (ends[:10] % share == share - 1).all()
        assert ends[10] % share == 0 and long_rows.tolist() == [11]
    if case == "hub":                     # row 17 spans 3000 / share shares
        assert 17 in long_rows


def test_k1_layout_covers_the_columns():
    """K1's lanes a group cover a width's 16- or 4-byte chunks with a power
    of two up to 32, and narrow widths take shorter shares."""
    for width, vec, want in ((1, 1, (1, 16)), (2, 1, (2, 32)),
                             (4, 4, (1, 16)), (7, 1, (8, 64)),
                             (16, 4, (4, 64)), (64, 4, (16, 64)),
                             (100, 4, (32, 64)), (256, 4, (32, 64))):
        assert tcsr.k1_layout(width, vec) == want


def test_wrappers_count_no_launch_on_cpu():
    src, dst, x = _rand_graph(200, 800, 4)
    before = (tcsr.SCATTER_LAUNCHES, tcsr.DEDUP_LAUNCHES)
    for dedup in ("never", "always"):
        fwd, bwd = tcsr.build_csr_blocking(src, dst, 200, dedup=dedup)
        tcsr.csr_mean_aggregate(torch.from_numpy(x), fwd, bwd)
    assert (tcsr.SCATTER_LAUNCHES, tcsr.DEDUP_LAUNCHES) == before
