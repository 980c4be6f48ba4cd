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
    src, dst, _ = _rand_graph(2000, 30000, 1, seed=4)
    fwd, _ = tcsr.build_csr_blocking(src, dst, 2000, bm=1024, dedup="always")
    per_tile = fwd.tile_uniq_ptr.diff()
    assert int(per_tile.max()) == tcsr.DEDUP_UNIQ and int(per_tile.min()) > 0
    assert int(fwd.slot.max()) < tcsr.DEDUP_UNIQ


def test_wrappers_count_no_launch_on_cpu():
    src, dst, x = _rand_graph(200, 800, 4)
    before = (tcsr.SCATTER_LAUNCHES, tcsr.DEDUP_LAUNCHES)
    for dedup in ("never", "always"):
        fwd, bwd = tcsr.build_csr_blocking(src, dst, 200, dedup=dedup)
        tcsr.csr_mean_aggregate(torch.from_numpy(x), fwd, bwd)
    assert (tcsr.SCATTER_LAUNCHES, tcsr.DEDUP_LAUNCHES) == before
