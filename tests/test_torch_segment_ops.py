"""The rest of the ops API (``mpgnn_tpu_torch.ops.segment``:
``masked_segment_mean``, ``segment_max``, ``segment_argmax``,
``segment_count``; ``mpgnn_tpu_torch.ops.spmm.ell_max_gather``) on the CPU
against the JAX package's functions, on the same seeded numpy inputs, and
the cases of ``tests/test_segment_ops.py``.

Tolerances, with their reasons:
* max, argmax, counts, ``ell_max_gather``'s values, winners and gradient:
  exact. A max picks one of its inputs, and the gradient's terms are whole
  numbers, whose float32 sums are exact in any order;
* float32 means: rtol 1e-6, atol 1e-7, sums in another order;
* bf16 means: 2.5 bf16 ulps of the JAX package's float32 mean of the same
  bf16 values. The port sums bf16 rows in float32 and rounds each sum
  once, as its K1/K2 bf16 forms do, and multiplies by the inverse count
  rounded to bf16, as the JAX package does (the counts sum in float32 in
  both). The sum's and the inverse's roundings each move the mean by at
  most one of its ulps (half an ulp of a value at the bottom of its
  binade is 2^-8 of it), the product's by half an ulp. The JAX package's
  own bf16 path is not the yardstick: its CPU segment sum rounds at every
  add (its HLO converts each partial sum to bf16), hundreds of ulps off
  the float32 mean on a segment of 300 entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgnn_tpu.ops import segment as jseg
from mpgnn_tpu.ops.spmm import ell_max_gather as j_ell_max_gather
from mpgnn_tpu_torch.ops import segment as tseg
from mpgnn_tpu_torch.ops.spmm import ell_max_gather

MEAN_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_ULPS = 2.5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.dtype == torch.bfloat16 \
            else a.detach().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32)
                      if a.dtype == jnp.bfloat16 else a)


def _segments(rng, n_seg, e, empty):
    """Segment ids of ``e`` entries over ``n_seg`` segments, none of them in
    the segments listed in ``empty``."""
    live = np.setdiff1d(np.arange(n_seg), empty)
    return rng.choice(live, e).astype(np.int64)


# ----------------------------------------------------------- the means
@pytest.mark.parametrize("f", [None, 1, 6])
def test_masked_segment_mean_matches_jax(f):
    rng = np.random.default_rng(f or 0)
    n, e = 20, 120
    seg = _segments(rng, n, e, empty=[3, 11])
    mask = rng.random(e) > 0.4
    mask[seg == 7] = False                       # a fully masked segment
    shape = (e,) if f is None else (e, f)
    data = rng.normal(size=shape).astype(np.float32)
    got = tseg.masked_segment_mean(torch.as_tensor(data),
                                   torch.as_tensor(seg),
                                   torch.as_tensor(mask), n)
    want = jseg.masked_segment_mean(jnp.asarray(data), jnp.asarray(seg),
                                    jnp.asarray(mask), n)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **MEAN_TOL)
    for s in (3, 11, 7):
        assert not _np(got)[s].any()


def test_masked_segment_mean_bf16_counts_in_float32():
    """bf16 data: within ``BF16_ULPS`` of the JAX float32 mean of the same
    values: a segment of 300 entries, past bf16's 256 whole numbers, and
    an empty one."""
    rng = np.random.default_rng(1)
    n, f = 12, 8
    seg = np.concatenate([np.zeros(300, np.int64),
                          _segments(rng, n, 200, empty=[0, 5])])
    mask = np.ones(len(seg), bool)
    mask[rng.choice(len(seg), 60, replace=False)] = False
    data = _np(torch.as_tensor(rng.normal(size=(len(seg), f)).astype(
        np.float32)).bfloat16())                 # bf16 values, as float32
    got = tseg.masked_segment_mean(
        torch.as_tensor(data).bfloat16(), torch.as_tensor(seg),
        torch.as_tensor(mask), n)
    want = _np(jseg.masked_segment_mean(
        jnp.asarray(data), jnp.asarray(seg), jnp.asarray(mask), n))
    assert got.dtype == torch.bfloat16
    g = _np(got)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(g - want) <= BF16_ULPS * ulp), \
        (np.abs(g - want) / ulp).max()
    assert not g[5].any()


def test_masked_segment_mean_matches_dense():
    """tests/test_segment_ops.py's case: the masked mean over in-edges."""
    rng = np.random.default_rng(0)
    n, e, f = 30, 100, 4
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    mask = rng.random(e) > 0.4
    x = rng.normal(size=(n, f)).astype(np.float32)
    want = np.zeros((n, f))
    cnt = np.zeros(n)
    for i in range(e):
        if mask[i]:
            want[src[i]] += x[dst[i]]
            cnt[src[i]] += 1
    want[cnt > 0] /= cnt[cnt > 0, None]
    got = tseg.masked_segment_mean(torch.as_tensor(x)[torch.as_tensor(dst)],
                                   torch.as_tensor(src),
                                   torch.as_tensor(mask), n)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)


def test_segment_count_matches_jax():
    rng = np.random.default_rng(2)
    seg = _segments(rng, 9, 50, empty=[0, 8])
    got = tseg.segment_count(torch.as_tensor(seg), 9)
    want = jseg.segment_count(jnp.asarray(seg), 9)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(want))


# ------------------------------------------------------- max and argmax
def _tie_data(rng, e, levels=4):
    """Values from a few levels, so that most segments hold ties."""
    return rng.integers(0, levels, e).astype(np.float32) - 1.5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fill", [0.0, -7.0])
def test_segment_max_matches_jax(masked, fill):
    rng = np.random.default_rng(3)
    n, e = 15, 80
    seg = _segments(rng, n, e, empty=[2, 9])
    data = _tie_data(rng, e)
    mask = rng.random(e) > 0.3 if masked else None
    if masked:
        mask[seg == 4] = False                   # a fully masked segment
    got = tseg.segment_max(torch.as_tensor(data), torch.as_tensor(seg), n,
                           None if mask is None else torch.as_tensor(mask),
                           fill=fill)
    want = jseg.segment_max(jnp.asarray(data), jnp.asarray(seg), n,
                            None if mask is None else jnp.asarray(mask),
                            fill=fill)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert _np(got)[2] == fill and _np(got)[9] == fill
    if masked:
        assert _np(got)[4] == fill


def test_segment_max_rows_match_jax():
    """[E, F] rows, each feature its own max; a full-shape mask."""
    rng = np.random.default_rng(4)
    n, e, f = 10, 60, 5
    seg = _segments(rng, n, e, empty=[6])
    data = rng.normal(size=(e, f)).astype(np.float32)
    mask = rng.random((e, f)) > 0.5
    for m in (None, mask):
        got = tseg.segment_max(torch.as_tensor(data), torch.as_tensor(seg), n,
                               None if m is None else torch.as_tensor(m))
        want = jseg.segment_max(jnp.asarray(data), jnp.asarray(seg), n,
                                None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [5, 6])
def test_segment_argmax_matches_jax(masked, seed):
    """Ties go to the first occurrence; an empty or fully masked segment
    gives (-inf, 0); a masked entry above the maximum is not chosen."""
    rng = np.random.default_rng(seed)
    n, e = 15, 90
    seg = _segments(rng, n, e, empty=[0, 13])
    data = _tie_data(rng, e)
    mask = None
    if masked:
        mask = rng.random(e) > 0.3
        mask[seg == 4] = False
        data[np.flatnonzero(~mask)[:5]] = 100.0  # masked, larger than all
    got_v, got_i = tseg.segment_argmax(
        torch.as_tensor(data), torch.as_tensor(seg), n,
        None if mask is None else torch.as_tensor(mask))
    want_v, want_i = jseg.segment_argmax(
        jnp.asarray(data), jnp.asarray(seg), n,
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(_np(got_v), _np(want_v))
    np.testing.assert_array_equal(_np(got_i), np.asarray(want_i))
    for s in [0, 13] + ([4] if masked else []):
        assert np.isneginf(_np(got_v)[s]) and int(got_i[s]) == 0
    # the first occurrence, read off the data
    for s in range(n):
        idx = np.flatnonzero((seg == s) & (True if mask is None else mask))
        if len(idx):
            assert int(got_i[s]) == idx[np.argmax(data[idx])]


def test_segment_max_and_argmax_first_occurrence():
    """tests/test_segment_ops.py's case."""
    data = torch.tensor([1.0, 3.0, 3.0, 2.0, 5.0])
    seg = torch.tensor([0, 0, 0, 1, 1])
    np.testing.assert_array_equal(_np(tseg.segment_max(data, seg, 3)),
                                  [3.0, 5.0, 0.0])
    v, i = tseg.segment_argmax(data, seg, 3)
    assert i.tolist() == [1, 4, 0] and np.isneginf(_np(v)[2])


# ------------------------------------------------------- ell_max_gather
def _ell(rng, n, d, full_rows):
    nbr = rng.integers(0, n, (n, d)).astype(np.int64)
    mask = rng.random((n, d)) > 0.3
    mask[full_rows] = False                      # rows without a neighbour
    return nbr, mask


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_ell_max_gather_matches_jax(seed):
    """Values and winners exactly; ties (few weight levels) go to the first
    valid neighbour; a fully masked row gives (-inf, nbr[i, 0]); the
    gradient of sum(value * c) equals ``jax.grad``'s, masked rows giving
    none."""
    rng = np.random.default_rng(seed)
    n, d = 40, 6
    nbr, mask = _ell(rng, n, d, full_rows=[3, 17])
    w = (rng.integers(0, 5, n) / 4).astype(np.float32)
    c = rng.integers(-4, 5, n).astype(np.float32)
    tw = torch.as_tensor(w).requires_grad_()
    v, win = ell_max_gather(tw, torch.as_tensor(nbr), torch.as_tensor(mask))
    (v * torch.as_tensor(c)).sum().backward()
    jv, jwin = j_ell_max_gather(jnp.asarray(w), jnp.asarray(nbr),
                                jnp.asarray(mask))
    jg = jax.grad(lambda w: jnp.sum(j_ell_max_gather(
        w, jnp.asarray(nbr), jnp.asarray(mask))[0] * jnp.asarray(c)))(
            jnp.asarray(w))
    np.testing.assert_array_equal(_np(v), _np(jv))
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jg))
    for i in (3, 17):
        assert np.isneginf(_np(v)[i]) and int(win[i]) == nbr[i, 0]
    assert np.isfinite(tw.grad.numpy()).all()


def test_ell_max_gather_tie_break_and_gradient():
    """tests/test_segment_ops.py's case."""
    w = torch.tensor([0.5, 0.9, 0.9, 0.1], requires_grad=True)
    nbr = torch.tensor([[1, 2, 3], [3, 0, 0]])
    mask = torch.tensor([[True, True, True], [True, False, False]])
    v, win = ell_max_gather(w, nbr, mask)
    assert win.tolist() == [1, 3]
    np.testing.assert_allclose(_np(v), [0.9, 0.1])
    v[0].backward()
    np.testing.assert_array_equal(w.grad.numpy(), [0.0, 1.0, 0.0, 0.0])
