"""The port's relation-scoring sweeps (mpgnn_tpu_torch.search.scoring) on
the CPU against the JAX package's (mpgnn_tpu.search.scoring), from the same
numpy seed, with both packages' chunk budgets pinned to one value.

Tolerances, with their reasons (the JAX package's own tolerances for its
segment form against its ELL form, tests/test_scorer.py):
* losses: rtol 1e-5, atol 1e-6; trained weights and member values: rtol
  1e-4, atol 1e-5. Both packages draw the same random numbers and take the
  same winners, and the Adam arithmetic is XLA's; what differs is the sum
  order of the loss and of ``x . u``;
* decisions: equal chunk layouts, degenerate flags, restart counts and
  recorded members.
The segment form is forced as tests/test_scorer.py forces it (_SEG_RATIO
= 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgnn_tpu.config import ScorerConfig as JScorerConfig
from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.search import scoring as jsc
from mpgnn_tpu_torch.config import ScorerConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.models.scorer import seg_first_max
from mpgnn_tpu_torch.search import scoring as sc

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
W_TOL = dict(rtol=1e-4, atol=1e-5)
BUDGET = 1_000_000


@pytest.fixture(autouse=True)
def pinned_budget(monkeypatch):
    monkeypatch.setattr(jsc, "_MEM_BUDGET_ENTRIES", BUDGET)
    monkeypatch.setattr(sc, "_MEM_BUDGET_ENTRIES", BUDGET)


def _force(monkeypatch, form):
    if form == "seg":
        monkeypatch.setattr(jsc, "_SEG_RATIO", 0)
        monkeypatch.setattr(sc, "_SEG_RATIO", 0)


def _graphs(seed, n, e, rels, feat=2, src_hi=None, dst_lo=0, x=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, src_hi or n, e)
    dst = rng.integers(dst_lo, n, e)
    rel = rng.integers(0, rels, e)
    if x is None:
        x = np.ones((n, feat), np.float32)
    return (HeteroGraph(x, src, dst, rel, num_relations=rels),
            JGraph(x, src, dst, rel, num_relations=rels))


# ------------------------------------------------------------ first-max
def _brute(vals, src, em, C):
    seg_max = np.full(C, -np.inf, np.float32)
    win = np.zeros(C, np.int64)
    has = np.zeros(C, bool)
    for c in range(C):
        idx = np.where((src == c) & em)[0]
        if len(idx):
            has[c] = True
            win[c] = idx[np.argmax(vals[idx])]   # first maximum
            seg_max[c] = vals[win[c]]
    return seg_max, win, has


@jax.jit
def _jax_first_max(vals, src, em):
    return jsc._seg_first_max_scan(vals, *jsc._seg_boundaries(src, em, 12))


@pytest.mark.parametrize("trial", range(6))
def test_seg_first_max_matches_scan_and_bruteforce(trial):
    rng = np.random.default_rng(trial)
    C, E = 12, 48
    n_real = int(rng.integers(1, E))
    # sorted real ids, then pads at C - 1 (masked) as the compact stacks lay
    # them out; quantized values make ties likely; some segments empty
    src = np.concatenate([np.sort(rng.integers(0, C - 1, n_real)),
                          np.full(E - n_real, C - 1)])
    em = np.concatenate([rng.random(n_real) < 0.8, np.zeros(E - n_real,
                                                            bool)])
    vals = np.where(em, rng.integers(0, 3, E), -np.inf).astype(np.float32)
    want = _brute(vals, src, em, C)
    scan = [np.asarray(a) for a in _jax_first_max(
        jnp.asarray(vals), jnp.asarray(src, jnp.int32), jnp.asarray(em))]
    seg = torch.tensor(src)[None]
    emt = torch.tensor(em)[None]
    has = sc._segment_has(seg, emt, C)
    mx, win = seg_first_max(torch.tensor(vals)[None], seg, emt, has)
    np.testing.assert_array_equal(has[0].numpy(), want[2])
    np.testing.assert_array_equal(win[0].numpy(), want[1])
    np.testing.assert_array_equal(mx[0].numpy(), want[0])
    np.testing.assert_array_equal(win[0].numpy(), scan[1])
    np.testing.assert_array_equal(has[0].numpy(), scan[2])


def test_seg_first_max_batched_rows_stay_apart():
    """Two rows with the same local ids: flat ids keep their segments
    apart, and each row's winners index its own entries."""
    src = np.array([[0, 0, 1, 3], [0, 1, 1, 3]])
    em = np.array([[1, 1, 1, 0], [1, 1, 1, 0]], bool)
    vals = np.float32([[2, 2, 5, -np.inf], [1, 4, 4, -np.inf]])
    seg = sc._flat_ids(src, 4, "cpu")
    emt = torch.tensor(em)
    has = sc._segment_has(seg, emt, 4)
    mx, win = seg_first_max(torch.tensor(vals), seg, emt, has)
    assert win.tolist() == [[0, 2, 0, 0], [0, 1, 0, 0]]
    assert has.tolist() == [[True, True, False, False],
                            [True, True, False, False]]
    assert mx[0, :2].tolist() == [2.0, 5.0]


# ------------------------------------------------------------ helpers
def test_helpers_match_jax(monkeypatch):
    g, jg = _graphs(0, 300, 900, 3, src_hi=150)
    labels = np.random.default_rng(1).random(300).astype(np.float32)
    mask = np.random.default_rng(2).random(300) < 0.5
    for r in range(3):
        assert sc._relation_mode(g, r) == jsc._relation_mode(jg, r)
        assert sc._compact_pad(g, r) == jsc._compact_pad(jg, r)
        for a, b in zip(sc.dest_min_labels(g, r, mask, labels),
                        jsc.dest_min_labels(jg, r, mask, labels)):
            np.testing.assert_array_equal(a, b)
    for n in (0, 1, 3, 4, 5, 127, 128, 129):
        assert sc._pow2_bucket(n) == jsc._pow2_bucket(n)
        assert sc._pow2_bucket(n, lo=128) == jsc._pow2_bucket(n, lo=128)
    assert sc._chunks([2, 0, 1, 0], g) == jsc._chunks([2, 0, 1, 0], jg)
    _force(monkeypatch, "seg")
    assert sc._chunks([2, 0, 1], g) == jsc._chunks([2, 0, 1], jg)
    tasks = [(0, [0, 1], [[1, 2], [3]], np.float32([1, 0])),
             (5, [2], [[4, 5, 6]], np.float32([1]))]
    assert (sc._instance_chunks(g, tasks, 300)
            == jsc._instance_chunks(jg, tasks, 300))
    s, d, m, nodes = sc._relation_segment_stack_compact(g, [0, 2], 512, 256)
    js, jd, jm, jnodes = jsc._relation_segment_stack_compact(jg, [0, 2], 512,
                                                            256)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(m, jm)


def test_small_budget_splits_chunks_as_jax(monkeypatch):
    monkeypatch.setattr(jsc, "_MEM_BUDGET_ENTRIES", 3000)
    monkeypatch.setattr(sc, "_MEM_BUDGET_ENTRIES", 3000)
    g, jg = _graphs(3, 200, 1600, 4, src_hi=100)
    rels = [3, 1, 0, 2, 1]
    assert sc._chunks(rels, g) == jsc._chunks(rels, jg)
    assert len(sc._chunks(rels, g)) > 1


# --------------------------------------------------------------- flat
@pytest.mark.parametrize("form", ["ell", "seg"])
def test_flat_sweep_matches_jax(monkeypatch, form):
    _force(monkeypatch, form)
    g, jg = _graphs(0, 300, 600, 3, src_hi=150, dst_lo=150)
    labels = np.random.default_rng(0).random(300).astype(np.float32)
    cfg = ScorerConfig(epochs_flat=20)
    got = sc.score_relations_flat(g, [2, 0, 1], labels, None, cfg,
                                  np.random.default_rng(7), device="cpu")
    want = jsc.score_relations_flat(jg, [2, 0, 1], labels, None,
                                    JScorerConfig(epochs_flat=20),
                                    np.random.default_rng(7))
    assert sorted(got) == sorted(want)
    for r in want:
        np.testing.assert_allclose(got[r].loss, want[r].loss, **LOSS_TOL)
        np.testing.assert_allclose(got[r].weights, want[r].weights, **W_TOL)


@pytest.mark.parametrize("form", ["ell", "seg"])
def test_flat_sweep_fixed_sources_matches_jax(monkeypatch, form):
    """FB15K mode: one labeled-source set for every relation; sources
    without edges of a relation add the host-side constant in segment
    form (tests/test_scorer.py:176)."""
    _force(monkeypatch, form)
    rng = np.random.default_rng(1)
    N = 260
    src = np.concatenate([rng.integers(0, 50, 150), rng.integers(100, 150,
                                                                 150)])
    dst = np.concatenate([rng.integers(50, 100, 150),
                          rng.integers(150, 200, 150)])
    rel = np.concatenate([np.zeros(150, int), np.ones(150, int)])
    x = np.ones((N, 2), np.float32)
    g = HeteroGraph(x, src, dst, rel, num_relations=2)
    jg = JGraph(x, src, dst, rel, num_relations=2)
    labels = rng.random(N).astype(np.float32)
    sources = list(range(0, 30)) + list(range(100, 130)) + list(range(200,
                                                                      230))
    got = sc.score_relations_flat(g, [0, 1], labels, sources,
                                  ScorerConfig(epochs_flat=15),
                                  np.random.default_rng(9), device="cpu")
    want = jsc.score_relations_flat(jg, [0, 1], labels, sources,
                                    JScorerConfig(epochs_flat=15),
                                    np.random.default_rng(9))
    for r in (0, 1):
        np.testing.assert_allclose(got[r].loss, want[r].loss, **LOSS_TOL)
        np.testing.assert_allclose(got[r].weights, want[r].weights, **W_TOL)


# ---------------------------------------------------------------- bags
def _bag_setup(seed=3):
    rng = np.random.default_rng(seed)
    N = 120
    x = rng.random((N, 3)).astype(np.float32)
    g, jg = _graphs(seed, N, 300, 3, src_hi=60, dst_lo=60, x=x)
    tasks = [
        (0, [0, 1], [[0, 1, 2], [3], [4, 5]], np.float32([1, 0, 1])),
        (4, [2, 0], [[7, 8], [9], [10], [11, 12, 13, 14]],
         np.float32([1, 0, 0, 1])),
        (9, [1], [[20]], np.float32([1])),           # one bag: degenerate
    ]
    return g, jg, tasks


@pytest.mark.parametrize("form", ["ell", "seg"])
def test_bag_tasks_match_jax(monkeypatch, form):
    _force(monkeypatch, form)
    g, jg, tasks = _bag_setup()
    got = sc.score_bag_tasks(g, tasks, ScorerConfig(epochs_bags=12,
                                                    max_restarts=4),
                             np.random.default_rng(5), device="cpu")
    want = jsc.score_bag_tasks(jg, tasks, JScorerConfig(epochs_bags=12,
                                                         max_restarts=4),
                               np.random.default_rng(5))
    assert sorted(got) == sorted(want)
    restarts = []
    for tid in want:
        assert sorted(got[tid]) == sorted(want[tid])
        for r, w in want[tid].items():
            s = got[tid][r]
            assert s.degenerate == w.degenerate, (tid, r)
            assert s.num_restarts == w.num_restarts, (tid, r)
            restarts.append(s.num_restarts)
            np.testing.assert_allclose(s.loss, w.loss, **LOSS_TOL)
            np.testing.assert_allclose(s.weights, w.weights, **W_TOL)
            np.testing.assert_allclose(s.attribution, w.attribution, **W_TOL)
            np.testing.assert_array_equal(s.member_recorded,
                                          w.member_recorded)
            np.testing.assert_allclose(s.member_pred_max, w.member_pred_max,
                                       **W_TOL)
    assert any(got[9][1].degenerate for _ in [0])
    assert max(restarts) > 2          # some instance restarted past 2


@pytest.mark.parametrize("form", ["ell", "seg"])
def test_retrain_bags_predictions_matches_jax(monkeypatch, form):
    _force(monkeypatch, form)
    g, jg, tasks = _bag_setup(4)
    _, _, bags, labels = tasks[1]
    got = sc.retrain_bags_predictions(g, 0, bags, labels,
                                      ScorerConfig(epochs_bags=10),
                                      np.random.default_rng(2), device="cpu")
    want = jsc.retrain_bags_predictions(jg, 0, bags, labels,
                                        JScorerConfig(epochs_bags=10),
                                        np.random.default_rng(2))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **W_TOL)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].any()


def test_sweeps_refuse_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    g, _, tasks = _bag_setup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sc.score_relations_flat(g, [0], np.zeros(120, np.float32), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sc.score_bag_tasks(g, tasks)
