"""The port's search bookkeeping (mpgnn_tpu_torch.search.bags, a numpy copy)
against the JAX package's (mpgnn_tpu.search.bags): on random graphs, label
vectors and dictionaries, every function gives equal outputs (the same
lists in the same order, equal arrays)."""

import numpy as np
import pytest

from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.search import bags as jb
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.search import bags as tb

SEEDS = range(4)


def _graphs(seed, n=80, e=400, rels=5, feat=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, rels, e)
    x = rng.random((n, feat)).astype(np.float32)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    return (HeteroGraph(x, src, dst, rel, num_relations=rels),
            JGraph(x, src, dst, rel, num_relations=rels), labels, rng)


@pytest.mark.parametrize("seed", SEEDS)
def test_dictionaries_bags_and_cleaning_match_jax(seed):
    g, jg, labels, rng = _graphs(seed)
    sources = sorted(rng.choice(80, 40, replace=False).tolist())
    for r in range(5):
        ed, dd = tb.build_dictionaries(g, r, sources, labels)
        jed, jdd = jb.build_dictionaries(jg, r, sources, labels)
        assert ed == jed and list(ed) == list(jed)
        assert dd == jdd and list(dd) == list(jdd)
        for thr in (0.9, 0.5):
            bags, bl = tb.create_bags(ed, dd, thr)
            jbags, jbl = jb.create_bags(jed, jdd, thr)
            assert bags == jbags
            np.testing.assert_array_equal(bl, jbl)
        u = rng.random(3).astype(np.float32) - 0.2
        for thr in (0.01, 0.3):
            ce, cd = tb.clean_dictionaries(g.x, ed, dd, u, thr)
            jce, jcd = jb.clean_dictionaries(jg.x, jed, jdd, u, thr)
            assert ce == jce and list(ce) == list(jce)
            assert cd == jcd


@pytest.mark.parametrize("seed", SEEDS)
def test_relabel_and_connected_relations_match_jax(seed):
    g, jg, labels, rng = _graphs(seed)
    pred = rng.random(80).astype(np.float32)
    rec = rng.random(80) < 0.5
    for thr in (0.9, 0.5):
        s, lab = tb.relabel_from_predictions(pred, rec, 80, thr)
        js, jlab = jb.relabel_from_predictions(pred, rec, 80, thr)
        assert s == js
        np.testing.assert_array_equal(lab, jlab)
    members = sorted(rng.choice(80, 10, replace=False).tolist())
    assert (tb.connected_relations(g, node_labels=labels)
            == jb.connected_relations(jg, node_labels=labels))
    assert (tb.connected_relations(g, source_nodes=members)
            == jb.connected_relations(jg, source_nodes=members))
    assert (tb.connected_relations(g, bag_members=members)
            == jb.connected_relations(jg, bag_members=members))


@pytest.mark.parametrize("seed", SEEDS)
def test_gap_selections_match_jax(seed):
    rng = np.random.default_rng(seed)
    for n in range(0, 8):
        # quantized losses: equal gaps and equal losses occur
        items = [(int(r), float(v)) for r, v in zip(
            rng.permutation(20)[:n], rng.integers(0, 6, n) / 8.0)]
        assert tb.flat_gap_selection(items) == jb.flat_gap_selection(items)
        for inc in (False, True):
            assert (tb.bag_gap_selection(items, inclusive=inc)
                    == jb.bag_gap_selection(items, inclusive=inc))


def test_reference_branching_cases_match_jax():
    """The hand cases of tests/test_bags.py: the strict cut that admits
    nothing at exactly 3 relations, the 1-2 relation keep-all branch, and
    the negative-singleton dedup of create_bags."""
    three = [(0, 0.01), (1, 0.02), (2, 0.5)]
    assert tb.bag_gap_selection(three) == jb.bag_gap_selection(three) == []
    assert tb.bag_gap_selection(three[:2]) == three[:2]
    ed, dd = {10: [1, 2, 3], 11: [2]}, {1: [1.0, 1.0], 2: [1.0, 0.0],
                                        3: [1.0]}
    assert tb.create_bags(ed, dd)[0] == jb.create_bags(ed, dd)[0] == [[2],
                                                                     [1, 3]]
