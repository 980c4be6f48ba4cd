"""The port's host graph layer (mpgnn_tpu_torch.graph, .native,
.train.metrics) against the JAX package's: loaders, generator, relation
slices and macro-F1 give identical results."""

import os

import numpy as np
import pytest

from mpgnn_tpu.graph import generate as jgen
from mpgnn_tpu.graph import io as jio
from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.train.metrics import macro_f1_np as j_f1
from mpgnn_tpu_torch.graph import generate as tgen
from mpgnn_tpu_torch.graph import io as tio
from mpgnn_tpu_torch.graph.hetero import HeteroGraph as TGraph
from mpgnn_tpu_torch.train.metrics import macro_f1_np as t_f1

DATA = "data/synthetic_multiclass/"


def _files(folder):
    return [os.path.join(folder, f) for f in ("node.dat", "link.dat",
                                              "label.dat")]


def _assert_same_graph(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    for name in ("edge_src", "edge_dst", "edge_type", "sorted_src",
                 "sorted_dst", "sorted_type", "rel_ptr", "rel_counts"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.num_nodes, a.feat_dim, a.num_edges, a.num_relations) == \
        (b.num_nodes, b.feat_dim, b.num_edges, b.num_relations)


def test_load_dat_files_matches_jax():
    jg, jl, jb = jio.load_dat_files(*_files(DATA))
    tg, tl, tb = tio.load_dat_files(*_files(DATA))
    _assert_same_graph(jg, tg)
    np.testing.assert_array_equal(jl, tl)
    assert len(jb) == len(tb) == 3
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a, b)
    assert jg.distinct_relations == tg.distinct_relations


def test_relation_slices_match_jax():
    rng = np.random.default_rng(1)
    n, e, r = 300, 4000, 7
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    rel = rng.integers(0, r - 1, e)          # relation 6 stays empty
    x = rng.normal(size=(n, 3)).astype(np.float32)
    jg = JGraph(x, src, dst, rel, num_relations=r)
    tg = TGraph(x, src, dst, rel, num_relations=r)
    _assert_same_graph(jg, tg)
    for k in range(r):
        assert jg.rel_slice(k) == tg.rel_slice(k)
        for a, b in zip(jg.rel_edges(k), tg.rel_edges(k)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jg.rel_edges_csr(k), tg.rel_edges_csr(k)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jg.rel_degrees(k), tg.rel_degrees(k))


def test_powerlaw_generator_is_bit_identical(tmp_path):
    kw = dict(num_nodes=2000, num_edges=20000, num_relations=12,
              metapath_len=3, seed=5)
    a = jgen.generate_powerlaw_kg(**kw)
    b = tgen.generate_powerlaw_kg(**kw)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        elif isinstance(a[k], list) and a[k] and \
                isinstance(a[k][0], np.ndarray):
            for u, v in zip(a[k], b[k]):
                np.testing.assert_array_equal(u, v)
        else:
            assert a[k] == b[k], k
    jgen.write_dat_files(str(tmp_path / "j"), a)
    tgen.write_dat_files(str(tmp_path / "t"), b)
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name
    # and the KG-format files load the same in both packages
    jg, jl, _, jn = jio.load_fb15k237(*_files(str(tmp_path / "j")))
    tg, tl, _, tn = tio.load_fb15k237(*_files(str(tmp_path / "t")))
    _assert_same_graph(jg, tg)
    np.testing.assert_array_equal(jl, tl)
    assert jn == tn


@pytest.mark.parametrize("rows", [
    ["0\t0.5\t1\t", "1\t2\t-3.25\t", "2\t0\t0\t"],          # numeric, trailing tab
    ["1\t7", "0\t3"],                                        # one numeric column
])
def test_read_node_features_matches_jax(tmp_path, rows):
    path = tmp_path / "node.dat"
    path.write_text("\n".join(rows) + "\n")
    want = jio.read_node_features(str(path))
    got = tio.read_node_features(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_node_features_one_hot_colours(tmp_path):
    """A single string column is one-hot encoded over its sorted values,
    as pd.get_dummies does. (The JAX loader's own test of this, its
    ``dtype == object`` check, misses pandas 3's string dtype, so the
    expected array is written out.)"""
    path = tmp_path / "node.dat"
    path.write_text("2\tred\n0\tblue\n1\tgreen\n3\tred\n")
    want = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(tio.read_node_features(str(path)), want)


def test_macro_f1_matches_jax():
    rng = np.random.default_rng(0)
    for c in (2, 3, 5):
        preds = rng.integers(0, c, 200)
        labels = rng.integers(0, c, 200)
        assert t_f1(preds, labels) == pytest.approx(j_f1(preds, labels),
                                                    abs=1e-6)
    assert t_f1([0, 0], [0, 0], 4) == pytest.approx(j_f1([0, 0], [0, 0], 4))
