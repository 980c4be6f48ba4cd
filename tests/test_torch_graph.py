"""The port's host graph layer (mpgnn_tpu_torch.graph, .native,
.train.metrics) against the JAX package's: loaders, generator, relation
slices and macro-F1 give identical results."""

import json
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


# ------------------------------------------- the rest of the graph layer
def _assert_same_tree(a, b, key=""):
    """Equal values, arrays equal with the same dtype, at any depth."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), key
        for k in a:
            _assert_same_tree(a[k], b[k], f"{key}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), key
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same_tree(u, v, f"{key}[{i}]")
    else:
        assert a == b, key


def _same_folder(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
    return names


@pytest.mark.parametrize("kw", [
    dict(num_nodes=300, max_rel_for_node=4, metapath="red-red-blue",
         seed=3),
    dict(num_nodes=400, max_rel_for_node=6, metapath="red-blue-blue",
         overlap=2, shared_relations=1, seed=1),
    dict(num_nodes=400, max_rel_for_node=5, metapath="red-blue",
         metapath2="blue-red-red", metapath3="blue-blue", overlap=3,
         shared_relations=3, seed=2),
    dict(num_nodes=500, max_rel_for_node=5, metapath="red-red-blue",
         metapath2="blue-blue", multiclass=True, seed=4),
    dict(num_nodes=200, max_rel_for_node=3, metapath="blue-red",
         planted_relations=[2], seed=9),
])
def test_synthetic_generator_is_bit_identical(tmp_path, kw):
    """Every option: the same arrays with the same dtypes, byte-identical
    .dat files, and the planted path read back from metapath.dat."""
    want = jgen.generate_synthetic_graph(**kw, out_dir=str(tmp_path / "j"))
    got = tgen.generate_synthetic_graph(**kw, out_dir=str(tmp_path / "t"))
    _assert_same_tree(want, got)
    names = _same_folder(str(tmp_path / "j"), str(tmp_path / "t"))
    assert ("metapath2.dat" in names) == ("metapath2" in kw)
    assert tgen.read_planted_metapath(str(tmp_path / "t")) == \
        jgen.read_planted_metapath(str(tmp_path / "j"))
    for ov in range(4):
        for sr in range(4):
            assert tgen.relation_table(ov, sr) == jgen.relation_table(ov, sr)


def test_npy_dirs_load_in_both_packages(tmp_path):
    """A folder written by either package is byte-identical and loads in
    the other, as memmaps."""
    g = tgen.generate_powerlaw_kg(3000, 30000, 16, metapath_len=2, seed=17)
    jgen.write_npy_dir(str(tmp_path / "j"), g, 16)
    tgen.write_npy_dir(str(tmp_path / "t"), g, 16)
    _same_folder(str(tmp_path / "j"), str(tmp_path / "t"))
    for writer, reader in (("j", tgen.load_npy_dir), ("t", jgen.load_npy_dir),
                           ("t", tgen.load_npy_dir)):
        meta, x, src, dst, rel, labels, label_nodes = reader(
            str(tmp_path / writer))
        assert meta == json.load(open(tmp_path / "j" / "meta.json"))
        assert isinstance(x, np.memmap) and x.dtype == np.float32
        for a in (src, dst, rel, labels, label_nodes):
            assert isinstance(a, np.memmap)
        np.testing.assert_array_equal(x, g["node_features"])
        np.testing.assert_array_equal(src, g["src"])
        np.testing.assert_array_equal(dst, g["dst"])
        np.testing.assert_array_equal(rel, g["rel"])
        np.testing.assert_array_equal(labels, g["labels"])
        np.testing.assert_array_equal(label_nodes, g["label_nodes"])
        assert (src.dtype, labels.dtype, label_nodes.dtype) == \
            (np.int32, np.int8, np.int64)


def test_relation_views_of_the_graph_layer_match_jax():
    rng = np.random.default_rng(4)
    n, e = 60, 500
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    rel = rng.choice([0, 1, 3, 4], e)              # relation 2 stays empty
    x = rng.normal(size=(n, 2)).astype(np.float32)
    jg = JGraph(x, src, dst, rel, num_relations=6)
    tg = TGraph(x, src, dst, rel, num_relations=6)
    assert tg.present_relations() == jg.present_relations() == [0, 1, 3, 4]
    for rels, kw in (([0, 3], {}), ([4, 2, 1], dict(pad_to=300)),
                     ([1], dict(pad_multiple=7)), ([2], {})):
        a, b = tg.relation_batch(rels, **kw), jg.relation_batch(rels, **kw)
        for name in ("relations", "src", "dst", "mask", "counts"):
            got, want = getattr(a, name), getattr(b, name)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want)
        assert (a.num_relations, a.max_edges) == (b.num_relations,
                                                  b.max_edges)
    sources = rng.choice(n, 25, replace=False)
    for r in range(6):
        assert tg.edge_dictionary(r, sources) == jg.edge_dictionary(
            r, sources)


def _acm_fixture(folder):
    """tests/test_train.py's ACM-style fixture, written from
    data/synthetic_multiclass: its node and link files and labels split
    into labels_{train,val,test}.dat."""
    os.makedirs(folder, exist_ok=True)
    for name in ("node.dat", "link.dat"):
        with open(os.path.join(DATA, name)) as f, \
                open(os.path.join(folder, name), "w") as g:
            g.write(f.read())
    ids, labels = tio.read_labels(os.path.join(DATA, "label.dat"))
    order = np.random.default_rng(0).permutation(len(ids))
    cut = [0, len(ids) * 6 // 10, len(ids) * 8 // 10, len(ids)]
    for k, name in enumerate(("train", "val", "test")):
        with open(os.path.join(folder, f"labels_{name}.dat"), "w") as f:
            for i in order[cut[k]: cut[k + 1]]:
                f.write(f"{ids[i]}\t{labels[i]}\n")
    return folder


def test_acm_style_loader_matches_jax(tmp_path):
    d = _acm_fixture(str(tmp_path / "acm"))
    node, link = os.path.join(d, "node.dat"), os.path.join(d, "link.dat")
    jg, jp, jb = jio.load_acm_style(node, link, d)
    tg, tp, tb = tio.load_acm_style(node, link, d)
    _assert_same_graph(jg, tg)
    assert tg.distinct_relations == jg.distinct_relations
    for name in ("train_idx", "train_y", "val_idx", "val_y", "test_idx",
                 "test_y", "sources", "labels"):
        a, b = getattr(tp, name), getattr(jp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    js, ts = jp.as_split(), tp.as_split()
    for name in ("node_idx", "train_idx", "train_y", "val_idx", "val_y",
                 "test_idx", "test_y"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    assert len(jb) == len(tb) == 3
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a, b)


def test_load_synthetic_matches_jax():
    jg, jl, jb = jio.load_synthetic(DATA)
    tg, tl, tb = tio.load_synthetic(DATA)
    _assert_same_graph(jg, tg)
    np.testing.assert_array_equal(jl, tl)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("values", [
    [3, 1, 3, 2, 7], ["red", "blue", "red", "green"], [0.5, -1.0, 0.5],
    ["b"],
])
def test_one_hot_features_matches_jax(values):
    want = jio.one_hot_features(values)
    got = tio.one_hot_features(values)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
