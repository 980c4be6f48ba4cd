"""The port's data tools (mpgnn_tpu_torch.utils.misc, graph.fb15k,
graph.continents, graph.gtn and the ``generate`` CLI) on the CPU against
the JAX package's.

* misc: identical values and files; ``find_smallest_values`` against
  sklearn's DBSCAN through the JAX package, ties at the eps boundary and
  the return types included.
* FB15K-237 preprocessing on tests/test_fb15k.py's fixtures, both label
  modes: byte-identical link.dat, label.dat, relations_legend.dat and
  node.dat, and the same returned arrays. Both packages take the JAX
  package's no-NLTK branch (``nltk`` hidden in ``sys.modules``).
  node_bow.dat: the BoW + PCA features within atol 1e-9 (the port's numpy
  SVD and sklearn's scipy one round differently; components of a zero
  singular value have no defined sign and hold values at rounding level).
  The fixture is small enough that sklearn's ``PCA(svd_solver='auto')``
  takes its exact 'full' solver: its randomized one, which it takes for
  larger inputs, is unseeded in the JAX package.
* ``export_gtn``: pickles holding the same matrices, label lists and
  features.
* ``python -m mpgnn_tpu_torch.generate``: for the same arguments, the same
  folder, file for file, and the same summary line as the JAX CLI."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from mpgnn_tpu import generate as jcli
from mpgnn_tpu.graph import fb15k as jfb
from mpgnn_tpu.graph.continents import continent_of as j_continent_of
from mpgnn_tpu.graph.gtn import export_gtn as j_export_gtn
from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.utils import misc as jmisc
from mpgnn_tpu_torch import generate as tcli
from mpgnn_tpu_torch.graph import fb15k as tfb
from mpgnn_tpu_torch.graph.continents import continent_of
from mpgnn_tpu_torch.graph.gtn import export_gtn
from mpgnn_tpu_torch.graph.hetero import HeteroGraph as TGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.utils import misc as tmisc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOW_ATOL = 1e-9


def _same_files(a, b, skip=()):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        if name in skip:
            continue
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
    return names


# ------------------------------------------------------------------- misc
def test_misc_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    for values in ([3, 1, 3, 2, 1], ["a", "b", "b", "a"], [5]):
        assert tmisc.most_frequent(values) == jmisc.most_frequent(values)
    labels = rng.integers(0, 4, 50)
    np.testing.assert_array_equal(tmisc.one_hot_encoding(labels),
                                  jmisc.one_hot_encoding(labels))
    binary = rng.integers(0, 2, 60)
    assert tmisc.negative_sampling(binary, np.random.default_rng(3)) == \
        jmisc.negative_sampling(binary, np.random.default_rng(3))
    assert tmisc.negative_sampling(binary) == jmisc.negative_sampling(binary)
    idx = rng.permutation(100)[:40]
    for a, b in zip(tmisc.balanced_undersample(idx, labels[:40]),
                    jmisc.balanced_undersample(idx, labels[:40])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("y_true,y_pred", [
    ([0, 1, 2, 2, 1], [0, 2, 2, 1, 1]),
    ([1, 1, 3], [0, 1, 5]),                  # labels seen in one side only
    ([0, 0, 0], [0, 0, 0]),
])
def test_confusion_matrix_files_match_jax(tmp_path, y_true, y_pred):
    want = jmisc.save_confusion_matrix(y_true, y_pred, str(tmp_path / "j"))
    got = tmisc.save_confusion_matrix(y_true, y_pred, str(tmp_path / "t"))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for ext in (".npy", ".txt"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()


def test_find_smallest_values_matches_dbscan():
    """Values on a 0.05 grid put many neighbours exactly at (or a rounding
    off) the eps = 0.1 boundary."""
    cases = [[0.5, 0.6, 0.9], [0.1, 0.2], [0.7, 0.8], [0.2, 0.3, 0.45],
             [0.9, 0.9, 0.9], [0.3], [0.95, 0.4, 0.5, 0.62, 0.05]]
    rng = np.random.default_rng(1)
    for _ in range(60):
        k = int(rng.integers(1, 8))
        cases.append(list(np.round(rng.integers(0, 21, k) * 0.05, 2)))
        cases.append(list(rng.random(k)))
    for vals in cases:
        want = jmisc.find_smallest_values(vals)
        got = tmisc.find_smallest_values(vals)
        assert type(got) is type(want) and got == want, vals


# ----------------------------------------------------------------- FB15K
def _write_fb(d, names, splits):
    os.makedirs(d)
    with open(os.path.join(d, "FB15k_mid2name.txt"), "w") as f:
        for mid, name in names:
            f.write(f"/m/{mid}\t{name}\n")
    for fname, rows in splits.items():
        with open(os.path.join(d, fname), "w") as f:
            for s, r, o in rows:
                f.write(f"{s}\t{r}\t{o}\n")
    return d


@pytest.fixture
def mini_fb(tmp_path):
    """tests/test_fb15k.py's destination-mode fixture."""
    triples = [
        ("/m/e0", "/r/gender", "/m/male"),
        ("/m/e1", "/r/gender", "/m/female"),
        ("/m/e2", "/r/gender", "/m/male"),
        ("/m/e0", "/r/knows", "/m/e1"),
        ("/m/e1", "/r/knows", "/m/e2"),
        ("/m/e3", "/r/likes", "/m/e4"),
        ("/m/e4", "/r/knows", "/m/e5"),
        ("/m/e2", "/r/likes", "/m/male"),
    ]
    names = [(e, f"name_{e}") for e in
             ["e0", "e1", "e2", "e3", "e4", "e5", "male", "female"]]
    return _write_fb(str(tmp_path / "fb"), names, {
        "train.tsv": triples[:6], "test.tsv": triples[6:7],
        "dev.tsv": triples[7:]})


@pytest.fixture
def mini_fb_continent(tmp_path):
    """tests/test_fb15k.py's continent-mode fixture, plus a location whose
    name is one of pandas' missing-value strings and a source that reaches
    a label destination (the "link unlinked nodes" rows)."""
    ents = {"paris": "Paris", "tokyo": "Tokyo", "lima": "Lima",
            "x1": "Xanadu_9", "x2": "x2", "fr": "France", "jp": "Japan",
            "pe": "Peru", "zz": "Atlantis_Land", "na": "NA",
            "e0": "name_e0", "e1": "name_e1"}
    rel = "/base/biblioness/bibs_location/country"
    triples = [
        ("/m/paris", rel, "/m/fr"), ("/m/tokyo", rel, "/m/jp"),
        ("/m/lima", rel, "/m/pe"), ("/m/x1", rel, "/m/zz"),
        ("/m/x2", rel, "/m/na"),
        ("/m/paris", "/r/knows", "/m/tokyo"),
        ("/m/e0", "/r/knows", "/m/e1"),
        ("/m/fr", "/r/borders", "/m/e0"),
    ]
    return _write_fb(str(tmp_path / "fbc"), list(ents.items()), {
        "train.tsv": triples, "test.tsv": [], "dev.tsv": []})


def _descriptions(folder, entities, seed=0):
    """entity2textlong.txt: random sentences over a small vocabulary, with
    punctuation, case and one entity left without a description."""
    rng = np.random.default_rng(seed)
    words = ["Alpha", "beta", "gamma's", "delta", "eps-ilon", "zeta",
             "eta", "theta!", "iota", "kappa", "lambda", "mu", "nu", "xi",
             "omicron", "pi", "rho", "sigma", "tau", "upsilon", "a", "I"]
    with open(os.path.join(folder, "entity2textlong.txt"), "w") as f:
        for e in entities[:-1]:
            k = int(rng.integers(3, 12))
            f.write(f"{e}\t{' '.join(rng.choice(words, k))}.\n")


def _hide_nltk(monkeypatch):
    for mod in ("nltk", "nltk.corpus", "nltk.stem", "nltk.tokenize"):
        monkeypatch.setitem(sys.modules, mod, None)


def _bow(path):
    return np.array([[float(v) for v in line.rstrip("\t\n").split("\t")]
                     for line in open(path)])


@pytest.mark.parametrize("mode", ["destination", "continent"])
def test_preprocess_fb15k_matches_jax(mini_fb, mini_fb_continent, tmp_path,
                                      monkeypatch, mode):
    _hide_nltk(monkeypatch)
    folder, relation = (
        (mini_fb, "/r/gender") if mode == "destination" else
        (mini_fb_continent,
         "/base/biblioness/bibs_location/country/continent"))
    ents = [line.split("\t")[0] for line in
            open(os.path.join(folder, "FB15k_mid2name.txt"))]
    _descriptions(folder, ents)
    want = jfb.preprocess_fb15k(folder, relation, out_dir=str(tmp_path / "j"))
    got = tfb.preprocess_fb15k(folder, relation, out_dir=str(tmp_path / "t"))
    names = _same_files(str(tmp_path / "j"), str(tmp_path / "t"),
                        skip=("node_bow.dat",))
    assert "node_bow.dat" in names and "label.dat" in names
    np.testing.assert_allclose(_bow(tmp_path / "t" / "node_bow.dat"),
                               _bow(tmp_path / "j" / "node_bow.dat"),
                               atol=BOW_ATOL, rtol=0)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k
    assert got["label_mode"] == mode


def test_bow_features_match_sklearn(tmp_path, monkeypatch):
    """CountVectorizer + PCA through the JAX package against the port's
    numpy at 12 and 40 descriptions (sklearn's 'full' solver)."""
    _hide_nltk(monkeypatch)
    for n in (12, 40):
        ents = [f"/m/e{i}" for i in range(n + 1)]
        d = tmp_path / f"d{n}"
        d.mkdir()
        _descriptions(str(d), ents, seed=n)
        ids = {e: i for i, e in enumerate(ents)}
        path = str(d / "entity2textlong.txt")
        want = jfb.build_bow_features(path, ids, len(ents), 8)
        got = tfb.build_bow_features(path, ids, len(ents), 8)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=BOW_ATOL, rtol=0)


def test_triplet_reading_and_continents_match_jax(mini_fb):
    import pandas as pd

    names, triplets = tfb.load_triplet_files(mini_fb)
    jnames, jtrip = jfb.load_triplet_files(mini_fb)
    assert names == list(zip(jnames["entity"], jnames["name"]))
    assert triplets == list(jtrip.itertuples(index=False, name=None))
    assert tfb.many_to_one_relations(triplets) == \
        jfb.many_to_one_relations(pd.DataFrame(
            triplets, columns=["source_entity", "relation",
                               "destination_entity"]))
    for name in ("United_States_of_America", "Republic_of_Macedonia",
                 "Germany", "new zealand", "Texas", "Nowhere", "PERU",
                 "Palestinian_National_Authority", ""):
        assert continent_of(name) == j_continent_of(name)
    assert continent_of("Nowhere", extra={"nowhere": "AF"}) == \
        j_continent_of("Nowhere", extra={"nowhere": "AF"}) == "AF"
    assert tfb.CONTINENT_IDS == jfb.CONTINENT_IDS
    assert tfb.CONTINENT_RELATIONS == jfb.CONTINENT_RELATIONS


# ---------------------------------------------------------------- export
def test_export_gtn_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    n, e = 80, 600
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    rel = rng.choice([0, 2, 3], e)                 # relation 1 stays empty
    x = rng.normal(size=(n, 3)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    split = split_nodes(labels)
    j_export_gtn(JGraph(x, src, dst, rel, num_relations=4), split,
                 str(tmp_path / "j"))
    export_gtn(TGraph(x, src, dst, rel, num_relations=4), split,
               str(tmp_path / "t"))

    def load(side, name):
        with open(tmp_path / side / name, "rb") as f:
            return pickle.load(f)

    want, got = load("j", "edges.pkl"), load("t", "edges.pkl")
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.format == b.format == "csr"
        assert (a != b).nnz == 0
    assert load("t", "labels.pkl") == load("j", "labels.pkl")
    np.testing.assert_array_equal(load("t", "node_features.pkl"),
                                  load("j", "node_features.pkl"))


# ------------------------------------------------------------------- CLI
def _both_clis(tmp_path, capsys, argv):
    """Run both CLIs' main in this process with ``argv`` and the output
    folder last; return the two summary lines with the folders cut out."""
    lines = []
    for side, main in (("j", jcli.main), ("t", tcli.main)):
        out = str(tmp_path / side)
        main([*argv, "--out", out])
        lines.append(capsys.readouterr().out.strip().replace(out, "OUT"))
    return lines


@pytest.mark.parametrize("argv", [
    ["synthetic", "--num_nodes", "300", "--max_rel_for_node", "4",
     "--metapath", "red-red-blue", "--seed", "3"],
    ["synthetic", "--num_nodes", "400", "--max_rel_for_node", "5",
     "--metapath", "red-blue", "--metapath2", "blue-blue", "--overlap", "1",
     "--shared_relations", "2", "--multiclass"],
    ["powerlaw", "--num_nodes", "2000", "--num_edges", "20000",
     "--num_relations", "12", "--metapath_len", "3", "--seed", "5"],
    ["powerlaw", "--num_nodes", "3000", "--num_edges", "30000",
     "--num_relations", "16", "--seed", "17", "--alpha", "1.1",
     "--format", "npy"],
])
def test_generate_cli_matches_jax(tmp_path, capsys, argv):
    want, got = _both_clis(tmp_path, capsys, argv)
    assert got == want and got.startswith("wrote OUT: ")
    _same_files(str(tmp_path / "j"), str(tmp_path / "t"))


def test_generate_cli_fb15k_matches_jax(mini_fb, tmp_path, capsys,
                                        monkeypatch):
    _hide_nltk(monkeypatch)
    want, got = _both_clis(tmp_path, capsys, ["fb15k", "--path", mini_fb,
                                              "--relation", "/r/gender"])
    assert got == want
    _same_files(str(tmp_path / "j"), str(tmp_path / "t"))


def test_generate_cli_runs_as_a_module(tmp_path):
    """``python -m mpgnn_tpu_torch.generate`` in a process without the JAX
    package on its path: host only, no device."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = str(tmp_path / "kg")
    r = subprocess.run(
        [sys.executable, "-m", "mpgnn_tpu_torch.generate", "powerlaw",
         "--num_nodes", "1000", "--num_edges", "8000", "--num_relations",
         "8", "--format", "npy", "--out", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith(f"wrote {out}: 1000 nodes")
    assert sorted(os.listdir(out)) == [
        "dst.npy", "label_nodes.npy", "labels.npy", "meta.json", "rel.npy",
        "src.npy", "x.f32"]
