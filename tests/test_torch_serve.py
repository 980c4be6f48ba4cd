"""The port's eval forward and serving path (mpgnn_tpu_torch, on the CPU)
against the JAX package's mpgnn_forward and MetapathPredictor with the same
parameters. Tolerance atol = 1e-4 on log-probs, as tests/test_torch_parity.py:
float32 aggregation, GEMMs and log_softmax in another order."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.graph.io import load_dat_files as j_load
from mpgnn_tpu.models.mpgnn import init_mpgnn as j_init
from mpgnn_tpu.models.mpgnn import mpgnn_forward
from mpgnn_tpu.serve import MetapathPredictor as JPredictor
from mpgnn_tpu.train.loops import build_hop_arrays as j_hops
from mpgnn_tpu_torch import serve as tserve
from mpgnn_tpu_torch.graph.hetero import HeteroGraph as TGraph
from mpgnn_tpu_torch.graph.io import load_dat_files as t_load
from mpgnn_tpu_torch.ops.csr import CsrBlocking, DedupCsrBlocking
from mpgnn_tpu_torch.train.loops import build_hop_arrays as t_hops
from mpgnn_tpu_torch.utils.checkpoint import restore_params, save_params
from mpgnn_tpu_torch.weights import params_from_jax

ATOL = 1e-4
DATA = "data/synthetic_multiclass/"
SYNTH_PATHS = [[1, 0], [2, 3]]     # metapath.dat and metapath2.dat


def _graph_arrays(seed=0):
    """600 nodes; relations 0 and 2 uniform, relation 1 hub-skewed (its
    destinations are 40 hub nodes) so that 'auto' routes it to the dedup
    tiles and the others to the classic CSR."""
    rng = np.random.default_rng(seed)
    n, f = 600, 5
    parts = []
    for rel, e in ((0, 500), (1, 2000), (2, 500)):
        src = rng.integers(0, n, e)
        dst = rng.integers(0, 40, e) if rel == 1 else rng.integers(0, n, e)
        parts.append((src, dst, np.full(e, rel)))
    src, dst, rel = (np.concatenate(p) for p in zip(*parts))
    x = rng.normal(size=(n, f)).astype(np.float32)
    return x, src, dst, rel


def test_mpnetm_matches_jax_forward():
    x, src, dst, rel = _graph_arrays()
    metapaths = [[0, 2], [1, 0], [1]]
    params = j_init(jax.random.PRNGKey(7), x.shape[1], 16, 3, metapaths)
    jg = JGraph(x, src, dst, rel, num_relations=3)
    want = np.asarray(mpgnn_forward(
        params, jnp.asarray(x), j_hops(jg, metapaths, backend="csr"),
        train=False))

    tg = TGraph(x, src, dst, rel, num_relations=3)
    model = params_from_jax(params, device="cpu").eval()
    xt = torch.from_numpy(x)
    for backend in ("csr", "segment"):
        ops = t_hops(tg, metapaths, backend=backend, device="cpu")
        with torch.no_grad():
            got = model(xt, ops).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    csr_ops = t_hops(tg, metapaths, backend="csr", device="cpu")
    assert isinstance(csr_ops[1][0][1], DedupCsrBlocking)
    assert isinstance(csr_ops[0][0][1], CsrBlocking)


def test_params_from_jax_reads_keys_and_attributes():
    params = j_init(jax.random.PRNGKey(1), 4, 8, 2, [[0, 1]])
    as_dict = {
        "convs": [[c._asdict() for c in stack] for stack in params.convs],
        "fc1": params.fc1._asdict(), "fc2": params.fc2._asdict(),
    }
    a = params_from_jax(params, device="cpu").state_dict()
    b = params_from_jax(as_dict, device="cpu").state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    np.testing.assert_array_equal(
        a["fc1.weight"].numpy(), np.asarray(params.fc1.w).T)


@pytest.fixture(scope="module")
def synthetic_model(tmp_path_factory):
    """JAX parameters for the shipped synthetic dataset, saved by the
    port's save_params."""
    jg, _, _ = j_load(DATA + "node.dat", DATA + "link.dat", DATA + "label.dat")
    params = j_init(jax.random.PRNGKey(3), jg.feat_dim, 8, 3, SYNTH_PATHS)
    model_dir = str(tmp_path_factory.mktemp("model"))
    save_params(model_dir, params_from_jax(params, device="cpu"))
    return jg, params, model_dir


def test_serve_main_matches_jax_predictor(synthetic_model, capsys):
    jg, params, model_dir = synthetic_model
    want = JPredictor(jg, SYNTH_PATHS, params, backend="csr")
    nodes = [0, 1, 17, 42, 4999]
    common = ["--model_dir", model_dir, "--metapaths", json.dumps(SYNTH_PATHS),
              "--folder", DATA, "--hidden_dim", "8", "--num_classes", "3",
              "--device", "cpu"]
    tserve.main(common)
    got_all = json.loads(capsys.readouterr().out)
    preds = want.predict()
    assert got_all == {"num_nodes": len(preds),
                       "class_counts": np.bincount(preds).tolist()}
    tserve.main(common + ["--nodes", ",".join(map(str, nodes))])
    got_nodes = json.loads(capsys.readouterr().out)
    assert got_nodes == {str(i): int(preds[i]) for i in nodes}


@pytest.mark.parametrize("backend", ["csr", "segment", "ell", "ell2",
                                     "dense", "onehot"])
def test_predictor_log_probs_match_jax(synthetic_model, backend):
    jg, params, model_dir = synthetic_model
    want = JPredictor(jg, SYNTH_PATHS, params, backend="csr").log_probs()
    tg, _, _ = t_load(DATA + "node.dat", DATA + "link.dat", DATA + "label.dat")
    pred = tserve.MetapathPredictor.load(
        model_dir, tg, SYNTH_PATHS, num_classes=3, hidden_dim=8,
        device="cpu", backend=backend)
    np.testing.assert_allclose(pred.log_probs(), want, atol=ATOL, rtol=0)
    assert pred.refresh() > 0
    np.testing.assert_allclose(pred.log_probs(), want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pred.predict([3, 5]),
                                  want.argmax(axis=1)[[3, 5]])


@pytest.mark.parametrize("backend,err", [("auto", "unknown backend"),
                                         ("halo", "requires a mesh")])
def test_predictor_refuses_what_the_jax_predictor_does_not_resolve(
        synthetic_model, backend, err):
    tg, _, _ = t_load(DATA + "node.dat", DATA + "link.dat", DATA + "label.dat")
    with pytest.raises(ValueError, match=err):
        tserve.MetapathPredictor.load(
            synthetic_model[2], tg, SYNTH_PATHS, num_classes=3, hidden_dim=8,
            device="cpu", backend=backend)


def test_restore_params_round_trip(synthetic_model):
    _, params, model_dir = synthetic_model
    saved = params_from_jax(params, device="cpu").state_dict()
    restored = restore_params(model_dir, params_from_jax(
        j_init(jax.random.PRNGKey(9), 2, 8, 3, SYNTH_PATHS), device="cpu"))
    for k, v in restored.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
