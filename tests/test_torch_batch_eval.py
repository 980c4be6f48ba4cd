"""The port's batched final evaluation (mpgnn_tpu_torch.train.batch_eval,
ops.csr.stack_blockings, ops.segment.stack_edge_lists, MPNetmStack) on the
CPU, against the port's per-candidate ``train_mpgnn`` and the JAX
package's ``evaluate_candidates``.

Tolerances, with their reasons:
* batched against per-candidate, dropout 0.6: validation F1 within 1e-6,
  each candidate's validation log-probabilities within LOGP_ATOL = 1e-5 and
  its trained parameters within PARAM_ATOL = 1e-4. Every candidate of a
  length starts from the same parameters and draws the same masks in both;
  the stacked GEMMs and sums may order float32 terms otherwise, which moves
  parameters by about 1e-7, until a unit's pre-activation sits at its
  ReLU's edge: then one element can take a different Adam step (1.7e-5 on
  [3, 3, 1]'s hop-0 root between epochs 15 and 20, csr).
* each candidate's trained parameters against the JAX package's
  ``train_mpgnn`` of it alone, dropout 0, its initial parameters carried
  across: JAX_PARAM_ATOL = 1e-4 (2.4e-5 seen, csr). On the planted graph:
  on this file's noisy graph the JAX package's first-step gradient of
  [1, 0] lies 1.6e-5 (1% of its largest entry) off a float64 autograd of
  the same model, the port's 5e-10, and Adam's sign-led steps carry that
  to 2e-2 in 20 epochs.
* batched against JAX, dropout 0, the JAX package's initial parameters
  carried across: validation F1 within 1e-6, as the port's training is
  held against JAX's (tests/test_torch_train.py). The graph's labels are
  noisy, so the F1s lie well below 1 and differ between candidates. After
  20 Adam steps float32 noise moves the logits by up to about 1e-2, so a
  validation node nearer than that to the decision boundary may flip
  between two correct runs: the JAX package's own segment and csr batched
  paths part that way on [0, 3], whose last hop sums the hub relation's
  long rows (0.6139 against 0.6062, the node's margin 0.0066), where the
  port's segment, csr and per-candidate runs and JAX's csr run all give
  0.6062. The segment comparison therefore takes paths of the uniform
  relations, whose rows are short; the csr one takes the hub relation (K2)
  too.
* stacked blockings through K1's plain version, a chunk cap of 2 and a
  resumed evaluation: bitwise (the same float64 sums, the same steps)."""

import jax
import numpy as np
import pytest
import torch

from mpgnn_tpu.config import MPGNNConfig as JConfig
from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.graph.io import split_nodes as j_split
from mpgnn_tpu.models.mpgnn import init_mpgnn as j_init
from mpgnn_tpu.train.batch_eval import evaluate_candidates as j_evaluate
from mpgnn_tpu.train.loops import train_mpgnn as j_train
from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.models.mpgnn import MPNetmStack, init_mpgnn
from mpgnn_tpu_torch.ops import csr
from mpgnn_tpu_torch.ops.segment import stack_edge_lists
from mpgnn_tpu_torch.train import batch_eval, train_mpgnn
from mpgnn_tpu_torch.train.loops import (
    build_hop_arrays,
    relation_op,
    split_tensors,
)
from mpgnn_tpu_torch.weights import params_from_jax, stack_params_from_jax
from test_torch_csr import _merge_path_walk


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread in this module, as tests/test_torch_warm.py
    runs: the tier-1 run shares the cores among several workers, where
    PyTorch's intra-op pool waits on descheduled threads at every parallel
    op of these CPU training loops (100-200x slower than alone). Both sides
    of every comparison run under it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F1_ATOL = 1e-6
LOGP_ATOL = 1e-5
PARAM_ATOL = 1e-4
JAX_PARAM_ATOL = 1e-4
HUB = 3                    # the relation whose hub rows route to K2
PATHS = [[0], [2], [HUB], [1, 0], [HUB, 2], [0, HUB], [2, 1, 0],
         [HUB, HUB, 1]]


def _arrays(n=2500, e=10000, seed=0):
    """Four relations over n nodes, relation 3 hub-skewed (K2 both ways);
    labels from a noisy feature, so no path explains them whole."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    rel = rng.integers(0, 4, e)
    hub = rel == HUB
    src[hub] = (n * rng.random(hub.sum()) ** 4).astype(np.int64)
    dst[hub] = (n * rng.random(hub.sum()) ** 6).astype(np.int64)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    labels = (x[:, 0] + 1.5 * rng.normal(size=n) > 0).astype(np.int64)
    return (x, src, dst, rel), labels


@pytest.fixture(scope="module")
def case():
    arrays, labels = _arrays()
    return HeteroGraph(*arrays, num_relations=4), labels


def test_the_hub_relation_runs_k2_and_the_others_k1(case):
    graph, _ = case
    for rel in range(4):
        _, fwd, bwd = relation_op(graph, rel, "csr", "cpu")
        want = csr.DedupCsrBlocking if rel == HUB else csr.CsrBlocking
        assert isinstance(fwd, want) and isinstance(bwd, want)
    parts = batch_eval.stacked_hop(graph, [0, HUB, 2, HUB], "csr",
                                   torch.device("cpu"))
    assert [p[0] for p in parts] == [(0, 2), (1,), (3,)]


def _trained(graph, paths, split, cfg, seed, backend, init=None):
    """{str(path): trained MPNetm}: ``batch_eval.train_chunk`` on each
    length group of ``paths``, its stack split back into models. ``init``,
    if given, maps a chunk to its initial stack."""
    x = torch.from_numpy(graph.x)
    parts = split_tensors(split, "cpu")[:4]
    out = {}
    for length in sorted({len(p) for p in paths}):
        chunk = [list(p) for p in paths if len(p) == length]
        real = batch_eval.init_stack
        if init is not None:
            batch_eval.init_stack = lambda *a: (init(chunk), 0)
        try:
            _, stack = batch_eval.train_chunk(graph, chunk, x, parts, 2, cfg,
                                              seed, backend)
        finally:
            batch_eval.init_stack = real
        out.update(zip(map(str, chunk), stack.split()))
    return out


def _val_logp(graph, path, model, split, backend):
    with torch.no_grad():
        return model(torch.from_numpy(graph.x),
                     build_hop_arrays(graph, [path], backend, "cpu"))[
                         torch.from_numpy(split.val_idx)]


def _assert_models_close(got, want, atol):
    sg, sw = got.state_dict(), want.state_dict()
    assert sg.keys() == sw.keys()
    for k in sw:
        torch.testing.assert_close(sg[k], sw[k], rtol=0, atol=atol)


@pytest.mark.parametrize("backend", ["segment", "csr"])
def test_batched_equals_per_candidate_train_mpgnn(case, backend):
    graph, labels = case
    split = split_nodes(labels)
    cfg = MPGNNConfig(epochs=20, hidden_dim=16, dropout=0.6)
    got = batch_eval.evaluate_candidates(graph, PATHS, split, 2, cfg, seed=3,
                                         backend=backend, device="cpu")
    runs = {str(p): train_mpgnn(graph, [p], split, 2, cfg, seed=3,
                                backend=backend, device="cpu")
            for p in PATHS}
    want = {k: r.val_f1 for k, r in runs.items()}
    # length order, as the JAX package returns them
    assert list(got) == [str(p) for p in sorted(PATHS, key=len)]
    for k, v in want.items():
        assert abs(got[k] - v) <= F1_ATOL, k
    assert len(set(want.values())) > 3 and max(want.values()) < 0.95
    # each candidate's trained parameters and validation log-probabilities
    models = _trained(graph, PATHS, split, cfg, 3, backend)
    for p in PATHS:
        one = runs[str(p)].params
        _assert_models_close(models[str(p)], one, PARAM_ATOL)
        torch.testing.assert_close(
            _val_logp(graph, p, models[str(p)], split, backend),
            _val_logp(graph, p, one, split, backend), rtol=0, atol=LOGP_ATOL)


@pytest.mark.parametrize("backend", ["segment", "csr"])
def test_batched_equals_jax_evaluate_candidates(backend, monkeypatch):
    arrays, labels = _arrays(n=800, e=3200)
    graph = HeteroGraph(*arrays, num_relations=4)
    jgraph = JGraph(*arrays, num_relations=4)
    assert isinstance(relation_op(graph, 0, "csr", "cpu")[1],
                      csr.CsrBlocking)
    paths = ([[0], [HUB], [1, 0], [HUB, 2], [0, HUB]] if backend == "csr"
             else [[0], [2], [1, 0], [2, 1], [0, 2, 1]])
    seed, epochs, hidden = 4, 20, 16
    want = j_evaluate(jgraph, paths, j_split(labels), 2,
                      JConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0),
                      seed=seed, backend=backend)

    def carried(c, input_dim, hidden_dim, num_classes, length, seed_, dev):
        # the JAX package's per-candidate keys of an unchunked group
        keys = jax.random.split(jax.random.PRNGKey(seed_), c)
        trees = [j_init(keys[i], input_dim, hidden_dim, num_classes,
                        [[0] * length]) for i in range(c)]
        return stack_params_from_jax(trees, device=dev), 0

    monkeypatch.setattr(batch_eval, "init_stack", carried)
    got = batch_eval.evaluate_candidates(
        graph, paths, split_nodes(labels), 2,
        MPGNNConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0),
        seed=seed, backend=backend, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= F1_ATOL, k
    assert len(set(want.values())) > 2 and max(want.values()) < 0.95


@pytest.mark.parametrize("backend", ["segment", "csr"])
def test_batched_parameters_equal_jax_train_mpgnn(backend):
    """Each candidate's trained parameters against the JAX package's
    ``train_mpgnn`` of that candidate alone, dropout 0, its initial
    parameters carried into the stack, on tests/test_torch_train.py's
    planted graph, where the port's training is held against JAX's."""
    from mpgnn_tpu.graph.generate import generate_synthetic_graph

    g = generate_synthetic_graph(800, 4, "red-red-blue", seed=7)
    arrays = (g["node_features"].astype(np.float32), g["src"], g["dst"],
              g["rel"])
    graph = HeteroGraph(*arrays, num_relations=4)
    jgraph = JGraph(*arrays, num_relations=4)
    paths = [[2 if backend == "segment" else 3], [1, 0], [2, 3], [0, 1, 2]]
    seed, epochs, hidden = 4, 20, 16
    init_key, _ = jax.random.split(jax.random.PRNGKey(seed))

    def carried(chunk):
        return stack_params_from_jax(
            [j_init(init_key, graph.feat_dim, hidden, 2, [p]) for p in chunk],
            device="cpu")

    models = _trained(graph, paths, split_nodes(g["labels"]),
                      MPGNNConfig(epochs=epochs, hidden_dim=hidden,
                                  dropout=0.0), seed, backend, init=carried)
    for p in paths:
        want = j_train(jgraph, [p], j_split(g["labels"]), 2,
                       JConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0),
                       seed=seed, backend=backend)
        _assert_models_close(models[str(p)],
                             params_from_jax(want.params, device="cpu"),
                             JAX_PARAM_ATOL)


def test_stacked_blockings_through_plain_k1_equal_per_candidate(case):
    graph, _ = case
    n, f = graph.num_nodes, 5
    rels = [0, 2, 1, 0]
    ops = [relation_op(graph, r, "csr", "cpu") for r in rels]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (len(rels) * n, f)).astype(np.float32))
    for d in (1, 2):                       # forward, backward
        stacked = csr.stack_blockings(op[d] for op in ops)
        assert (stacked.num_rows, stacked.num_cols) == (4 * n, 4 * n)
        got = csr.csr_scatter_plain(stacked, x)
        want = torch.cat([csr.csr_scatter_plain(op[d], x[c * n:(c + 1) * n])
                          for c, op in enumerate(ops)])
        assert torch.equal(got, want)
        # K1's merge-path partition and carry order on the stacked layout
        _, share = csr.k1_layout(f, 1)
        walked, written, _, _, _ = _merge_path_walk(stacked, x.numpy(), share)
        np.testing.assert_allclose(walked, want.numpy(), rtol=1e-6, atol=1e-7)
        assert (written == 1).all()
    with pytest.raises(TypeError):
        csr.stack_blockings([relation_op(graph, HUB, "csr", "cpu")[1]])


def test_stacked_edge_lists_equal_per_candidate(case):
    from mpgnn_tpu_torch.ops.spmm import rel_mean_aggregate

    graph, _ = case
    n = graph.num_nodes
    ops = [relation_op(graph, r, "segment", "cpu") for r in (2, HUB, 2)]
    x = torch.randn(3 * n, 4, generator=torch.Generator().manual_seed(0))
    src, dst, inv = stack_edge_lists([op[1:] for op in ops], n)
    got = rel_mean_aggregate(x, src, dst, 3 * n, inv_count=inv)
    want = torch.cat([rel_mean_aggregate(x[c * n:(c + 1) * n], *op[1:3], n,
                                         inv_count=op[3])
                      for c, op in enumerate(ops)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("split_rows", [1, 1 << 30])
def test_stacked_matmul_gradients(monkeypatch, split_rows):
    """Both forms of the weight gradient (one product a candidate, and the
    batched one) against autograd through torch.bmm."""
    from mpgnn_tpu_torch.models import mpgnn

    monkeypatch.setattr(mpgnn, "SPLIT_ROWS", split_rows)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(3, 50, 4, generator=gen, requires_grad=True)
    w = torch.randn(3, 4, 6, generator=gen, requires_grad=True)
    g = torch.randn(3, 50, 6, generator=gen)
    got = torch.autograd.grad(mpgnn.stacked_matmul(a, w), (a, w), g)
    want = torch.autograd.grad(torch.bmm(a, w), (a, w), g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def test_stack_splits_back_into_its_models():
    models = [init_mpgnn(3, 8, 2, [[0, 0]], device="cpu",
                         generator=torch.Generator().manual_seed(s))
              for s in range(3)]
    back = MPNetmStack.from_models(models).split()
    for a, b in zip(models, back):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("backend", ["segment", "csr"])
def test_chunk_cap_of_two_equals_no_cap(case, backend, monkeypatch):
    graph, labels = case
    split = split_nodes(labels)
    cfg = MPGNNConfig(epochs=8, hidden_dim=8)
    whole = batch_eval.evaluate_candidates(graph, PATHS, split, 2, cfg,
                                           backend=backend, device="cpu")
    monkeypatch.setattr(batch_eval, "_CHUNK_CAP", 2)
    sunk = []
    chunked = batch_eval.evaluate_candidates(graph, PATHS, split, 2, cfg,
                                             backend=backend, device="cpu",
                                             sink=sunk.append)
    assert chunked == whole
    assert [len(s) for s in sunk] == [2, 1, 2, 1, 2]


def test_resume_from_existing_equals_uninterrupted(case, monkeypatch):
    graph, labels = case
    split = split_nodes(labels)
    cfg = MPGNNConfig(epochs=8, hidden_dim=8)
    monkeypatch.setattr(batch_eval, "_CHUNK_CAP", 2)
    whole = batch_eval.evaluate_candidates(graph, PATHS, split, 2, cfg,
                                           device="cpu")
    saved, trained = {}, []
    real = batch_eval.train_chunk

    def interrupted(graph, chunk, *args):
        if len(trained) == 3:
            raise RuntimeError("interrupted")
        trained.append(chunk)
        return real(graph, chunk, *args)

    monkeypatch.setattr(batch_eval, "train_chunk", interrupted)
    with pytest.raises(RuntimeError, match="interrupted"):
        batch_eval.evaluate_candidates(graph, PATHS, split, 2, cfg,
                                       device="cpu", sink=saved.update)
    assert len(saved) == 5
    trained.clear()
    monkeypatch.setattr(batch_eval, "train_chunk", real)
    resumed = batch_eval.evaluate_candidates(graph, PATHS, split, 2, cfg,
                                             device="cpu", existing=saved)
    assert resumed == whole


@pytest.mark.parametrize("backend,err", [("pallas", "single-model")])
def test_refuses_what_has_no_batched_form(case, backend, err):
    graph, labels = case
    with pytest.raises(ValueError, match=err):
        batch_eval.evaluate_candidates(graph, [[0]], split_nodes(labels), 2,
                                       backend=backend, device="cpu")


def test_a_single_model_backend_from_the_config_is_refused(case):
    """A 'pallas' config is not trained with 'segment' in its place (the
    JAX package's fallback): the caller asked for K3/K4."""
    graph, labels = case
    with pytest.raises(ValueError, match="single-model"):
        batch_eval.evaluate_candidates(
            graph, [[0], [1, 2]], split_nodes(labels), 2,
            MPGNNConfig(epochs=5, hidden_dim=8, backend="pallas"),
            device="cpu")
