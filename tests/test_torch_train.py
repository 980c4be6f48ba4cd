"""The port's training slice (mpgnn_tpu_torch.train, graph.io.split_nodes,
MPNetm's training forward) on the CPU against the JAX package.

Tolerances, with their reasons:
* split_nodes, mask_label_leak: identical index sets and arrays.
* macro_f1 and evaluate_mpgnn: 1e-6, the same counts in float32.
* training trajectories (30 epochs, dropout 0, the same initial
  parameters): final loss atol 1e-5 and the three macro-F1s atol 1e-6 on
  every backend; final parameters atol 1e-3, a tenth of one Adam step
  (lr 0.01). Adam divides each gradient by its running RMS, so a gradient
  element that float32 noise dominates moves its parameter by up to lr a
  step on either side; the loss and the predictions do not see it. The
  pallas backend rounds h to bf16 on both sides, where a last-bit
  difference can flip a rounding; the same tolerances hold there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgnn_tpu.config import MPGNNConfig as JConfig
from mpgnn_tpu.graph.generate import generate_synthetic_graph
from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.graph.io import mask_label_leak as j_mask
from mpgnn_tpu.graph.io import split_nodes as j_split
from mpgnn_tpu.models.mpgnn import init_mpgnn as j_init
from mpgnn_tpu.train.loops import evaluate_mpgnn as j_evaluate
from mpgnn_tpu.train.loops import train_mpgnn as j_train
from mpgnn_tpu.train.metrics import macro_f1 as j_macro_f1
from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph as TGraph
from mpgnn_tpu_torch.graph.io import mask_label_leak, read_labels, split_nodes
from mpgnn_tpu_torch.models.mpgnn import init_mpgnn
from mpgnn_tpu_torch.train import loops
from mpgnn_tpu_torch.train.metrics import macro_f1
from mpgnn_tpu_torch.weights import params_from_jax


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


SPLIT_FIELDS = ("node_idx", "train_idx", "train_y", "val_idx", "val_y",
                "test_idx", "test_y")
LOSS_ATOL = 1e-5
F1_ATOL = 1e-6
PARAM_ATOL = 1e-3


# -------------------------------------------------------------- split_nodes
def _labels(case):
    rng = np.random.default_rng(11)
    if case == "synthetic_multiclass":
        return read_labels("data/synthetic_multiclass/label.dat")[1]
    if case == "random2":
        return rng.integers(0, 2, 500)
    if case == "random5":
        return rng.integers(0, 5, 731)
    if case == "singletons":
        # classes 7 and 9 have one member each, class 4 two
        return rng.permutation(np.concatenate(
            [rng.integers(0, 4, 120), [7, 9, 4, 4]]))
    if case == "ties4":
        # 4 classes of 11: every share has remainder .75, ties everywhere
        return rng.permutation(np.repeat(np.arange(4), 11))
    if case == "ties5":
        return rng.permutation(np.repeat(np.arange(5), 21))
    raise ValueError(case)


@pytest.mark.parametrize("with_ids", [False, True])
@pytest.mark.parametrize("case", ["synthetic_multiclass", "random2",
                                  "random5", "singletons", "ties4", "ties5"])
def test_split_nodes_is_index_identical(case, with_ids):
    labels = _labels(case)
    ids = None
    if with_ids:
        ids = np.random.default_rng(3).permutation(4 * len(labels))[
            :len(labels)]
    want, got = j_split(labels, ids), split_nodes(labels, ids)
    for name in SPLIT_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == np.int64 and np.array_equal(a, b), name


@pytest.mark.parametrize("counts,draws", [
    ([11, 11, 11, 11], 39),        # ties4's first split: 3 of 4 tied
    ([21, 21, 21, 21, 21], 94),    # ties5's: 4 of 5 tied
    ([7, 7, 3, 3, 9], 20),         # two tie groups, the first taken whole
])
@pytest.mark.parametrize("seed", [0, 415])
def test_approximate_mode_draws_as_sklearn(counts, draws, seed):
    """The tie-breaking draws, group by group, as sklearn makes them (the
    cases above reach tied remainders)."""
    from sklearn.utils.extmath import _approximate_mode as sk_mode

    from mpgnn_tpu_torch.graph.io import _approximate_mode

    counts = np.asarray(counts)
    rng_a, rng_b = np.random.RandomState(seed), np.random.RandomState(seed)
    got = _approximate_mode(counts, draws, rng_a)
    assert np.array_equal(got, sk_mode(counts, draws, rng_b))
    assert got.sum() == draws
    assert rng_a.randint(1 << 30) == rng_b.randint(1 << 30)   # same draws


def test_split_nodes_refuses_what_sklearn_refuses():
    labels = np.repeat(np.arange(8), 3)      # 8 classes, 3 test rows
    with pytest.raises(ValueError):
        j_split(labels)
    with pytest.raises(ValueError):
        split_nodes(labels)


def test_mask_label_leak_matches_jax():
    labels = _labels("random5")
    x = np.random.default_rng(0).normal(size=(800, 3)).astype(np.float32)
    ids = np.random.default_rng(1).permutation(800)[:len(labels)]
    np.testing.assert_array_equal(
        mask_label_leak(x, split_nodes(labels, ids)),
        j_mask(x, j_split(labels, ids)))


# ------------------------------------------------------------------ metrics
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_macro_f1_matches_jax(seed):
    rng = np.random.default_rng(seed)
    preds, labels = rng.integers(0, 4, 300), rng.integers(0, 3, 300)
    want = float(j_macro_f1(jnp.asarray(preds), jnp.asarray(labels), 5))
    got = float(macro_f1(torch.from_numpy(preds), torch.from_numpy(labels),
                         5))
    assert abs(got - want) <= F1_ATOL


# ------------------------------------------------------------ training data
@pytest.fixture(scope="module")
def planted():
    g = generate_synthetic_graph(800, 4, "red-red-blue", seed=7)
    arrays = (g["node_features"].astype(np.float32), g["src"], g["dst"],
              g["rel"])
    jg = JGraph(*arrays, num_relations=4, labels=g["labels"])
    tg = TGraph(*arrays, num_relations=4, labels=g["labels"])
    return jg, tg, g


def _assert_params_close(model, jparams):
    for stack, jstack in zip(model.convs, jparams.convs):
        for conv, jconv in zip(stack, jstack):
            for name in ("weight", "root", "bias"):
                np.testing.assert_allclose(
                    getattr(conv, name).detach().numpy(),
                    np.asarray(getattr(jconv, name)), rtol=0,
                    atol=PARAM_ATOL)
    for name in ("fc1", "fc2"):
        fc, jfc = getattr(model, name), getattr(jparams, name)
        np.testing.assert_allclose(fc.weight.detach().numpy().T,
                                   np.asarray(jfc.w), rtol=0, atol=PARAM_ATOL)
        np.testing.assert_allclose(fc.bias.detach().numpy(),
                                   np.asarray(jfc.b), rtol=0, atol=PARAM_ATOL)


VARIANTS = {
    "plain": {},
    "class_weighted": dict(class_weighted=True),
    # a path that cannot explain the labels, so the best epoch is not the
    # first
    "track_best": dict(track_best=True, metapaths=[[2, 2]]),
    "x_override": dict(x_override=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("backend", ["segment", "csr", "pallas"])
def test_fit_matches_jax_train(planted, backend, variant):
    jg, tg, g = planted
    opts = dict(VARIANTS[variant])
    metapaths = opts.pop("metapaths", [list(g["metapath_relations"]),
                                       [2, 3]])
    x = tg.x
    if opts.pop("x_override", False):
        x = (2.0 * x + np.random.default_rng(5).normal(
            size=x.shape)).astype(np.float32)
    seed, epochs, hidden = 3, 30, 16
    want = j_train(jg, metapaths, j_split(g["labels"]), 2,
                   JConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0),
                   seed=seed, backend=backend, x_override=x, **opts)

    # the JAX trainer's initial parameters, carried over
    init_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    model = params_from_jax(
        j_init(init_key, x.shape[1], hidden, 2, metapaths), device="cpu")
    split = split_nodes(g["labels"])
    cw = loops.class_weights(split.train_y, 2,
                             opts.get("class_weighted", False))
    cfg = MPGNNConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0)
    train_f1, val_f1, test_f1, loss = loops.fit_mpgnn(
        model, loops.build_hop_arrays(tg, metapaths, backend, device="cpu"),
        torch.from_numpy(x), loops.split_tensors(split, "cpu"),
        torch.from_numpy(cw), cfg, None, 2,
        track_best=opts.get("track_best", False))
    assert abs(loss - want.final_loss) <= LOSS_ATOL
    np.testing.assert_allclose((train_f1, val_f1, test_f1),
                               (want.train_f1, want.val_f1, want.test_f1),
                               rtol=0, atol=F1_ATOL)
    _assert_params_close(model, want.params)


def test_evaluate_matches_jax(planted):
    jg, tg, g = planted
    metapaths = [list(g["metapath_relations"])]
    params = j_init(jax.random.PRNGKey(4), tg.feat_dim, 16, 2, metapaths)
    split = split_nodes(g["labels"])
    want_f1, want_preds = j_evaluate(jg, metapaths, params, split.test_idx,
                                     split.test_y, 2)
    got_f1, got_preds = loops.evaluate_mpgnn(
        tg, metapaths, params_from_jax(params, device="cpu"),
        split.test_idx, split.test_y, 2, device="cpu")
    np.testing.assert_array_equal(got_preds, want_preds)
    assert abs(got_f1 - want_f1) <= F1_ATOL


# ------------------------------------------------------------------- dropout
def test_dropout_keep_rate_and_scale_from_the_generator(planted):
    """On a one-hop path the embedding fc1 sees is the hop's output: in
    training each entry is kept with probability 1 - p and scaled by
    1 / (1 - p), and the masks come from the generator alone."""
    _, tg, g = planted
    one = [[int(g["metapath_relations"][0])]]
    model = init_mpgnn(tg.feat_dim, 64, 2, one, device="cpu")
    hop_ops = loops.build_hop_arrays(tg, one, device="cpu")
    x = torch.from_numpy(tg.x)
    seen = []
    model.fc1.register_forward_pre_hook(lambda m, args: seen.append(args[0]))

    def run(train, seed, p=0.6):
        with torch.no_grad():
            return model(x, hop_ops, dropout_rate=p, train=train,
                         generator=torch.Generator().manual_seed(seed))

    clean = run(False, 0)
    a, b, c = run(True, 1), run(True, 1), run(True, 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(clean, a)
    ref, drop = seen[0], seen[1]
    live = ref != 0
    kept = drop != 0
    assert not (kept & ~live).any()
    assert kept[live].float().mean().item() == pytest.approx(0.4, abs=0.01)
    torch.testing.assert_close(drop[kept], ref[kept] / 0.4)
    assert torch.equal(run(True, 1, p=0.0), clean)


# -------------------------------------------------------------- entry point
def test_train_mpgnn_runs_on_the_cpu(planted):
    _, tg, g = planted
    split = split_nodes(g["labels"])
    cfg = MPGNNConfig(epochs=40, hidden_dim=16)
    runs = [loops.train_mpgnn(tg, [list(g["metapath_relations"])], split, 2,
                              cfg, seed=5, backend=backend, device="cpu")
            for backend in ("segment", "csr", "segment")]
    assert runs[0].final_loss == runs[2].final_loss     # seeded
    # csr draws the same masks as segment: the same run up to float32 order
    assert abs(runs[0].final_loss - runs[1].final_loss) <= LOSS_ATOL
    assert runs[0].val_f1 > 0.8 and np.isfinite(runs[0].final_loss)
    assert isinstance(runs[0].params, torch.nn.Module)


@pytest.mark.parametrize("change,err", [
    (dict(backend="halo"), "requires a mesh"),
    (dict(cfg=MPGNNConfig(halo_exchange="ring")), "halo_exchange"),
    (dict(cfg=MPGNNConfig(halo_local="dense")), "halo_local"),
])
def test_train_mpgnn_refuses_what_is_not_ported(planted, change, err):
    """The halo settings are ported (tests/test_torch_parallel.py); what
    the port refuses is 'halo' without a mesh, as the JAX package does, and
    halo settings it does not know."""
    _, tg, g = planted
    with pytest.raises(ValueError, match=err):
        loops.train_mpgnn(tg, [[0]], split_nodes(g["labels"]), 2,
                          device="cpu", **change)
