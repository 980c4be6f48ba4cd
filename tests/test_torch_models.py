"""The model variants on the CPU against the JAX package: the decomposed
RelConvs (``num_bases`` / ``num_blocks``: init, transform, effective
weight and its gradient, training), MPNet, the RGCN ``Net`` with
``fast_rgcn_aggregate``, the RGCN baseline and its CLI, and serving and
checkpoints of a decomposed MPNetm.

Tolerances, with their reasons:
* transforms, effective weights, their gradients and the forwards:
  rtol = atol = 1e-5, float32 products in other orders; a transform of
  bf16 inputs rtol = atol = 2^-6, its products and adds each rounded to
  bf16 (2^-8 to 2^-7 of a value) at other places in the two packages. The RGCN
  aggregation sums each relation's ``(x @ W_r)[dst]`` where the JAX package
  sums per-edge products ``x[dst] @ W_r``: the same terms, other rounding.
* training (20 epochs, dropout 0, the JAX trainer's initial parameters
  carried over): final loss atol 1e-5, macro-F1s atol 1e-6, parameters
  atol 1e-3 (``tests/test_torch_train.py``'s bounds and reasons: Adam
  divides each gradient by its running RMS, so an element that float32
  noise dominates moves its parameter by up to lr a step).
* the RGCN baseline (the same, 15 epochs): loss atol 1e-5, macro-F1s atol
  1e-6, parameters atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgnn_tpu.config import MPGNNConfig as JConfig
from mpgnn_tpu.graph.generate import generate_synthetic_graph
from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.graph.io import split_nodes as j_split
from mpgnn_tpu.models import mpgnn as jm
from mpgnn_tpu.models import relconv as jr
from mpgnn_tpu.rgcn_baseline import train_rgcn_baseline as j_baseline
from mpgnn_tpu.serve import MetapathPredictor as JPredictor
from mpgnn_tpu.train.loops import build_hop_arrays as j_build
from mpgnn_tpu.train.loops import train_mpgnn as j_train
from mpgnn_tpu_torch import rgcn_baseline
from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.models import relconv as tr
from mpgnn_tpu_torch.models.mpgnn import (
    init_mpgnn,
    init_rgcn_net,
    precompute_rgcn_input,
)
from mpgnn_tpu_torch.serve import MetapathPredictor
from mpgnn_tpu_torch.train import loops
from mpgnn_tpu_torch.utils.checkpoint import restore_params, save_params
from mpgnn_tpu_torch.weights import (
    metapath_net_params_from_jax,
    params_from_jax,
    rgcn_params_from_jax,
)

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_ATOL = 1e-5
F1_ATOL = 1e-6
PARAM_ATOL = 1e-3
DECOMPOSITIONS = [dict(num_bases=2), dict(num_blocks=2), dict(num_bases=3),
                  dict(num_blocks=4)]


@pytest.fixture(scope="module")
def planted():
    g = generate_synthetic_graph(800, 4, "red-red-blue", seed=7)
    arrays = (g["node_features"].astype(np.float32), g["src"], g["dst"],
              g["rel"])
    return (JGraph(*arrays, num_relations=4, labels=g["labels"]),
            HeteroGraph(*arrays, num_relations=4, labels=g["labels"]), g)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, dtype=np.float32)


def _j_conv(kw, key, in_dim, out_dim):
    if "num_bases" in kw:
        return jr.init_relconv_basis(key, in_dim, out_dim, kw["num_bases"])
    return jr.init_relconv_block(key, in_dim, out_dim, kw["num_blocks"])


def _port_conv(jconv):
    """The port's conv module holding the JAX conv's parameters."""
    in_dim, out_dim = np.shape(jconv.root)
    if isinstance(jconv, jr.RelConvBasisParams):
        conv = tr.RelConvBasis(in_dim, out_dim, len(jconv.comp))
    else:
        conv = tr.RelConvBlock(in_dim, out_dim, np.shape(jconv.blocks)[0])
    with torch.no_grad():
        for name in jconv._fields:
            getattr(conv, name).copy_(torch.from_numpy(
                np.array(getattr(jconv, name))))
    return conv


# ------------------------------------------------------- decomposed convs
@pytest.mark.parametrize("kw", DECOMPOSITIONS)
def test_decomposed_init_has_the_jax_shapes_and_fans(kw):
    jc = _j_conv(kw, jax.random.PRNGKey(0), 8, 16)
    gen = torch.Generator().manual_seed(0)
    tc = (tr.init_relconv_basis(8, 16, kw["num_bases"], gen)
          if "num_bases" in kw else
          tr.init_relconv_block(8, 16, kw["num_blocks"], gen))
    assert type(tc).__name__ == type(jc).__name__
    for name in jc._fields:
        a, b = _np(getattr(tc, name)), _np(getattr(jc, name))
        assert a.shape == b.shape, name
        if name != "bias":
            # glorot's bound from the last two dimensions (comp: R = 1, B)
            fans = (1 + a.shape[0]) if name == "comp" else sum(a.shape[-2:])
            bound = np.sqrt(6.0 / fans)
            assert np.abs(a).max() <= bound and np.abs(b).max() <= bound
            assert np.abs(a).max() > bound / 2, name
    assert not tc.bias.any()


def test_decomposed_init_draws_in_the_jax_key_order():
    """Bases, comp, root for basis; blocks, root for block."""
    gen = torch.Generator().manual_seed(4)
    got = tr.init_relconv_basis(8, 16, 2, gen)
    replay = torch.Generator().manual_seed(4)
    assert torch.equal(got.bases, tr.glorot((2, 8, 16), replay))
    assert torch.equal(got.comp, tr.glorot((1, 2), replay)[0])
    assert torch.equal(got.root, tr.glorot((8, 16), replay))
    gen = torch.Generator().manual_seed(4)
    got = tr.init_relconv_block(8, 16, 4, gen)
    replay = torch.Generator().manual_seed(4)
    assert torch.equal(got.blocks, tr.glorot((4, 2, 4), replay))
    assert torch.equal(got.root, tr.glorot((8, 16), replay))


def test_block_divisibility_error_in_both_packages():
    with pytest.raises(ValueError, match="num_blocks"):
        jm.init_mpgnn(jax.random.PRNGKey(0), 3, 16, 2, [[0]], num_blocks=2)
    with pytest.raises(ValueError, match="num_blocks"):
        init_mpgnn(3, 16, 2, [[0]], device="cpu", num_blocks=2)
    with pytest.raises(ValueError, match="num_blocks"):
        init_rgcn_net(3, 16, 4, 16, 2, num_blocks=2, device="cpu")


def test_bases_take_precedence_in_both_packages():
    j = jm.init_mpgnn(jax.random.PRNGKey(0), 4, 16, 2, [[0]], num_bases=2,
                      num_blocks=2)
    t = init_mpgnn(4, 16, 2, [[0]], device="cpu", num_bases=2, num_blocks=2)
    assert isinstance(j.convs[0][0], jr.RelConvBasisParams)
    assert isinstance(t.convs[0][0], tr.RelConvBasis)
    net = init_rgcn_net(4, 8, 3, 8, 2, num_bases=2, num_blocks=2,
                        device="cpu")
    assert net.conv1.kind == "basis"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", DECOMPOSITIONS)
def test_decomposed_transform_matches_jax(kw, dtype):
    """``relconv_transform`` and the effective weight, in float32 and with
    a bf16 hop input (the parameters cast to it, blocks applied in float32
    and cast back, as the JAX package does)."""
    jc = _j_conv(kw, jax.random.PRNGKey(1), 8, 16)
    conv = _port_conv(jc)
    rng = np.random.default_rng(2)
    agg, h = (rng.normal(size=(50, 8)).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jr.relconv_transform(jc, jnp.asarray(agg, jdt),
                                jnp.asarray(h, jdt))
    got = tr.relconv_transform(conv, torch.from_numpy(agg).to(dtype),
                               torch.from_numpy(h).to(dtype))
    assert got.dtype == dtype
    tol = TOL if dtype == torch.float32 else dict(rtol=2 ** -6, atol=2 ** -6)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(tr.relconv_effective_weight(conv)),
                               _np(jr.relconv_effective_weight(jc)), **TOL)


@pytest.mark.parametrize("kw", DECOMPOSITIONS)
def test_effective_weight_gradient_matches_jax(kw):
    """The comp, the bases and the blocks get gradients through the
    materialized weight (what K3 takes)."""
    jc = _j_conv(kw, jax.random.PRNGKey(3), 8, 16)
    conv = _port_conv(jc)
    ct = np.random.default_rng(4).normal(size=(8, 16)).astype(np.float32)
    _, vjp = jax.vjp(jr.relconv_effective_weight, jc)
    (want,) = vjp(jnp.asarray(ct))
    tr.relconv_effective_weight(conv).backward(torch.from_numpy(ct))
    names = ("comp", "bases") if "num_bases" in kw else ("blocks",)
    for name in names:
        np.testing.assert_allclose(_np(getattr(conv, name).grad),
                                   _np(getattr(want, name)), **TOL)


@pytest.mark.parametrize("backend", ["segment", "csr", "pallas"])
@pytest.mark.parametrize("kw", [dict(num_bases=2), dict(num_blocks=2)])
def test_decomposed_training_matches_jax(planted, kw, backend):
    jg, tg, g = planted
    mps = [list(g["metapath_relations"]), [2, 3]]
    seed, epochs, hidden = 3, 20, 16
    want = j_train(jg, mps, j_split(g["labels"]), 2,
                   JConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0,
                           **kw), seed=seed, backend=backend)
    init_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    model = params_from_jax(jm.init_mpgnn(init_key, tg.feat_dim, hidden, 2,
                                          mps, **kw), device="cpu")
    cfg = MPGNNConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0, **kw)
    split = split_nodes(g["labels"])
    train_f1, val_f1, test_f1, loss = loops.fit_mpgnn(
        model, loops.build_hop_arrays(tg, mps, backend, device="cpu"),
        torch.from_numpy(tg.x), loops.split_tensors(split, "cpu"),
        torch.ones(2), cfg, None, 2)
    assert abs(loss - want.final_loss) <= LOSS_ATOL
    np.testing.assert_allclose((train_f1, val_f1, test_f1),
                               (want.train_f1, want.val_f1, want.test_f1),
                               rtol=0, atol=F1_ATOL)
    for stack, jstack in zip(model.convs, want.params.convs):
        for conv, jconv in zip(stack, jstack):
            for name in jconv._fields:
                np.testing.assert_allclose(_np(getattr(conv, name)),
                                           _np(getattr(jconv, name)), rtol=0,
                                           atol=PARAM_ATOL)


@pytest.mark.parametrize("kw", [dict(num_bases=2), dict(num_blocks=2)])
def test_train_mpgnn_takes_the_decomposition(planted, kw):
    _, tg, g = planted
    res = loops.train_mpgnn(tg, [[1, 0]], split_nodes(g["labels"]), 2,
                            MPGNNConfig(epochs=10, hidden_dim=16, **kw),
                            seed=0, device="cpu")
    conv = res.params.convs[0][0]
    want = tr.RelConvBasis if "num_bases" in kw else tr.RelConvBlock
    assert isinstance(conv, want) and np.isfinite(res.final_loss)
    f1, _ = loops.evaluate_mpgnn(tg, [[1, 0]], res.params,
                                 split_nodes(g["labels"]).val_idx,
                                 split_nodes(g["labels"]).val_y, 2,
                                 device="cpu")
    assert abs(f1 - res.val_f1) <= F1_ATOL


# ------------------------------------------------ serving and checkpoints
@pytest.mark.parametrize("kw", [dict(num_bases=2), dict(num_blocks=2)])
def test_a_decomposed_model_serves_and_restores(planted, tmp_path, kw):
    """``MetapathPredictor`` serves a decomposed MPNetm as the JAX
    predictor serves its params tree; ``params.pt`` restores it into a
    template of the same variant."""
    jg, tg, g = planted
    mps = [[1, 0]]
    jparams = jm.init_mpgnn(jax.random.PRNGKey(5), tg.feat_dim, 16, 2, mps,
                            **kw)
    want = JPredictor(jg, mps, jparams).log_probs()
    model = params_from_jax(jparams, device="cpu")
    got = MetapathPredictor(tg, mps, model, device="cpu").log_probs()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    save_params(str(tmp_path), model)
    back = restore_params(str(tmp_path), init_mpgnn(tg.feat_dim, 16, 2, mps,
                                                    device="cpu", **kw))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              back.state_dict().items()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------- MPNet
def test_metapath_net_forward_matches_jax(planted):
    """conv1 on hop 0, conv2 shared by hops 1 and 2, raw logits."""
    jg, tg, _ = planted
    path = [1, 0, 1]
    jp = jm.init_metapath_net(jax.random.PRNGKey(6), tg.feat_dim, 16, 16, 2)
    want = jm.metapath_net_forward(jp, jnp.asarray(tg.x),
                                   j_build(jg, [path])[0])
    net = metapath_net_params_from_jax(jp, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(tg.x),
                  loops.build_hop_arrays(tg, [path], device="cpu")[0])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    fresh = jm.init_metapath_net(jax.random.PRNGKey(0), 4, 8, 8, 3)
    from mpgnn_tpu_torch.models.mpgnn import init_metapath_net

    mine = init_metapath_net(4, 8, 8, 3, device="cpu")
    for name in ("conv1", "conv2"):
        for field in ("weight", "root", "bias"):
            assert tuple(getattr(getattr(mine, name), field).shape) == \
                np.shape(getattr(getattr(fresh, name), field))
    assert tuple(mine.linear.weight.shape) == np.shape(fresh.linear.w)[::-1]


# -------------------------------------------------------------- the RGCN Net
@pytest.mark.parametrize("masked", [False, True])
def test_fast_rgcn_aggregate_matches_jax(planted, masked):
    """The typed-degree normalization (per (source, relation) counts of the
    masked edges, at least 1) and the relation-by-relation products."""
    jg, tg, _ = planted
    rng = np.random.default_rng(7)
    w = rng.normal(size=(4, tg.feat_dim, 8)).astype(np.float32)
    mask = rng.random(len(tg.sorted_src)) < 0.7 if masked else None
    want = jr.fast_rgcn_aggregate(
        jnp.asarray(tg.x), jnp.asarray(w), jnp.asarray(tg.sorted_src),
        jnp.asarray(tg.sorted_dst), jnp.asarray(tg.sorted_type),
        tg.num_nodes, None if mask is None else jnp.asarray(mask))
    got = tr.fast_rgcn_aggregate(
        torch.from_numpy(tg.x), torch.from_numpy(w), tg.sorted_src,
        tg.sorted_dst, tg.sorted_type, tg.num_nodes, mask)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("kw", [{}, dict(num_bases=2), dict(num_blocks=2)])
def test_rgcn_net_forward_matches_jax(planted, kw):
    _, tg, _ = planted
    jp = jm.init_rgcn_net(jax.random.PRNGKey(8), tg.feat_dim, 16, 4, 16, 2,
                          **kw)
    want = jm.rgcn_net_forward(jp, jnp.asarray(tg.x),
                               jnp.asarray(tg.sorted_src),
                               jnp.asarray(tg.sorted_dst),
                               jnp.asarray(tg.sorted_type), 3)
    net = rgcn_params_from_jax(jp, device="cpu")
    assert net.conv1.kind == {(): "plain", ("num_bases",): "basis",
                              ("num_blocks",): "block"}[tuple(kw)]
    np.testing.assert_allclose(
        _np(net.conv1.effective_weights()),
        _np(jm.rgcn_effective_weights(jp.conv1)), **TOL)
    x = torch.from_numpy(tg.x)
    with torch.no_grad():
        for backend in ("segment", "csr"):
            ops = rgcn_baseline.rgcn_operands(tg, backend, "cpu")
            got = net(x, ops, 3)
            np.testing.assert_allclose(_np(got), _np(want), **TOL)
            first = precompute_rgcn_input(x, ops)
            np.testing.assert_allclose(_np(net(x, ops, 3, first=first)),
                                       _np(want), **TOL)


def test_rgcn_init_shapes_match_jax():
    for kw in ({}, dict(num_bases=2), dict(num_blocks=2)):
        j = jm.init_rgcn_net(jax.random.PRNGKey(1), 4, 8, 3, 8, 2, **kw)
        t = init_rgcn_net(4, 8, 3, 8, 2, device="cpu", **kw)
        for name in ("conv1", "conv2"):
            jc, tc = getattr(j, name), getattr(t, name)
            for field in jc._fields:
                assert tuple(getattr(tc, field).shape) == \
                    np.shape(getattr(jc, field)), (kw, name, field)
        assert tuple(t.conv1.effective_weights().shape) == (3, 4, 8)
    w = init_rgcn_net(4, 8, 3, 8, 2, num_blocks=2,
                      device="cpu").conv1.effective_weights()
    assert not w[:, :2, 4:].any() and not w[:, 2:, :4].any()


# ---------------------------------------------------------- the baseline
@pytest.mark.parametrize("kw", [{}, dict(num_bases=2), dict(num_blocks=2)])
def test_rgcn_baseline_matches_jax(planted, kw):
    """``train_rgcn_baseline`` from the JAX baseline's initial parameters
    (seed 10): class-weighted NLL, Adam."""
    jg, tg, g = planted
    split = split_nodes(g["labels"])
    cfg = dict(epochs=15, hidden_dim=16, **kw)
    want = j_baseline(jg, g["labels"], j_split(g["labels"]), 2, 2,
                      JConfig(**cfg))
    jp = jm.init_rgcn_net(jax.random.PRNGKey(10), tg.feat_dim, 16, 4, 16, 2,
                          **kw)
    got = rgcn_baseline.train_rgcn_baseline(
        tg, g["labels"], split, 2, 2, MPGNNConfig(**cfg), device="cpu",
        model=rgcn_params_from_jax(jp, device="cpu"))
    assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_ATOL
    for k in ("train_f1", "val_f1", "test_f1"):
        assert abs(got[k] - want[k]) <= F1_ATOL, k
    for name in ("conv1", "conv2"):
        jc = getattr(want["params"], name)
        for field in jc._fields:
            np.testing.assert_allclose(
                _np(getattr(getattr(got["params"], name), field)),
                _np(getattr(jc, field)), rtol=0, atol=PARAM_ATOL)


def test_balanced_class_weights_match_jax():
    from mpgnn_tpu.rgcn_baseline import balanced_class_weights as j_bcw

    y = np.array([0, 0, 0, 1, 2, 2, 4])
    np.testing.assert_array_equal(rgcn_baseline.balanced_class_weights(y, 5),
                                  j_bcw(y, 5))


def test_rgcn_baseline_cli_on_the_cpu(capsys):
    res = rgcn_baseline.main([
        "--folder", "data/synthetic_multiclass", "--metapath_length", "2",
        "--hidden_dim", "8", "--epochs", "5", "--num_bases", "2",
        "--platform", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("train F1 ") and " test F1 " in line
    assert res["params"].conv1.kind == "basis"
    assert all(0.0 <= res[k] <= 1.0 for k in ("train_f1", "val_f1",
                                               "test_f1"))
    assert np.isfinite(res["final_loss"])
