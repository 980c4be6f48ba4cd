"""Mixed precision (``compute_dtype='bfloat16'``) on the CPU against the
JAX package: each backend's bf16 hop (aggregation and its gradient; csr
through K1/K2's plain versions, the fused hop through K3's), the MPNetm
forward, whole ``train_mpgnn`` runs, the dropout scale, the bf16 dense
operand, the batched evaluation (which trains float32 in both packages)
and the CLI.

Tolerances, with their reasons (bf16 keeps 8 significant bits: one unit in
the last place, ulp, is 2^-8 to 2^-7 of a value):
* hops, forward and gradient: csr, ell and dense sum in float32 (float64 in
  the kernels' plain versions) and round once, rtol 2^-7 (one ulp) with
  atol 2^-9, a quarter ulp of a unit-sized term, for sums that cancel to
  small values (the JAX package's interpreted csr kernel rounds a few such
  sums less exactly than float32 would). segment sums in bf16 in both
  packages, rounding after every add, in other orders: rtol 2^-6, atol
  2^-7. The fused hop's output is float32 on both sides over the same
  bf16 operands: rtol = atol = 1e-5.
* the forward at the JAX package's initial parameters: float32
  log-probabilities within 2e-2 (every product of the model rounds to bf16
  in both packages, at other places: XLA fuses the adds that PyTorch
  rounds one by one) and the argmax agreeing on at least 99% of the nodes,
  the JAX package's own bound for bf16 against float32
  (``tests/test_train.py:484-520``).
* ``train_mpgnn`` (20 epochs, dropout 0, carried initial parameters): final
  loss atol 1e-3 and macro-F1s atol 1e-6 (the same predictions);
  parameters atol 5e-2: Adam moves a parameter by up to lr = 0.01 a step,
  and where bf16 rounding decides the sign of a gradient element the two
  runs part by that much (measured up to 4.3e-2 after 30 steps).
* 'ell2' and 'onehot' (no JAX reference: the JAX package's bf16 'ell2'
  raises and its 'onehot' training raises on every config, ROADMAP.md
  section C): against the port's and the JAX package's bf16 'segment' runs
  at the same bounds.
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
from mpgnn_tpu.models.mpgnn import hop_aggregate as j_hop
from mpgnn_tpu.models.mpgnn import init_mpgnn as j_init
from mpgnn_tpu.models.mpgnn import mpgnn_forward as j_forward
from mpgnn_tpu.ops.pallas_conv import pallas_dense_conv as j_conv
from mpgnn_tpu.train import batch_eval as j_batch
from mpgnn_tpu.train.loops import build_hop_arrays as j_build
from mpgnn_tpu.train.loops import train_mpgnn as j_train
from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.models import mpgnn
from mpgnn_tpu_torch.models.mpgnn import dropout_scale, hop_aggregate
from mpgnn_tpu_torch.ops import conv as tconv
from mpgnn_tpu_torch.train import batch_eval, loops
from mpgnn_tpu_torch.weights import params_from_jax

BF16 = torch.bfloat16
HOP_TOL = {"segment": dict(rtol=2 ** -6, atol=2 ** -7)}
HOP_TOL_SUM_ONCE = dict(rtol=2 ** -7, atol=2 ** -9)
LOGP_ATOL = 2e-2
LOSS_ATOL = 1e-3
F1_ATOL = 1e-6
PARAM_ATOL = 5e-2


@pytest.fixture(scope="module")
def hop_graph():
    """One relation of 400 nodes, 3,000 edges, rows without edges."""
    rng = np.random.default_rng(0)
    n = 400
    src, dst = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
    src[src % 37 == 5] = 6
    rel = np.zeros(len(src), np.int64)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    h = rng.normal(size=(n, 8)).astype(np.float32)
    g = rng.normal(size=(n, 8)).astype(np.float32)
    return (JGraph(x, src, dst, rel, num_relations=1),
            HeteroGraph(x, src, dst, rel, num_relations=1), h, g)


@pytest.fixture(scope="module")
def planted():
    g = generate_synthetic_graph(800, 4, "red-red-blue", seed=7)
    arrays = (g["node_features"].astype(np.float32), g["src"], g["dst"],
              g["rel"])
    return (JGraph(*arrays, num_relations=4),
            HeteroGraph(*arrays, num_relations=4), g)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, dtype=np.float32)


# ----------------------------------------------------------------- the hops
def _port_hop(tg, kind, h, g, dedup=None):
    """(out, dh) of the port's bf16 hop."""
    op = loops.build_hop_arrays(tg, [[0]], kind, device="cpu",
                                dtype=BF16)[0][0]
    if dedup is not None:
        from mpgnn_tpu_torch.ops.csr import build_csr_blocking

        s, d = tg.rel_edges(0)
        op = ("csr",) + build_csr_blocking(s, d, tg.num_nodes, dedup=dedup)
    th = torch.from_numpy(h).to(BF16).requires_grad_()
    out = hop_aggregate(th, op, tg.num_nodes)
    out.backward(torch.from_numpy(g).to(BF16))
    return out, th.grad


def _jax_hop(jg, kind, h, g):
    """(out, dh) of the JAX package's bf16 hop."""
    op = j_build(jg, [[0]], backend=kind)[0][0]
    out, vjp = jax.vjp(lambda a: j_hop(a, op, jg.num_nodes),
                       jnp.asarray(h, jnp.bfloat16))
    (dh,) = vjp(jnp.asarray(g, jnp.bfloat16))
    return out, dh


@pytest.mark.parametrize("kind,dedup", [
    ("segment", None), ("csr", "never"), ("csr", "always"), ("ell", None),
    ("dense", None)])
def test_bf16_hop_matches_jax(hop_graph, kind, dedup):
    """Forward and input gradient of one bf16 hop; csr through K1's
    (``dedup='never'``) and K2's (``'always'``) plain versions."""
    jg, tg, h, g = hop_graph
    out, dh = _port_hop(tg, kind, h, g, dedup)
    want_out, want_dh = _jax_hop(jg, kind, h, g)
    assert out.dtype == BF16 and dh.dtype == BF16
    assert want_out.dtype == jnp.bfloat16
    tol = HOP_TOL.get(kind, HOP_TOL_SUM_ONCE)
    np.testing.assert_allclose(_f32(out), _f32(want_out), **tol)
    np.testing.assert_allclose(_f32(dh), _f32(want_dh), **tol)


@pytest.mark.parametrize("kind", ["ell2", "onehot"])
def test_bf16_hop_without_jax_reference_sums_once(hop_graph, kind):
    """'ell2' and 'onehot' in bf16 give bf16(float32 sum), the JAX
    package's bf16 csr hop (which casts around its float32 kernel)."""
    jg, tg, h, g = hop_graph
    out, dh = _port_hop(tg, kind, h, g)
    want_out, want_dh = _jax_hop(jg, "csr", h, g)
    assert out.dtype == BF16 and dh.dtype == BF16
    np.testing.assert_allclose(_f32(out), _f32(want_out), **HOP_TOL_SUM_ONCE)
    tol = HOP_TOL_SUM_ONCE if kind == "ell2" else dict(rtol=2 ** -6,
                                                       atol=2 ** -7)
    # onehot's incidence carries 1/deg in bf16 (as segment's inv_count
    # does): one more rounding of each weight
    np.testing.assert_allclose(_f32(dh), _f32(want_dh), **tol)


def test_fused_hop_with_bf16_h_matches_jax(hop_graph):
    """K3 (plain version) with a bf16 h against the JAX package's Pallas
    kernel in interpret mode: float32 out; gradients of W, root and b."""
    jg, tg, h, g = hop_graph
    rng = np.random.default_rng(1)
    w, root = (rng.normal(size=(8, 16)).astype(np.float32) / 3
               for _ in range(2))
    b = rng.normal(size=16).astype(np.float32) / 10
    gz = rng.normal(size=(tg.num_nodes, 16)).astype(np.float32)
    jop = j_build(jg, [[0]], backend="pallas")[0][0]

    def jf(w_, r_, b_):
        return j_conv(jop[1], True, jnp.asarray(h, jnp.bfloat16), w_, r_, b_)

    want, vjp = jax.vjp(jf, jnp.asarray(w), jnp.asarray(root),
                        jnp.asarray(b))
    want_grads = vjp(jnp.asarray(gz))
    top = loops.build_hop_arrays(tg, [[0]], "pallas", device="cpu")[0][0]
    params = [torch.from_numpy(a).requires_grad_() for a in (w, root, b)]
    out = tconv.dense_conv(top[1], torch.from_numpy(h).to(BF16), *params)
    out.backward(torch.from_numpy(gz))
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=1e-5, atol=1e-5)
    for p, wg in zip(params, want_grads):
        np.testing.assert_allclose(_f32(p.grad), _f32(wg), rtol=1e-5,
                                   atol=1e-4)


# ------------------------------------------------------------ the forward
@pytest.mark.parametrize("backend", ["segment", "csr", "pallas", "dense",
                                     "ell"])
def test_bf16_forward_matches_jax(planted, backend):
    jg, tg, g = planted
    mps = [list(g["metapath_relations"]), [2, 3]]
    params = j_init(jax.random.PRNGKey(0), tg.feat_dim, 32, 2, mps)
    want = j_forward(params, jnp.asarray(tg.x),
                     j_build(jg, mps, backend=backend), train=False,
                     compute_dtype=jnp.bfloat16)
    want32 = j_forward(params, jnp.asarray(tg.x),
                       j_build(jg, mps, backend=backend), train=False)
    model = params_from_jax(params, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(tg.x),
                    loops.build_hop_arrays(tg, mps, backend, device="cpu",
                                           dtype=BF16),
                    compute_dtype=BF16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=LOGP_ATOL)
    preds = got.argmax(dim=1).numpy()
    assert np.mean(preds == np.argmax(np.asarray(want), 1)) >= 0.99
    assert np.mean(preds == np.argmax(np.asarray(want32), 1)) >= 0.99
    # the parameters stay float32
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ------------------------------------------------------------ train_mpgnn
_RUNS = {}


def _jax_run(jg, g, mps, backend, epochs=20, hidden=16, seed=3):
    """The JAX package's bf16 ``train_mpgnn`` (each run once a module)."""
    key = ("jax", backend, epochs, str(mps))
    if key not in _RUNS:
        _RUNS[key] = j_train(jg, mps, j_split(g["labels"]), 2,
                             JConfig(epochs=epochs, hidden_dim=hidden,
                                     dropout=0.0, compute_dtype="bfloat16"),
                             seed=seed, backend=backend)
    return _RUNS[key]


def _port_fit(tg, g, mps, backend, epochs=20, hidden=16, seed=3):
    """The port's ``fit_mpgnn`` in bf16 from the JAX trainer's initial
    parameters (each run once a module)."""
    key = ("port", backend, epochs, str(mps))
    if key not in _RUNS:
        _RUNS[key] = _port_fit_run(tg, g, mps, backend, epochs, hidden, seed)
    return _RUNS[key]


def _port_fit_run(tg, g, mps, backend, epochs, hidden, seed):
    init_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    model = params_from_jax(j_init(init_key, tg.feat_dim, hidden, 2, mps),
                            device="cpu")
    cfg = MPGNNConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0,
                      compute_dtype="bfloat16")
    split = split_nodes(g["labels"])
    res = loops.fit_mpgnn(
        model, loops.build_hop_arrays(tg, mps, backend, device="cpu",
                                      dtype=BF16),
        torch.from_numpy(tg.x), loops.split_tensors(split, "cpu"),
        torch.ones(2), cfg, None, 2)
    return model, res


def _assert_run_close(model, res, want):
    train_f1, val_f1, test_f1, loss = res
    assert abs(loss - want.final_loss) <= LOSS_ATOL
    np.testing.assert_allclose((train_f1, val_f1, test_f1),
                               (want.train_f1, want.val_f1, want.test_f1),
                               rtol=0, atol=F1_ATOL)
    for stack, jstack in zip(model.convs, want.params.convs):
        for conv, jconv in zip(stack, jstack):
            for name in jconv._fields:
                np.testing.assert_allclose(
                    _f32(getattr(conv, name)), _f32(getattr(jconv, name)),
                    rtol=0, atol=PARAM_ATOL)
    for name in ("fc1", "fc2"):
        fc, jfc = getattr(model, name), getattr(want.params, name)
        np.testing.assert_allclose(_f32(fc.weight).T, _f32(jfc.w), rtol=0,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("backend", ["segment", "csr", "pallas", "dense",
                                     "ell"])
def test_bf16_training_matches_jax(planted, backend):
    jg, tg, g = planted
    mps = [list(g["metapath_relations"]), [2, 3]]
    want = _jax_run(jg, g, mps, backend)
    model, res = _port_fit(tg, g, mps, backend)
    _assert_run_close(model, res, want)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("backend", ["ell2", "onehot"])
def test_bf16_training_without_jax_reference(planted, backend):
    """Held against the port's and the JAX package's bf16 segment runs."""
    jg, tg, g = planted
    mps = [list(g["metapath_relations"]), [2, 3]]
    model, res = _port_fit(tg, g, mps, backend)
    _assert_run_close(model, res, _jax_run(jg, g, mps, "segment"))
    seg_model, seg_res = _port_fit(tg, g, mps, "segment")
    assert abs(res[3] - seg_res[3]) <= LOSS_ATOL
    np.testing.assert_allclose(res[:3], seg_res[:3], rtol=0, atol=F1_ATOL)


def test_the_jax_package_refuses_bf16_ell2(planted):
    """The reason 'ell2' has no JAX reference (ROADMAP.md section C): its
    custom VJP returns a float32 cotangent for the bf16 primal."""
    jg, _, g = planted
    with pytest.raises(AssertionError):
        _jax_run(jg, g, [[0, 1]], "ell2", epochs=2)


def test_train_mpgnn_bf16_on_every_backend(planted):
    """The entry point takes bfloat16 on every single-model backend and
    'auto', with finite losses and float32 parameters."""
    _, tg, g = planted
    split = split_nodes(g["labels"])
    cfg = MPGNNConfig(epochs=3, hidden_dim=8, compute_dtype="bfloat16")
    for backend in loops.BACKENDS + ("auto",):
        res = loops.train_mpgnn(tg, [[0, 1]], split, 2, cfg, backend=backend,
                                device="cpu")
        assert np.isfinite(res.final_loss), backend
        assert res.params.fc1.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        loops.train_mpgnn(tg, [[0]], split, 2,
                          MPGNNConfig(compute_dtype="float16"), device="cpu")


def test_evaluate_mpgnn_takes_the_compute_dtype(planted):
    """``evaluate_mpgnn`` evaluates in float32 by default, as the JAX
    package's, and in ``cfg.compute_dtype`` when given one."""
    _, tg, g = planted
    mps = [list(g["metapath_relations"])]
    model = loops.init_mpgnn(tg.feat_dim, 16, 2, mps, device="cpu")
    split = split_nodes(g["labels"])
    ops = loops.build_hop_arrays(tg, mps, device="cpu")
    x = torch.from_numpy(tg.x)
    for cfg, dt in ((None, torch.float32),
                    (MPGNNConfig(compute_dtype="bfloat16"), BF16)):
        f1, preds = loops.evaluate_mpgnn(tg, mps, model, split.test_idx,
                                         split.test_y, 2, device="cpu",
                                         cfg=cfg)
        with torch.no_grad():
            want = model(x, ops, compute_dtype=dt).argmax(dim=1).numpy()
        np.testing.assert_array_equal(preds, want)


# ---------------------------------------------------------------- dropout
def test_dropout_scale_is_the_compute_dtypes():
    assert dropout_scale(0.6, BF16) == 0.400390625
    assert dropout_scale(0.6, torch.float32) == float(np.float32(0.4))
    assert dropout_scale(0.0, BF16) == 1.0


@pytest.mark.parametrize("backend", ["segment", "pallas"])
def test_bf16_dropout_divides_by_the_bf16_scale(planted, backend,
                                                monkeypatch):
    """A kept entry is the hop's output over 0.400390625, also when the
    hop's output is float32 (a fused hop: there 0.4 would differ by 1e-3
    of a value, far above float32's rounding), and the mask is the
    generator's float32 draw on h's shape, whatever h's dtype."""
    _, tg, g = planted
    one = [[int(g["metapath_relations"][0])]]
    model = loops.init_mpgnn(tg.feat_dim, 16, 2, one, device="cpu")
    ops = loops.build_hop_arrays(tg, one, backend, device="cpu", dtype=BF16)
    seen = []
    linear = mpgnn.linear

    def spy(fc, h, dtype):        # the embedding fc1 sees
        if fc is model.fc1:
            seen.append(h)
        return linear(fc, h, dtype)

    monkeypatch.setattr(mpgnn, "linear", spy)
    x = torch.from_numpy(tg.x)
    with torch.no_grad():
        for train in (False, True):
            model(x, ops, train=train, compute_dtype=BF16,
                  generator=torch.Generator().manual_seed(1))
    clean, drop = seen
    keep = torch.rand(clean.shape, generator=torch.Generator().manual_seed(1)
                      ) < 0.4
    live = clean != 0
    assert drop.dtype == (torch.float32 if backend == "pallas" else BF16)
    assert torch.equal(drop != 0, keep & live)
    want = clean.float()[keep & live] / 0.400390625
    tol = dict(rtol=1e-6, atol=0) if backend == "pallas" else dict(
        rtol=2 ** -7, atol=0)
    torch.testing.assert_close(drop[keep & live].float(), want, **tol)


# ------------------------------------------------------------- operands
def test_dense_keeps_one_bf16_operand_per_relation(planted):
    _, tg, _ = planted
    tg._operand_cache = {}
    a = loops.relation_operand(tg, 1, "dense", torch.device("cpu"), BF16)
    b = loops.relation_operand(tg, 1, "dense", torch.device("cpu"), BF16)
    f = loops.relation_operand(tg, 1, "dense", torch.device("cpu"))
    assert a is b and a[1].dtype == BF16 and a[2].dtype == BF16
    assert f[1].dtype == torch.float32
    assert torch.equal(a[1], f[1].to(BF16))


# --------------------------------------------------- the batched evaluation
def test_batched_evaluation_trains_float32_plain_convs(planted):
    """Both packages' batched evaluation give the same F1s with bf16 and
    bases in the config as with the defaults: neither reads them."""
    jg, tg, g = planted
    paths = [[1, 0], [2, 3]]
    split = split_nodes(g["labels"])
    base = dict(epochs=3, hidden_dim=8)
    odd = dict(base, compute_dtype="bfloat16", num_bases=2)
    got = [batch_eval.evaluate_candidates(tg, paths, split, 2,
                                          MPGNNConfig(**kw), device="cpu",
                                          backend="segment")
           for kw in (base, odd)]
    want = [j_batch.evaluate_candidates(jg, paths, j_split(g["labels"]), 2,
                                        JConfig(**kw), backend="segment")
            for kw in (base, odd)]
    assert got[0] == got[1]
    assert want[0] == want[1]


# -------------------------------------------------------------------- CLI
def test_cli_runs_bf16(tmp_path):
    """``--compute_dtype bfloat16`` runs (the A1 refusal is gone), on a
    300-node planted graph."""
    from mpgnn_tpu_torch import run

    generate_synthetic_graph(300, 4, "red-red-blue", seed=3,
                             out_dir=str(tmp_path))
    results = run.main([
        "--platform", "cpu", "--hidden_dim", "8", "--dataset", "synthetic",
        "--folder", str(tmp_path), "--node_file", "node.dat",
        "--link_file", "link.dat", "--label_file", "label.dat",
        "--epochs", "3", "--max_hops", "1", "--backend", "segment",
        "--compute_dtype", "bfloat16"])
    assert results and all(0.0 <= r.test_f1 <= 1.0
                           for r in results.values())
