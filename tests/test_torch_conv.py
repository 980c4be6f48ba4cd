"""The port's fused dense RelConv (mpgnn_tpu_torch/ops/conv.py) and the
gradient of its sorted-CSR aggregation (ops/csr.py), on the CPU with the
kernels' plain versions, against the JAX package: pallas_dense_conv run in
interpret mode, as tests/test_pallas_conv.py runs it, and jax.grad of
csr_mean_aggregate.

Tolerances: the dense operand is bit-equal (the same float32 division and
round-to-nearest-even bf16 cast). dense_conv's forward is held at atol 1e-5
and its gradients at 1e-4: both sides round the same operands to bf16 and
sum in float32 (the port's plain version in float64) in other orders, and
the gradients add float32 GEMMs on top. The csr gradient is held as
tests/test_pallas_csr.py holds the JAX one: rtol = atol = 1e-5 on uniform
graphs, rtol 1e-4 on skewed ones, since the JAX kernel feeds its MXU a hi/lo
bf16 split of each float32 (about 2^-16 relative at the row's magnitude),
and the backward sums hundreds of terms into a hub column."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgnn_tpu.ops import pallas_conv as jconv
from mpgnn_tpu.ops import pallas_csr as jcsr
from mpgnn_tpu_torch.ops import conv as tconv
from mpgnn_tpu_torch.ops import csr as tcsr

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _relation(n, e, seed=0):
    """Random edges with repeats, and node 0 without out-edges."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, n, e), rng.integers(0, n, e)


@pytest.mark.parametrize("n,e", [(200, 700), (257, 3000), (64, 0)])
def test_operand_is_bit_equal_to_jax(n, e):
    src, dst = _relation(n, e)
    want = jconv.build_dense_conv_operand(src, dst, n)
    got = tconv.build_dense_conv_operand(src, dst, n, "cpu")
    for mine, theirs in ((got.a, want.a), (got.a_t, want.a_t)):
        assert mine.dtype == torch.bfloat16 and mine.shape == (n, n)
        theirs = np.asarray(theirs)[:n]
        assert np.array_equal(mine.view(torch.int16).numpy(),
                              theirs.view(np.int16))
    assert got.num_rows == want.num_rows == n


@pytest.mark.parametrize("n", [64, 257])
def test_operand_rows_are_16_byte_aligned(n):
    """The rows of a and a_t start every N rounded up to 8 elements (the
    TMA copies of K3 and K4 need 16-byte row strides), the padding zero."""
    src, dst = _relation(n, 4 * n)
    op = tconv.build_dense_conv_operand(src, dst, n, "cpu")
    assert torch.equal(op.a_t, op.a.t())
    for m in (op.a, op.a_t):
        assert m.stride() == (-(-n // 8) * 8, 1) and m.shape == (n, n)
        assert m.is_contiguous() == (n % 8 == 0)
        storage = torch.as_strided(m, (n, m.stride(0)), m.stride())
        assert not storage[:, n:].any()


def test_operand_builds_on_the_card_unless_asked(monkeypatch):
    """With no device given the operand goes to the GPU, as every entry
    point's does; without CUDA that raises instead of building on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = _relation(64, 200)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tconv.build_dense_conv_operand(src, dst, 64)
    op = tconv.build_dense_conv_operand(src, dst, 64, "cpu")
    assert op.a.device.type == op.a_t.device.type == "cpu"


@pytest.mark.parametrize("n", [257, 1000, 5000, 32768])
def test_k4_splits_give_every_sm_a_cta(n):
    """K4 splits the reduction so that its CTAs (row blocks of 128 times
    splits) give every SM one and no SM two, each split holding at least
    one 64-column tile."""
    rows, tiles = -(-n // 128), -(-n // 64)
    for sms in (114, 132):
        s = tconv.matmul_splits(n, sms)
        assert 1 <= s <= tiles
        assert s == 1 or rows * s <= sms
        assert s == tiles or rows * (s + 1) > sms
    assert tconv.matmul_splits(5000, 132) == 3
    assert tconv.matmul_splits(1000, 132) == 16
    assert tconv.matmul_splits(32768, 132) == 1


def _conv_case(f, seed, n=200, e=700, hdim=16):
    """tests/test_pallas_conv.py's shapes and scales, from numpy."""
    src, dst = _relation(n, e, seed)
    rng = np.random.default_rng(seed + 10)
    arrs = (rng.normal(size=(n, f)).astype(np.float32),
            (rng.normal(size=(f, hdim)) * 0.3).astype(np.float32),
            (rng.normal(size=(f, hdim)) * 0.3).astype(np.float32),
            (rng.normal(size=(hdim,)) * 0.1).astype(np.float32))
    g = rng.normal(size=(n, hdim)).astype(np.float32)
    return src, dst, arrs, g


@pytest.mark.parametrize("f", [2, 8])
def test_dense_conv_matches_jax_kernel(f):
    n = 200
    src, dst, arrs, g = _conv_case(f, seed=f)
    jop = jconv.build_dense_conv_operand(src, dst, n, block_rows=64)

    def loss(*args):
        return jnp.sum(jconv.pallas_dense_conv(jop, True, *args) * g)

    jargs = [jnp.asarray(a) for a in arrs]
    want = np.asarray(jconv.pallas_dense_conv(jop, True, *jargs))
    want_grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*jargs)

    op = tconv.build_dense_conv_operand(src, dst, n, "cpu")
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    launches = (tconv.CONV_LAUNCHES, tconv.MATMUL_LAUNCHES)
    out = tconv.dense_conv(op, *leaves)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=FWD_ATOL)
    (out * torch.from_numpy(g)).sum().backward()
    for leaf, wg in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wg),
                                   rtol=0, atol=GRAD_ATOL)
    # the CPU path runs the plain versions and counts no launch
    assert (tconv.CONV_LAUNCHES, tconv.MATMUL_LAUNCHES) == launches


def test_dense_conv_skips_dh_when_h_needs_no_gradient():
    src, dst, arrs, g = _conv_case(4, seed=3)
    op = tconv.build_dense_conv_operand(src, dst, 200, "cpu")
    h, *params = [torch.from_numpy(a) for a in arrs]
    for p in params:
        p.requires_grad_(True)
    (tconv.dense_conv(op, h, *params) * torch.from_numpy(g)).sum().backward()
    assert h.grad is None and all(p.grad is not None for p in params)


def test_plain_versions_round_once():
    """The plain versions equal an exact float64 product of the bf16
    operands, rounded once to float32."""
    src, dst, (h, w, root, b), _ = _conv_case(8, seed=5)
    op = tconv.build_dense_conv_operand(src, dst, 200, "cpu")
    h, w, root, b = (torch.from_numpy(a) for a in (h, w, root, b))
    exact = op.a.double() @ h.to(torch.bfloat16).double()
    out, agg = tconv.dense_conv_plain(op.a, h, w, root, b)
    assert torch.equal(agg, exact.float())
    assert torch.equal(tconv.dense_matmul_plain(op.a_t, h),
                       (op.a_t.double() @ h.to(torch.bfloat16).double())
                       .float())
    z = exact @ w.double() + h.double() @ root.double() + b.double()
    assert torch.equal(out, torch.relu(z).float())


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain version for CPU tensors only: other
    devices and mixed devices raise."""
    src, dst, arrs, _ = _conv_case(2, seed=0)
    op = tconv.build_dense_conv_operand(src, dst, 200, "cpu")
    meta = torch.empty((200, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tconv.dense_matmul(op.a_t.to("meta"), meta)
    with pytest.raises(ValueError, match="tensors on"):
        tconv.dense_matmul(op.a_t, meta)
    h, w, root, b = (torch.from_numpy(x) for x in arrs)
    with pytest.raises(ValueError, match="tensors on"):
        tconv.dense_conv_fwd(op.a, h, w.to("meta"), root, b)


# ----------------------------------------------------------- csr gradient
@pytest.mark.parametrize("dedup", ["never", "always"])
@pytest.mark.parametrize("n,e,f,bm,skew", [
    (100, 400, 8, 32, False),     # tests/test_pallas_csr.py:59's shapes
    (257, 1000, 16, 64, False),
    (300, 5000, 8, 64, True),     # skewed degrees, zero-degree rows
])
def test_csr_gradient_matches_jax(n, e, f, bm, skew, dedup):
    rng = np.random.default_rng(1)
    if skew:
        src = (n * rng.random(e) ** 3).astype(np.int64)
        dst = (n * rng.random(e) ** 4).astype(np.int64)
    else:
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, f)).astype(np.float32)
    g = rng.standard_normal((n, f)).astype(np.float32)
    jf, jb = jcsr.build_csr_blocking(src, dst, n, bm=bm, dedup=dedup)
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jcsr.csr_mean_aggregate(v, jf, jb) * g))(jnp.asarray(x)))

    fwd, bwd = tcsr.build_csr_blocking(src, dst, n, bm=bm, dedup=dedup)
    assert isinstance(bwd, tcsr.DedupCsrBlocking) == (dedup == "always")
    xt = torch.from_numpy(x).requires_grad_(True)
    before = tcsr.CSR_BACKWARD_LAUNCHES
    (tcsr.csr_mean_aggregate(xt, fwd, bwd) * torch.from_numpy(g)).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), want,
                               rtol=1e-4 if skew else 1e-5, atol=1e-5)
    assert tcsr.CSR_BACKWARD_LAUNCHES == before       # CPU: no launch
