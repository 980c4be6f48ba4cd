"""The CUDA kernels K1 (csrc/csr_scatter.cu), K2 (csrc/csr_dedup.cu), K3
and K4 (both csrc/dense_matmul.cu) against their plain PyTorch versions on
the GPU, at the edge cases of their layouts, and the gradients that run
them. Marked ``cuda``: they skip where no GPU is found.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance rtol = atol = 1e-5: the kernels sum float32 (K1 and K2
compensated, in shares or pieces of at most 64 items and ordered passes
over their parts) and the plain versions float64, in other orders;
K3 and K4 sum the same bf16-rounded operands as their plain versions.
Gradients through K3 and K4 are held at 1e-4: their small GEMMs are
float32 on the card and on the CPU, in other orders."""

import numpy as np
import pytest
import torch

from mpgnn_tpu_torch.ops import csr

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _graph(n, e, skew, seed=0):
    rng = np.random.default_rng(seed)
    if skew:
        return ((n * rng.random(e) ** 3).astype(np.int64),
                (n * rng.random(e) ** 4).astype(np.int64))
    return rng.integers(0, n, e), rng.integers(0, n, e)


@pytest.mark.parametrize("n,e,f,bm,skew", [
    (100, 400, 8, 32, False),
    (257, 1000, 16, 64, False),      # n not a multiple of bm
    (64, 0, 4, 32, False),           # edgeless relation: all rows zero
    (2000, 9000, 7, 512, False),     # odd width: K1's scalar path
    (3000, 40000, 64, 1024, True),   # hub rows cut into pieces
    (5000, 60000, 100, 1024, True),  # F = 100: lanes loop over columns
])
@pytest.mark.parametrize("dedup", ["never", "always"])
def test_kernels_match_plain(dev, n, e, f, bm, skew, dedup):
    src, dst = _graph(n, e, skew)
    x = torch.randn(n, f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    for blk in csr.build_csr_blocking(src, dst, n, bm=bm, dedup=dedup):
        blk = blk.to(dev)
        is_dedup = isinstance(blk, csr.DedupCsrBlocking)
        kernel = csr.csr_dedup if is_dedup else csr.csr_scatter
        plain = csr.csr_dedup_plain if is_dedup else csr.csr_scatter_plain
        before = (csr.SCATTER_LAUNCHES, csr.DEDUP_LAUNCHES)
        got = kernel(blk, x)
        torch.cuda.synchronize()
        after = (csr.SCATTER_LAUNCHES, csr.DEDUP_LAUNCHES)
        assert after[is_dedup] == before[is_dedup] + 1
        torch.testing.assert_close(got, plain(blk, x), **TOL)


def _hub_graph(case):
    """One row of 60k edges (three passes of K2), rows spread over many
    pieces, or an edgeless relation."""
    if case == "hub_row":
        n = 3000
        src, dst = _graph(n, 70000, True, seed=2)
        src[:60000] = 11
    elif case == "many_pieces":
        n = 5000
        src, dst = _graph(n, 60000, True, seed=3)
    else:
        n = 300
        src = dst = np.zeros(0, dtype=np.int64)
    return n, src, dst


@pytest.mark.parametrize("f", [1, 4, 7, 64, 100])
@pytest.mark.parametrize("case", ["hub_row", "many_pieces", "edgeless"])
def test_dedup_kernel_cuts_hub_rows(dev, case, f):
    """K2 in both directions against its plain version, and a second launch
    on the same input bitwise-equal to the first (no atomics)."""
    n, src, dst = _hub_graph(case)
    if case == "edgeless":      # build_csr_blocking routes it to K1
        inv = np.ones(n, dtype=np.float32)
        blks = [csr._build_one_direction_dedup(src, dst, inv, n, n, pre)
                for pre in (False, True)]
    else:
        blks = csr.build_csr_blocking(src, dst, n, dedup="always")
    x = torch.randn(n, f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(f))
    for blk in blks:
        assert isinstance(blk, csr.DedupCsrBlocking)
        blk = blk.to(dev)
        before = csr.DEDUP_LAUNCHES
        got = csr.csr_dedup(blk, x)
        again = csr.csr_dedup(blk, x)
        torch.cuda.synchronize()
        assert csr.DEDUP_LAUNCHES == before + 2
        torch.testing.assert_close(got, csr.csr_dedup_plain(blk, x), **TOL)
        assert torch.equal(got, again)
        if case == "hub_row" and not blk.scale_is_pre:
            assert len(blk.level_pieces) - 1 == 3
        if case == "edgeless":
            assert not got.any()


def _k1_graph(case, share):
    """One row of 60k edges (about 940 shares of 64 items), rows of
    share - 1 edges that with their ends fill exactly one share each, or an
    edgeless relation."""
    if case == "hub_row":
        n = 3000
        src, dst = _graph(n, 70000, True, seed=2)
        src[:60000] = 11
    elif case == "one_share_rows":
        n = 2000
        src = np.repeat(np.arange(1000), share - 1)
        dst = np.random.default_rng(4).integers(0, n, len(src))
    else:
        n = 300
        src = dst = np.zeros(0, dtype=np.int64)
    return n, src, dst


@pytest.mark.parametrize("f", [1, 4, 7, 64, 100])
@pytest.mark.parametrize("case", ["hub_row", "one_share_rows", "edgeless"])
def test_scatter_kernel_balances_long_rows(dev, case, f):
    """K1 in both directions against its plain version, and a second launch
    on the same input bitwise-equal to the first (no atomics, the carries
    added in share order)."""
    _, share = csr.k1_layout(f, 4 if f % 4 == 0 else 1)
    n, src, dst = _k1_graph(case, share)
    x = torch.randn(n, f, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(f))
    for blk in csr.build_csr_blocking(src, dst, n, dedup="never"):
        assert isinstance(blk, csr.CsrBlocking)
        blk = blk.to(dev)
        before = csr.SCATTER_LAUNCHES
        got = csr.csr_scatter(blk, x)
        again = csr.csr_scatter(blk, x)
        torch.cuda.synchronize()
        assert csr.SCATTER_LAUNCHES == before + 2
        torch.testing.assert_close(got, csr.csr_scatter_plain(blk, x), **TOL)
        assert torch.equal(got, again)
        if case == "edgeless":
            assert not got.any()


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    src, dst = _graph(100, 400, False)
    fwd, _ = csr.build_csr_blocking(src, dst, 100)
    x = torch.randn(100, 8, device=dev)
    with pytest.raises(ValueError, match="blocking"):
        csr.csr_scatter(fwd, x)                      # blocking on the CPU
    fwd = fwd.to(dev)
    with pytest.raises(TypeError):
        csr.csr_scatter(fwd, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        csr.csr_scatter(fwd, x.t().contiguous().t())


# ------------------------------------------------------------- K3 and K4
def _conv_inputs(n, e, f, hdim, dev, seed=0):
    """A random relation whose node 0 has no out-edge (an empty row of A),
    its operand on ``dev`` and numpy-seeded h, w, root, b; w and root are
    scaled by 1/sqrt(f) as glorot's are, so that the epilogue's float32
    sums of 2f terms stay inside the tolerance at any f."""
    from mpgnn_tpu_torch.ops import conv

    rng = np.random.default_rng(seed)
    src, dst = rng.integers(1, n, e), rng.integers(0, n, e)
    op = conv.build_dense_conv_operand(src, dst, n, dev)
    scale = (1.0, f ** -0.5, f ** -0.5, 1.0)
    t = [torch.from_numpy((c * rng.normal(size=s)).astype(np.float32)).to(dev)
         for c, s in zip(scale, ((n, f), (f, hdim), (f, hdim), (hdim,)))]
    return op, t


@pytest.mark.parametrize("n,e,f,hdim", [
    (100, 400, 8, 16),
    (257, 1500, 2, 64),       # n not a multiple of 8 (padded row stride)
    (1000, 4000, 1, 64),      # F = 1
    (1000, 4000, 64, 64),
    (5000, 5000, 2, 64),      # the shipped dataset's shapes, hop 0
    (5000, 5000, 64, 64),     # and hop 1
    (600, 3000, 200, 16),     # the widest tile (F padded to 256)
])
def test_dense_kernels_match_plain(dev, n, e, f, hdim):
    from mpgnn_tpu_torch.ops import conv

    op, (h, w, root, b) = _conv_inputs(n, e, f, hdim, dev)
    assert not op.a[0].any()
    before = (conv.CONV_LAUNCHES, conv.MATMUL_LAUNCHES)
    out, agg = conv.dense_conv_fwd(op.a, h, w, root, b)
    dh = conv.dense_matmul(op.a_t, h)
    torch.cuda.synchronize()
    assert (conv.CONV_LAUNCHES, conv.MATMUL_LAUNCHES) == (before[0] + 1,
                                                          before[1] + 1)
    want_out, want_agg = conv.dense_conv_plain(op.a, h, w, root, b)
    torch.testing.assert_close(agg, want_agg, **TOL)
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(dh, conv.dense_matmul_plain(op.a_t, h), **TOL)
    assert not agg[0].any()


@pytest.mark.parametrize("f", [1, 2, 64, 200])
@pytest.mark.parametrize("n", [257, 1000, 5000])
def test_matmul_kernel_splits_the_reduction(dev, n, f):
    """K4 against its plain version at N not a multiple of 8 (a_t's padded
    row stride) and reduction lengths that its splits do not divide, and a
    second launch bitwise-equal to the first."""
    from mpgnn_tpu_torch.ops import conv

    op, (h, _, _, _) = _conv_inputs(n, 4 * n, f, 8, dev, seed=n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = conv.matmul_splits(n, sms)
    assert splits > 1 and (n % splits or n % 64)
    before = conv.MATMUL_LAUNCHES
    got = conv.dense_matmul(op.a_t, h)
    again = conv.dense_matmul(op.a_t, h)
    torch.cuda.synchronize()
    assert conv.MATMUL_LAUNCHES == before + 2
    torch.testing.assert_close(got, conv.dense_matmul_plain(op.a_t, h), **TOL)
    assert torch.equal(got, again)
    if n % 8:
        with pytest.raises(ValueError, match="aligned"):
            conv.dense_matmul(op.a_t.contiguous(), h)


@pytest.mark.parametrize("f", [1, 2, 64, 200])
@pytest.mark.parametrize("n", [257, 1000, 5000])
def test_conv_kernel_splits_the_reduction(dev, n, f):
    """K3 (out and agg) against its plain version on the main loop's split
    reduction, where the splits do not divide it, and a second launch
    bitwise-equal to the first; an operand without the padded row stride is
    refused."""
    from mpgnn_tpu_torch.ops import conv

    op, (h, w, root, b) = _conv_inputs(n, 4 * n, f, 64, dev, seed=n + f)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = conv.matmul_splits(n, sms)
    assert splits > 1 and (n % splits or n % 64)
    before = conv.CONV_LAUNCHES
    out, agg = conv.dense_conv_fwd(op.a, h, w, root, b)
    again_out, again_agg = conv.dense_conv_fwd(op.a, h, w, root, b)
    torch.cuda.synchronize()
    assert conv.CONV_LAUNCHES == before + 2
    want_out, want_agg = conv.dense_conv_plain(op.a, h, w, root, b)
    torch.testing.assert_close(agg, want_agg, **TOL)
    torch.testing.assert_close(out, want_out, **TOL)
    assert torch.equal(out, again_out) and torch.equal(agg, again_agg)
    if n % 8:
        with pytest.raises(ValueError, match="aligned"):
            conv.dense_conv_fwd(op.a.contiguous(), h, w, root, b)


@pytest.mark.parametrize("h_grad", [False, True])
def test_dense_conv_backward_launches_k4_only_for_dh(dev, h_grad):
    """Hop 0's input needs no gradient: K4 does not run there. The
    gradients equal the CPU path's (plain versions) on the same inputs."""
    from mpgnn_tpu_torch.ops import conv

    op, ts = _conv_inputs(300, 1200, 16, 64, dev, seed=1)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=(300, 64)).astype(np.float32)).to(dev)
    grads = {}
    for where in ("cuda", "cpu"):
        o = op if where == "cuda" else conv.DenseConvOperand(
            op.a.cpu(), op.a_t.cpu(), op.num_rows)
        leaves = [t.detach().to(where, copy=True).requires_grad_(
            i > 0 or h_grad) for i, t in enumerate(ts)]
        before = conv.MATMUL_LAUNCHES
        (conv.dense_conv(o, *leaves) * g.to(where)).sum().backward()
        if where == "cuda":
            torch.cuda.synchronize()
            assert conv.MATMUL_LAUNCHES == before + h_grad
        grads[where] = [None if t.grad is None else t.grad.cpu()
                        for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_dense_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from mpgnn_tpu_torch.ops import conv

    op, (h, w, root, b) = _conv_inputs(64, 200, 4, 8, dev)
    with pytest.raises(TypeError):
        conv.dense_conv_fwd(op.a.float(), h, w, root, b)
    with pytest.raises(ValueError, match="contiguous"):
        conv.dense_matmul(op.a_t, torch.randn(4, 64, device=dev).t())
    with pytest.raises(ValueError, match="tensors on"):
        conv.dense_conv_fwd(op.a, h.cpu(), w, root, b)
    with pytest.raises(ValueError):
        conv.dense_matmul(op.a_t, torch.randn(64, 300, device=dev))


# ------------------------------------------------------- csr backward
@pytest.mark.parametrize("dedup", ["never", "always"])
def test_csr_backward_runs_the_kernels(dev, dedup):
    """The gradient of csr_mean_aggregate runs K1 or K2 on the backward
    blocking and equals the CPU path's (plain versions)."""
    src, dst = _graph(3000, 40000, True, seed=3)
    fwd, bwd = csr.build_csr_blocking(src, dst, 3000, dedup=dedup)
    x = torch.randn(3000, 64, generator=torch.Generator().manual_seed(0))
    g = torch.randn(3000, 64, generator=torch.Generator().manual_seed(1))
    grads = []
    for where, f, b in (("cuda", fwd.to(dev), bwd.to(dev)), ("cpu", fwd, bwd)):
        xl = x.to(where).requires_grad_(True)
        before = (csr.CSR_BACKWARD_LAUNCHES, csr.SCATTER_LAUNCHES,
                  csr.DEDUP_LAUNCHES)
        (csr.csr_mean_aggregate(xl, f, b) * g.to(where)).sum().backward()
        if where == "cuda":
            torch.cuda.synchronize()
            k = 2 if dedup == "always" else 1
            after = (csr.CSR_BACKWARD_LAUNCHES, csr.SCATTER_LAUNCHES,
                     csr.DEDUP_LAUNCHES)
            assert after[0] == before[0] + 1
            assert after[k] == before[k] + 2          # forward and backward
        grads.append(xl.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], **TOL)
