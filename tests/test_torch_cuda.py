"""The CUDA kernels K1 (csrc/csr_scatter.cu) and K2 (csrc/csr_dedup.cu)
against their plain PyTorch versions on the GPU, at the edge cases of the
blocking layout. Marked ``cuda``: they skip where no GPU is found. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance rtol = atol = 1e-5: the kernels sum compensated float32 and the
plain versions float64, in other orders."""

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
    (5000, 60000, 100, 1024, True),  # K2 in two column chunks
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
