"""K5's module (mpgnn_tpu_torch.ops.gather) and the gather probe on the CPU
against the JAX package's probe (benchmarks/bench_dma_gather.py, whose
Pallas kernel runs here in interpret mode).

A gather is a copy, so the port's plain version and the Pallas kernel are
held bitwise; ``run_lengths`` equals the JAX probe's run arithmetic."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mpgnn_tpu_torch.ops import gather

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_dma_gather",
        os.path.join(ROOT, "benchmarks", "bench_dma_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rows_per_run", [1, 4, 16])
def test_plain_gather_matches_the_pallas_kernel(jax_probe, rows_per_run):
    import jax.numpy as jnp

    n, f, tiles, per = 2048, 128, 2, 32
    rng = np.random.default_rng(rows_per_run)
    x = rng.standard_normal((n, f)).astype(np.float32)
    starts = rng.integers(0, n - rows_per_run, (tiles, per)).astype(np.int32)
    want = np.asarray(jax_probe.dma_gather(jnp.asarray(x),
                                           jnp.asarray(starts), rows_per_run))
    s = torch.from_numpy(starts)
    got = gather.dma_gather_plain(torch.from_numpy(x), s, rows_per_run)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        gather.dma_gather(torch.from_numpy(x), s, rows_per_run).numpy(), want)


def test_run_lengths_is_the_jax_probes_arithmetic():
    rng = np.random.default_rng(4)
    col = np.sort(rng.integers(0, 400, 3000))
    col[100:140] = np.arange(50, 90)          # one run of 40
    col[700:705] = np.arange(7, 12)
    # the JAX probe's real_blocking_runs (bench_dma_gather.py:213-214)
    brk = np.nonzero(np.diff(col) != 1)[0]
    want = np.diff(np.concatenate([[-1], brk, [len(col) - 1]]))
    got = gather.run_lengths(col)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == len(col) and got.max() >= 40
    assert len(gather.run_lengths([])) == 0
    np.testing.assert_array_equal(gather.run_lengths([5, 6, 7, 9, 3, 4]),
                                  [3, 1, 2])


def test_wrapper_refuses_what_a_bulk_copy_does_not_take():
    x = torch.zeros(10, 8)
    s = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        gather.dma_gather(torch.zeros(10, 6), s, 1)
    with pytest.raises(TypeError, match="int32"):
        gather.dma_gather(x, s.long(), 1)
    with pytest.raises(TypeError, match=r"\[T, P\]"):
        gather.dma_gather(x, s.reshape(-1), 1)
    with pytest.raises(ValueError, match="runs a tile"):
        gather.dma_gather(x, torch.zeros(1, 4097, dtype=torch.int32), 1)
    with pytest.raises(TypeError, match="float32"):
        gather.dma_gather(x.double(), s, 1)
    with pytest.raises(ValueError, match="contiguous"):
        gather.dma_gather(torch.zeros(8, 10).T, s, 1)
    with pytest.raises(ValueError, match="bytes"):
        gather.dma_gather(torch.zeros(300, 4096), s, 16)
    with pytest.raises(ValueError, match="at least 1"):
        gather.dma_gather(x, s, 0)


def test_the_probe_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the probe runs there")
    from mpgnn_tpu_torch.benchmarks import bench_dma_gather

    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench_dma_gather.main([])
