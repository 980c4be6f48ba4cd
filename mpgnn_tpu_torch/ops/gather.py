"""Row gather by contiguous runs, on a hand-written CUDA kernel (K5).

Counterpart of the Pallas kernel of ``benchmarks/bench_dma_gather.py``
(``_dma_gather_call``): ``out[k * R + j] = x[run_starts[k] + j]`` for
``j < R`` (``rows_per_run``), one bulk copy per run on the card
(``csrc/dma_gather.cu``). It lies on no path of the package: the gather
probe ``mpgnn_tpu_torch.benchmarks.bench_dma_gather`` measures with it how
fast the card gathers rows one copy per run, the ceiling of the row gather
inside K1.

``dma_gather`` launches K5 for a CUDA tensor and runs ``dma_gather_plain``
(``index_select``) for a CPU tensor; ``DMA_GATHER_LAUNCHES`` counts the
launches. ``run_lengths`` gives the run structure of a blocking's gather
columns, the runs such a gather could copy whole.
"""

from __future__ import annotations

import numpy as np
import torch

from mpgnn_tpu_torch.ops import _kernels

# Largest run (bytes) that one slot of the kernel's shared-memory ring
# holds, and most runs a tile (their starts are staged in shared memory).
MAX_RUN_BYTES = 200 * 1024
MAX_RUNS_PER_TILE = 4096

DMA_GATHER_LAUNCHES = 0


def _check(x: torch.Tensor, run_starts: torch.Tensor,
           rows_per_run: int) -> None:
    """What a bulk copy takes: 16-byte rows and addresses."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"dma_gather takes a 2-D float32 x, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("dma_gather takes a contiguous x")
    if x.shape[1] % 4:
        raise ValueError(f"dma_gather takes rows of a multiple of 4 floats "
                         f"(16 bytes), got F = {x.shape[1]}")
    if run_starts.dtype != torch.int32 or run_starts.dim() != 2:
        raise TypeError(f"run_starts must be [T, P] int32 (T tiles of P "
                        f"runs), got {run_starts.dtype} "
                        f"{tuple(run_starts.shape)}")
    if not 1 <= run_starts.shape[1] <= MAX_RUNS_PER_TILE:
        raise ValueError(f"runs a tile must lie in [1, {MAX_RUNS_PER_TILE}], "
                         f"not {run_starts.shape[1]}")
    if rows_per_run < 1:
        raise ValueError(f"rows_per_run must be at least 1, not "
                         f"{rows_per_run}")
    if rows_per_run * x.shape[1] * 4 > MAX_RUN_BYTES:
        raise ValueError(f"a run of {rows_per_run} rows of {x.shape[1]} "
                         f"floats exceeds {MAX_RUN_BYTES} bytes")
    if run_starts.device != x.device:
        raise ValueError(f"run_starts is on {run_starts.device}, x on "
                         f"{x.device}")


def run_rows(run_starts: torch.Tensor, rows_per_run: int) -> torch.Tensor:
    """The gathered row of every output row: ``starts[:, None] + arange(R)``,
    flattened (int64)."""
    flat = run_starts.reshape(-1).long()
    return (flat[:, None] + torch.arange(rows_per_run,
                                         device=flat.device)).reshape(-1)


def dma_gather_plain(x: torch.Tensor, run_starts: torch.Tensor,
                     rows_per_run: int) -> torch.Tensor:
    """K5's function in PyTorch: ``index_select`` of every run's rows."""
    return x.index_select(0, run_rows(run_starts, rows_per_run))


def dma_gather(x: torch.Tensor, run_starts: torch.Tensor, rows_per_run: int,
               check: bool = True) -> torch.Tensor:
    """``out[k * R + j] = x[run_starts[k] + j]``: K5 on a CUDA tensor, its
    plain version on a CPU tensor. ``x`` is [n, F] float32, contiguous, F a
    multiple of 4; ``run_starts`` int32 [T, P], T tiles of P runs, one CTA
    a tile, as the JAX probe passes them. With ``check`` every start is held in
    [0, n - R] first, one device reduction read by the host; without it an
    out-of-range start is a fault of the caller."""
    _check(x, run_starts, rows_per_run)
    if x.device.type == "cpu":
        return dma_gather_plain(x, run_starts, rows_per_run)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("dma_gather takes a 16-byte aligned x")
    flat = run_starts.contiguous()
    n, f = x.shape
    if check and flat.numel() and bool(
            ((flat < 0) | (flat > n - rows_per_run)).any()):
        raise IndexError(f"a run start lies outside [0, {n - rows_per_run}]")
    out = torch.empty((flat.numel() * rows_per_run, f), dtype=x.dtype,
                      device=x.device)
    if flat.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _kernels.launch(
            "dma_gather", x.data_ptr(), flat.data_ptr(), out.data_ptr(),
            run_starts.shape[0], run_starts.shape[1], f, rows_per_run,
            torch.cuda.current_stream(x.device).cuda_stream)
    global DMA_GATHER_LAUNCHES
    DMA_GATHER_LAUNCHES += 1
    return out


def run_lengths(col) -> np.ndarray:
    """Lengths of the maximal runs of consecutive values (each one more
    than the last) in ``col``, taken in order: the rows a gather of ``col``
    could copy a run at a time (the JAX probe's ``real_blocking_runs``)."""
    col = np.asarray(col, dtype=np.int64)
    if len(col) == 0:
        return np.zeros(0, dtype=np.int64)
    brk = np.nonzero(np.diff(col) != 1)[0]
    return np.diff(np.concatenate([[-1], brk, [len(col) - 1]]))
