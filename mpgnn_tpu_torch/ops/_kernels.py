"""Build and load the CUDA kernels in ``mpgnn_tpu_torch/csrc``.

Each ``*.cu`` source (with the ``*.cuh`` headers beside it) has a plain C
interface and is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library at first use, then loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds. The libraries go to
``mpgnn_tpu_torch/build/`` under a name that carries a hash of the source,
the headers and the flags, so an edited source builds anew. All missing
libraries are compiled at once, one ``nvcc`` per source in parallel.
``-Xptxas=-v`` keeps each kernel's register and shared-memory report in a
``.log`` beside its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from mpgnn_tpu_torch.utils.prof import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("csr_scatter", "csr_dedup", "dense_matmul", "dma_gather",
           "csr_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # kernel name: (source in csrc/, C function, argtypes)
    "csr_scatter": ("csr_scatter", "mpgnn_csr_scatter",
                    [_P] * 7 + [_I] * 5 + [_P]),
    "csr_scatter_bf16": ("csr_scatter", "mpgnn_csr_scatter_bf16",
                         [_P] * 8 + [_I] * 5 + [_P]),
    "csr_dedup": ("csr_dedup", "mpgnn_csr_dedup",
                  [_P] * 9 + [_I, _P, _I, _I, _I, _I, _P]),
    "csr_dedup_bf16": ("csr_dedup", "mpgnn_csr_dedup_bf16",
                       [_P] * 9 + [_I, _P, _I, _I, _I, _I, _P]),
    "dense_conv": ("dense_matmul", "mpgnn_dense_conv",
                   [_P, _I] + [_P] * 8 + [_I] * 4 + [_P]),
    "dense_conv_bf16h": ("dense_matmul", "mpgnn_dense_conv_bf16h",
                         [_P, _I] + [_P] * 8 + [_I] * 4 + [_P]),
    "dense_matmul": ("dense_matmul", "mpgnn_dense_matmul",
                     [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P]),
    "dma_gather": ("dma_gather", "mpgnn_dma_gather",
                   [_P, _P, _P, _L, _I, _I, _I, _P]),
    "attn_fwd": ("csr_attention", "mpgnn_attn_fwd",
                 [_P] * 3 + [_I] + [_P] * 2 + [_I] + [_P] * 9),
    "attn_bwd_rows": ("csr_attention", "mpgnn_attn_bwd_rows",
                      [_P] * 3 + [_I] + [_P] * 2 + [_I] + [_P] * 12),
    "attn_bwd_cols": ("csr_attention", "mpgnn_attn_bwd_cols",
                      [_P] * 3 + [_I] + [_P] * 2 + [_I] + [_P] * 10),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    the headers of ``csrc/`` it may include, and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{tag}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel, and
    return {name: library path}. Raises with the compiler's output if a
    build fails."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        ), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, todo[name])
        else:
            failed.append(name)
    if failed:
        msgs = [paths[n].with_suffix(".log").read_text() for n in failed]
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(msgs))
    return paths


def build_log(name: str) -> str:
    """The compiler's report (registers, shared memory, spills) of the
    library built from ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


def lib(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, building it at first
    use, with the argument types of every entry point it holds. A first
    load (with its build, if any) is timed as the span ``kernels.load``."""
    with _LOCK:
        if source not in _LIBS:
            with span("kernels.load"):
                _LIBS[source] = _load(source)
        return _LIBS[source]


def _load(source: str) -> ctypes.CDLL:
    path = build_all()[source]
    cdll = ctypes.CDLL(str(path))
    for src, fn_name, argtypes in _SIGNATURES.values():
        if src == source:
            fn = getattr(cdll, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    cdll.mpgnn_error_string.argtypes = [ctypes.c_int]
    cdll.mpgnn_error_string.restype = ctypes.c_char_p
    return cdll


def launch(name: str, *args) -> None:
    """Call the C entry point of kernel ``name`` and raise if it returned a
    CUDA error (a refused launch never runs, and a later synchronize would
    not report it)."""
    source, fn_name, _ = _SIGNATURES[name]
    cdll = lib(source)
    code = getattr(cdll, fn_name)(*args)
    if code != 0:
        msg = cdll.mpgnn_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
