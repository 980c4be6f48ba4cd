"""The port stands alone: importing every module of mpgnn_tpu_torch (and
chip_smoke.py) pulls in neither JAX nor the JAX package, nor the libraries
the machine with the GPU lacks; and its entry points do not fall back to the
CPU when no GPU is found."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "mpgnn_tpu", "pandas", "sklearn", "orbax")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import mpgnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mpgnn_tpu_torch.__path__,
                                               "mpgnn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")


def test_entry_points_without_device_raise_on_cpu_only():
    _no_cuda()
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph
    from mpgnn_tpu_torch.models.mpgnn import init_mpgnn
    from mpgnn_tpu_torch.serve import MetapathPredictor
    from mpgnn_tpu_torch.train.loops import build_hop_arrays

    g = HeteroGraph(np.zeros((4, 2), np.float32), [0, 1], [1, 2], [0, 0])
    model = init_mpgnn(2, 4, 2, [[0]], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MetapathPredictor(g, [[0]], model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_mpgnn(2, 4, 2, [[0]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_hop_arrays(g, [[0]], backend="csr")


def test_chip_smoke_refuses_without_cuda():
    _no_cuda()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
