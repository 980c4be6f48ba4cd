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
FORBIDDEN = ("jax", "mpgnn_tpu", "optax", "pandas", "sklearn", "orbax")

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
need = {{"mpgnn_tpu_torch.search.scoring", "mpgnn_tpu_torch.search.bags",
        "mpgnn_tpu_torch.search.engine", "mpgnn_tpu_torch.models.scorer",
        "mpgnn_tpu_torch.run", "mpgnn_tpu_torch.ops.gather",
        "mpgnn_tpu_torch.benchmarks.bench_dma_gather",
        "mpgnn_tpu_torch.train.batch_eval", "mpgnn_tpu_torch.rgcn_baseline",
        "mpgnn_tpu_torch.benchmarks.bench_train",
        "mpgnn_tpu_torch.graph.partition", "mpgnn_tpu_torch.train.stream",
        "mpgnn_tpu_torch.benchmarks.bench_ooc", "mpgnn_tpu_torch.generate",
        "mpgnn_tpu_torch.graph.fb15k", "mpgnn_tpu_torch.graph.continents",
        "mpgnn_tpu_torch.graph.gtn", "mpgnn_tpu_torch.utils.misc",
        "mpgnn_tpu_torch.utils.prof", "mpgnn_tpu_torch.parallel.mesh",
        "mpgnn_tpu_torch.parallel.halo", "mpgnn_tpu_torch.parallel.shard",
        "mpgnn_tpu_torch.parallel.elastic", "mpgnn_tpu_torch.parallel.context",
        "mpgnn_tpu_torch.benchmarks.bench_parallel",
        "mpgnn_tpu_torch.utils.warm", "mpgnn_tpu_torch.benchmarks.bench_warm"}}
print(len(names), bad, sorted(need - set(names)))
sys.exit(1 if bad or len(names) < 20 or need - set(names) else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


# the modules whose functions ranks of ``parallel.mesh.spawn_ranks`` run:
# a spawned rank imports them (and only them) afresh, so they must not
# import JAX at import time
_RANK_BODIES = """
import sys
sys.path.insert(0, "tests")
import test_torch_parallel, test_torch_elastic
import mpgnn_tpu_torch.benchmarks.bench_parallel
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(bad)
sys.exit(1 if bad else 0)
"""


def test_rank_bodies_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _RANK_BODIES.format(forbidden=set(FORBIDDEN))],
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
    from mpgnn_tpu_torch.search import find_metapaths, score_relations_flat

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        score_relations_flat(g, [0], np.zeros(4, np.float32), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        find_metapaths(g, np.zeros(4, np.float32), None, 2)


def test_chip_smoke_refuses_without_cuda():
    _no_cuda()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_new_entry_points_refuse_without_a_device():
    """The RGCN baseline runs on the card unless asked (no quiet CPU run);
    the training bench refuses without one."""
    _no_cuda()
    from mpgnn_tpu_torch import rgcn_baseline
    from mpgnn_tpu_torch.benchmarks import bench_train
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.models.mpgnn import init_rgcn_net

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rgcn_baseline.main(["--folder", "data/synthetic_multiclass",
                            "--epochs", "1"])
    g = HeteroGraph(np.zeros((40, 2), np.float32), [0, 1], [1, 2], [0, 0])
    labels = np.array([0, 1] * 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rgcn_baseline.train_rgcn_baseline(g, labels, split_nodes(labels), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_rgcn_net(2, 4, 1, 4, 2)
    assert bench_train.main(["--epochs", "1"]) == 2


def test_out_of_core_entry_points_refuse_without_a_device():
    """The clustered trainer runs on the card unless asked for the CPU;
    the out-of-core bench refuses without one."""
    _no_cuda()
    from mpgnn_tpu_torch.benchmarks import bench_ooc
    from mpgnn_tpu_torch.graph.io import split_nodes
    from mpgnn_tpu_torch.graph.partition import PartitionedHeteroGraph
    from mpgnn_tpu_torch.train.stream import train_mpgnn_clustered

    labels = np.array([0, 1] * 20)
    pg = PartitionedHeteroGraph(np.zeros((40, 2), np.float32), [0, 1],
                                [1, 2], [0, 0], 1, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mpgnn_clustered(pg, [[0]], split_nodes(labels), 2)
    assert bench_ooc.main(["--epochs", "1"]) == 2


def test_parallel_entry_points_refuse_without_a_device():
    """The meshes, the launcher and elastic training run on the card
    unless asked for the CPU, and so does halo training on such a mesh;
    the parallel bench refuses without one."""
    _no_cuda()
    from mpgnn_tpu_torch.benchmarks import bench_parallel
    from mpgnn_tpu_torch.parallel import context, elastic, mesh

    for call in (lambda: mesh.make_mesh((1,), ("nodes",)),
                 lambda: context.mesh_from_spec("1"),
                 lambda: mesh.spawn_ranks(bench_parallel.world1_rank, 1),
                 lambda: elastic.train_elastic(None, [[0]], None, 2, 1,
                                               "unused.pt")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert bench_parallel.main(["--epochs", "1"]) == 2
