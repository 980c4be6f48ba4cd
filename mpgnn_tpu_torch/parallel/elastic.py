"""Elastic training: layout-free checkpoints, resume on another mesh, and
recovery from a failed step by shrinking the ranks.

Counterpart of ``mpgnn_tpu/parallel/elastic.py``. The sharded step
(``parallel/shard.py``) gathers its shards to whole host tensors, which
rank 0 writes with ``torch.save`` (the JAX package writes an orbax
checkpoint); a restore cuts them again for any (data, model) mesh.

``train_elastic`` runs the steps, checkpoints every ``checkpoint_every``,
and when a step raises on every rank (a lost card; the tests' and
``chip_smoke.py``'s ``fault_hook``) all ranks take the same decision: keep
the largest power of two below their count, as the JAX package does, on
every failure down to ``min_devices``. The kept ranks rebuild the step on
the smaller mesh and restore the last checkpoint; the others return at
once, with ``left`` set. Group creation is collective over every rank of
the default group, so the meshes of every count a run can shrink to
(``shrink_counts``) are built at its start, while all ranks are there: a
recovery then creates no group, and no rank waits on one that has left.
(``new_group(..., use_local_synchronization=True)`` would let the kept
ranks create theirs alone, but it names a group by its ranks and the
count of groups the calling process holds, which differs between ranks
once a mesh over some of them was built.)
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.parallel.mesh import all_reduce_sum, make_mesh
from mpgnn_tpu_torch.parallel.shard import (
    ShardedTrainStep,
    build_sharded_train_step,
)

log = logging.getLogger("mpgnn_tpu_torch.elastic")


def _barrier(mesh) -> None:
    all_reduce_sum(torch.zeros(1, device=mesh.device), mesh.group)


def save_train_state(path: str, step: int, train_step: ShardedTrainStep
                     ) -> None:
    """Write (step, parameters, Adam state) as whole CPU tensors: every
    rank of the step's mesh calls it; rank 0 of the mesh writes."""
    params, opt = train_step.host_state()
    mesh = train_step.mesh
    if mesh.rank == 0:
        tmp = path + ".tmp"
        torch.save({"step": int(step), "params": params, "opt_state": opt},
                   tmp)
        os.replace(tmp, path)
    _barrier(mesh)


def load_train_state(path: str):
    """(step, parameters, Adam state) of a checkpoint, as host tensors."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return int(state["step"]), state["params"], state["opt_state"]


def resume_train_step(ckpt_path: str, mesh, graph, metapaths, split,
                      num_classes: int, cfg: Optional[MPGNNConfig] = None,
                      seed: int = 0) -> Tuple[ShardedTrainStep, int]:
    """The sharded step rebuilt on ``mesh`` from the checkpoint, and the
    step it resumes at."""
    start, params, opt = load_train_state(ckpt_path)
    return build_sharded_train_step(mesh, graph, metapaths, split,
                                    num_classes, cfg, seed=seed,
                                    init_params=params,
                                    init_opt_state=opt), start


@dataclasses.dataclass
class ElasticResult:
    losses: List[float]
    steps_run: int
    recoveries: int
    final_device_count: int
    params: Optional[dict]       # whole host tensors; None on a rank that
    left: bool = False           # left a shrunk mesh


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of step ``step``, alike on every rank."""
    return torch.Generator(device=device).manual_seed(
        (seed + 1) * 1_000_003 + step)


def _shrunk(n: int) -> int:
    """The rank count a run on ``n`` ranks recovers on: the largest power
    of two below n (1 stays 1), as the JAX package's."""
    return max(1, 2 ** int(np.log2(max(n - 1, 1))))


def shrink_counts(n: int, min_devices: int = 1) -> List[int]:
    """The rank counts a run on ``n`` ranks can recover on, failure by
    failure, while at least ``min_devices`` (4 -> 2 -> 1; 6 -> 4 -> 2 ->
    1)."""
    counts: List[int] = []
    while True:
        n = _shrunk(n)
        if n < min_devices or n in counts:
            return counts
        counts.append(n)


def train_elastic(
    graph,
    metapaths,
    split,
    num_classes: int,
    num_steps: int,
    ckpt_path: str,
    cfg: Optional[MPGNNConfig] = None,
    ranks: Optional[Sequence[int]] = None,
    axis_shapes: Optional[Tuple[int, int]] = None,
    checkpoint_every: int = 10,
    seed: int = 0,
    min_devices: int = 1,
    fault_hook: Optional[Callable[[int], None]] = None,
    init_params=None,
    device=None,
) -> ElasticResult:
    """Supervised elastic training over ``ranks`` (default: every rank of
    the default group), each calling it, on ``device`` (default the card;
    the CPU only with ``device='cpu'``).

    Runs ``num_steps`` sharded steps on a (data, model) mesh of
    ``axis_shapes`` (default all ranks on data), checkpointing to
    ``ckpt_path`` every ``checkpoint_every``. A step that raises (every
    rank raising it, as ``fault_hook(step)`` does in tests) shrinks the
    ranks to the largest power of two below their count and resumes from
    the last checkpoint on an (n, 1) mesh of the first n, on every failure;
    fewer than ``min_devices`` re-raises. ``losses`` holds every step's
    loss, repeated steps after a resume included, as the JAX package's."""
    device = resolve_device(device)
    cfg = cfg or MPGNNConfig()
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    mesh = make_mesh(axis_shapes, ("data", "model"), ranks, device)
    # every mesh a recovery can move to, while every rank is here
    shrunk = {n: make_mesh(None, ("data", "model"), ranks[:n], device)
              for n in shrink_counts(len(ranks), min_devices)}
    if mesh.rank is None:
        return ElasticResult([], 0, 0, len(ranks), None, left=True)
    step_fn = build_sharded_train_step(mesh, graph, metapaths, split,
                                       num_classes, cfg, seed=seed,
                                       init_params=init_params)
    save_train_state(ckpt_path, 0, step_fn)
    losses: List[float] = []
    recoveries = 0
    step = 0
    while step < num_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)
            losses.append(step_fn(step_generator(seed, step, mesh.device)))
            step += 1
            if step % checkpoint_every == 0:
                save_train_state(ckpt_path, step, step_fn)
        except Exception as e:  # noqa: BLE001 - any step failure recovers
            new_n = _shrunk(len(ranks))
            if new_n < min_devices:
                raise
            log.warning("step %d failed (%s); recovering on %d ranks from "
                        "%s", step, e, new_n, ckpt_path)
            recoveries += 1
            ranks = ranks[:new_n]
            mesh = shrunk[new_n]
            if mesh.rank is None:
                return ElasticResult(losses, step, recoveries, len(ranks),
                                     None, left=True)
            step_fn, step = resume_train_step(ckpt_path, mesh, graph,
                                              metapaths, split, num_classes,
                                              cfg, seed)
    save_train_state(ckpt_path, step, step_fn)
    params, _ = step_fn.host_state()
    return ElasticResult(losses=losses, steps_run=step,
                         recoveries=recoveries,
                         final_device_count=len(ranks), params=params)
