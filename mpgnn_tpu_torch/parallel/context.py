"""The active sweep mesh: the search's batched sweeps split over ranks.

Counterpart of ``mpgnn_tpu/parallel/context.py``. The reference fans its
search out with ``mpiexec -n 10``: relations are ``np.array_split`` over
ranks for the hop-0 and bag sweeps (main.py:1319, 1400) and candidates for
the final evaluation (main.py:1444-1450), the graph replicated in every
rank. The sweeps already batch those axes, so here each rank of the active
mesh computes its contiguous slice of a sweep's batch axis and the slices
are gathered back (``sweep_slice``, ``gather_sweep``). Every rank draws
the random numbers of the whole batch on the host, so the draws are a
single process's, and every rank holds the whole result, so every rank
takes the same decisions.

A batch whose length does not divide by the rank count is computed whole
on every rank (the JAX package replicates it). The sweeps pad their chunks
to ``max(pow2, sweep_devices())`` as the JAX package's do, which fixes
which random numbers each relation's init draws.

The mesh is process-wide (``set_sweep_mesh``, set by ``run.py --mesh``),
or per thread inside ``with sweep_mesh(mesh)``. Not inherited: the
``abstract_*`` helpers for ahead-of-time lowering (``context.py:121-151``)
and GSPMD placement (``shard_sweep``, ``replicate_sweep``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.parallel.mesh import all_gather_rows, make_mesh

_state = threading.local()
_GLOBAL = None   # set_sweep_mesh (CLI) is process-wide; sweep_mesh shadows
                 # it per thread


def set_sweep_mesh(mesh):
    """Install ``mesh`` as the process-wide sweep mesh; returns the old
    one."""
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, mesh
    return old


def get_sweep_mesh():
    return getattr(_state, "mesh", None) or _GLOBAL


@contextlib.contextmanager
def sweep_mesh(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def sweep_devices() -> int:
    """Rank count of the active sweep mesh (1 when none)."""
    mesh = get_sweep_mesh()
    return mesh.size if mesh is not None else 1


def sweep_pad(n: int) -> int:
    """``n`` rounded up to a multiple of the mesh's rank count."""
    d = sweep_devices()
    return -(-n // d) * d


def pad_batch_list(items: list) -> list:
    """A batch list padded to the mesh multiple by repeating its last
    element (callers keep the first result of a repeat)."""
    if not items:
        return items
    return items + [items[-1]] * (sweep_pad(len(items)) - len(items))


def sweep_slice(n: int) -> slice:
    """This rank's contiguous slice of a batch axis of ``n``: the whole
    axis without a mesh, or when ``n`` does not divide by its ranks."""
    mesh = get_sweep_mesh()
    if mesh is None or mesh.size == 1 or n % mesh.size:
        return slice(0, n)
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def gather_sweep(t: torch.Tensor, n: int) -> torch.Tensor:
    """The whole [n, ...] batch from every rank's ``sweep_slice(n)`` of it
    (``t``), on t's device; ``t`` itself when the batch was not split."""
    mesh = get_sweep_mesh()
    if sweep_slice(n) == slice(0, n):
        return t
    return all_gather_rows(t, mesh.group)


def parse_mesh_spec(spec: str, n: int) -> Tuple[List[str], List[int]]:
    """(axis names, sizes) of a CLI mesh spec over ``n`` ranks: ``"8"``
    (one fan-out axis, ``rel``), ``"rel=8"`` or ``"data=4,model=2"``; one
    size may be -1, inferred. The sizes must multiply to ``n``."""
    names: List[str] = []
    sizes: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=")
            names.append(k.strip())
            sizes.append(int(v))
        else:
            names.append("rel")
            sizes.append(int(part))
    if not names:
        names, sizes = ["rel"], [n]
    if sizes.count(-1) == 1:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // max(known, 1)
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh spec {spec!r} = {sizes} does not multiply "
                         f"to the {n} ranks")
    return names, sizes


def mesh_from_spec(spec: str, device=None, ranks: Optional[Sequence[int]] =
                   None):
    """The mesh of a CLI spec over ``ranks`` (default every rank of the
    default group) on ``device`` (default the card, as ``make_mesh``);
    every rank calls it."""
    import torch.distributed as dist

    device = resolve_device(device)
    ranks = list(range(dist.get_world_size())) if ranks is None else ranks
    names, sizes = parse_mesh_spec(spec, len(ranks))
    return make_mesh(sizes, names, ranks, device)
