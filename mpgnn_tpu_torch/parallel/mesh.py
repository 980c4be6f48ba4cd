"""Process groups, named meshes over them, the collectives the parallel
paths use, and a launcher for local ranks.

Counterpart of ``mpgnn_tpu/parallel/mesh.py``. The reference distributes
its search with ``mpiexec -n 10`` and MPI.COMM_WORLD (main.py:1191-1195,
run.sh:32); the JAX package builds a ``jax.sharding.Mesh`` over one
process's devices. Here every rank is a process: ``initialize_distributed``
joins the default process group (torchrun's environment, or arguments),
``make_mesh`` names a grid over its ranks with one process group per line
of each axis (``nodes``; ``data`` x ``model``; ``rel``), and the
collectives below run on those groups.

The collective backend is the caller's choice (``pick_backend`` gives the
usual one): NCCL where each rank has a card of its own, gloo for CPU ranks
and for several ranks on one card (NCCL refuses two ranks on one device).
The arithmetic stays on the rank's device whichever backend moves the
data: a CUDA tensor given to a gloo group is staged through pinned host
memory here, explicitly, and copied back.

``spawn_ranks`` starts local ranks (spawn start method, a ``FileStore``
rendezvous in a temporary directory, one thread each), joins them with a
hard timeout and raises with each failed rank's traceback; tests and
``chip_smoke.py`` use it. On the card it builds the CUDA kernels before it
spawns, so that the ranks do not race on the first build.
"""

from __future__ import annotations

import datetime
import logging
import os
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mpgnn_tpu_torch.device import resolve_device

log = logging.getLogger("mpgnn_tpu_torch.parallel")

# seconds a collective may wait before its process group raises
DEFAULT_PG_TIMEOUT_S = 300


def pick_backend(device, local_world_size: int) -> str:
    """'nccl' when ``device`` is a card and every local rank has one of its
    own, else 'gloo' (CPU ranks, or several ranks on one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def initialize_distributed(
    backend: str,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    init_method: str = "env://",
    timeout_s: float = DEFAULT_PG_TIMEOUT_S,
    device: str = "cuda",
) -> torch.device:
    """Join the default process group and return this rank's device.

    Rank, world size and local rank come from the arguments, else from
    torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``. The device is
    ``cuda:LOCAL_RANK % device_count`` (made current), or the CPU with
    ``device='cpu'``. Every collective of the group raises after
    ``timeout_s`` seconds of waiting."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = (int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None
                  else local_rank)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("rank %d of %d: backend %s, device %s%s", rank, world_size,
             backend, dev,
             " (CUDA tensors staged through pinned host memory)"
             if backend == "gloo" and dev.type == "cuda" else "")
    return dev


# ------------------------------------------------------------------- meshes
class Mesh:
    """A named grid over ranks, row-major: ``ranks[i]`` is the global rank
    at flat position i of ``shape``. Each axis has one process group per
    line (the ranks that differ only in that axis' index) and the mesh one
    over all its ranks. Built by every rank of the default group (group
    creation is collective); a rank outside ``ranks`` holds no groups
    (``rank`` None)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 ranks: Sequence[int], device: torch.device):
        sizes = tuple(int(s) for s in axis_sizes)
        if len(sizes) != len(axis_names):
            raise ValueError(f"axis sizes {sizes} and names {axis_names}")
        if int(np.prod(sizes)) != len(ranks):
            raise ValueError(f"axis sizes {sizes} != {len(ranks)} ranks")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.ranks = [int(r) for r in ranks]
        self.device = torch.device(device)
        me = dist.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else None
        grid = np.arange(len(self.ranks)).reshape(sizes)
        self.coords: Dict[str, int] = {}
        self._lines: Dict[str, Tuple[object, List[int]]] = {}
        for i, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
            for line in lines:
                members = [self.ranks[k] for k in line]
                group = dist.new_group(members)
                if self.rank is not None and self.rank in line:
                    self._lines[name] = (group, members)
                    self.coords[name] = int(list(line).index(self.rank))
        self.group = (dist.group.WORLD
                      if self.ranks == list(range(dist.get_world_size()))
                      else dist.new_group(self.ranks))

    @property
    def size(self) -> int:
        return len(self.ranks)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[axis]

    def axis_group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self._lines[axis][0]

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along ``axis``, in order."""
        return self._lines[axis][1]


def make_mesh(
    axis_shapes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    ranks: Optional[Sequence[int]] = None,
    device=None,
) -> Mesh:
    """A mesh over ``ranks`` (default: every rank of the default group) on
    this rank's ``device`` (default: the current card; the CPU only with
    ``device='cpu'``). Default shape: every rank on the first axis, 1 on
    the others. Must be called by every rank of the default group."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ranks = (list(range(dist.get_world_size())) if ranks is None
             else list(ranks))
    if axis_shapes is None:
        axis_shapes = (len(ranks),) + (1,) * (len(axis_names) - 1)
    return Mesh(axis_shapes, axis_names, ranks, device)


# -------------------------------------------------------------- collectives
def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` must go through host memory for ``group``'s backend
    (a CUDA tensor on gloo)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in a new tensor on t's device."""
    if _staged(t, group):
        h = _to_host(t)
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) concatenated along dim
    0 in group-rank order, on t's device."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    staged = _staged(t, group)
    src = _to_host(t) if staged else t.contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather(list(out.chunk(n)), src, group=group)
    return out.to(t.device) if staged else out


class Exchange:
    """A row exchange in flight: ``wait()`` returns the received rows,
    their buffers concatenated in order, on ``device``. It holds the send
    buffers until then: a collective in flight reads them."""

    def __init__(self, works, recvs: Sequence[torch.Tensor],
                 device: torch.device, sends: Sequence[torch.Tensor] = ()):
        self._works, self._recvs, self._device = works, list(recvs), device
        self._sends = list(sends)

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._sends = []
        recv = (self._recvs[0] if len(self._recvs) == 1
                else torch.cat(self._recvs))
        return recv.to(self._device)


def start_all_to_all(send: torch.Tensor, send_splits: Sequence[int],
                     recv_splits: Sequence[int], group) -> Exchange:
    """One ``all_to_all_single`` of rows: ``send_splits[q]`` rows of
    ``send`` (in group-rank order) go to rank q, ``recv_splits[q]`` rows
    come from it. Returns at once; ``wait()`` on the result."""
    staged = _staged(send, group)
    src = _to_host(send) if staged else send.contiguous()
    recv = torch.empty((int(sum(recv_splits)),) + tuple(send.shape[1:]),
                       dtype=send.dtype, device=src.device)
    work = dist.all_to_all_single(
        recv, src, output_split_sizes=[int(s) for s in recv_splits],
        input_split_sizes=[int(s) for s in send_splits], group=group,
        async_op=True)
    return Exchange([work], [recv], send.device, [src])


def start_ring(chunks: Sequence[Tuple[torch.Tensor, int, int, int]],
               width: int, dtype: torch.dtype, group_ranks: Sequence[int],
               group, device: torch.device) -> Exchange:
    """Point-to-point rounds: each ``(send rows, peer to send to, peer to
    receive from, rows to receive)`` in ``chunks`` (peers as indices into
    ``group_ranks``) runs as one isend / irecv pair; a side with no rows
    does not post. The received chunks are concatenated in round order."""
    staged = dist.get_backend(group) == "gloo" and device.type == "cuda"
    ops, recvs, sends = [], [], []
    for send, dst, src_peer, n_recv in chunks:
        if send.shape[0]:
            buf = _to_host(send) if staged else send.contiguous()
            sends.append(buf)
            ops.append(dist.P2POp(dist.isend, buf, group_ranks[dst], group))
        recv = torch.empty((n_recv, width), dtype=dtype,
                           device="cpu" if staged else device)
        if n_recv:
            ops.append(dist.P2POp(dist.irecv, recv, group_ranks[src_peer],
                                  group))
        recvs.append(recv)
    if not recvs:
        recvs.append(torch.empty((0, width), dtype=dtype, device=device))
    works = dist.batch_isend_irecv(ops) if ops else []
    return Exchange(works, recvs, device, sends)


# ----------------------------------------------------------- local launcher
def _rank_main(fn, rank, world, store, out_dir, args, backend, device,
               pg_timeout_s):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        dev = initialize_distributed(
            backend, rank=rank, world_size=world, local_rank=rank,
            init_method=f"file://{store}", timeout_s=pg_timeout_s,
            device=device)
        result = fn(dev, *args)
        torch.save(result, path + ".tmp")
        os.replace(path + ".tmp", path + ".pt")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(
    fn: Callable,
    world: int,
    args: tuple = (),
    *,
    backend: str = "gloo",
    device=None,
    timeout_s: float = 300.0,
    pg_timeout_s: float = 120.0,
) -> List:
    """Run ``fn(device, *args)`` in ``world`` new processes, one rank each
    of a fresh default process group on ``device`` (default the card; the
    CPU only with ``device='cpu'``), and return their results in rank
    order (a rank may return None, as a rank that left a shrunk group
    does).

    ``fn`` must be a module-level function (it is pickled by name) of a
    module that imports nothing of JAX. Tensors in ``args`` reach the
    ranks in shared memory: a rank that changes one copies it first. Each
    rank runs one thread. The
    ranks rendezvous through a ``FileStore`` in a temporary directory.
    They are joined with a hard ``timeout_s``: on expiry, or a few seconds
    after one rank failed, every rank still running is killed, and the
    call raises with each failed rank's traceback."""
    device = resolve_device(device).type
    if device == "cuda":
        from mpgnn_tpu_torch.ops import _kernels

        _kernels.build_all()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mpgnn_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, world, store, tmp, args, backend, device,
                  pg_timeout_s))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed_at = None
        try:
            while any(p.is_alive() for p in procs):
                now = time.monotonic()
                if failed_at is None and any(
                        p.exitcode not in (None, 0) for p in procs):
                    failed_at = now
                if now > deadline or (failed_at is not None
                                      and now > failed_at + 10.0):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10.0)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}"
                              + (" (killed)" if p.exitcode is not None
                                 and p.exitcode < 0 else ""))
        if errors:
            timed_out = time.monotonic() > deadline
            raise RuntimeError(
                ("ranks timed out after %.0f s; " % timeout_s
                 if timed_out else "")
                + f"{len(errors)} of {world} ranks failed:\n"
                + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
