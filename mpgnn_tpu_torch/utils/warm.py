"""First-call warming of a process, off its main thread.

Counterpart of ``mpgnn_tpu/utils/warm.py``. The JAX package's warmer
compiles the search's jit signatures ahead on background threads and
touches the TPU so that its first-use stall overlaps data loading. The port
compiles nothing ahead. What a fresh process pays at first use is the
card's context, the kernel libraries' load (and their build, the first
time a checkout runs), the first launch of each kernel, cuBLAS's and
autograd's set-up, and the ``torch._dynamo`` import that the first
``torch.optim`` step makes (``PERF.md`` §5, "First calls"). A
``ProgramWarmer`` pays these on threads of its own:

* ``poke_device(device)``: all of the above, at the CLI's start, so that
  they overlap the graph's load and the first sweeps;
* ``warm_flat_signature`` (and ``warm_flat``): the hop-0 sweep's step
  function, ``search.scoring._flat_sweep``, on tiny zero operands, once
  for each operand form ('ell', 'seg');
* ``warm_bag_signature``: one bag restart round,
  ``search.scoring._bag_round``, the same way;
* ``warm_eval``: one epoch of the batched evaluation's stacked model
  (``train.batch_eval.train_chunk``) on a graph of a few nodes, once for
  each backend.

In eager mode a shape costs nothing, so a warm is keyed on its stage, its
form or backend and its device, not on the shape signature that the JAX
API takes: the sizes given are checked (a warm of a nonsense signature
fails) and otherwise unused.

PyTorch keeps some state per thread: the current device and stream, and
the cuBLAS handle with its workspace. A handle goes back to PyTorch's pool
when its thread ends, and the next thread to need one takes it; so each
warm runs on a thread of its own that ends with it. What crosses threads
is process-wide: the context, the loaded kernel modules and libraries,
autograd's device threads, the allocator's cached blocks and Python's
imports. ``chip_smoke.py`` phase 1 reads which first calls leave the main
thread. The ``torch._dynamo`` import is Python work: it holds the GIL, so
it slows what the main thread does in Python while it runs.

A warm never raises: a failure is logged, recorded in ``failures``, and
the real call then does the same work itself. A warm draws no number from
a default generator, and its tensors are freed when it ends (the cuBLAS
workspace goes on with the handle), so a warmed search takes the unwarmed
search's decisions.

Not inherited: the ahead-of-time half, ``warm_eval``'s ``compile_only``
pass, the batched evaluation's ``eval_aot_keys`` / ``claim_aot_keys`` and
their in-flight events (``ROADMAP.md``, "What the port does not
inherit").
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.device import resolve_device

log = logging.getLogger("mpgnn_tpu_torch.warm")

# The warms' operands: N nodes on a ring, two neighbours each, B bags of M
# members.
_N, _B, _M = 8, 2, 2
# How long ``shutdown`` waits for the warms still running. A warm takes
# seconds (the ``torch._dynamo`` import the most); one that hangs is left
# to its daemon thread, which does not hold the process's exit.
_SHUTDOWN_WAIT_S = 30.0


class ProgramWarmer:
    """First-call warms on background threads, at most ``max_workers`` at
    a time. Thread-safe; a key is warmed once, and a repeated request is
    free. Best effort: a failure is logged and kept in ``failures`` as
    (key, message), never raised."""

    def __init__(self, max_workers: int = 4):
        self._slots = threading.BoundedSemaphore(max_workers)
        self._seen: set = set()
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._closed = False
        self.failures: List[Tuple[object, str]] = []

    def _claim(self, key) -> bool:
        """Mark ``key`` as handled; False if it already was."""
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            return True

    def _submit(self, key, fn, *args) -> None:
        """Run ``fn(*args)`` on a new daemon thread, unless ``key`` was
        warmed or the warmer is shut down."""
        if not self._claim(key):
            return

        def task():
            with self._slots:
                if self._closed:
                    return
                t0 = time.perf_counter()
                try:
                    fn(*args)
                    log.info("warmed %s in %.3fs", key,
                             time.perf_counter() - t0)
                except Exception as e:  # best effort by design
                    with self._lock:
                        self.failures.append((key, f"{type(e).__name__}: "
                                                   f"{e}"))
                    log.warning("warm %s failed: %s", key, e, exc_info=True)

        with self._lock:
            if self._closed:
                return
            t = threading.Thread(target=task, daemon=True,
                                 name=f"mpgnn-warm-{len(self._threads)}")
            self._threads.append(t)
        t.start()

    # ------------------------------------------------------------- warmers
    def poke_device(self, device=None) -> None:
        """On ``device`` (the GPU unless ``device='cpu'``): create the
        context, load every kernel library (building it at first use),
        launch K1 once on a blocking of a few rows, run one cuBLAS product
        and one autograd backward, and construct and step one
        ``torch.optim.Adam``, which imports ``torch._dynamo`` (at the
        construction or at the first step, by torch version). On the CPU
        the product, the backward and the Adam step."""
        device = _resolve(device)
        self._submit(("poke", str(device)), _poke, device)

    def warm_flat(self, graph, relations: Sequence[int], cfg,
                  device=None) -> None:
        """The hop-0 sweep of ``relations`` (``scoring._chunks`` of them):
        one ``warm_flat_signature`` a chunk, with ``cfg``'s epochs and lr."""
        from mpgnn_tpu_torch.search import scoring as sc

        device = _resolve(device)
        budget = sc._mem_budget_entries(device)
        for mode, pad, cpad, chunk in sc._chunks(list(relations), graph,
                                                 budget):
            self.warm_flat_signature(len(chunk), graph.num_nodes, pad,
                                     cfg.epochs_flat, cfg.lr, mode=mode,
                                     C=cpad, device=device)

    def warm_flat_signature(
        self, R: int, N: int, D: int, epochs: int, lr: float,
        mode: str = "ell", C: int = 0, device=None,
    ) -> None:
        """The hop-0 sweep's step function in ``mode``'s operand form
        ('ell': ``D`` the degree pad; 'seg': ``D`` the edge pad and ``C``
        the compact width), two epochs at ``lr``, once a form and
        device."""
        device = _resolve(device)
        sizes = dict(R=R, N=N, D=D, epochs=epochs)
        if mode == "seg":
            sizes["C"] = C
        self._submit(("flat", mode, str(device)), _flat, device, mode, lr,
                     sizes)

    def warm_bag_signature(
        self, R: int, N: int, D: int, B: int, M: int, F: int,
        epochs: int, lr: float, mode: str = "ell", C: int = 0, P: int = 0,
        device=None,
    ) -> None:
        """One bag restart round in ``mode``'s operand form ('seg': ``C``
        the compact width, ``P`` the flattened members), two epochs at
        ``lr`` over ``F`` features, once a form and device."""
        device = _resolve(device)
        sizes = dict(R=R, N=N, D=D, B=B, M=M, F=F, epochs=epochs)
        if mode == "seg":
            sizes.update(C=C, P=P)
        self._submit(("bag", mode, str(device)), _bag, device, mode, lr,
                     sizes)

    def warm_eval(
        self, graph, paths, split, num_classes, cfg, seed, x_override,
        existing=None, backend: Optional[str] = None, device=None,
    ) -> None:
        """One epoch of the batched evaluation of a length group, as
        ``evaluate_candidates`` routes ``paths`` (``backend``, else
        ``cfg.backend``), on a ring of a few nodes with the group's length,
        feature width and class count, once a backend and device. Nothing
        for a group whose every path is in ``existing``, for 'dense' (its
        operands depend on the whole candidate set, as in the JAX
        package), or for a single-model backend, whose candidates train
        through ``train_mpgnn``. ``split`` is not read: the ring has its
        own."""
        from mpgnn_tpu_torch.train.batch_eval import (
            BATCH_BACKENDS,
            resolve_eval_backend,
        )

        if not paths or (existing and all(str(p) in existing
                                          for p in paths)):
            return
        backend = resolve_eval_backend(backend, cfg, graph, paths)
        if backend not in BATCH_BACKENDS or backend == "dense":
            return
        device = _resolve(device)
        feat_dim = (graph.feat_dim if x_override is None
                    else int(np.shape(x_override)[1]))
        self._submit(("eval", backend, str(device)), _eval, device, backend,
                     len(paths[0]), feat_dim, num_classes, cfg, seed)

    # ---------------------------------------------------------------- sync
    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every warm submitted so far has ended, or until
        ``timeout`` seconds in all have passed."""
        with self._lock:
            threads = list(self._threads)
        end = None if timeout is None else time.monotonic() + timeout
        for t in threads:
            t.join(None if end is None else max(0.0, end - time.monotonic()))

    def shutdown(self) -> None:
        """Start no further warm, and wait up to ``_SHUTDOWN_WAIT_S`` for
        those running."""
        with self._lock:
            self._closed = True
        self.wait(_SHUTDOWN_WAIT_S)


_global_warmer: Optional[ProgramWarmer] = None


def get_warmer(enabled: bool = True) -> Optional[ProgramWarmer]:
    """The process's warmer (None when disabled); a new one once the last
    was shut down."""
    global _global_warmer
    if not enabled:
        return None
    if _global_warmer is None or _global_warmer._closed:
        _global_warmer = ProgramWarmer()
    return _global_warmer


# ------------------------------------------------------------ the warms
def _resolve(device) -> torch.device:
    """``resolve_device(device)``, a CUDA device with its index: the
    caller's current one (a warm thread's own current device is 0)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device()
                              if torch.cuda.is_initialized() else 0)
    return device


def _on(device: torch.device):
    """``device`` as the thread's current device (a CUDA one)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check(sizes: dict) -> None:
    """Refuse a signature with a size below 1."""
    bad = {k: v for k, v in sizes.items() if int(v) < 1}
    if bad:
        raise ValueError(f"not a sweep signature: {bad}")


def _ring(device) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """The ring's node ids, and its sources and destinations as [1, N]
    flat ids on ``device``."""
    from mpgnn_tpu_torch.search.scoring import _flat_ids

    ring = np.arange(_N)
    return (ring, _flat_ids(ring[None], _N, device),
            _flat_ids(np.roll(ring, -1)[None], _N, device))


def _ring_ell(device) -> torch.Tensor:
    """[1, N, 2] flat ids of each ring node's two neighbours."""
    from mpgnn_tpu_torch.search.scoring import _flat_ids

    ring = np.arange(_N)
    return _flat_ids(np.stack([np.roll(ring, -1), np.roll(ring, 1)],
                              axis=-1)[None], _N, device)


def _poke(device: torch.device) -> None:
    from mpgnn_tpu_torch.config import MPGNNConfig
    from mpgnn_tpu_torch.train.loops import make_optimizer

    with _on(device):
        # the context, and a generator of the warm's own
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.rand((_N, _N), generator=gen, device=device)
        if device.type == "cuda":
            from mpgnn_tpu_torch.ops import _kernels, csr

            for source in _kernels.SOURCES:
                _kernels.lib(source)
            ring = np.arange(_N)
            blk, _ = csr.build_csr_blocking(ring, np.roll(ring, -1), _N,
                                            dedup="never")
            csr.csr_scatter(blk.to(device), x)
        w = x.clone().requires_grad_()
        (w @ x).sum().backward()
        holder = torch.nn.Module()
        holder.p = torch.nn.Parameter(torch.zeros(1, device=device))
        opt = make_optimizer(holder, MPGNNConfig())
        holder.p.grad = torch.ones_like(holder.p)
        opt.step()
        _sync(device)


def _flat(device: torch.device, mode: str, lr: float, sizes: dict) -> None:
    from mpgnn_tpu_torch.models.scorer import (
        flat_forward_ell,
        flat_forward_seg,
    )
    from mpgnn_tpu_torch.search.scoring import _flat_sweep, _segment_has

    _check(sizes)
    with _on(device):
        lmask = torch.ones(1, _N, device=device)
        denom = lmask.sum(1)
        ct = lmask / denom[:, None]
        if mode == "ell":
            nbr = _ring_ell(device)
            mask = torch.ones(nbr.shape, dtype=torch.bool, device=device)
            has = mask.any(-1)
            y, const = torch.zeros(_N, device=device), None

            def fwd(w):
                return flat_forward_ell(w, nbr, mask, has)
        elif mode == "seg":
            _, src, dst = _ring(device)
            em = torch.ones(src.shape, dtype=torch.bool, device=device)
            has = _segment_has(src, em, _N)
            y, const = torch.zeros_like(lmask), torch.zeros(1, device=device)

            def fwd(w):
                return flat_forward_seg(w, src, dst, em, has)
        else:
            raise ValueError(f"no sweep form {mode!r}")
        _flat_sweep(torch.zeros(1, _N, device=device), fwd, ct, has, y,
                    lmask, denom, const, epochs=2, lr=lr)
        _sync(device)


def _bag(device: torch.device, mode: str, lr: float, sizes: dict) -> None:
    from mpgnn_tpu_torch.models.scorer import bag_forward_ell, bag_forward_seg
    from mpgnn_tpu_torch.search.scoring import (
        _bag_round,
        _flat_ids,
        _segment_has,
    )

    _check(sizes)
    f = min(int(sizes["F"]), 64)
    with _on(device):
        labels = torch.zeros(1, _B, device=device)
        keep = torch.ones(1, _B, device=device)
        bag_has = keep > 0.5
        members = np.arange(_B * _M)[None] % _N              # [1, B * M]
        if mode == "ell":
            nbr = _ring_ell(device)
            mask = torch.ones(nbr.shape, dtype=torch.bool, device=device)
            has = mask.any(-1)
            bags = _flat_ids(members.reshape(1, _B, _M), _N, device)
            mmask = torch.ones(bags.shape, dtype=torch.bool, device=device)
            x = torch.zeros(_N, f, device=device)

            def fwd(w, u):
                return bag_forward_ell(w, u, x, nbr, mask, has, bags, mmask,
                                       bag_has)
        elif mode == "seg":
            _, src, dst = _ring(device)
            em = torch.ones(src.shape, dtype=torch.bool, device=device)
            has = _segment_has(src, em, _N)
            mn = _flat_ids(members, _N, device)
            mb = _flat_ids(np.repeat(np.arange(_B), _M)[None], _B, device)
            mm = torch.ones(mn.shape, dtype=torch.bool, device=device)
            x = torch.zeros(1, _N, f, device=device)

            def fwd(w, u):
                return bag_forward_seg(w, u, x, src, dst, em, has, mn, mb,
                                       mm, bag_has)
        else:
            raise ValueError(f"no sweep form {mode!r}")
        _bag_round(fwd, torch.zeros(1, _N, device=device),
                   torch.zeros(1, f, device=device), x, labels, keep,
                   bag_has, has, torch.ones(1, _N, device=device),
                   torch.zeros(1, _N, dtype=torch.bool, device=device),
                   epochs=2, lr=lr)
        _sync(device)


def _eval(device: torch.device, backend: str, length: int, feat_dim: int,
          num_classes: int, cfg, seed: int) -> None:
    from mpgnn_tpu_torch.graph.hetero import HeteroGraph, NodeSplit
    from mpgnn_tpu_torch.train.batch_eval import train_chunk
    from mpgnn_tpu_torch.train.loops import split_tensors

    ring = np.arange(_N)
    graph = HeteroGraph(np.zeros((_N, feat_dim), np.float32), ring,
                        np.roll(ring, -1), np.zeros(_N, np.int64),
                        num_relations=1)
    half = _N // 2
    y = np.arange(half) % num_classes
    split = NodeSplit(node_idx=ring, train_idx=ring[:half], train_y=y,
                      val_idx=ring[half:], val_y=y, test_idx=ring[half:],
                      test_y=y)
    with _on(device):
        x = torch.zeros(_N, feat_dim, device=device)
        train_chunk(graph, [[0] * length], x,
                    split_tensors(split, device)[:4], num_classes,
                    dataclasses.replace(cfg, epochs=1), seed, backend)
        _sync(device)
