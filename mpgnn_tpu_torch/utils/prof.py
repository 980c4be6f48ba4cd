"""Spans, phase timing and device traces.

``PhaseTimer`` sums wall time by named phase, and is the port's span
registry: ``span(name)`` (or its alias ``phase``) times a block on the
host clock and counts it; ``start`` / ``stop`` time a piece of work that
starts in one function and ends in another. Each name keeps the span that
enclosed its first call on the same thread as its ``parent``.

While a ``torch.profiler`` session is active (``device_trace``, or a
benchmark's own profiler) a span also opens a
``torch.profiler.record_function`` range of its name, so it lands in the
Chrome trace as a ``user_annotation`` around the ops and launches it made,
and, once CUDA is initialised, records a timing ``torch.cuda.Event`` on
the current stream at its start and at its end. The pair is folded into
the name's ``device_s`` once the end event has completed, at a later
traced span's end or in ``spans()``; a span never synchronises. Without a
profiler a span costs two clock reads and a dict update under a lock, and
the module needs no torch (the host-only graph code uses it).

The process-wide registry is read by ``spans()`` and emptied by
``reset_spans()``; ``span``, ``start_span`` and ``stop_span`` use it.

``device_trace`` records a ``torch.profiler`` trace (host and, where a GPU
is present, CUDA kernels), writes it as one Chrome trace JSON, which
Perfetto or ``chrome://tracing`` open, and beside it the spans taken while
it ran.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

class _Open(threading.local):
    """The spans open on this thread, innermost last."""

    def __init__(self) -> None:
        self.spans: list = []


class _Span:
    """One timing of a name: a context manager, or the handle that
    ``PhaseTimer.start`` returns and ``PhaseTimer.stop`` takes."""

    __slots__ = ("timer", "name", "t0", "range", "start_event")

    def __init__(self, timer: "PhaseTimer", name: str) -> None:
        self.timer = timer
        self.name = name
        self.range = None
        self.start_event = None

    def __enter__(self) -> "_Span":
        self.timer._open(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.timer._close(self)
        return False


class PhaseTimer:
    """Accumulates wall time per named phase, and registers spans (see the
    module's docstring)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.traced_totals: Dict[str, float] = defaultdict(float)
        self.traced_counts: Dict[str, int] = defaultdict(int)
        self.device: Dict[str, float] = defaultdict(float)
        self.parents: Dict[str, Optional[str]] = {}
        self._pending: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._open_spans = _Open()

    def span(self, name: str) -> _Span:
        """A context manager that times its block as one call of
        ``name``."""
        return _Span(self, name)

    phase = span

    def start(self, name: str) -> _Span:
        """Open a span of ``name``; ``stop`` closes it."""
        s = _Span(self, name)
        self._open(s)
        return s

    def stop(self, s: _Span) -> None:
        """Close a span that ``start`` opened."""
        self._close(s)

    def _open(self, s: _Span) -> None:
        stack = self._open_spans.spans
        if s.name not in self.parents:
            self.parents.setdefault(s.name, stack[-1].name if stack
                                    else None)
        stack.append(s)
        s.t0 = time.perf_counter()
        # no profiler is active where torch's autograd profiler is not loaded
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is not None and prof._is_profiler_enabled:
            import torch

            s.range = torch.profiler.record_function(s.name)
            s.range.__enter__()
            if torch.cuda.is_initialized():
                s.start_event = torch.cuda.Event(enable_timing=True)
                s.start_event.record()

    def _close(self, s: _Span) -> None:
        end = None
        if s.range is not None:
            if s.start_event is not None:
                import torch

                end = torch.cuda.Event(enable_timing=True)
                end.record()
            s.range.__exit__(None, None, None)
        dt = time.perf_counter() - s.t0
        stack = self._open_spans.spans
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)
        name = s.name
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1
            if s.range is not None:
                self.traced_totals[name] += dt
                self.traced_counts[name] += 1
                if end is not None:
                    self._pending.append((name, s.start_event, end))
        if end is not None:
            self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        """Add the device time of each pending event pair whose end has
        completed (with ``wait``, of every pair, waiting for each), oldest
        first; without ``wait`` stop at the first pair still running."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                name, a, b = self._pending[0]
                if not wait and not (b.query() and a.query()):
                    return
                self._pending.popleft()
            if wait:
                a.synchronize()
                b.synchronize()
            with self._lock:
                self.device[name] += a.elapsed_time(b) * 1e-3

    def spans(self) -> Dict[str, dict]:
        """{name: {calls, host_s, traced_calls, traced_host_s, device_s,
        parent}} of every name timed; waits for the device time of
        traced spans still running on the card."""
        self._fold(wait=True)
        with self._lock:
            return {
                name: {"calls": self.counts[name],
                       "host_s": self.totals[name],
                       "traced_calls": self.traced_counts[name],
                       "traced_host_s": self.traced_totals[name],
                       "device_s": self.device[name],
                       "parent": self.parents.get(name)}
                for name in list(self.counts)}

    def reset(self) -> None:
        """Forget every name timed (spans still open count when they
        close)."""
        with self._lock:
            for d in (self.totals, self.counts, self.traced_totals,
                      self.traced_counts, self.device, self.parents):
                d.clear()
            self._pending.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 3), "count": self.counts[k]}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def dump(self) -> str:
        return json.dumps(self.summary())


# the process-wide registry of the program's spans
SPANS = PhaseTimer()
span = SPANS.span
start_span = SPANS.start
stop_span = SPANS.stop
spans = SPANS.spans
reset_spans = SPANS.reset


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where a GPU is present) and write one Chrome trace JSON into
    ``log_dir``, ``trace-<pid>-<ns>.json``; yields its path. Beside it,
    ``spans-<pid>-<ns>.json`` holds ``spans()`` as the block ends: every
    span since the process started (or the last ``reset_spans``), those
    timed inside the block among the traced ones, each a
    ``user_annotation`` range of its name in the trace. A no-op that
    yields None when ``log_dir`` is None or empty."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    stem = f"{os.getpid()}-{time.time_ns()}"
    path = os.path.join(log_dir, f"trace-{stem}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    with open(os.path.join(log_dir, f"spans-{stem}.json"), "w") as f:
        json.dump(spans(), f, indent=1, sort_keys=True)
