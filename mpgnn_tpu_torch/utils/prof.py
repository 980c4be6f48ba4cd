"""Phase timing and device traces.

``PhaseTimer`` sums wall time by named phase; ``device_trace`` records a
``torch.profiler`` trace (host and, where a GPU is present, CUDA kernels)
and writes it as one Chrome trace JSON, which Perfetto or
``chrome://tracing`` open.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class PhaseTimer:
    """Accumulates wall time per named phase."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 3), "count": self.counts[k]}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def dump(self) -> str:
        return json.dumps(self.summary())


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where a GPU is present) and write one Chrome trace JSON into
    ``log_dir``, ``trace-<pid>-<ns>.json``; yields its path. A no-op that
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
    path = os.path.join(log_dir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
