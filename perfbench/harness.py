"""What every cell of the benchmark shares: finding configurations,
traffic mixes, drivers and metrics by name, the timed window, the
profiler's reading, the module check and the result line."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent          # perfbench/
# top-level module names that no process of a run may hold: the JAX
# package and JAX itself, compared whole (the port's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "mpgnn_tpu")
# kernels and copies the profiler reports on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


# ------------------------------------------------------------- discovery
def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(bench: dict, name: str, root: Path) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_of(name: str) -> dict:
    with open(ROOT / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module: imported as
    ``perfbench.<kind>.<name>``, or, for a name with dots (a metric's),
    loaded from its file."""
    if "." not in name:
        return importlib.import_module(f"perfbench.{kind}.{name}")
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metric entries a run of ``workload`` reports: with ``trace``
    the per-layer ones whose cells include it, else the end-to-end ones."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


# ---------------------------------------------------------- module check
def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------------ runs
def process_start_time() -> float:
    """This process's start on the ``time.time()`` clock, from
    /proc/self/stat (clock ticks after boot) and the boot time."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Run:
    """One run's arguments, what it learns and what it reports."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    device: object
    cell: dict
    config: dict
    traffic: dict
    t_start: float                         # process start, time.time()
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    info: Dict[str, object] = dataclasses.field(default_factory=dict)
    checks: List[tuple] = dataclasses.field(default_factory=list)
    trace_summary: Optional[dict] = None
    attempted: int = 0
    failed: int = 0
    drop_seed: int = 0
    work: object = None                    # the step's Work (traced runs)
    shapes: Dict[str, object] = dataclasses.field(default_factory=dict)

    def check(self, name: str, value: float, limit: float) -> None:
        """One number compared against its limit (``passes``)."""
        self.checks.append((name, value, limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(passes(v, lim)
                                         for _, v, lim in self.checks)


def passes(value, limit: float) -> bool:
    """A compared number passes at or under its limit; one that is not a
    finite number fails."""
    return isinstance(value, (int, float)) and math.isfinite(value) \
        and value <= limit


def timed_window(seconds: float, step: Callable[[], object], device,
                 lag: int = 2) -> dict:
    """Run ``step`` back to back for ``seconds`` of the host clock and
    return {count, seconds}: every step started in the window counts, and
    the window ends on ``sync()`` after the last. The host runs at most
    ``lag`` steps ahead of the device (a CUDA event a step), so the clock
    is read close to the work it times."""
    import torch

    cuda = torch.device(device).type == "cuda"
    events = []
    count = 0
    t0 = time.perf_counter()
    while True:
        step()
        count += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
            if len(events) > lag:
                events.pop(0).synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(device)
    return {"count": count, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------- traces
def trace_window(run_steps: Callable[[], int]) -> dict:
    """Profile ``run_steps()`` (which returns how many steps it ran and
    ends on a synchronise) with ``torch.profiler`` and reduce the trace:
    {steps, window_s, busy_s, kernels (launches seen), ops: {name: device s},
    gaps: {host op: idle s}}. ``busy_s`` is the union of the device's
    kernels and copies over the window, ``gaps`` the idle time of the
    device by the outermost host operation running as each gap began."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = run_steps()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = reduce_trace(events, window_s)
    out["steps"] = steps
    return out


def reduce_trace(events: List[dict], window_s: float) -> dict:
    """The reading of a Chrome trace (``traceEvents``): see
    ``trace_window``."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "cpu_op"]
    ops: Dict[str, float] = {}
    for e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] * 1e-6
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, gaps_iv = 0.0, []
    cur = None
    for a, b in spans:
        if cur is None:
            cur = [a, b]
        elif a > cur[1]:
            busy += cur[1] - cur[0]
            gaps_iv.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    # outermost host ops: not inside another
    top = []
    for e in sorted(host, key=lambda e: (e["ts"], -e["dur"])):
        if top and e["ts"] + e["dur"] <= top[-1][1]:
            continue
        top.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    gaps: Dict[str, float] = {}
    j = 0
    for a, b in gaps_iv:
        while j < len(top) and top[j][1] <= a:
            j += 1
        name = "host"
        if j < len(top) and top[j][0] <= a:
            name = top[j][2]
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return {"window_s": window_s, "busy_s": busy * 1e-6,
            "kernels": sum(1 for e in dev if e["cat"] == "kernel"),
            "ops": ops, "gaps": gaps}


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k[:120], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def device_time(summary: dict, names) -> float:
    """Seconds of device time in kernels whose name holds one of
    ``names``."""
    return sum(t for k, t in summary["ops"].items()
               if any(n in k for n in names))


# ---------------------------------------------------------------- output
def device_block(run: Run, count: int) -> dict:
    import torch

    block = {"platform": "gpu",
             "kind": torch.cuda.get_device_name(run.device),
             "count": count,
             "memory_peak_bytes": int(run.counters["memory_peak_bytes"])}
    if run.trace and run.trace_summary is not None:
        block["busy_s"] = run.trace_summary["busy_s"]
        block["window_s"] = run.trace_summary["window_s"]
    return block


def metric_values(run: Run, bench: dict) -> Dict[str, dict]:
    """Each metric of the run's kind (end-to-end, or per-layer with
    --trace 1) read by its own reader, ``perfbench/metrics/<name>.py``;
    a reader that finds nothing returns None and the metric is left
    out."""
    out = {}
    for m in metrics_for(bench, run.workload, run.trace):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(run: Run, bench: dict, chips: int) -> dict:
    res = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metric_values(run, bench),
           "device": device_block(run, chips)}
    if run.trace and run.trace_summary is not None:
        res["breakdown"] = {"device_ops": top(run.trace_summary["ops"]),
                            "idle_gaps": top(run.trace_summary["gaps"])}
    res["compared"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in run.checks}
    return res


def report_checks(run: Run) -> None:
    """Each compared number beside its limit, as the last lines of
    standard error."""
    for name, v, lim in run.checks:
        print(f"compared {name} {v!r} limit {lim!r} "
              f"{'ok' if passes(v, lim) else 'FAILED'}", file=sys.stderr,
              flush=True)
