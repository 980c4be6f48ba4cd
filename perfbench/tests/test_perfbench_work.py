"""The work counts, the least-time arithmetic and the trace reading, on
shapes worked by hand."""

from __future__ import annotations

import pytest

from perfbench import harness, peaks
from perfbench.reference import mpnetm
from perfbench.work import Work, kernel_bytes


def test_bound_takes_the_larger_side():
    t, side = peaks.bound(3.35e12, 1.0)
    assert side == "bytes" and t == pytest.approx(1.0)
    t, side = peaks.bound(1.0, 67e12)
    assert side == "operations" and t == pytest.approx(1.0)
    t, side = peaks.bound(0.0, 0.0, 989e12 * 2)
    assert side == "operations" and t == pytest.approx(2.0)


def test_work_by_hand():
    w = Work().matmul(10, 4, 3)                   # fwd + dW + dX
    assert w.flops == 3 * 2 * 10 * 4 * 3 and w.bytes == 0
    w = Work().matmul(10, 4, 3, grad_input=False)
    assert w.flops == 2 * 2 * 10 * 4 * 3
    w = Work().aggregate(edges=7, width=5)        # and its transpose
    assert w.flops == 2 * 2 * 7 * 5
    w = Work().csr(edges=7, rows=3).read(100)
    assert w.bytes == 4 * (7 + 3 + 1) + 100
    assert Work().adam(10).bytes == 4 * 7 * 10
    # 2 distinct rows of width 8 gathered into 3 rows over 5 edges
    assert kernel_bytes(5, 3, 2, 8) == 4 * (2 + 3) * 8 + 4 * (5 + 3 + 1)


def test_mpnetm_epoch_by_hand():
    # one metapath of two hops, N=10, F=4, H=2, C=3, 6 train rows
    hops = [[{"edges": 5, "rows": 3, "cols": 4}] * 2]
    w = mpnetm.step_work(10, 4, 2, 3, 6, hops, num_params=50)
    mm = (2 * 2 * 10 * 4 * 2) * 2 + (3 * 2 * 10 * 2 * 2) * 2   # hop 0, 1
    mm += 3 * 2 * 10 * 2 * 2 + 3 * 2 * 10 * 2 * 3             # fc1, fc2
    agg = 2 * 2 * 5 * 2
    elem = 2 * (4 * 20 * 2 + 2 * 20 + 5 * 30 + 3 * 6)
    assert w.flops == mm + agg + elem + 14 * 50
    assert w.bytes == (4 * 10 * 4 * 2 + 2 * 4 * (5 + 10 + 1)
                       + 6 * 20 + 4 * 7 * 50)


def test_trace_reading():
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "inner", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "csr_scatter_x", "ts": 130, "dur": 10},
    ]
    t = harness.reduce_trace(ev, 200e-6)
    assert t["busy_s"] == pytest.approx(50e-6)       # [0, 30] [50, 60] ..
    assert t["kernels"] == 3
    assert t["ops"]["k1"] == pytest.approx(40e-6)
    # idle [30, 50] under 'outer'; [60, 130] begins under 'outer' too
    assert t["gaps"] == {"outer": pytest.approx(90e-6)}
    assert harness.device_time(t, ("csr_scatter",)) == pytest.approx(10e-6)
