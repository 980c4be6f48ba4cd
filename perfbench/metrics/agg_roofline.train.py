"""agg_roofline.train: the hop aggregations' byte bound over the device
time of the kernels that run them (K1 ``csr_scatter_kernel`` and its
``csr_carry_kernel`` pass, K2 ``csr_dedup_kernel``), forward and
backward, over the traced epochs, in %.

The bytes of one aggregation are counted as ``chip_smoke.bound`` counts
them, from the graph: the distinct rows it gathers, its CSR (row offsets
and columns) and its output, float32 at the hidden width; the backward
the same of the transpose. Hop 0 aggregates the constant features once
before the epochs and is not counted."""

from perfbench.harness import device_time
from perfbench.peaks import bound
from perfbench.work import kernel_bytes

KERNELS = ("csr_scatter_kernel", "csr_carry_kernel", "csr_dedup_kernel")


def epoch_bytes(shapes) -> float:
    """Hop 1 and on of every metapath: the forward gathers the relation's
    destinations into every row, the backward its sources' gradients."""
    n, h = shapes["num_nodes"], shapes["hidden"]
    return sum(kernel_bytes(s["edges"], n, s["cols"], h)
               + kernel_bytes(s["edges"], n, s["rows"], h)
               for hops in shapes["hops"] for s in hops[1:])


def read(run):
    t = run.trace_summary
    if t is None or "hops" not in run.shapes:
        return None
    busy = device_time(t, KERNELS)
    if busy <= 0.0:
        return None
    least, _ = bound(epoch_bytes(run.shapes) * t["steps"], 0.0)
    return 100.0 * least / busy
