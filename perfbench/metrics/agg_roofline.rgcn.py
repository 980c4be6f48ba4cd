"""agg_roofline.rgcn: the R-GCN step's aggregations' byte bound over the
device time of the kernels that run them (K1 ``csr_scatter_kernel`` and
its ``csr_carry_kernel`` pass, K2 ``csr_dedup_kernel``), forward and
backward, over the traced epochs, in %.

Every layer after the first aggregates each relation over all N rows,
forward and backward; the bytes of one pass are counted as
``perfbench.work.kernel_bytes`` counts them, from the graph: the distinct
rows it gathers, its CSR (row offsets and columns) and its output, float32
at the layer's input width. Layer 0 aggregates the constant features once
before the epochs and is not counted."""

from perfbench.harness import device_time
from perfbench.peaks import bound
from perfbench.work import kernel_bytes

KERNELS = ("csr_scatter_kernel", "csr_carry_kernel", "csr_dedup_kernel")


def epoch_bytes(shapes) -> float:
    """Layers 1 and on: each relation's forward gathers its destinations
    into every row, its backward its sources' gradients."""
    n = shapes["num_nodes"]
    widths = [shapes["hidden"]] + [shapes["output"]] * (shapes["layers"] - 2)
    return sum(kernel_bytes(s["edges"], n, s["cols"], f)
               + kernel_bytes(s["edges"], n, s["rows"], f)
               for f in widths[:shapes["layers"] - 1]
               for s in shapes["relations"] if s["edges"])


def read(run):
    t = run.trace_summary
    if t is None or "relations" not in run.shapes:
        return None
    busy = device_time(t, KERNELS)
    if busy <= 0.0:
        return None
    least, _ = bound(epoch_bytes(run.shapes) * t["steps"], 0.0)
    return 100.0 * least / busy
