"""attn_roofline.hgt: HGT's attention, forward and backward, at its byte
bound over the device time of the kernels that run it (K6,
``csrc/csr_attention.cu``: every kernel whose name holds ``csr_attn_``),
over the traced epochs, in %.

The bytes of a layer are counted as ``perfbench.reference.hgt.
attention_bytes`` counts the work, whatever implements it: Q of its target
rows and K and V of its distinct source nodes read once, the CSR read, out
and lse written, and in the backward the output's gradient, out, lse, Q,
K, V and the CSR read and the gradients of Q, K and V written;
intermediates are not counted."""

from perfbench.harness import device_time
from perfbench.peaks import bound
from perfbench.reference.hgt import attention_bytes

KERNELS = ("csr_attn_",)


def epoch_bytes(shapes) -> float:
    return sum(attention_bytes(s["rows"], s["edges"], s["sources"],
                               shapes["hidden"], shapes["heads"])
               for s in shapes["attention"])


def read(run):
    t = run.trace_summary
    if t is None or "attention" not in run.shapes:
        return None
    busy = device_time(t, KERNELS)
    if busy <= 0.0:
        return None
    least, _ = bound(epoch_bytes(run.shapes) * t["steps"], 0.0)
    return 100.0 * least / busy
