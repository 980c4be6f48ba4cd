"""typed_ms.hgt: the device time an epoch of HGT's typed projections, the
program's span ``hgt.typed`` (``mpgnn_tpu_torch.utils.prof``: around the
typed input Linear, each layer's typed K, Q and V Linears, and its typed
A-Linear with the gated skip; CUDA events on the current stream at its
start and end while the profiler runs), over the traced epochs (the traced
calls of ``train.step``), in ms."""

from mpgnn_tpu_torch.utils import prof

SPAN = "hgt.typed"
STEP = "train.step"


def read(run):
    spans = getattr(prof, "spans", lambda: {})()
    s, step = spans.get(SPAN), spans.get(STEP)
    if not s or not step or not s["traced_calls"] \
            or not step["traced_calls"] or s["device_s"] <= 0.0:
        return None
    return 1e3 * s["device_s"] / step["traced_calls"]
