"""rel_agg_ms.rgcn: the device time an epoch of the R-GCN forward's sums
over relations, the program's span ``rgcn.relations``
(``mpgnn_tpu_torch.utils.prof``: around each layer's aggregations, their
products with the relations' weights and the root's, and the bias; CUDA
events on the current stream at its start and end while the profiler
runs), over the traced epochs (the traced calls of ``train.step``), in
ms."""

from mpgnn_tpu_torch.utils import prof

SPAN = "rgcn.relations"
STEP = "train.step"


def read(run):
    spans = getattr(prof, "spans", lambda: {})()
    s, step = spans.get(SPAN), spans.get(STEP)
    if not s or not step or not s["traced_calls"] \
            or not step["traced_calls"] or s["device_s"] <= 0.0:
        return None
    return 1e3 * s["device_s"] / step["traced_calls"]
