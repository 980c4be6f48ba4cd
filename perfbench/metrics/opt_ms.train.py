"""opt_ms.train: the device time of one traced epoch's Adam step, the
program's span ``train_step.optimizer`` (``mpgnn_tpu_torch.utils.prof``:
CUDA events on the current stream at its start and end while the profiler
runs), over its traced calls, in ms."""

from mpgnn_tpu_torch.utils import prof

SPAN = "train_step.optimizer"


def read(run):
    s = getattr(prof, "spans", lambda: {})().get(SPAN)
    if not s or not s["traced_calls"] or s["device_s"] <= 0.0:
        return None
    return 1e3 * s["device_s"] / s["traced_calls"]
