"""mfu.train: the epoch's least time at the published peaks over the
measured epoch (the untraced window of the same run), in %. The least
time is the larger of the epoch's float32 operations at 67 TFLOP/s and
its bytes at 3.35 TB/s, both counted by the configuration's reference
module (``step_work``) from the model's equations and the graph's
shapes."""

from perfbench.peaks import bound


def read(run):
    if run.work is None or "epoch_s" not in run.counters:
        return None
    least, _ = bound(run.work.bytes, run.work.flops)
    return 100.0 * least / run.counters["epoch_s"]
