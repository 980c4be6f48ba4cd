"""device_idle.train: the share of the traced window of training epochs
in which no kernel or copy ran on the card, from the profiler's
timeline, in %."""


def read(run):
    t = run.trace_summary
    if t is None or t["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
