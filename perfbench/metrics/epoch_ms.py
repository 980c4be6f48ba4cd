"""epoch_ms: the window's wall time over the training epochs run in it
(host clock; the window ends on a synchronise)."""


def read(run):
    s = run.counters.get("epoch_s")
    return None if s is None else s * 1e3
