"""csr_build_s: host seconds of the hop operands' blockings, the
program's span ``csr.build`` (``mpgnn_tpu_torch.utils.prof``: each
direction's K1 or K2 layout in ``ops/csr.py`` ``build_csr_blocking``),
summed over the run's set-up."""

from mpgnn_tpu_torch.utils import prof

SPAN = "csr.build"


def read(run):
    s = getattr(prof, "spans", lambda: {})().get(SPAN)
    return s["host_s"] if s and s["calls"] else None
