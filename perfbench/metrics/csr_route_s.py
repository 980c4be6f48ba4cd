"""csr_route_s: host seconds of the hop operands' K1/K2 routing, the
program's span ``csr.route`` (``mpgnn_tpu_torch.utils.prof``: each
direction's ``dedup_ratio`` in ``ops/csr.py`` ``build_csr_blocking``),
summed over the run's set-up."""

from mpgnn_tpu_torch.utils import prof

SPAN = "csr.route"


def read(run):
    s = getattr(prof, "spans", lambda: {})().get(SPAN)
    return s["host_s"] if s and s["calls"] else None
