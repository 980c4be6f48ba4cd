"""setup_unspanned_s: the seconds of set-up's program phase (the driver's
``at_program_s`` less ``at_hetero_s``: the program's objects and
operands) that no top-level span of the program covers, the phase's self
time. The spans subtracted are the program's set-up spans
(``mpgnn_tpu_torch.utils.prof``) that no other span encloses."""

from mpgnn_tpu_torch.utils import prof

# the program's spans that the program phase may open
PROGRAM = ("train.resolve_backend", "train.build_hop_arrays",
           "model.init", "train.make_optimizer", "model.first_hop",
           "kernels.load")


def read(run):
    spans = getattr(prof, "spans", lambda: {})()
    phase = run.spans.get("at_program_s", 0.0) - run.spans.get(
        "at_hetero_s", 0.0)
    top = [spans[n]["host_s"] for n in PROGRAM
           if n in spans and spans[n]["parent"] is None]
    if phase <= 0.0 or not top:
        return None
    return phase - sum(top)
