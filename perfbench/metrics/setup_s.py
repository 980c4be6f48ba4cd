"""setup_s: process start to the first timed step: graph generation, the
program's operand build, the kernels' first build in a checkout, and the
warm-up."""


def read(run):
    return run.spans.get("setup_s")
