"""operand_build_s: host clock around the program's hop-operand build
(``train.loops.build_hop_arrays``: the csr blockings of ``ops/csr.py``,
moved to the card), in the harness."""


def read(run):
    return run.spans.get("operand_build_s")
