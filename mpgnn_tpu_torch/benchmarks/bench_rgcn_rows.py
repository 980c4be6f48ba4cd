"""An R-GCN layer's relation terms on the rows each relation reaches
against the stacked product, at several reach shares, on the card.

    python -m mpgnn_tpu_torch.benchmarks.bench_rgcn_rows \
        [--shares 0.05,0.25,0.5,0.75,0.9,1.0] [--out FILE]

Its question decides ``rgcn_baseline.rgcn_operands``' rule: relation r's
term is zero on every row without an r-edge, so ``RgcnNet`` can run it
on the rows R_r it reaches alone (K1 on the rows of every such relation,
one product a relation, one K1 pass that sums each node's terms:
``models.mpgnn.rgcn_layer``'s row terms) or, as every relation did
before, through the [N, (R + 1) F] stacked product.
The row terms do less work the fewer rows a relation reaches, but their
products are thinner; at which share of N do the two cross?

The workload, one R-GCN layer at ogbn-mag's size for each share s:
``NODES`` = 1,939,743 rows, F = H = 64 (the cell ``mag_rgcn.train``'s
layers 1 and 2), float32 with TF32 off, ``RELATIONS`` = 8 relations of
``EDGES`` = 5,000,000 edges each (ogbn-mag's mean: 42,222,014 / 8). Each
relation's sources are a random s N rows, each with at least one edge, and
so are its destinations (a seeded numpy generator); the 8 relations share
one such blocking pair (``ops.csr.build_csr_blocking``, K1 both ways),
given 8 times (and 8 times to ``ops.csr.row_term_blockings``). A step is
``rgcn_layer``'s forward on an h that wants its gradient, then its
backward from a fixed gradient, all 8 relations stacked (their 'csr'
operands) or all on their rows (their 'csr_rows' operands).
Each path runs 2 warm-up steps, then the two run in turns (stacked, rows,
rows, stacked), ``STEPS`` steps a turn between CUDA events; a path's time
is its mean step over its two turns. Before timing, the two paths' z, h's
gradient and the weights' gradients are compared (their largest relative
gap is printed).

Prints one JSON line a share, then one summary line with the card's name
and power limit and the largest share at which the row terms were faster;
``--out`` also writes the lines to a file. It refuses to run without a
card: a CPU run gives no time.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from mpgnn_tpu_torch.benchmarks.bench_routing import card
from mpgnn_tpu_torch.models.mpgnn import ROW_OPERAND, rgcn_layer
from mpgnn_tpu_torch.models.relconv import RgcnConv
from mpgnn_tpu_torch.ops import _kernels
from mpgnn_tpu_torch.ops.csr import build_csr_blocking, row_term_blockings

NODES = 1_939_743
RELATIONS = 8
EDGES = 5_000_000
WIDTH = 64
STEPS = 5


def reach_edges(n: int, e: int, share: float, seed: int):
    """(src, dst) of e edges whose sources are a random round(share n)
    rows, each with at least one edge, and whose destinations are another
    such set."""
    rng = np.random.default_rng(seed)
    m = max(1, round(share * n))

    def side():
        rows = rng.permutation(n)[:m]
        return rng.permutation(np.concatenate(
            [rows, rows[rng.integers(0, m, e - m)]]))

    return side(), side()


def operands(n: int, e: int, share: float, seed: int, device):
    """The ``RELATIONS`` relations' stacked operands and their row-compact
    ones, each relation the same blocking pair."""
    src, dst = reach_edges(n, e, share, seed)
    fwd, bwd = (b.to(device) for b in build_csr_blocking(
        src, dst, n, dedup="never"))
    blk = row_term_blockings(range(RELATIONS), [fwd] * RELATIONS)
    return ([("csr", fwd, bwd)] * RELATIONS,
            [(ROW_OPERAND, blk.fwd, blk.bwd, blk)] * RELATIONS)


def layer_step(conv, h, gz, ops):
    """One layer's forward and backward; returns z, h's gradient and the
    weights' gradients."""
    h.grad = None
    for p in conv.parameters():
        p.grad = None
    z = rgcn_layer(conv, h, ops)
    z.backward(gz)
    return z.detach(), h.grad, conv.weight.grad, conv.root.grad


def gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def time_share(share: float, seed: int, device) -> dict:
    stacked, rows = operands(NODES, EDGES, share, seed, device)
    reach = rows[0][3].offsets[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    conv = RgcnConv(WIDTH, WIDTH, RELATIONS, device=device)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=device)
                    / WIDTH ** 0.5)
    h = torch.randn(NODES, WIDTH, generator=gen,
                    device=device).requires_grad_(True)
    gz = torch.randn(NODES, WIDTH, generator=gen, device=device)
    paths = {"stacked": stacked, "rows": rows}
    want = layer_step(conv, h, gz, paths["stacked"])
    got = layer_step(conv, h, gz, paths["rows"])
    gaps = max(gap(a, b) for a, b in zip(got, want))
    del want, got
    for ops in paths.values():
        for _ in range(2):
            layer_step(conv, h, gz, ops)
    ms = {k: [] for k in paths}
    for name in ("stacked", "rows", "rows", "stacked"):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(STEPS):
            layer_step(conv, h, gz, paths[name])
        b.record()
        b.synchronize()
        ms[name].append(a.elapsed_time(b) / STEPS)
    out = {k: float(np.mean(v)) for k, v in ms.items()}
    return dict(bench="rgcn_rows", share=share, reach=reach,
                stacked_ms=out["stacked"],
                rows_ms=out["rows"], rows_over_stacked=out["rows"]
                / out["stacked"], turns_ms=ms, largest_gap=gaps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shares", default="0.05,0.25,0.5,0.75,0.9,1.0",
                    help="reach shares, comma-separated")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_rgcn_rows: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = card()
    _kernels.build_all()
    lines = []
    for i, share in enumerate(float(v) for v in args.shares.split(",")):
        rec = time_share(share, i, device)
        print(json.dumps(rec), flush=True)
        lines.append(rec)
        torch.cuda.empty_cache()
    faster = [r["share"] for r in lines if r["rows_ms"] < r["stacked_ms"]]
    summary = dict(bench="rgcn_rows_summary", card=smi, nodes=NODES,
                   relations=RELATIONS, edges=EDGES, width=WIDTH,
                   largest_faster_share=max(faster) if faster else None)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for rec in lines + [summary]:
                f.write(json.dumps(rec) + "\n")
    return summary


if __name__ == "__main__":
    main()
