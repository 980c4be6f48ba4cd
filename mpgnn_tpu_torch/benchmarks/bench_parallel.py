"""Multi-rank runs of ``parallel/`` on one card: the ranks' bodies that
``chip_smoke.py`` phase 10 spawns, and a command line for the halo run.

    python -m mpgnn_tpu_torch.benchmarks.bench_parallel [--epochs 20] \
        [--ranks 2]

The command line trains node-sharded (``train_mpgnn(backend='halo')``) on
``--ranks`` ranks (NCCL where the machine has a card for each, rank r on
``cuda:r``, else gloo ranks sharing the cards): bench.py's 200,000-node,
10M-edge uniform graph (``bench_train.make_graph``) with labels planted
on relation 1 (``planted_graph``), the metapath [0, 1], hidden 64,
dropout 0, ``halo_local='csr'`` (K1 on each rank's local and halo
blockings), with the 'a2a' and then the 'ppermute' exchange, a short
bf16 ``num_bases=2`` run and a control with the last rank's halo zeroed,
and the single-process csr runs from the same seed beside them. It
prints one JSON line: each rank's loss and F1s, its parameters' largest
distance from the single-process run's, epoch ms (CUDA events after each
optimizer step), exchange calls and ms (host clock from an exchange's
start to its rows on the card, synchronized, after one warm-up exchange;
the pinned-memory staging of gloo included) and K1 launches against what
the hops imply, and whether every run holds to the single-process one
within ``HALO_*`` and the control does not (``judge``; exit 1 where
not). Several ranks on one card measure correctness and the exchange's
cost, not scaling. It refuses to run without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mpgnn_tpu_torch.benchmarks.bench_train import AVG_DEG, NODES, card, \
    make_graph
from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.ops import csr
from mpgnn_tpu_torch.parallel import elastic, halo
from mpgnn_tpu_torch.parallel.mesh import make_mesh, pick_backend, \
    spawn_ranks
from mpgnn_tpu_torch.parallel.shard import build_sharded_train_step
from mpgnn_tpu_torch.train import loops

HIDDEN = 64
METAPATHS = [[0, 1]]
# the node-sharded runs against the single-process csr run from the same
# seed (dropout 0): each rank sums a row's local and halo edges in two K1
# launches where the single process sums them in one, float32 in another
# order, and 20 epochs of Adam on labels the model learns carry such
# rounding into the parameters (the first epoch's loss is bitwise equal).
# Read on H100 80GB HBM3 cards at 700 W (chip_smoke.py phase 10 on 2 gloo
# ranks of one card, three times; bench_parallel --ranks 4 over NCCL once):
# final loss up to 7.9e-4 relative apart, parameters 3.7e-3, F1s 1.4e-4;
# the single-process segment run, another order of the same sums, is
# 7.0e-5 to 6.9e-4 and 1.5e-3 to 3.5e-3 from csr (its index_add_ sums in
# no fixed order). The control with one rank's halo zeroed is 0.64-0.98,
# 0.17-0.20 and 0.077-0.082 apart. The bounds leave 5-7x over the
# readings and stay 8x or more under the control. The bf16
# ``num_bases=2`` run against the single-process one (2-5 epochs): loss
# up to 4.5e-6 relative apart, bound 1e-3.
HALO_LOSS_RTOL = 5e-3
HALO_F1_ATOL = 1e-3
HALO_PARAM_ATOL = 2e-2
HALO_BF16_LOSS_RTOL = 1e-3


def expected_k1(hop_ops, epochs: int) -> int:
    """K1 launches a csr-local halo run implies on this rank: hop 0's
    local and halo forwards once (its aggregation of the constant features
    is cached), each later hop's two forwards and two backwards every
    epoch (the halo backward only where the rank receives rows: a blocking
    of 0 rows launches nothing) and two forwards in the final
    evaluation."""
    n = 0
    for ops in hop_ops:
        n += 2
        for op in ops[1:]:
            n += epochs * (3 + (op[3].halo > 0)) + 2
    return n


def timed_train(graph, split, cfg, backend, mesh=None):
    """``train_mpgnn`` with a CUDA event after every optimizer step: (the
    result, the ms an epoch between the first and the last step)."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    events = []

    def after_step(*_):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    torch.cuda.synchronize()
    hook = register_optimizer_step_post_hook(after_step)
    try:
        res = loops.train_mpgnn(graph, METAPATHS, split, 2, cfg, seed=0,
                                backend=backend, mesh=mesh)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    return res, events[0].elapsed_time(events[-1]) / max(len(events) - 1, 1)


def planted_graph():
    """bench.py's uniform graph (``bench_train.make_graph``) with labels
    that the metapath [0, 1] can learn, and their split: whether a node's
    mean of feature 0 over its relation-1 edges (hop 1's messages, which
    reach a block's rows through the halo exchange) is above the median.
    On bench.py's random labels every run ends near ln 2, whatever its
    exchange does."""
    graph, _ = make_graph(NODES, AVG_DEG)
    n = graph.num_nodes
    m = graph.edge_type == 1
    src, dst = graph.edge_src[m], graph.edge_dst[m]
    mean = (np.bincount(src, weights=graph.x[dst, 0], minlength=n)
            / np.maximum(np.bincount(src, minlength=n), 1))
    return graph, split_nodes((mean > np.median(mean)).astype(np.int64))


def host_params(model) -> dict:
    return {k: v.detach().float().cpu() for k, v in
            model.state_dict().items()}


@contextlib.contextmanager
def halo_zeroed_on(rank: Optional[int]):
    """The control run: rank ``rank`` receives zeros for its halo rows,
    every hop, forward and backward (None: no change)."""
    if rank is None:
        yield
        return
    wait = halo._wait

    def zeroed(started):
        out = wait(started)
        return out.zero_() if dist.get_rank() == rank else out

    halo._wait = zeroed
    try:
        yield
    finally:
        halo._wait = wait


def halo_run(graph, split, mesh, cfg, zero_halo_on=None) -> dict:
    """One node-sharded run on this rank, with its counts and its final
    parameters on the host. One exchange of the first hop, forward and
    backward, runs before the counts are set to 0 (an NCCL communicator is
    set up on its first collective), and the exchanges are timed with
    ``halo.EXCHANGE_SYNC`` on."""
    hop_ops = loops.build_hop_arrays(
        graph, METAPATHS, backend="halo", mesh=mesh,
        halo_exchange=cfg.halo_exchange, halo_local=cfg.halo_local)
    x = halo.shard_graph_features(graph.x, mesh).requires_grad_()
    halo.halo_sharded_mean_aggregate(mesh, x, hop_ops[0][0][3]).sum() \
        .backward()
    torch.cuda.synchronize()
    csr.SCATTER_LAUNCHES = csr.SCATTER_BF16_LAUNCHES = 0
    halo.EXCHANGE_CALLS, halo.EXCHANGE_SECONDS = 0, 0.0
    halo.EXCHANGE_SYNC = True
    t0 = time.perf_counter()
    try:
        with halo_zeroed_on(zero_halo_on):
            res, epoch_ms = timed_train(graph, split, cfg, "halo", mesh)
    finally:
        halo.EXCHANGE_SYNC = False
    wall = time.perf_counter() - t0
    shards = [op[3] for ops in hop_ops for op in ops]
    return dict(
        rank=dist.get_rank(), exchange=cfg.halo_exchange,
        local=cfg.halo_local, dtype=cfg.compute_dtype,
        num_bases=cfg.num_bases, epochs=cfg.epochs,
        control=zero_halo_on is not None,
        final_loss=res.final_loss, train_f1=res.train_f1, val_f1=res.val_f1,
        test_f1=res.test_f1, epoch_ms=epoch_ms, wall_s=wall,
        k1_launches=csr.SCATTER_LAUNCHES,
        k1_bf16_launches=csr.SCATTER_BF16_LAUNCHES,
        k1_expected=expected_k1(hop_ops, cfg.epochs),
        exchanges=halo.EXCHANGE_CALLS,
        exchange_ms=1e3 * halo.EXCHANGE_SECONDS / max(halo.EXCHANGE_CALLS, 1),
        exchange_ms_per_epoch=1e3 * halo.EXCHANGE_SECONDS / cfg.epochs,
        halo_rows=[s.halo for s in shards],
        rows_sent=[int(s.send_idx.numel()) for s in shards],
        params=host_params(res.params))


def bf16_config(epochs: int, **kw) -> MPGNNConfig:
    return MPGNNConfig(epochs=epochs, hidden_dim=HIDDEN, dropout=0.0,
                       halo_local="csr", compute_dtype="bfloat16",
                       num_bases=2, **kw)


def halo_train_rank(device, epochs: int, bf16_epochs: int) -> dict:
    """Phase 10 (b) on each rank: the planted graph trained node-sharded
    with each exchange, csr local, float32; one short bf16 run with
    ``num_bases=2``; and the control, 'a2a' with the last rank's halo
    zeroed."""
    graph, split = planted_graph()
    mesh = make_mesh((dist.get_world_size(),), ("nodes",), device=device)
    runs = []
    for exchange in halo.EXCHANGES:
        cfg = MPGNNConfig(epochs=epochs, hidden_dim=HIDDEN, dropout=0.0,
                          halo_exchange=exchange, halo_local="csr")
        runs.append(halo_run(graph, split, mesh, cfg))
    runs.append(halo_run(graph, split, mesh, bf16_config(bf16_epochs)))
    cfg = MPGNNConfig(epochs=epochs, hidden_dim=HIDDEN, dropout=0.0,
                      halo_local="csr")
    runs.append(halo_run(graph, split, mesh, cfg,
                         zero_halo_on=dist.get_world_size() - 1))
    return {"runs": runs}


def world1_rank(device, epochs: int, bf16_epochs: int) -> dict:
    """Phase 10 (b)'s NCCL run: a world of one rank (its halo empty), and
    the single-process runs from the same seed, in one process: csr
    float32 and bf16 with ``num_bases=2``, and segment float32, another
    order of the same sums, whose distance from csr is the noise floor."""
    graph, split = planted_graph()
    mesh = make_mesh((1,), ("nodes",), device=device)
    cfg = MPGNNConfig(epochs=epochs, hidden_dim=HIDDEN, dropout=0.0,
                      halo_local="csr")
    out = {"backend": dist.get_backend(), "halo": halo_run(graph, split,
                                                           mesh, cfg)}
    for key, c, backend in (("csr", cfg, "csr"),
                            ("csr_bf16", bf16_config(bf16_epochs), "csr"),
                            ("segment", cfg, "segment")):
        res, epoch_ms = timed_train(graph, split, c, backend)
        out[key] = dict(final_loss=res.final_loss, train_f1=res.train_f1,
                        val_f1=res.val_f1, test_f1=res.test_f1,
                        epoch_ms=epoch_ms, params=host_params(res.params))
    return out


def param_diff(a: dict, b: dict) -> float:
    """The largest absolute difference between two parameter sets."""
    return max(float((a[k] - b[k]).abs().max()) for k in b)


def sharded_elastic_rank(device, graph_files, metapaths, steps: int,
                         fault_step: int, elastic_steps: int, every: int,
                         ckpt_dir: str) -> dict:
    """Phase 10 (c) and (d) on each of 4 gloo ranks: ``steps`` of the
    sharded step on (data, model) = (2, 2), then ``train_elastic`` without
    a fault and with one at ``fault_step`` on every rank (4 -> 2 ranks)."""
    from mpgnn_tpu_torch.graph.io import load_dat_files

    graph, labels, _ = load_dat_files(*graph_files)
    split = split_nodes(labels)
    c = int(np.max(labels)) + 1
    cfg = MPGNNConfig(hidden_dim=HIDDEN, dropout=0.0)
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    step = build_sharded_train_step(mesh, graph, metapaths, split, c, cfg)
    out = {"sharded": [step() for _ in range(steps)]}
    del step
    fired = []

    def fault(k):
        if k == fault_step and not fired:
            fired.append(k)
            raise RuntimeError("injected card loss")

    for tag, hook in (("no_fault", None), ("fault", fault)):
        res = elastic.train_elastic(
            graph, metapaths, split, c, num_steps=elastic_steps,
            ckpt_path=f"{ckpt_dir}/{tag}.pt", cfg=cfg,
            checkpoint_every=every, fault_hook=hook, device=device)
        out[tag] = dict(losses=res.losses, steps_run=res.steps_run,
                        recoveries=res.recoveries,
                        final_device_count=res.final_device_count,
                        left=res.left)
        if res.left:
            break
    return out


def holds(run: dict, ref: dict) -> bool:
    """Whether a float32 node-sharded run holds to the single-process csr
    run ``ref`` within ``HALO_LOSS_RTOL``, ``HALO_F1_ATOL`` and
    ``HALO_PARAM_ATOL``."""
    return (abs(run["final_loss"] - ref["final_loss"])
            <= HALO_LOSS_RTOL * abs(ref["final_loss"])
            and all(abs(run[k] - ref[k]) <= HALO_F1_ATOL
                    for k in ("train_f1", "val_f1", "test_f1"))
            and run["param_max_abs_diff"] <= HALO_PARAM_ATOL)


def judge(ranks: List[dict], w1: dict) -> List[str]:
    """Hold phase 10 (b)'s runs (``halo_train_rank``'s on every rank,
    ``world1_rank``'s) to the single-process ones and return what failed.
    Each run's parameters give way to their largest distance from its
    reference's (``param_max_abs_diff``); the segment run's distance from
    csr is read, not held."""
    refs = {"float32": w1["csr"], "bfloat16": w1["csr_bf16"]}
    runs = [w1["halo"]] + [r for rk in ranks for r in rk["runs"]]
    for run in runs + [w1["segment"]]:
        run["param_max_abs_diff"] = param_diff(
            run.pop("params"), refs["bfloat16" if run.get("dtype") ==
                                    "bfloat16" else "float32"]["params"])
    for ref in refs.values():
        ref.pop("params")
    floor = w1["segment"]
    floor["loss_rel_diff"] = (abs(floor["final_loss"]
                                  - refs["float32"]["final_loss"])
                              / abs(refs["float32"]["final_loss"]))
    bad = []
    for run in runs:
        name = (f"halo rank {run['rank']} {run['exchange']} {run['dtype']}"
                + (" control" if run["control"] else ""))
        if not (run["k1_launches"] == run["k1_expected"]
                and run["k1_bf16_launches"] == 0):
            bad.append(f"{name}: K1 launched {run['k1_launches']} times "
                       f"({run['k1_bf16_launches']} bf16), its hops imply "
                       f"{run['k1_expected']}")
        if not np.isfinite(run["final_loss"]):
            bad.append(f"{name}: loss {run['final_loss']}")
        elif run["control"]:
            run["holds"] = holds(run, refs["float32"])
            if run["holds"]:
                bad.append(f"{name}: holds to csr with its halo zeroed")
        elif run["dtype"] == "bfloat16":
            ref = refs["bfloat16"]
            if (abs(run["final_loss"] - ref["final_loss"])
                    > HALO_BF16_LOSS_RTOL * abs(ref["final_loss"])):
                bad.append(f"{name}: loss {run['final_loss']} against the "
                           f"single-process bf16 {ref['final_loss']}")
        elif not holds(run, refs["float32"]):
            bad.append(f"{name}: {run} against csr {refs['float32']}")
    for same in zip(*[rk["runs"] for rk in ranks]):
        if len({(r["final_loss"], r["val_f1"], r["param_max_abs_diff"])
                for r in same}) != 1:
            bad.append(f"the ranks disagree: {same}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_parallel: no CUDA device", file=sys.stderr)
        return 2
    backend = pick_backend("cuda", args.ranks)
    try:
        ranks = spawn_ranks(halo_train_rank, args.ranks, (args.epochs, 2),
                            backend=backend, device="cuda", timeout_s=900)
        single = spawn_ranks(world1_rank, 1, (args.epochs, 2),
                             backend="nccl", device="cuda", timeout_s=900)
    except RuntimeError:
        traceback.print_exc()
        return 1
    bad = judge(ranks, single[0])
    for b in bad:
        print(f"bench_parallel: {b}", file=sys.stderr)
    print(json.dumps({"card": card(), "cards": torch.cuda.device_count(),
                      "backend": backend, "nodes": NODES,
                      "avg_deg": AVG_DEG, "metapaths": METAPATHS,
                      "hidden": HIDDEN, "holds": not bad, "ranks": ranks,
                      "world1": single[0]}))
    return 1 if bad else 0

if __name__ == "__main__":
    sys.exit(main())
