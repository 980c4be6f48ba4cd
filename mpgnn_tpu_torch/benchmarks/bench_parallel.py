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

    python -m mpgnn_tpu_torch.benchmarks.bench_parallel --elastic

runs ``train_elastic`` on 4 ranks instead, over ``data/synthetic_multiclass``
and its metapaths ``SYNTH_PATHS`` (NCCL where the machine has 4 cards, else
gloo ranks sharing them): without a fault, with one (4 -> 2 ranks) and with
two (4 -> 2 -> 1), each held to the unfaulted run (``judge_elastic``; exit
1 where one does not hold), and the seconds its meshes take to build
(``mesh_setup_s``), one JSON line.

It also holds what ``chip_smoke.py`` and the tests share to check the
search CLI's own rank launcher (``run.py --mesh`` without torchrun):
``RANK_SITE``, a sitecustomize for the launched ranks, and
``run_session``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path
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
from mpgnn_tpu_torch.utils.prof import reset_spans, spans

HIDDEN = 64
METAPATHS = [[0, 1]]
ROOT = Path(__file__).resolve().parents[2]
SYNTH = ROOT / "data" / "synthetic_multiclass"
SYNTH_PATHS = [[1, 0], [2, 3]]            # metapath.dat, metapath2.dat
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
    set up on its first collective), and the exchanges are timed (the
    span ``halo.exchange``) with ``halo.EXCHANGE_SYNC`` on."""
    hop_ops = loops.build_hop_arrays(
        graph, METAPATHS, backend="halo", mesh=mesh,
        halo_exchange=cfg.halo_exchange, halo_local=cfg.halo_local)
    x = halo.shard_graph_features(graph.x, mesh).requires_grad_()
    halo.halo_sharded_mean_aggregate(mesh, x, hop_ops[0][0][3]).sum() \
        .backward()
    torch.cuda.synchronize()
    csr.SCATTER_LAUNCHES = csr.SCATTER_BF16_LAUNCHES = 0
    reset_spans()
    halo.EXCHANGE_SYNC = True
    t0 = time.perf_counter()
    try:
        with halo_zeroed_on(zero_halo_on):
            res, epoch_ms = timed_train(graph, split, cfg, "halo", mesh)
    finally:
        halo.EXCHANGE_SYNC = False
    wall = time.perf_counter() - t0
    ex = spans().get("halo.exchange", {"calls": 0, "host_s": 0.0})
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
        exchanges=ex["calls"],
        exchange_ms=1e3 * ex["host_s"] / max(ex["calls"], 1),
        exchange_ms_per_epoch=1e3 * ex["host_s"] / cfg.epochs,
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


def mesh_setup_s(device) -> dict:
    """The seconds this rank spends building ``train_elastic``'s meshes
    over every rank of the default group, as it builds them: the run's
    own mesh, then apart those of every count it can shrink to
    (``elastic.shrink_counts``), which a run without a failure never
    uses. Each rank starts after a barrier."""
    world = dist.get_world_size()
    dist.barrier()
    t0 = time.perf_counter()
    make_mesh(None, ("data", "model"), list(range(world)), device)
    t1 = time.perf_counter()
    counts = elastic.shrink_counts(world)
    for n in counts:
        make_mesh(None, ("data", "model"), list(range(n)), device)
    t2 = time.perf_counter()
    dist.barrier()
    return dict(run_mesh_s=t1 - t0, shrink_meshes_s=t2 - t1,
                shrink_counts=counts)


def sharded_elastic_rank(device, graph_files, metapaths, steps: int,
                         fault_steps, elastic_steps: int, every: int,
                         ckpt_dir: str) -> dict:
    """Phase 10 (c) and (d) on each of 4 ranks: ``steps`` of the sharded
    step on (data, model) = (2, 2), ``train_elastic``'s meshes timed
    (``mesh_setup_s``), then ``train_elastic`` without a fault, with one
    at ``fault_steps[0]`` on every rank (4 -> 2 ranks) and with one at
    each of ``fault_steps`` (4 -> 2 -> 1). A rank that left a run takes
    part in the next."""
    from mpgnn_tpu_torch.graph.io import load_dat_files

    graph, labels, _ = load_dat_files(*graph_files)
    split = split_nodes(labels)
    c = int(np.max(labels)) + 1
    cfg = MPGNNConfig(hidden_dim=HIDDEN, dropout=0.0)
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    step = build_sharded_train_step(mesh, graph, metapaths, split, c, cfg)
    out = {"sharded": [step() for _ in range(steps)]}
    del step
    out["mesh_setup"] = mesh_setup_s(device)

    def faults(at):
        fired = set()

        def hook(k):
            if k in at and k not in fired:
                fired.add(k)
                raise RuntimeError(f"injected card loss at step {k}")
        return hook

    for tag, hook in (("no_fault", None), ("fault", faults(fault_steps[:1])),
                      ("twice", faults(fault_steps))):
        res = elastic.train_elastic(
            graph, metapaths, split, c, num_steps=elastic_steps,
            ckpt_path=f"{ckpt_dir}/{tag}.pt", cfg=cfg,
            checkpoint_every=every, fault_hook=hook, device=device)
        out[tag] = dict(losses=res.losses, steps_run=res.steps_run,
                        recoveries=res.recoveries,
                        final_device_count=res.final_device_count,
                        left=res.left)
    return out


# the elastic runs of sharded_elastic_rank: faults at ELASTIC_FAULTS
# (4 -> 2, then 2 -> 1), a checkpoint every ELASTIC_EVERY steps; a faulted
# run's losses against the unfaulted run's, resumed at each fault from the
# last checkpoint before it: float32 sums split over other ranks. Read:
# 1.1e-7 and 3.3e-7 relative at most on 4 gloo ranks of one H100, 1.5e-7
# and 2.2e-7 on 4 H100s over NCCL
ELASTIC_STEPS, ELASTIC_FAULTS, ELASTIC_EVERY = 12, (5, 9), 4
ELASTIC_LOSS_RTOL = 1e-5


def judge_elastic(ranks: List[dict]) -> tuple:
    """(what failed, a record a run) of ``sharded_elastic_rank``'s runs on
    4 ranks: "fault" recovers once onto 2 ranks (ranks 2 and 3 leave),
    "twice" twice, onto 1 (ranks 1-3 leave), each with every step run and
    its losses within ``ELASTIC_LOSS_RTOL`` of the unfaulted run's
    resumed at each fault."""
    base = ranks[0]["no_fault"]["losses"]
    failed, records = [], []
    for tag, faults, left in (
            ("fault", ELASTIC_FAULTS[:1], [False, False, True, True]),
            ("twice", ELASTIC_FAULTS, [False, True, True, True])):
        want, start = [], 0
        for k in faults:
            want += base[start:k]
            start = (k // ELASTIC_EVERY) * ELASTIC_EVERY
        want += base[start:]
        run = ranks[0][tag]
        rel = (max(abs(a - b) / abs(b) for a, b in zip(run["losses"], want))
               if len(run["losses"]) == len(want) else float("inf"))
        got_left = [r[tag]["left"] for r in ranks]
        records.append(dict(run=tag, faults=list(faults), fault=run,
                            max_rel_diff=rel, left=got_left))
        if not (run["recoveries"] == len(faults)
                and run["final_device_count"] == 4 >> len(faults)
                and run["steps_run"] == ELASTIC_STEPS and got_left == left
                and rel <= ELASTIC_LOSS_RTOL):
            failed.append(f"elastic run {tag} {run}, left {got_left}, "
                          f"against {want}")
    return failed, records


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


def mesh_setup_record(ranks: List[dict]) -> dict:
    """``sharded_elastic_rank``'s mesh timings over its ranks: the slowest
    rank's seconds for the run's mesh and for the shrink meshes."""
    setups = [r["mesh_setup"] for r in ranks]
    return dict(run_mesh_s=max(s["run_mesh_s"] for s in setups),
                shrink_meshes_s=max(s["shrink_meshes_s"] for s in setups),
                shrink_counts=setups[0]["shrink_counts"])


def elastic_main(backend: str) -> int:
    """``--elastic``: ``sharded_elastic_rank`` on 4 ranks of ``backend``
    over ``SYNTH``'s graph and ``SYNTH_PATHS``, judged by
    ``judge_elastic``; one JSON line."""
    import tempfile

    files = [str(SYNTH / f) for f in ("node.dat", "link.dat", "label.dat")]
    with tempfile.TemporaryDirectory() as ckpt:
        ranks = spawn_ranks(
            sharded_elastic_rank, 4,
            (files, SYNTH_PATHS, 2, ELASTIC_FAULTS, ELASTIC_STEPS,
             ELASTIC_EVERY, ckpt), backend=backend, device="cuda",
            timeout_s=900)
    bad, records = judge_elastic(ranks)
    for b in bad:
        print(f"bench_parallel: {b}", file=sys.stderr)
    print(json.dumps({"card": card(), "cards": torch.cuda.device_count(),
                      "backend": backend, "folder": str(SYNTH),
                      "holds": not bad, "elastic": records,
                      "mesh_setup": mesh_setup_record(ranks),
                      "sharded": ranks[0]["sharded"]}))
    return 1 if bad else 0


# The launcher's checks: a sitecustomize put on the launched ranks'
# PYTHONPATH, which acts at a rank's first import of the search engine (its
# process group is up by then). With MPGNN_FAIL_ONCE=<marker>, rank 1 exits
# with code 3, once (the marker file says it has); with
# MPGNN_HOLD_RANKS=<dir>, every rank writes its pid to <dir>/rank<r>.pid
# and sleeps, as a long search would run on. Then it hands over to the
# sitecustomize it shadows, if the interpreter has one.
RANK_SITE = """\
import importlib, os, sys, time

_marker = os.environ.get("MPGNN_FAIL_ONCE")
_hold = os.environ.get("MPGNN_HOLD_RANKS")
_rank = os.environ.get("RANK")
if _rank is not None and (_hold or (_marker and _rank == "1"
                                    and not os.path.exists(_marker))):
    class _AtEngine:
        def find_spec(self, name, path=None, target=None):
            if name == "mpgnn_tpu_torch.search.engine":
                if _hold:
                    with open(os.path.join(_hold, f"rank{_rank}.pid"),
                              "w") as f:
                        f.write(str(os.getpid()))
                    time.sleep(3600)
                else:
                    open(_marker, "w").close()
                    os._exit(3)
            return None

    sys.meta_path.insert(0, _AtEngine())

_here = os.path.dirname(os.path.abspath(__file__))
_path = sys.path[:]
sys.path[:] = [p for p in _path if os.path.abspath(p or os.curdir) != _here]
_me = sys.modules.pop("sitecustomize", None)
try:
    importlib.import_module("sitecustomize")
except ImportError:
    pass
finally:
    sys.path[:] = _path
    sys.modules["sitecustomize"] = _me
"""


def rank_site_env(site_dir: str, **modes: str) -> dict:
    """Write ``RANK_SITE`` into ``site_dir`` and return the environment
    that puts it first on a child's PYTHONPATH with ``modes``
    (``MPGNN_FAIL_ONCE=...``, ``MPGNN_HOLD_RANKS=...``)."""
    with open(os.path.join(site_dir, "sitecustomize.py"), "w") as f:
        f.write(RANK_SITE)
    return dict(PYTHONPATH=os.pathsep.join(
        [site_dir] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        **modes)


def run_session(cmd: List[str], env: dict, timeout: float,
                cwd=ROOT) -> tuple:
    """(exit code, stdout, stderr) of ``cmd`` run from ``cwd`` in a session
    of its own, whose every process (a launcher's ranks too) is killed if
    it outlives ``timeout`` seconds (then RuntimeError)."""
    p = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        raise RuntimeError(f"{cmd} outlived {timeout} s:\n{err[-3000:]}")
    return p.returncode, out, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--elastic", action="store_true",
                    help="instead of the halo runs: train_elastic on 4 "
                         "ranks over data/synthetic_multiclass, 4 -> 2 "
                         "and 4 -> 2 -> 1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_parallel: no CUDA device", file=sys.stderr)
        return 2
    if args.elastic:
        return elastic_main(pick_backend("cuda", 4))
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
