"""Main CLI: the full metapath search over a dataset, on one GPU or over
ranks (``--mesh``).

Counterpart of ``python -m mpgnn_tpu.run`` (the reference's ``main.py``
argparse and ``main(args)``, main.py:1191-1508), with the same flags:

    python -m mpgnn_tpu_torch.run --hidden_dim 64 --dataset synthetic \\
        --folder data/synthetic_multiclass --node_file node.dat \\
        --link_file link.dat --label_file label.dat

``--backend`` defaults to ``auto``, as the JAX CLI's: each ``train_mpgnn``
(the greedy stage) takes 'dense' where its adjacencies fit the card's
budget, else 'csr' (K1/K2) from ``train.loops.CSR_EDGE_CUTOVER`` edges in
a relation, else 'segment', and the batched final evaluation routes each
length group to 'csr' or 'segment' by the same cutover
(``train.loops.resolve_backend``, ``train.batch_eval.resolve_eval_backend``).

``--mesh SPEC`` fans the search out over ranks, the reference's ``mpiexec
-n 10`` (run.sh:32): each rank computes its slice of every sweep's batch
(``parallel.context``) and all take the same decisions; only rank 0
prints the summary and writes checkpoints, models and the ``--trace_dir``
trace, and rank r > 0 keeps its frontier in
``<--frontier>.class<i>.pkl.rank<r>``. One command starts the ranks, as
the JAX CLI's ``--mesh`` runs from one command:

    python -m mpgnn_tpu_torch.run --mesh 2 --retries 1 ...

Started so (no ``WORLD_SIZE`` in its environment), the command is a
launcher: it starts the spec's product of ranks on this host, each a child
``python -m mpgnn_tpu_torch.run`` with the same flags and torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, a free ``MASTER_PORT``), kills them all at once when one
fails or the launcher is stopped (SIGTERM, SIGHUP, Ctrl-C), and with
``--retries R`` starts them all again, up to R times
(``--frontier`` and ``--pickle_filename`` make each attempt resume). Under
torchrun (``torchrun --nproc_per_node 2 -m mpgnn_tpu_torch.run --mesh 2
...``) the ranks are torchrun's and ``--retries`` is refused: torchrun's
``--max-restarts`` restarts them. Each rank works on ``cuda:LOCAL_RANK``
(modulo the cards present); the collectives run on NCCL where each rank
has a card of its own, else on gloo, which also serves several ranks on
one card (``parallel.mesh.pick_backend``; the choice is logged).

Differences from the JAX CLI:
* ``--device`` (default ``cuda``) picks the device; ``--platform cpu`` is
  its alias, so the JAX command lines run unchanged;
* ``--mesh`` spans processes (ranks), not one process's devices;
* refused: ``--dropout_rng threefry|rbg``: the port draws dropout masks
  from a ``torch.Generator`` only ("What the port does not inherit"), and
  ``--retries`` with ``--mesh`` under torchrun;
* the warmer (``utils.warm``, off with ``--no_warm``) compiles nothing
  ahead: before the graph loads, it starts the device's first calls on a
  thread of its own (the context, the kernel libraries' load and build,
  a K1 launch, cuBLAS, autograd, the first ``torch.optim`` step's
  ``torch._dynamo`` import), and the search warms each sweep form and a
  length group's batched evaluation once, where the JAX engine warms;
* ``--trace_dir DIR`` writes one ``torch.profiler`` Chrome trace JSON a
  class into DIR (``utils.prof.device_trace``), where the JAX CLI writes a
  ``jax.profiler`` trace. Beside each trace, ``spans-<pid>-<ns>.json``
  holds the program's spans since the process started, as they stand
  when the class's trace ends (``utils.prof.spans``: calls, host seconds,
  traced calls and seconds, device seconds and the enclosing span of
  each), such as the graph load's ``graph.hetero``, the sweep's
  ``score.operands``, ``score.upload``, ``score.epochs`` and
  ``score.gather``, and the MPNetm runs' ``train.build_hop_arrays`` and
  ``train_step.*``; each span timed during the trace is a
  ``user_annotation`` range of its name in it.

``--dataset DBLP|IMDB|ACM`` reads the pre-split ``labels_{train,val,test}
.dat`` of ``--folder`` (``graph.io.load_acm_style``) and trains on that
split; ``--label_file`` is not read for them.

Stdout ends with one JSON line: ``dataset``, ``classes.{i: {metapaths,
test_f1}}``, ``wall_s``; logs go to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional

import numpy as np

ACM_STYLE_DATASETS = ("DBLP", "IMDB", "ACM")
# seconds between a failed attempt and the next
RETRY_PAUSE_S = 10.0


def _supervise(args, argv, ranks: Optional[int] = None) -> int:
    """Run the search in a child process (``ranks`` None) or as ``ranks``
    child processes, one rank each of ``--mesh`` (``_run_ranks``), and
    start it again on failure, up to ``--retries`` times; with
    ``--frontier`` and ``--pickle_filename`` each restart resumes instead of
    recomputing. Returns the last attempt's exit code."""
    base = list(sys.argv[1:] if argv is None else argv)
    child_args = []
    skip = False
    for a in base:
        if skip:
            skip = False
            continue
        if a == "--retries":
            skip = True
            continue
        if a.startswith("--retries="):
            continue
        child_args.append(a)
    cmd = [sys.executable, "-m", "mpgnn_tpu_torch.run"] + child_args
    rc = 1
    with _exit_on_hangup():
        for attempt in range(1, args.retries + 2):
            rc = (subprocess.call(cmd) if ranks is None
                  else _run_ranks(cmd, ranks))
            if rc == 0:
                return 0
            print(
                f"[supervisor] attempt {attempt} exited rc={rc}"
                + ("; retrying (checkpoints resume the search)"
                   if attempt <= args.retries else "; giving up"),
                file=sys.stderr, flush=True,
            )
            if attempt <= args.retries:
                time.sleep(RETRY_PAUSE_S)
    return rc


@contextlib.contextmanager
def _exit_on_hangup():
    """Within it, SIGTERM and SIGHUP (a ``timeout``, a scheduler's or a
    closed terminal's stop) raise SystemExit(128 + signal), so that the
    children are killed on the way out (``_run_ranks``' ``finally``,
    ``subprocess.call``'s kill on an exception) instead of outliving their
    supervisor. Only the main thread takes signals: elsewhere it does
    nothing."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _exit(signum, frame):
        raise SystemExit(128 + signum)

    old = {sig: signal.signal(sig, _exit)
           for sig in (signal.SIGTERM, signal.SIGHUP)}
    try:
        yield
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(cmd: List[str], world: int) -> int:
    """Run ``cmd`` as ranks 0 .. world - 1 of one process group on this
    host, with the environment torchrun gives its ranks and a fresh
    rendezvous port; they share this process's stdout and stderr. When a
    rank exits non-zero, kill the others at once (a collective would wait
    on the lost rank until its process group's timeout). Returns the first
    non-zero exit code seen, else 0."""
    port = _free_port()
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(cmd, env=env))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def _mesh_ranks(spec: str) -> int:
    """The rank count a ``--mesh`` spec names: the product of its sizes,
    every one given."""
    from mpgnn_tpu_torch.parallel.context import parse_mesh_spec

    sizes = [int(p.split("=")[-1]) for p in spec.split(",") if p.strip()]
    if not sizes or min(sizes) < 1:
        raise ValueError(f"mesh spec {spec!r}: a launch needs every size, "
                         f"each at least 1 (-1 only under torchrun)")
    world = int(np.prod(sizes))
    parse_mesh_spec(spec, world)
    return world


def _under_torchrun() -> bool:
    """Whether this process is a rank already (torchrun's, the launcher's,
    or a caller's process group)."""
    import torch.distributed as dist

    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def build_argparser() -> argparse.ArgumentParser:
    # the flag set of mpgnn_tpu.run (main.py:1489-1506 and its extensions)
    p = argparse.ArgumentParser(description="learning meta-paths (PyTorch, "
                                            "one GPU)")
    p.add_argument("--hidden_dim", type=int, required=True,
                   help="hidden dimension")
    p.add_argument("--dataset", type=str, required=True,
                   help="synthetic | fb15k-237 | DBLP | IMDB | ACM")
    p.add_argument("--folder", type=str, required=True, help="dataset folder")
    p.add_argument("--node_file", type=str, required=True)
    p.add_argument("--link_file", type=str, required=True)
    p.add_argument("--label_file", type=str, required=True)
    p.add_argument("--relations_legend_file", type=str, required=False)
    p.add_argument("--pickle_filename", type=str, required=False,
                   help="per-class search-result checkpoint (JSON; resume "
                        "supported)")
    p.add_argument("--epochs", type=int, default=1000,
                   help="MPNetm evaluation epochs")
    p.add_argument("--max_hops", type=int, default=3, help="extension hops")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "segment", "ell", "ell2", "dense",
                            "pallas", "onehot", "csr"],
                   help="MPNetm aggregation backend; 'auto' picks dense "
                        "where the relations' adjacencies fit the card's "
                        "budget, else csr (the CUDA kernels K1/K2) from "
                        "train.loops.CSR_EDGE_CUTOVER edges in a relation, "
                        "else segment")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--platform", type=str, default=None,
                   help="alias of --device for the JAX command lines: cpu "
                        "or gpu")
    p.add_argument("--mesh", type=str, default=None,
                   help="fan the sweeps out over ranks: '2', 'rel=2' or "
                        "'data=2,model=2' (the batch axes are split over "
                        "every rank); without torchrun this command starts "
                        "the spec's product of ranks itself")
    p.add_argument("--save_model", type=str, default=None,
                   help="directory to save the final joint model's "
                        "parameters per class (params.pt)")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler trace (Chrome JSON) of each "
                        "class's search into this directory")
    p.add_argument("--no_warm", action="store_true",
                   help="disable the background first-call warmer "
                        "(utils/warm.py)")
    p.add_argument("--bag_gap_inclusive", action="store_true",
                   help="use the hop-0-style <= gap cut at bag hops too")
    p.add_argument("--retries", type=int, default=0,
                   help="supervise the search in a subprocess (with --mesh, "
                        "its ranks) and restart it up to this many times on "
                        "failure; combine with --frontier and "
                        "--pickle_filename to resume")
    p.add_argument("--frontier", type=str, default=None,
                   help="frontier-checkpoint path prefix: each class's "
                        "search saves its frontier to <prefix>.class<i>.pkl "
                        "and resumes mid-search after a crash")
    p.add_argument("--max_extensions_per_state", type=int, default=None,
                   help="bounded-frontier beam: keep at most this many "
                        "lowest-loss gap-cut survivors per state")
    p.add_argument("--top_k_final", type=int, default=3,
                   help="how many top-val-F1 metapaths enter the greedy "
                        "test accumulation (reference: 3, main.py:1465)")
    p.add_argument("--dropout_rng", type=str, default="auto",
                   choices=["auto", "threefry", "rbg"],
                   help="only auto is ported: dropout masks come from a "
                        "torch.Generator")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="MPNetm precision of the greedy stage and the "
                        "saved models (the batched final evaluation trains "
                        "in float32, as the JAX CLI's)")
    return p


def _refusals(args) -> list:
    """The flags and values the CLI refuses, each with its reason: a mesh
    spec that does not fit the ranks, ``--retries`` with ``--mesh`` under
    torchrun, and what the port does not inherit."""
    out = []
    if args.mesh and _under_torchrun():
        import torch.distributed as dist

        from mpgnn_tpu_torch.parallel.context import parse_mesh_spec

        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ["WORLD_SIZE"]))
        try:
            parse_mesh_spec(args.mesh, world)
        except ValueError as e:
            out.append(f"--mesh: {e} started by torchrun")
        if args.retries:
            out.append("--retries does not supervise torchrun's ranks: "
                       "give torchrun --max-restarts, or start --mesh "
                       "without torchrun")
    elif args.mesh:
        try:
            _mesh_ranks(args.mesh)
        except ValueError as e:
            out.append(f"--mesh: {e}")
    if args.dropout_rng != "auto":
        out.append(f"dropout_rng {args.dropout_rng!r} is not ported: dropout "
                   f"masks come from a torch.Generator (ROADMAP.md, 'What "
                   f"the port does not inherit')")
    return out


def _join_mesh(args, device):
    """Join the ranks' process group from torchrun's environment (set by
    torchrun or by the launcher; unless the caller already has a group),
    install the sweep mesh of ``--mesh`` and return (this rank's device,
    its rank, whether this call joined the group)."""
    import torch
    import torch.distributed as dist

    from mpgnn_tpu_torch.parallel.context import mesh_from_spec, \
        set_sweep_mesh
    from mpgnn_tpu_torch.parallel.mesh import initialize_distributed, \
        pick_backend

    joined = not dist.is_initialized()
    if joined:
        backend = pick_backend(device, int(os.environ.get(
            "LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1))))
        device = initialize_distributed(backend, device=device.type)
    elif device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_from_spec(args.mesh, device=device)
    set_sweep_mesh(mesh)
    logging.info("sweep mesh active: %s over %d ranks (%s, %s)", mesh.shape,
                 mesh.size, dist.get_backend(), device)
    return device, dist.get_rank(), joined


def _device(args) -> str:
    if args.platform is None:
        return args.device
    if args.platform in ("cpu", "gpu", "cuda"):
        return "cpu" if args.platform == "cpu" else "cuda"
    raise SystemExit(f"--platform {args.platform!r}: expected cpu or gpu")


def main(argv=None):
    ap = build_argparser()
    args = ap.parse_args(argv)
    refused = _refusals(args)
    if refused:
        ap.error("; ".join(refused))
    if args.mesh and not _under_torchrun():
        return _supervise(args, argv, ranks=_mesh_ranks(args.mesh))
    if args.retries > 0:
        return _supervise(args, argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(message)s",
        stream=sys.stderr,
    )
    from mpgnn_tpu_torch.device import resolve_device
    from mpgnn_tpu_torch.utils.warm import get_warmer

    device = resolve_device(_device(args))
    rank, joined = 0, False
    if args.mesh:
        device, rank, joined = _join_mesh(args, device)
    # the device's first calls on a thread of their own, so that they
    # overlap the graph's load and the first sweeps
    warmer = get_warmer(enabled=not args.no_warm)
    if warmer is not None:
        warmer.poke_device(device)
    try:
        return _search(args, device, rank, joined, warmer)
    finally:
        if warmer is not None:
            warmer.shutdown()


def _search(args, device, rank: int, joined: bool, warmer):
    """Load the dataset, search every class and print the summary (rank
    0), as ``main`` set it up."""
    from mpgnn_tpu_torch.config import MPGNNConfig, SearchConfig
    from mpgnn_tpu_torch.graph.io import (
        load_acm_style,
        load_dat_files,
        load_fb15k237,
        mask_label_leak,
        split_nodes,
    )
    from mpgnn_tpu_torch.search import find_metapaths
    from mpgnn_tpu_torch.utils.checkpoint import SearchCheckpoint
    from mpgnn_tpu_torch.utils.prof import device_trace

    t_start = time.time()
    folder = args.folder.rstrip("/") + "/"
    node_f = folder + args.node_file
    link_f = folder + args.link_file
    label_f = folder + args.label_file

    source_nodes = None
    presplit = None
    if args.dataset == "fb15k-237":
        graph, labels, binary_labels, source_nodes = load_fb15k237(
            node_f, link_f, label_f
        )
    elif args.dataset in ACM_STYLE_DATASETS:
        graph, presplit, binary_labels = load_acm_style(node_f, link_f,
                                                        folder)
        labels = presplit.labels
        source_nodes = presplit.sources.tolist()
    else:
        graph, labels, binary_labels = load_dat_files(node_f, link_f, label_f)

    cfg = SearchConfig(
        max_extension_hops=args.max_hops,
        bag_gap_inclusive=args.bag_gap_inclusive,
        max_extensions_per_state=args.max_extensions_per_state,
        top_k_final=args.top_k_final,
        mpgnn=MPGNNConfig(epochs=args.epochs, hidden_dim=args.hidden_dim,
                          compute_dtype=args.compute_dtype,
                          backend=args.backend,
                          dropout_rng=args.dropout_rng),
    )
    ckpt = SearchCheckpoint(args.pickle_filename) if args.pickle_filename else None
    # under --mesh every rank resumes from a frontier file of its own: with
    # one file, rank 0 could replace it before another rank had read the
    # state they both resume from. Rank 0 alone writes the trace.
    suffix = f".rank{rank}" if rank else ""
    trace_dir = None if rank else args.trace_dir

    results = {}
    for list_index, binary_lab in enumerate(binary_labels):
        # per-class split and label-leak masking (main.py:1214-1240);
        # ACM/DBLP/IMDB ship pre-split labels (main.py:96-113)
        if presplit is not None:
            split = presplit.as_split()
        else:
            split = split_nodes(labels, node_idx=source_nodes,
                                seed=cfg.split_seed)
        x = graph.x
        if args.dataset == "fb15k-237":
            x = mask_label_leak(graph.x, split)
        # one output a label id: the JAX CLI takes the count of distinct
        # labels, which on ids with gaps (fb15k-237-continent's 0, 1, 3, 6)
        # leaves labels past the last output, where its NLL gathers NaN
        num_classes = int(np.max(labels)) + 1

        if ckpt and ckpt.has(list_index):
            results[list_index] = ckpt.load(list_index)
            logging.info("class %d restored from checkpoint", list_index)
            continue

        with device_trace(trace_dir):
            res = find_metapaths(
                graph,
                np.asarray(binary_lab, dtype=np.float32),
                split,
                num_classes=num_classes,
                config=cfg,
                dataset=args.dataset,
                source_nodes=source_nodes,
                x_features=x,
                seed=args.seed,
                frontier_checkpoint=(
                    f"{args.frontier}.class{list_index}.pkl{suffix}"
                    if args.frontier else None
                ),
                device=device,
                warmer=warmer,
            )
        results[list_index] = res
        if rank:
            continue
        if ckpt:
            ckpt.save(list_index, res)
        if args.save_model and res.metapaths:
            from mpgnn_tpu_torch.train.loops import train_mpgnn
            from mpgnn_tpu_torch.utils.checkpoint import save_params

            final = train_mpgnn(
                graph, res.metapaths, split, num_classes, cfg.mpgnn,
                seed=args.seed, x_override=x, device=device,
            )
            save_params(f"{args.save_model}/class_{list_index}", final.params)
            logging.info(
                "class %d final model saved (val F1 %.4f)",
                list_index, final.val_f1,
            )
        print(
            f"class {list_index}: final meta: {res.metapaths} "
            f"test acc: {res.test_f1:.4f}",
            flush=True,
        )

    if args.mesh:
        import torch.distributed as dist

        from mpgnn_tpu_torch.parallel.context import set_sweep_mesh

        set_sweep_mesh(None)
        if joined:
            dist.destroy_process_group()
    if rank:
        return results
    summary = {
        "dataset": args.dataset,
        "classes": {
            str(k): {"metapaths": v.metapaths, "test_f1": v.test_f1}
            for k, v in results.items()
        },
        "wall_s": round(time.time() - t_start, 1),
    }
    print(json.dumps(summary), flush=True)
    return results


if __name__ == "__main__":
    _out = main()
    sys.exit(_out if isinstance(_out, int) else 0)
