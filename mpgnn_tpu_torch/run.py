"""Main CLI: the full metapath search over a dataset, on one GPU.

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

``--mesh SPEC`` fans the search out over the ranks that ``torchrun``
starts, the reference's ``mpiexec -n 10`` (run.sh:32): each rank computes
its slice of every sweep's batch (``parallel.context``) and all take the
same decisions; only rank 0 prints the summary and writes checkpoints,
models and the ``--trace_dir`` trace, and rank r > 0 keeps its frontier
in ``<--frontier>.class<i>.pkl.rank<r>``:

    torchrun --nproc_per_node 2 -m mpgnn_tpu_torch.run --mesh 2 ...

Each rank works on ``cuda:LOCAL_RANK`` (modulo the cards present); the
collectives run on NCCL where each rank has a card of its own, else on
gloo, which also serves several ranks on one card
(``parallel.mesh.pick_backend``; the choice is logged).

Differences from the JAX CLI:
* ``--device`` (default ``cuda``) picks the device; ``--platform cpu`` is
  its alias, so the JAX command lines run unchanged;
* ``--mesh`` spans processes (torchrun's ranks), not one process's
  devices;
* refused: ``--dropout_rng threefry|rbg``: the port draws dropout masks
  from a ``torch.Generator`` only ("What the port does not inherit"), and
  ``--retries`` with ``--mesh``;
* the warmer (``utils.warm``, off with ``--no_warm``) compiles nothing
  ahead: before the graph loads, it starts the device's first calls on a
  thread of its own (the context, the kernel libraries' load and build,
  a K1 launch, cuBLAS, autograd, the first ``torch.optim`` step's
  ``torch._dynamo`` import), and the search warms each sweep form and a
  length group's batched evaluation once, where the JAX engine warms;
* ``--trace_dir DIR`` writes one ``torch.profiler`` Chrome trace JSON a
  class into DIR (``utils.prof.device_trace``), where the JAX CLI writes a
  ``jax.profiler`` trace.

``--dataset DBLP|IMDB|ACM`` reads the pre-split ``labels_{train,val,test}
.dat`` of ``--folder`` (``graph.io.load_acm_style``) and trains on that
split; ``--label_file`` is not read for them.

Stdout ends with one JSON line: ``dataset``, ``classes.{i: {metapaths,
test_f1}}``, ``wall_s``; logs go to stderr.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

ACM_STYLE_DATASETS = ("DBLP", "IMDB", "ACM")


def _supervise(args, argv) -> int:
    """Run the search in a child process and restart it on failure, up to
    ``--retries`` times; with ``--frontier`` and ``--pickle_filename`` each
    restart resumes instead of recomputing."""
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
    for attempt in range(1, args.retries + 2):
        rc = subprocess.call(cmd)
        if rc == 0:
            return 0
        print(
            f"[supervisor] attempt {attempt} exited rc={rc}"
            + ("; retrying (checkpoints resume the search)"
               if attempt <= args.retries else "; giving up"),
            file=sys.stderr, flush=True,
        )
        if attempt <= args.retries:
            time.sleep(10)
    return rc


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
                   help="fan the sweeps out over torchrun's ranks: '2', "
                        "'rel=2' or 'data=2,model=2' (the batch axes are "
                        "split over every rank)")
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
                   help="supervise the search in a subprocess and restart "
                        "it up to this many times on failure; combine with "
                        "--frontier and --pickle_filename to resume")
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
    spec that does not fit the ranks, ``--retries`` with ``--mesh``, and
    what the port does not inherit."""
    out = []
    if args.mesh:
        import torch.distributed as dist

        from mpgnn_tpu_torch.parallel.context import parse_mesh_spec

        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)))
        try:
            parse_mesh_spec(args.mesh, world)
        except ValueError as e:
            out.append(f"--mesh: {e} (start the ranks with torchrun)")
        if args.retries:
            out.append("--retries does not supervise --mesh ranks")
    if args.dropout_rng != "auto":
        out.append(f"dropout_rng {args.dropout_rng!r} is not ported: dropout "
                   f"masks come from a torch.Generator (ROADMAP.md, 'What "
                   f"the port does not inherit')")
    return out


def _join_mesh(args, device):
    """Join torchrun's process group (unless the caller already has one),
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
