"""Full-graph training epochs, closed loop, back to back.

Set-up makes the graph and the initial parameters from the seed, builds
the program's training step once (``perfbench/models/<model>.py``) and
drives that same object through its first steps: the reference follows
the first three. The window then runs the step for ``--seconds``; the
traced run profiles ``trace_steps`` more. After the window the program's
state is freed and the reference's three steps are compared with the
program's: each step's loss, each leaf's first gradient as Adam got it
(from its first moment after one step) and each leaf's change over the
three steps.

The configuration's ``model.dtype`` and ``model.tf32`` hold: TF32
products are switched as it says, and a program whose parameters are of
another type is refused. Set-up's phases go into the run's spans, each
the seconds since the process started: ``at_driver_s`` (imports, the
card's context), ``at_graph_s``, ``at_hetero_s``, ``at_program_s`` (the
program's objects and operands), then ``setup_s`` after the first
steps."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from perfbench import graphgen, harness, params as P
from perfbench.reference.common import leaf_gaps, moving_leaves


def hetero_graph(graph):
    """The program's ``HeteroGraph`` of the benchmark's graph (features
    stay on the device, where the step reads them)."""
    return HeteroGraph(np.zeros((graph.num_nodes, 0), np.float32),
                       graph.src.cpu().numpy(), graph.dst.cpu().numpy(),
                       graph.edge_type.cpu().numpy(),
                       num_relations=graph.num_relations)


def snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def first_moment_grads(opt, model, beta1: float) -> dict:
    """Each leaf's gradient as Adam took it in its first step: its first
    moment over (1 - beta1)."""
    return {k: opt.state[p]["exp_avg"] / (1.0 - beta1)
            for k, p in model.named_parameters()}


def run(r: harness.Run) -> None:
    dev, cfg, tr = r.device, r.config, r.traffic
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    def phase(name):
        sync()
        r.spans[name] = time.time() - r.t_start

    phase("at_driver_s")
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["model"]["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["model"]["tf32"])
    r.drop_seed = P.drop_seed(r.seed)
    graph = graphgen.generate(cfg["graph"], r.seed, dev)
    model_mod = harness.load_module("models", cfg["model"]["name"])
    spec = model_mod.param_spec(cfg, graph.x.shape[1],
                                int(cfg["graph"]["num_classes"]))
    params0 = P.make(spec, r.seed + 1, dev)
    phase("at_graph_s")
    hetero = hetero_graph(graph)
    r.info["edges"] = {n: int(c) for n, c in zip(graph.relation_names,
                                                 hetero.rel_counts)}
    phase("at_hetero_s")
    prog = model_mod.build(r, graph, hetero, params0)
    dtype = getattr(torch, cfg["model"]["dtype"])
    wrong = {p.dtype for p in prog.model.parameters()} - {dtype}
    if wrong:
        raise ValueError(f"the configuration states {dtype}; the program's "
                         f"parameters hold {sorted(map(str, wrong))}")
    phase("at_program_s")

    # the first steps: the ones the reference follows, then a warm-up
    losses = []
    for t in range(tr["checked_steps"]):
        losses.append(prog.step().detach())
        if t == 0:
            g1 = first_moment_grads(prog.opt, prog.model, 0.9)
            g1 = {k: float(v.norm()) for k, v in g1.items()}
    p3 = snapshot(prog.model)
    for _ in range(tr["warmup_steps"]):
        prog.step()
    sync()
    prog_losses = [float(x) for x in losses]
    delta = {k: float((p3[k] - params0[k]).norm()) for k in p3}
    del p3
    r.spans["setup_s"] = time.time() - r.t_start

    win = harness.timed_window(r.seconds, prog.step, dev)
    r.counters["epochs"] = win["count"]
    r.counters["epoch_s"] = win["seconds"] / win["count"]
    r.attempted = win["count"]
    if r.trace:
        def traced():
            for _ in range(tr["trace_steps"]):
                prog.step()
            sync()
            return tr["trace_steps"]
        r.trace_summary = harness.trace_window(traced)
        r.counters["trace_steps"] = tr["trace_steps"]
    r.counters["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)

    del prog, losses, hetero
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if r.trace:
        r.work = model_mod.epoch_work(r, graph)
    t0 = time.perf_counter()
    ref = model_mod.reference(r, graph, params0, tr["checked_steps"],
                              "float64")
    r.spans["reference_s"] = time.perf_counter() - t0
    compare(r, prog_losses, g1, delta, ref)


def gaps(losses, grad1, delta, ref) -> dict:
    """The three numbers a training cell compares: the widest relative
    gap of a step's loss, and over the moving leaves (``moving_leaves``)
    the widest gap of a leaf's first-gradient norm and of its change's
    norm after the checked steps (``leaf_gaps``)."""
    keep = moving_leaves(ref["grad1"])
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, ref["losses"])),
        "grad1_gap": max(leaf_gaps(grad1, ref["grad1"], keep).values()),
        "delta_gap": max(leaf_gaps(delta, ref["delta"], keep).values()),
        "left_out": sorted(set(ref["grad1"]) - set(keep)),
    }


def compare(r: harness.Run, losses, grad1, delta, ref) -> None:
    """Each of ``gaps`` that the configuration limits (``limits.train``)
    against its limit; the others go into the info line, read and not
    held."""
    lim = r.config["limits"]["train"]
    got = gaps(losses, grad1, delta, ref)
    r.info["leaves_left_out"] = got.pop("left_out")
    r.info["not_held"] = {k: v for k, v in got.items() if k not in lim}
    for name, limit in lim.items():
        r.check(name, got[name], limit)
