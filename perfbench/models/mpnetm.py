"""MPNetm training through the port: the graph handed to the program's
``HeteroGraph``, the hop operands of ``train.loops.build_hop_arrays``
(backend 'auto' resolved by ``resolve_backend`` as ``train_mpgnn`` does),
the hop-0 aggregation of ``precompute_first_hop``, ``make_optimizer`` and
one ``train.loops.train_step`` an epoch: ``fit_mpgnn``'s set-up and epoch,
the step its loop runs."""

from __future__ import annotations

import time

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.models.mpgnn import MPNetm, precompute_first_hop
from mpgnn_tpu_torch.ops import csr
from mpgnn_tpu_torch.train import loops
from perfbench import params as P
from perfbench.reference import mpnetm as ref
from perfbench.work import distinct


def param_spec(cfg: dict, feat_dim: int, classes: int) -> P.Spec:
    h = cfg["model"]["hidden_dim"]
    mps = cfg["model"]["metapaths"]
    spec = []
    for i, mp in enumerate(mps):
        for j in range(len(mp)):
            fin = feat_dim if j == 0 else h
            pre = f"convs.{i}.{j}."
            spec += [(pre + "weight", (fin, h), "glorot"),
                     (pre + "root", (fin, h), "glorot"),
                     (pre + "bias", (h,), "zeros")]
    k = len(mps) * h
    spec += [("fc1.weight", (h, k), "linear"),
             ("fc1.bias", (h,), f"linear_bias:{k}"),
             ("fc2.weight", (classes, h), "linear"),
             ("fc2.bias", (classes,), f"linear_bias:{h}")]
    return spec


class Program:
    """The program's objects of one run and its epoch, ``step()``."""

    def __init__(self, run, graph, hetero, params0):
        cfg, dev = run.config, run.device
        m = cfg["model"]
        self.metapaths = [[graph.relation_id(r) for r in mp]
                          for mp in m["metapaths"]]
        backend = loops.resolve_backend(
            m["backend"], hetero, self.metapaths,
            loops.auto_dense_budget_bytes(dev))
        self.dtype = getattr(torch, m["dtype"])
        self.mcfg = MPGNNConfig(lr=m["lr"], weight_decay=m["weight_decay"],
                                hidden_dim=m["hidden_dim"],
                                dropout=m["dropout"], backend=backend)
        t0 = time.perf_counter()
        self.hop_ops = loops.build_hop_arrays(
            hetero, self.metapaths, backend=backend, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run.spans["operand_build_s"] = time.perf_counter() - t0
        run.info["backend"] = backend
        run.info["hop_kernels"] = {
            cfg["model"]["metapaths"][i][j]:
                [type(b).__name__ for b in op[1:]
                 if isinstance(b, (csr.CsrBlocking, csr.DedupCsrBlocking))]
            for i, ops in enumerate(self.hop_ops) for j, op in enumerate(ops)}
        self.x = graph.x
        c = int(cfg["graph"]["num_classes"])
        self.model = MPNetm(graph.x.shape[1], m["hidden_dim"], c,
                            [len(mp) for mp in self.metapaths], device=dev)
        self.model.load_state_dict(params0)
        self.opt = loops.make_optimizer(self.model, self.mcfg)
        self.first = precompute_first_hop(self.x, self.hop_ops,
                                          self.dtype)
        tr = graph.split["train"]
        self.train_idx = graph.labeled[tr]
        self.train_y = graph.labels[tr]
        cw = loops.class_weights(self.train_y.cpu().numpy(), c, False)
        self.w = torch.as_tensor(cw, device=dev)[self.train_y]
        self.gen = torch.Generator(device=dev).manual_seed(run.drop_seed)

    def step(self) -> torch.Tensor:
        return loops.train_step(self.model, self.opt, self.x, self.hop_ops,
                                self.first, self.train_idx, self.train_y,
                                self.w, self.mcfg, self.gen, self.dtype)


def build(run, graph, hetero, params0) -> Program:
    return Program(run, graph, hetero, params0)


def reference(run, graph, params0, steps: int, precision: str,
              rows: float = 1.0) -> dict:
    """The plain reference's first ``steps`` steps from ``params0``, on
    the first ``rows`` share of the train rows (all but in a fault's
    reading)."""
    m = run.config["model"]
    mps = [[graph.relation_id(r) for r in mp] for mp in m["metapaths"]]
    edges = {r: graph.rel_edges(r) for mp in mps for r in mp}
    tr = graph.split["train"]
    tr = tr[:max(1, int(tr.numel() * rows))]
    train_y = graph.labels[tr]
    return ref.train_steps(
        graph.x, edges, mps, params0, graph.labeled[tr], train_y,
        torch.ones(train_y.numel(), device=graph.x.device), run.drop_seed,
        m["dropout"], m["lr"], m["weight_decay"], steps, precision)


def relation_shapes(graph, r: int) -> dict:
    s, d = graph.rel_edges(r)
    return {"edges": int(s.numel()), "rows": distinct(s), "cols": distinct(d)}


def epoch_work(run, graph):
    """The epoch's Work; the hop relations' shapes are left in
    ``run.shapes`` for the per-layer readers."""
    m = run.config["model"]
    mps = [[graph.relation_id(r) for r in mp] for mp in m["metapaths"]]
    shapes = {r: relation_shapes(graph, r) for mp in mps for r in mp}
    run.shapes = {"num_nodes": graph.num_nodes, "hidden": m["hidden_dim"],
                  "hops": [[shapes[r] for r in mp] for mp in mps]}
    n_params = sum(int(np.prod(s)) for _, s, _ in param_spec(
        run.config, graph.x.shape[1], run.config["graph"]["num_classes"]))
    return ref.step_work(graph.num_nodes, graph.x.shape[1], m["hidden_dim"],
                         run.config["graph"]["num_classes"],
                         int(graph.split["train"].numel()),
                         run.shapes["hops"], n_params)
