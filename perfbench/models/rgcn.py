"""The R-GCN baseline's training through the port: the graph handed to
the program's ``HeteroGraph`` and the program's own set-up,
``rgcn_baseline.setup_rgcn`` (backend 'auto' resolved by
``resolve_backend``, every relation's hop operand from
``build_hop_arrays``, layer 0's aggregations once, Adam, the balanced
class weights), whose ``step`` is one ``train.loops.rgcn_train_step`` an
epoch: what ``train_rgcn_baseline``'s loop runs."""

from __future__ import annotations

import numpy as np

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.models.mpgnn import RgcnNet
from mpgnn_tpu_torch.ops import csr
from mpgnn_tpu_torch.rgcn_baseline import setup_rgcn
from mpgnn_tpu_torch.utils import prof
from perfbench import params as P
from perfbench.reference import rgcn as ref


def param_spec(cfg: dict, feat_dim: int, classes: int) -> P.Spec:
    m = cfg["model"]
    r, h, o = len(m["relations"]), m["hidden_dim"], m["output_dim"]
    spec = []
    for name, fin, fout in (("conv1", feat_dim, h), ("conv2", h, o)):
        spec += [(f"{name}.weight", (r, fin, fout), "glorot"),
                 (f"{name}.root", (fin, fout), "glorot"),
                 (f"{name}.bias", (fout,), "zeros")]
    spec += [("linear.weight", (classes, o), "linear"),
             ("linear.bias", (classes,), f"linear_bias:{o}")]
    return spec


def _relations(run, graph) -> list:
    """The configuration's relations, which have to be the graph's, in its
    order: the ``Net`` runs over every relation of the graph, with no
    dropout and balanced class weights."""
    m = run.config["model"]
    if list(m["relations"]) != list(graph.relation_names):
        raise ValueError(f"the R-GCN runs over every relation of the graph "
                         f"{graph.relation_names}, not {m['relations']}")
    if m["dropout"] != 0.0 or m["class_weights"] != "balanced":
        raise ValueError("the R-GCN Net has no dropout and balanced class "
                         "weights")
    return list(range(graph.num_relations))


def _operand_build_s():
    """Host seconds so far of the program's hop-operand build, its span
    ``train.build_hop_arrays`` (the build runs inside ``setup_rgcn``, so
    the harness reads the program's own clock around it); None if the
    program has no such span."""
    s = getattr(prof, "spans", lambda: {})().get("train.build_hop_arrays")
    return s["host_s"] if s and s["calls"] else None


def build(run, graph, hetero, params0):
    """The program's ``RgcnTraining`` from ``params0``: ``model``,
    ``opt`` and ``step()``."""
    cfg, dev = run.config, run.device
    m = cfg["model"]
    _relations(run, graph)
    c = int(cfg["graph"]["num_classes"])
    model = RgcnNet(graph.x.shape[1], m["hidden_dim"], graph.num_relations,
                    m["output_dim"], c, device=dev)
    model.load_state_dict(params0)
    tr = graph.split["train"]
    before = _operand_build_s()
    prog = setup_rgcn(
        hetero, graph.x, graph.labeled[tr], graph.labels[tr], c,
        m["layers"], MPGNNConfig(lr=m["lr"], weight_decay=m["weight_decay"],
                                 hidden_dim=m["hidden_dim"]),
        backend=m["backend"], model=model, device=dev)
    after = _operand_build_s()
    if after is not None:
        run.spans["operand_build_s"] = after - (before or 0.0)
    run.info["backend"] = prog.backend
    run.info["hop_kernels"] = {
        name: [type(b).__name__ for b in op[1:]
               if isinstance(b, (csr.CsrBlocking, csr.DedupCsrBlocking))]
        for name, op in zip(graph.relation_names, prog.rel_ops)
        if op is not None}
    return prog


def reference(run, graph, params0, steps: int, precision: str,
              rows: float = 1.0) -> dict:
    """The plain reference's first ``steps`` steps from ``params0``, on
    the first ``rows`` share of the train rows (all but in a fault's
    reading)."""
    m = run.config["model"]
    edges = {r: graph.rel_edges(r) for r in _relations(run, graph)}
    tr = graph.split["train"]
    tr = tr[:max(1, int(tr.numel() * rows))]
    return ref.train_steps(
        graph.x, edges, params0, m["layers"], graph.labeled[tr],
        graph.labels[tr], int(run.config["graph"]["num_classes"]), m["lr"],
        m["weight_decay"], steps, precision)


def epoch_work(run, graph):
    """The epoch's Work; the relations' shapes are left in ``run.shapes``
    for the per-layer readers."""
    m = run.config["model"]
    edges = {r: graph.rel_edges(r) for r in _relations(run, graph)}
    train_idx = graph.labeled[graph.split["train"]]
    shapes, tail = ref.epoch_shapes(edges, graph.num_nodes, train_idx)
    run.shapes = {"num_nodes": graph.num_nodes, "hidden": m["hidden_dim"],
                  "output": m["output_dim"], "layers": m["layers"],
                  "relations": shapes}
    c = int(run.config["graph"]["num_classes"])
    n_params = sum(int(np.prod(s)) for _, s, _ in param_spec(
        run.config, graph.x.shape[1], c))
    return ref.step_work(graph.num_nodes, graph.x.shape[1], m["hidden_dim"],
                         m["output_dim"], c, m["layers"],
                         int(train_idx.numel()), shapes, tail, n_params)
