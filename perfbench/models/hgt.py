"""HGT's training through the port: the graph handed to the program's
``HeteroGraph``, the node types beside it, and the program's own set-up,
``hgt_baseline.setup_hgt`` (the nodes numbered type by type, every
relation's square K1 forward built on the card, each layer's attention
operands derived from them, the last layer's at the train rows, Adam),
whose ``step`` is one ``train.loops.hgt_train_step`` an epoch."""

from __future__ import annotations

import numpy as np

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.hgt_baseline import setup_hgt
from mpgnn_tpu_torch.models.hgt import HgtNet
from mpgnn_tpu_torch.utils import prof
from perfbench import params as P
from perfbench.reference import hgt as ref


def param_spec(cfg: dict, feat_dim: int, classes: int) -> P.Spec:
    m = cfg["model"]
    d, heads = m["hidden_dim"], m["heads"]
    types, r = len(cfg["graph"]["node_types"]), len(m["relations"])
    dk = d // heads
    spec = [("inp_w", (types, feat_dim, d), "glorot"),
            ("inp_b", (types, d), "zeros")]
    for layer in range(m["layers"]):
        pre = f"layers.{layer}."
        for name in ("k", "q", "v", "a"):
            spec += [(f"{pre}{name}_w", (types, d, d), "glorot"),
                     (f"{pre}{name}_b", (types, d), "zeros")]
        spec += [(pre + "att", (r, heads, dk, dk), "glorot"),
                 (pre + "msg", (r, heads, dk, dk), "glorot"),
                 (pre + "mu", (r, heads), "linear_bias:1"),
                 (pre + "skip", (types,), "linear_bias:1")]
    spec += [("linear.weight", (classes, d), "linear"),
             ("linear.bias", (classes,), f"linear_bias:{d}")]
    return spec


def _relations(run, graph) -> list:
    """The configuration's relations, which have to be the graph's, in its
    order; HGT has no dropout and no class weights."""
    m = run.config["model"]
    if list(m["relations"]) != list(graph.relation_names):
        raise ValueError(f"HGT attends over every relation of the graph "
                         f"{graph.relation_names}, not {m['relations']}")
    if m["dropout"] != 0.0 or m["class_weights"] != "none":
        raise ValueError("the HGT cell has no dropout and no class weights")
    return list(range(graph.num_relations))


def _operand_build_s():
    """Host seconds so far of the program's span ``train.build_hop_arrays``
    (the build runs inside ``setup_hgt``); None if it has no such span."""
    s = getattr(prof, "spans", lambda: {})().get("train.build_hop_arrays")
    return s["host_s"] if s and s["calls"] else None


def build(run, graph, hetero, params0):
    """The program's ``HgtTraining`` from ``params0``: ``model``, ``opt``
    and ``step()``. ``run.info['attention']`` gives each layer's rows,
    edges and stacked source rows."""
    cfg, dev = run.config, run.device
    m = cfg["model"]
    _relations(run, graph)
    c = int(cfg["graph"]["num_classes"])
    model = HgtNet(graph.x.shape[1], m["hidden_dim"],
                   len(cfg["graph"]["node_types"]), graph.num_relations, c,
                   m["layers"], m["heads"], device=dev)
    model.load_state_dict(params0)
    tr = graph.split["train"]
    before = _operand_build_s()
    prog = setup_hgt(
        hetero, graph.x, graph.node_type, graph.labeled[tr],
        graph.labels[tr], c, m["layers"],
        MPGNNConfig(lr=m["lr"], weight_decay=m["weight_decay"],
                    hidden_dim=m["hidden_dim"]),
        heads=m["heads"], model=model, device=dev)
    after = _operand_build_s()
    if after is not None:
        run.spans["operand_build_s"] = after - (before or 0.0)
    run.info["attention"] = [
        {"layer": i, "rows": b.num_rows, "edges": b.num_edges,
         "stacked_sources": b.num_sources}
        for i, b in enumerate(prog.layer_blockings)]
    return prog


def reference(run, graph, params0, steps: int, precision: str,
              rows: float = 1.0) -> dict:
    """The plain reference's first ``steps`` steps from ``params0``, on
    the first ``rows`` share of the train rows (all but in a fault's
    reading)."""
    cfg = run.config
    m = cfg["model"]
    edges = {r: graph.rel_edges(r) for r in _relations(run, graph)}
    tr = graph.split["train"]
    tr = tr[:max(1, int(tr.numel() * rows))]
    return ref.train_steps(
        graph.x, graph.node_type, len(cfg["graph"]["node_types"]), edges,
        graph.num_relations, params0, m["layers"], m["heads"],
        graph.labeled[tr], graph.labels[tr], m["lr"], m["weight_decay"],
        steps, precision)


def epoch_work(run, graph):
    """The epoch's Work; each layer's attention shapes are left in
    ``run.shapes`` for the per-layer readers."""
    cfg = run.config
    m = cfg["model"]
    edges = {r: graph.rel_edges(r) for r in _relations(run, graph)}
    train_idx = graph.labeled[graph.split["train"]]
    full = ref.layer_shapes(edges, graph.num_nodes)
    shapes = [full] * (m["layers"] - 1) + [
        ref.layer_shapes(edges, graph.num_nodes, train_idx)]
    run.shapes = {"hidden": m["hidden_dim"], "heads": m["heads"],
                  "attention": shapes}
    c = int(cfg["graph"]["num_classes"])
    n_params = sum(int(np.prod(s)) for _, s, _ in param_spec(
        cfg, graph.x.shape[1], c))
    return ref.step_work(graph.num_nodes, graph.x.shape[1], m["hidden_dim"],
                         m["heads"], c, shapes, n_params)
