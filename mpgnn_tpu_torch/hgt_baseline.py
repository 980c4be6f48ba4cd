"""HGT (``models.hgt.HgtNet``) on one GPU: the set-up of a full-graph
training run and its epoch.

``setup_hgt`` numbers the nodes type by type once (each typed Linear is
then one product a type on contiguous rows), derives every layer's
attention operands on the device from the square K1 forward blockings of
the graph's relations (``attention_operands``: each built on the device
by ``ops.csr.build_csr_forward``, the forward that ``build_csr_blocking``
gives the R-GCN's row terms and MPNetm's hops, without their backward
blockings and routing, which attention never reads), the last layer's at
the train rows alone, and returns an ``HgtTraining`` whose ``step`` is
one ``train.loops.hgt_train_step``. The benchmark calls it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.models.hgt import HgtNet, init_hgt_net
from mpgnn_tpu_torch.ops.attention import (
    AttentionBlockings,
    attention_blockings,
)
from mpgnn_tpu_torch.ops.csr import build_csr_forward
from mpgnn_tpu_torch.train.loops import hgt_train_step, make_optimizer
from mpgnn_tpu_torch.utils.prof import span

log = logging.getLogger("mpgnn_tpu_torch.hgt_baseline")


def type_order(node_type, num_types: int, device):
    """(order [N]: the node of each new id, type by type and ascending
    within a type; relabel [N]: each node's new id; the types' new id
    ranges), on ``device``."""
    node_type = torch.as_tensor(node_type, device=device).long()
    order = torch.sort(node_type, stable=True).indices
    relabel = torch.empty_like(order)
    relabel[order] = torch.arange(order.numel(), device=device)
    counts = torch.bincount(node_type, minlength=num_types).tolist()
    return order, relabel, tuple(np.cumsum([0] + counts).tolist())


def attention_operands(graph: HeteroGraph, relabel: torch.Tensor,
                       rows: torch.Tensor, device):
    """(every row's ``AttentionBlockings``, the train rows' ``rows``) of
    the relations of ``graph`` with edges, in the new ids ``relabel``,
    from their square K1 forwards built on ``device``. Each derivation is
    timed as a call of the span ``train.build_hop_arrays``; each layer's
    rows and edges are logged."""
    present = graph.present_relations()
    if not present:
        raise ValueError("HGT attends over edges: the graph has none")
    with span("train.build_hop_arrays"):
        fwds = [build_csr_forward(*graph.rel_edges(r), graph.num_nodes,
                                  device) for r in present]
        blk = attention_blockings(present, fwds, relabel)
    with span("train.build_hop_arrays"):
        tail = attention_blockings(present, fwds, relabel, rows)
    for name, b in (("every layer but the last", blk),
                    ("the last layer", tail)):
        log.info("hgt: %s attends %d rows over %d edges from %d stacked "
                 "source rows", name, b.num_rows, b.num_edges,
                 b.num_sources)
    return blk, tail


def row_types(offsets, rows: torch.Tensor):
    """The types' ranges among ``rows`` (ascending new ids)."""
    cut = torch.searchsorted(rows, torch.tensor(offsets, device=rows.device))
    return tuple(cut.tolist())


@dataclasses.dataclass
class HgtTraining:
    """One HGT run's objects on the device, and its epoch. Nodes are in
    the types' order (``order[i]`` is new id i's node in the caller's
    graph, ``relabel`` the inverse); ``tail`` is the last layer's
    blockings at the train rows, ascending new ids, whose labels
    ``train_y`` follow that order."""

    model: HgtNet
    opt: torch.optim.Optimizer
    x: torch.Tensor
    blk: AttentionBlockings
    tail: AttentionBlockings
    offsets: tuple
    tail_offsets: tuple
    order: torch.Tensor
    relabel: torch.Tensor
    train_y: torch.Tensor
    w: torch.Tensor

    @property
    def layer_blockings(self) -> List[AttentionBlockings]:
        """Each layer's blockings in a training step."""
        n = len(self.model.layers)
        return [self.blk] * (n - 1) + [self.tail]

    def step(self) -> torch.Tensor:
        """One epoch's step; returns its loss."""
        return hgt_train_step(self.model, self.opt, self.x,
                              self.layer_blockings, self.offsets,
                              self.tail_offsets, self.train_y, self.w)

    @torch.no_grad()
    def predict(self) -> torch.Tensor:
        """[N] predicted classes, in the caller's node ids."""
        logp = self.model(self.x, [self.blk] * len(self.model.layers),
                          self.offsets)
        return logp.argmax(dim=1)[self.relabel]


def setup_hgt(graph: HeteroGraph, x, node_type, train_idx, train_y,
              num_classes: int, layers: int = 3,
              cfg: Optional[MPGNNConfig] = None, heads: int = 8,
              model: Optional[HgtNet] = None, device=None) -> HgtTraining:
    """An ``HgtTraining`` of ``graph`` on ``device`` (the GPU unless
    ``device='cpu'``). ``x`` [N, F] float32 and ``node_type`` [N] (types
    0 .. num_types - 1) are in the graph's node ids, as are
    ``train_idx`` and ``train_y``. The model: ``model`` (moved to
    ``device``), or ``init_hgt_net``'s draw with hidden width
    ``cfg.hidden_dim``; Adam from ``make_optimizer(model, cfg)``. The
    NLL is the unweighted mean over the train rows. The layers' blockings
    are ``attention_operands``'."""
    cfg = cfg or MPGNNConfig()
    device = resolve_device(device)
    node_type = torch.as_tensor(node_type, device=device)
    num_types = (model.inp_w.shape[0] if model is not None
                 else int(node_type.max()) + 1)
    order, relabel, offsets = type_order(node_type, num_types, device)
    rows, pos = torch.sort(relabel[torch.as_tensor(train_idx,
                                                   device=device).long()])
    blk, tail = attention_operands(graph, relabel, rows, device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)[order]
    if model is None:
        model = init_hgt_net(
            x.shape[1], cfg.hidden_dim, num_types, graph.num_relations,
            num_classes, layers, heads, device=device)
    model = model.to(device)
    opt = make_optimizer(model, cfg)
    y = torch.as_tensor(train_y, device=device)[pos]
    return HgtTraining(
        model=model, opt=opt, x=x, blk=blk, tail=tail, offsets=offsets,
        tail_offsets=row_types(offsets, rows), order=order,
        relabel=relabel, train_y=y,
        w=torch.ones(y.numel(), device=device))
