"""The plain RGCN baseline, on one GPU.

Counterpart of ``python -m mpgnn_tpu.rgcn_baseline`` (the reference's
``main_rgcn.py``): load a dataset, train the all-relations RGCN ``Net``
(model.py:132-149, ``models.mpgnn.RgcnNet``) for ``--epochs`` epochs of
Adam with a class-weighted NLL (main_rgcn.py:376-379: unlike the search,
the baseline weighs each class by n / (C * count)), report macro-F1.

    python -m mpgnn_tpu_torch.rgcn_baseline --folder <dir> --metapath_length 3

It runs on the GPU unless ``--device cpu`` (or its alias ``--platform
cpu``, for the JAX command lines) is given. It trains on the port's normal
path: each relation's term runs on the rows it reaches, on K1 blockings
derived from the csr hop operands MPNetm's hops use
(``train.loops.build_hop_arrays``, one relation a hop; ``rgcn_operands``),
and every epoch is one ``train.loops.rgcn_train_step``. ``setup_rgcn``
builds the run's objects; the benchmark calls it too.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.models.mpgnn import (
    RgcnNet,
    init_rgcn_net,
    precompute_rgcn_rows,
)
from mpgnn_tpu_torch.ops.csr import (
    CsrBlocking,
    RowTermBlockings,
    build_csr_blocking,
    row_term_blockings,
    row_term_tail,
)
from mpgnn_tpu_torch.train.loops import (
    build_hop_arrays,
    make_optimizer,
    rgcn_train_step,
    split_tensors,
)
from mpgnn_tpu_torch.train.metrics import macro_f1
from mpgnn_tpu_torch.utils.prof import span

log = logging.getLogger("mpgnn_tpu_torch.rgcn_baseline")


def balanced_class_weights(y: np.ndarray, num_classes: int) -> np.ndarray:
    """sklearn's 'balanced' weights n / (C * bincount), an empty class
    counted once (main_rgcn.py:376). A label id without nodes (a gap) is
    such a class: every weight then scales by the same factor, which the
    weighted mean of ``weighted_nll`` cancels."""
    counts = np.bincount(y, minlength=num_classes).astype(np.float64)
    counts[counts == 0] = 1.0
    return (len(y) / (num_classes * counts)).astype(np.float32)


def rgcn_operands(graph: HeteroGraph, device
                  ) -> Optional[RowTermBlockings]:
    """The ``ops.csr.RowTermBlockings`` of every relation of ``graph`` with
    edges, on ``device``; None for a graph without edges. Each relation's
    'csr' hop operand comes from ``build_hop_arrays`` of one-hop
    metapaths, so from the graph's operand cache (``relation_operand``)
    that MPNetm's hops share; its forward blocking is the relation's K1
    forward, or, where ``build_csr_blocking`` routed it to K2, the K1
    forward is built from the relation's edges. The row terms won at
    every reach share measured, up to every row
    (``RgcnNet``'s terms on each relation's rows against one stacked
    [N, 9F] product of the aggregations and h, at ogbn-mag's 1,939,743
    rows, 64 -> 64, float32, 8 relations of 5M edges, on an NVIDIA H100
    80GB HBM3 at 700.00 W, ms: each relation reaching 5% of the rows
    9.63 / 30.00, 25% 14.49 / 31.73, 50% 19.14 / 32.11, 75% 23.72 /
    32.25, 90% 26.92 / 32.30, every row 28.56 / 32.32: at every row they
    still skip the concatenation, its gradient's copies and the 9-way
    gradient sum), so the reach does not choose the path. The derivation
    is timed as a second call of the span ``train.build_hop_arrays``; each
    relation's |R_r| is logged."""
    present = graph.present_relations()
    hops = build_hop_arrays(graph, [[r] for r in present], backend="csr",
                            device=device)
    if not present:
        return None
    n = graph.num_nodes
    with span("train.build_hop_arrays"):
        fwds = [hop[0][1] if isinstance(hop[0][1], CsrBlocking)
                else build_csr_blocking(*graph.rel_edges(r), n,
                                        dedup="never")[0].to(device)
                for r, hop in zip(present, hops)]
        blk = row_term_blockings(present, fwds)
    o = blk.offsets
    for i, r in enumerate(blk.rels):
        log.info("rgcn baseline: relation %d: row terms on %d of %d rows "
                 "(%.1f%%)", r, o[i + 1] - o[i], n,
                 100.0 * (o[i + 1] - o[i]) / n)
    return blk


def rgcn_tail_operands(blk: Optional[RowTermBlockings], rows: torch.Tensor
                       ) -> Optional[RowTermBlockings]:
    """The last layer's blockings at the loss's ``rows`` alone
    (``ops.csr.row_term_tail`` of ``blk``); None where ``blk`` is. The
    derivation is timed as one more call of the span
    ``train.build_hop_arrays``; each relation's rows and edges there are
    logged."""
    if blk is None:
        return None
    # The cut won at every share of rows measured, so no share gates it:
    # one training step, all rows against the last layer at T random rows,
    # 3 layers 128 -> 64 -> 64 -> 64 on ogbn-mag's 1,939,743 nodes and 8
    # relations, float32, NVIDIA H100 80GB HBM3 at 700.00 W, ms: T at 5%
    # 43.94 / 28.08, 32.5% 48.42 / 36.91, 60% 52.70 / 45.09, 90% 57.53 /
    # 54.64, every row 59.21 / 57.82; the 629,571 train papers 48.38 /
    # 39.17.
    with span("train.build_hop_arrays"):
        tail = row_term_tail(blk, rows)
    o = tail.offsets
    ptr = tail.fwd.row_ptr[list(o)].tolist()
    for i, r in enumerate(tail.rels):
        log.info("rgcn baseline: relation %d: last layer on %d of %d rows, "
                 "%d edges", r, o[i + 1] - o[i], rows.numel(),
                 ptr[i + 1] - ptr[i])
    return tail


@dataclasses.dataclass
class RgcnTraining:
    """One RGCN baseline run's objects on the device, and its epoch."""

    model: RgcnNet
    opt: torch.optim.Optimizer
    x: torch.Tensor
    blk: Optional[RowTermBlockings]     # rgcn_operands
    first: Optional[torch.Tensor]       # precompute_rgcn_rows
    tail: Optional[RowTermBlockings]    # rgcn_tail_operands
    tail_first: Optional[torch.Tensor]  # tail's layer 0, when it is last
    metapath_length: int
    num_relations: int
    train_idx: torch.Tensor
    train_y: torch.Tensor
    w: torch.Tensor                # [T] class weights of the train rows
    # every relation's term runs on K1 blockings
    backend = "csr"

    @property
    def rel_ops(self) -> List[Optional[Tuple]]:
        """Per relation, None for a relation without edges, else
        ``('csr', blk.fwd, blk.bwd)``: the K1 blockings its term runs on,
        which all relations share (the benchmark names the kernels)."""
        rels = () if self.blk is None else self.blk.rels
        return [(self.backend, self.blk.fwd, self.blk.bwd) if r in rels
                else None for r in range(self.num_relations)]

    def step(self) -> torch.Tensor:
        """One epoch's step; returns its loss."""
        return rgcn_train_step(self.model, self.opt, self.x, self.blk,
                               self.first, self.metapath_length,
                               self.train_idx, self.train_y, self.w,
                               tail=self.tail, tail_first=self.tail_first)

    @torch.no_grad()
    def predict(self) -> torch.Tensor:
        """[N] predicted classes."""
        return self.model(self.x, self.blk, self.metapath_length,
                          first=self.first).argmax(dim=1)


def setup_rgcn(graph: HeteroGraph, x: torch.Tensor, train_idx: torch.Tensor,
               train_y: torch.Tensor, num_classes: int,
               metapath_length: int = 3, cfg: Optional[MPGNNConfig] = None,
               backend: str = "auto", model: Optional[RgcnNet] = None,
               seed: int = 10, device=None) -> RgcnTraining:
    """An ``RgcnTraining`` of ``graph``'s relations on ``device`` (the GPU
    unless ``device='cpu'``): the relations' row-term blockings
    (``rgcn_operands``), the model (drawn by ``init_rgcn_net`` from
    ``seed``, ``cfg.num_bases`` / ``cfg.num_blocks`` picking the
    decomposition, hidden and output widths ``cfg.hidden_dim``; or
    ``model``, moved to ``device``), Adam (``make_optimizer``), layer 0's
    aggregations and the balanced class weights of ``train_y``. ``x`` is
    the [N, F] float32 features, on ``device`` or copied there.
    ``backend`` 'auto' and 'csr' both name the one path, K1 row terms;
    any other is refused."""
    if backend not in ("auto", "csr"):
        raise ValueError(f"the RGCN baseline runs every relation's term on "
                         f"K1 blockings of the rows it reaches: backend "
                         f"'auto' or 'csr', not {backend!r}")
    cfg = cfg or MPGNNConfig()
    device = resolve_device(device)
    blk = rgcn_operands(graph, device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if model is None:
        model = init_rgcn_net(
            x.shape[1], cfg.hidden_dim, graph.num_relations, cfg.hidden_dim,
            num_classes, cfg.num_bases, cfg.num_blocks,
            generator=torch.Generator().manual_seed(seed), device=device)
    model = model.to(device)
    opt = make_optimizer(model, cfg)
    first = precompute_rgcn_rows(x, blk)
    train_idx = torch.as_tensor(train_idx, device=device)
    tail = rgcn_tail_operands(blk, train_idx)
    train_y = torch.as_tensor(train_y, device=device)
    cw = balanced_class_weights(train_y.cpu().numpy(), num_classes)
    return RgcnTraining(
        model=model, opt=opt, x=x, blk=blk, first=first, tail=tail,
        tail_first=(precompute_rgcn_rows(x, tail) if metapath_length == 1
                    else None),
        metapath_length=metapath_length,
        num_relations=graph.num_relations, train_idx=train_idx,
        train_y=train_y, w=torch.as_tensor(cw, device=device)[train_y])


def train_rgcn_baseline(
    graph,
    labels: np.ndarray,
    split,
    num_classes: int,
    metapath_length: int = 3,
    cfg: Optional[MPGNNConfig] = None,
    seed: int = 10,          # main_rgcn.py:31 (torch.manual_seed(10))
    x_override: Optional[np.ndarray] = None,
    device=None,
    model=None,
) -> dict:
    """Train the RGCN ``Net`` on every relation of ``graph`` for
    ``cfg.epochs`` epochs on ``device`` (the GPU unless ``device='cpu'``)
    and return {params, train_f1, val_f1, test_f1, final_loss}: the
    trained ``RgcnNet``, the last epoch's macro-F1s and the loss of the
    last step. Set-up is ``setup_rgcn`` (the parameters drawn from ``seed``
    unless ``model`` gives the initial ones); each epoch is its
    ``step``."""
    cfg = cfg or MPGNNConfig()
    device = resolve_device(device)
    train_idx, train_y, val_idx, val_y, test_idx, test_y = split_tensors(
        split, device)
    x = np.asarray(graph.x if x_override is None else x_override,
                   dtype=np.float32)
    run = setup_rgcn(graph, torch.from_numpy(x), train_idx, train_y,
                     num_classes, metapath_length, cfg, model=model, seed=seed,
                     device=device)
    loss = torch.zeros((), device=device)
    t0 = time.perf_counter()
    for _ in range(cfg.epochs):
        loss = run.step()
    preds = run.predict()
    f1s = [float(macro_f1(preds[i], y, num_classes))
           for i, y in ((train_idx, train_y), (val_idx, val_y),
                        (test_idx, test_y))]
    seconds = time.perf_counter() - t0
    log.info("rgcn baseline: %d epochs in %.3f s (%.4f ms an epoch, the "
             "final evaluation included) on %s", cfg.epochs, seconds,
             seconds / max(cfg.epochs, 1) * 1e3, device)
    return {"params": run.model, "train_f1": f1s[0], "val_f1": f1s[1],
            "test_f1": f1s[2], "final_loss": float(loss.detach())}


def main(argv=None):
    ap = argparse.ArgumentParser(description="plain RGCN baseline (GPU)")
    ap.add_argument("--folder", required=True)
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--node_file", default="node.dat")
    ap.add_argument("--link_file", default="link.dat")
    ap.add_argument("--label_file", default="label.dat")
    ap.add_argument("--metapath_length", type=int, default=3)
    ap.add_argument("--hidden_dim", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--num_bases", type=int, default=None,
                    help="basis decomposition (mp_rgcn_layer.py:120-123)")
    ap.add_argument("--num_blocks", type=int, default=None,
                    help="block-diagonal decomposition "
                         "(mp_rgcn_layer.py:125-131)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--platform", type=str, default=None,
                    help="alias of --device for the JAX command lines: cpu "
                         "or gpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    device = args.device
    if args.platform is not None:
        if args.platform not in ("cpu", "gpu", "cuda"):
            ap.error(f"--platform {args.platform!r}: expected cpu or gpu")
        device = "cpu" if args.platform == "cpu" else "cuda"
    device = resolve_device(device)

    from mpgnn_tpu_torch.graph.io import (
        load_dat_files,
        load_fb15k237,
        mask_label_leak,
        split_nodes,
    )

    folder = args.folder.rstrip("/") + "/"
    files = (folder + args.node_file, folder + args.link_file,
             folder + args.label_file)
    source_nodes = None
    if args.dataset == "fb15k-237":
        graph, labels, _, source_nodes = load_fb15k237(*files)
    else:
        graph, labels, _ = load_dat_files(*files)
    split = split_nodes(labels, node_idx=source_nodes)
    x = graph.x
    if args.dataset == "fb15k-237":
        x = mask_label_leak(graph.x, split)   # main_rgcn.py:41-48, :503
    # one output a label id, as the search CLI's: the JAX baseline takes
    # the count of distinct labels, which on ids with gaps
    # (fb15k-237-continent's 0, 1, 3, 6) leaves labels past the last output
    num_classes = int(np.max(labels)) + 1
    res = train_rgcn_baseline(
        graph, labels, split, num_classes, args.metapath_length,
        MPGNNConfig(epochs=args.epochs, hidden_dim=args.hidden_dim,
                    num_bases=args.num_bases, num_blocks=args.num_blocks),
        x_override=x, device=device,
    )
    print(f"train F1 {res['train_f1']:.4f} val F1 {res['val_f1']:.4f} "
          f"test F1 {res['test_f1']:.4f} loss {res['final_loss']:.4f}",
          flush=True)
    return res


if __name__ == "__main__":
    main()
