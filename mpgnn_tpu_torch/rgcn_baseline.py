"""The plain RGCN baseline, on one GPU.

Counterpart of ``python -m mpgnn_tpu.rgcn_baseline`` (the reference's
``main_rgcn.py``): load a dataset, train the all-relations RGCN ``Net``
(model.py:132-149, ``models.mpgnn.RgcnNet``) for ``--epochs`` epochs of
Adam with a class-weighted NLL (main_rgcn.py:376-379: unlike the search,
the baseline weighs each class by n / (C * count)), report macro-F1.

    python -m mpgnn_tpu_torch.rgcn_baseline --folder <dir> --metapath_length 3

It runs on the GPU unless ``--device cpu`` (or its alias ``--platform
cpu``, for the JAX command lines) is given. It trains on the port's normal
path: each relation's mean aggregation runs on the hop operands MPNetm's
hops use (``train.loops.build_hop_arrays``, one relation a hop; with
``--backend auto``, the default, resolved by ``resolve_backend`` as
``train_mpgnn`` resolves it: the csr kernels K1/K2 on a large graph; a csr
relation with a K1 forward runs its term on the rows it reaches alone,
``rgcn_operands``), and every epoch is one
``train.loops.rgcn_train_step``. ``setup_rgcn`` builds the run's objects;
the benchmark calls it too.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.models.mpgnn import (
    ROW_OPERAND,
    RgcnInput,
    RgcnNet,
    init_rgcn_net,
    precompute_rgcn_input,
)
from mpgnn_tpu_torch.ops.csr import CsrBlocking, row_term_blockings
from mpgnn_tpu_torch.train.loops import (
    auto_dense_budget_bytes,
    build_hop_arrays,
    make_optimizer,
    resolve_backend,
    rgcn_train_step,
    split_tensors,
)
from mpgnn_tpu_torch.train.metrics import macro_f1
from mpgnn_tpu_torch.utils.prof import span

log = logging.getLogger("mpgnn_tpu_torch.rgcn_baseline")

# the backends whose operands ``models.mpgnn.hop_aggregate`` takes alone:
# 'pallas' fuses the aggregation into its conv's kernel, 'halo' shards
# the rows over a mesh
RGCN_BACKENDS = ("segment", "csr", "ell", "ell2", "dense", "onehot")


def balanced_class_weights(y: np.ndarray, num_classes: int) -> np.ndarray:
    """sklearn's 'balanced' weights n / (C * bincount), an empty class
    counted once (main_rgcn.py:376). A label id without nodes (a gap) is
    such a class: every weight then scales by the same factor, which the
    weighted mean of ``weighted_nll`` cancels."""
    counts = np.bincount(y, minlength=num_classes).astype(np.float64)
    counts[counts == 0] = 1.0
    return (len(y) / (num_classes * counts)).astype(np.float32)


def rgcn_operands(graph: HeteroGraph, backend: str, device
                  ) -> List[Optional[Tuple]]:
    """Each relation's aggregation operand on ``device``, None for a
    relation without edges: ``build_hop_arrays`` of one-hop metapaths, so
    from the graph's operand cache (``relation_operand``) that MPNetm's
    hops share. ``backend`` is one of ``RGCN_BACKENDS``.

    Relation r's term lives on the rows R_r with an r-edge, its sources.
    Every 'csr' relation whose forward blocking is K1's runs its term on
    those rows alone (``row_term_operands``); every other operand is the
    hop's, whose term joins the stacked product. The row terms won at
    every reach share measured, up to every row
    (``benchmarks/bench_rgcn_rows.py`` at ogbn-mag's 1,939,743 rows, 64 ->
    64, float32, 8 relations of 5M edges, on an NVIDIA H100 80GB HBM3 at
    700.00 W, row terms over the stacked product, ms: each relation
    reaching 5% of the rows 9.63 / 30.00, 25% 14.49 / 31.73, 50% 19.14 /
    32.11, 75% 23.72 / 32.25, 90% 26.92 / 32.30, every row 28.56 / 32.32:
    at every row they still skip the concatenation, its gradient's copies
    and the 9-way gradient sum), so the reach does not choose the path.
    The derivation is timed as a second call of the span
    ``train.build_hop_arrays``; each relation's path (and |R_r|) is
    logged."""
    if backend not in RGCN_BACKENDS:
        raise ValueError(f"the RGCN baseline takes a backend of "
                         f"{RGCN_BACKENDS}, not {backend!r}")
    present = graph.present_relations()
    ops = build_hop_arrays(graph, [[r] for r in present], backend=backend,
                           device=device)
    out: List[Optional[Tuple]] = [None] * graph.num_relations
    for r, hop in zip(present, ops):
        out[r] = hop[0]
    rows = [r for r in present
            if out[r][0] == "csr" and isinstance(out[r][1], CsrBlocking)]
    if rows:
        with span("train.build_hop_arrays"):
            out = row_term_operands(out, rows)
    n = graph.num_nodes
    for r in present:
        if out[r][0] != ROW_OPERAND:
            log.info("rgcn baseline: relation %d: stacked (%r operand)", r,
                     out[r][0])
            continue
        o, i = out[r][3].offsets, rows.index(r)
        log.info("rgcn baseline: relation %d: row terms on %d of %d rows "
                 "(%.1f%%)", r, o[i + 1] - o[i], n,
                 100.0 * (o[i + 1] - o[i]) / n)
    return out


def row_term_operands(ops: List[Optional[Tuple]], rels: List[int]
                      ) -> List[Optional[Tuple]]:
    """``ops`` with each relation of ``rels`` (a 'csr' operand whose
    forward blocking is K1's) turned to ``('csr_rows', blk.fwd, blk.bwd,
    blk)``: ``blk``, the ``ops.csr.RowTermBlockings`` of those relations
    that they all share, is derived on their device from their forward
    blockings."""
    blk = row_term_blockings(rels, [ops[r][1] for r in rels])
    out = list(ops)
    for r in rels:
        out[r] = (ROW_OPERAND, blk.fwd, blk.bwd, blk)
    return out


@dataclasses.dataclass
class RgcnTraining:
    """One RGCN baseline run's objects on the device, and its epoch."""

    model: RgcnNet
    opt: torch.optim.Optimizer
    x: torch.Tensor
    rel_ops: List[Optional[Tuple]]
    first: Union[torch.Tensor, RgcnInput]  # precompute_rgcn_input
    metapath_length: int
    train_idx: torch.Tensor
    train_y: torch.Tensor
    w: torch.Tensor                # [T] class weights of the train rows
    backend: str

    def step(self) -> torch.Tensor:
        """One epoch's step; returns its loss."""
        return rgcn_train_step(self.model, self.opt, self.x, self.rel_ops,
                               self.first, self.metapath_length,
                               self.train_idx, self.train_y, self.w)

    @torch.no_grad()
    def predict(self) -> torch.Tensor:
        """[N] predicted classes."""
        return self.model(self.x, self.rel_ops, self.metapath_length,
                          first=self.first).argmax(dim=1)


def setup_rgcn(graph: HeteroGraph, x: torch.Tensor, train_idx: torch.Tensor,
               train_y: torch.Tensor, num_classes: int,
               metapath_length: int = 3, cfg: Optional[MPGNNConfig] = None,
               backend: str = "auto", model: Optional[RgcnNet] = None,
               seed: int = 10, device=None) -> RgcnTraining:
    """An ``RgcnTraining`` of ``graph``'s relations on ``device`` (the GPU
    unless ``device='cpu'``): ``backend`` ('auto' resolved by
    ``resolve_backend`` over every relation, as ``train_mpgnn`` resolves
    it), the operands (``rgcn_operands``), the model (drawn by
    ``init_rgcn_net`` from ``seed``, ``cfg.num_bases`` / ``cfg.num_blocks``
    picking the decomposition, hidden and output widths ``cfg.hidden_dim``;
    or ``model``, moved to ``device``), Adam (``make_optimizer``), layer
    0's input and the balanced class weights of ``train_y``. ``x`` is the
    [N, F] float32 features, on ``device`` or copied there."""
    cfg = cfg or MPGNNConfig()
    device = resolve_device(device)
    relations = [[r] for r in range(graph.num_relations)]
    if backend == "auto":
        backend = resolve_backend(backend, graph, relations,
                                  auto_dense_budget_bytes(device))
        log.info("rgcn baseline: backend 'auto' -> %r (%d nodes, %d "
                 "relations)", backend, graph.num_nodes,
                 graph.num_relations)
    rel_ops = rgcn_operands(graph, backend, device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if model is None:
        model = init_rgcn_net(
            x.shape[1], cfg.hidden_dim, graph.num_relations, cfg.hidden_dim,
            num_classes, cfg.num_bases, cfg.num_blocks,
            generator=torch.Generator().manual_seed(seed), device=device)
    model = model.to(device)
    opt = make_optimizer(model, cfg)
    first = precompute_rgcn_input(x, rel_ops)
    train_y = torch.as_tensor(train_y, device=device)
    cw = balanced_class_weights(train_y.cpu().numpy(), num_classes)
    return RgcnTraining(
        model=model, opt=opt, x=x, rel_ops=rel_ops, first=first,
        metapath_length=metapath_length,
        train_idx=torch.as_tensor(train_idx, device=device), train_y=train_y,
        w=torch.as_tensor(cw, device=device)[train_y], backend=backend)


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
    backend: str = "auto",
) -> dict:
    """Train the RGCN ``Net`` on every relation of ``graph`` for
    ``cfg.epochs`` epochs on ``device`` (the GPU unless ``device='cpu'``)
    and return {params, train_f1, val_f1, test_f1, final_loss}: the
    trained ``RgcnNet``, the last epoch's macro-F1s and the loss of the
    last step. Set-up is ``setup_rgcn`` (``backend``, the parameters drawn
    from ``seed`` unless ``model`` gives the initial ones); each epoch is
    its ``step``."""
    cfg = cfg or MPGNNConfig()
    device = resolve_device(device)
    train_idx, train_y, val_idx, val_y, test_idx, test_y = split_tensors(
        split, device)
    x = np.asarray(graph.x if x_override is None else x_override,
                   dtype=np.float32)
    run = setup_rgcn(graph, torch.from_numpy(x), train_idx, train_y,
                     num_classes, metapath_length, cfg, backend, model, seed,
                     device)
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
             "final evaluation included) on %s, backend %r", cfg.epochs,
             seconds, seconds / max(cfg.epochs, 1) * 1e3, device,
             run.backend)
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
    ap.add_argument("--backend", default="auto",
                    choices=("auto",) + RGCN_BACKENDS,
                    help="each relation's aggregation (default auto: "
                         "resolved as train_mpgnn resolves it)")
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
        x_override=x, device=device, backend=args.backend,
    )
    print(f"train F1 {res['train_f1']:.4f} val F1 {res['val_f1']:.4f} "
          f"test F1 {res['test_f1']:.4f} loss {res['final_loss']:.4f}",
          flush=True)
    return res


if __name__ == "__main__":
    main()
