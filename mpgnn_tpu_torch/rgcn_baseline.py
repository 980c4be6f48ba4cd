"""The plain RGCN baseline, on one GPU.

Counterpart of ``python -m mpgnn_tpu.rgcn_baseline`` (the reference's
``main_rgcn.py``): load a dataset, train the all-relations RGCN ``Net``
(model.py:132-149, ``models.mpgnn.RgcnNet``) for ``--epochs`` epochs of
Adam with a class-weighted NLL (main_rgcn.py:376-379: unlike the search,
the baseline weighs each class by n / (C * count)), report macro-F1.

    python -m mpgnn_tpu_torch.rgcn_baseline --folder <dir> --metapath_length 3

It runs on the GPU unless ``--device cpu`` (or its alias ``--platform
cpu``, for the JAX command lines) is given. The aggregation is
``models.relconv.rgcn_aggregate``, one product per relation and a gather,
in PyTorch ops: the JAX package's ``fast_rgcn_aggregate`` has no Pallas
kernel either.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Optional

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.models.mpgnn import init_rgcn_net
from mpgnn_tpu_torch.models.relconv import rgcn_edges
from mpgnn_tpu_torch.train.loops import (
    make_optimizer,
    split_tensors,
    weighted_nll,
)
from mpgnn_tpu_torch.train.metrics import macro_f1

log = logging.getLogger("mpgnn_tpu_torch.rgcn_baseline")


def balanced_class_weights(y: np.ndarray, num_classes: int) -> np.ndarray:
    """sklearn's 'balanced' weights n / (C * bincount), an empty class
    counted once (main_rgcn.py:376). A label id without nodes (a gap) is
    such a class: every weight then scales by the same factor, which the
    weighted mean of ``weighted_nll`` cancels."""
    counts = np.bincount(y, minlength=num_classes).astype(np.float64)
    counts[counts == 0] = 1.0
    return (len(y) / (num_classes * counts)).astype(np.float32)


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
    last step. The parameters are drawn by ``init_rgcn_net`` from ``seed``
    (``cfg.num_bases`` / ``cfg.num_blocks`` pick the decomposition), unless
    ``model`` gives the initial ones; hidden and output widths are
    ``cfg.hidden_dim``."""
    cfg = cfg or MPGNNConfig()
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(
        graph.x if x_override is None else x_override, dtype=np.float32),
        device=device)
    edges = rgcn_edges(graph.sorted_src, graph.sorted_dst, graph.sorted_type,
                       graph.num_nodes, graph.num_relations, device=device)
    train_idx, train_y, val_idx, val_y, test_idx, test_y = split_tensors(
        split, device)
    weights = torch.as_tensor(balanced_class_weights(
        np.asarray(split.train_y), num_classes), device=device)
    if model is None:
        model = init_rgcn_net(
            x.shape[1], cfg.hidden_dim, graph.num_relations, cfg.hidden_dim,
            num_classes, cfg.num_bases, cfg.num_blocks,
            generator=torch.Generator().manual_seed(seed), device=device)
    model = model.to(device)
    opt = make_optimizer(model, cfg)
    w = weights[train_y]
    loss = torch.zeros((), device=device)
    t0 = time.perf_counter()
    for _ in range(cfg.epochs):
        opt.zero_grad(set_to_none=True)
        loss = weighted_nll(model(x, edges, metapath_length), train_idx,
                            train_y, w)
        loss.backward()
        opt.step()
    with torch.no_grad():
        preds = model(x, edges, metapath_length).argmax(dim=1)
        f1s = [float(macro_f1(preds[i], y, num_classes))
               for i, y in ((train_idx, train_y), (val_idx, val_y),
                            (test_idx, test_y))]
    seconds = time.perf_counter() - t0
    log.info("rgcn baseline: %d epochs in %.3f s (%.4f ms an epoch, the "
             "final evaluation included) on %s", cfg.epochs, seconds,
             seconds / max(cfg.epochs, 1) * 1e3, device)
    return {"params": model, "train_f1": f1s[0], "val_f1": f1s[1],
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
