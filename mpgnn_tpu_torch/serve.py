"""Serving a trained metapath model: a full-graph node classifier and its CLI.

    python -m mpgnn_tpu_torch.serve --model_dir models/class_0 \
        --metapaths "[[1, 0]]" --folder <dataset_dir> --nodes 17,42,99

``--model_dir`` holds the ``params.pt`` written by
``utils.checkpoint.save_params``. The predictor runs on the GPU unless
``--device cpu`` (or ``device='cpu'``) is given. The CLI aggregates with
``backend='csr'``: the CUDA kernels of ``ops/csr.py`` on the GPU, their
plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.models.mpgnn import MPNetm, init_mpgnn
from mpgnn_tpu_torch.train.loops import build_hop_arrays


class MetapathPredictor:
    """Full-graph node classifier for a metapath set. The graph's
    aggregation operands and features live on ``device``. ``backend`` is
    any single-model backend of ``train.loops.BACKENDS`` ('segment',
    'csr', 'pallas', 'ell', 'ell2', 'dense', 'onehot'); 'auto' is not
    resolved here, as the JAX package's predictor does not resolve it."""

    def __init__(
        self,
        graph,
        metapaths: Sequence[Sequence[int]],
        params: MPNetm,
        backend: str = "segment",
        device=None,
    ):
        self.device = resolve_device(device)
        self.graph = graph
        self.metapaths = [list(m) for m in metapaths]
        self.params = params.to(self.device).eval()
        self._x = torch.as_tensor(graph.x, device=self.device)
        self._hop_ops = build_hop_arrays(graph, self.metapaths,
                                         backend=backend, device=self.device)
        self._logp: Optional[np.ndarray] = None

    def _forward(self) -> np.ndarray:
        with torch.inference_mode():
            return self.params(self._x, self._hop_ops).cpu().numpy()

    def log_probs(self) -> np.ndarray:
        """[N, C] log-probabilities for every node (cached)."""
        if self._logp is None:
            self._logp = self._forward()
        return self._logp

    def refresh(self) -> float:
        """Re-run the full-graph forward (after a parameter or feature
        update) and return its latency in seconds, up to the log-probs on
        the host."""
        t0 = time.perf_counter()
        self._logp = self._forward()
        return time.perf_counter() - t0

    def predict(self, node_ids: Optional[Sequence[int]] = None) -> np.ndarray:
        preds = self.log_probs().argmax(axis=1)
        if node_ids is None:
            return preds
        return preds[np.asarray(list(node_ids), dtype=np.int64)]

    @classmethod
    def load(
        cls,
        model_dir: str,
        graph,
        metapaths: Sequence[Sequence[int]],
        num_classes: int,
        hidden_dim: int = 64,
        device=None,
        **kwargs,
    ) -> "MetapathPredictor":
        """Restore parameters saved by ``utils.checkpoint.save_params``."""
        from mpgnn_tpu_torch.utils.checkpoint import restore_params

        device = resolve_device(device)
        template = init_mpgnn(graph.feat_dim, hidden_dim, num_classes,
                              metapaths, device=device)
        params = restore_params(model_dir, template)
        return cls(graph, metapaths, params, device=device, **kwargs)


def main(argv=None):
    ap = argparse.ArgumentParser(description="metapath model serving")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--metapaths", required=True,
                    help='JSON list of metapaths, e.g. "[[1, 0]]"')
    ap.add_argument("--folder", required=True)
    ap.add_argument("--node_file", default="node.dat")
    ap.add_argument("--link_file", default="link.dat")
    ap.add_argument("--label_file", default="label.dat")
    ap.add_argument("--hidden_dim", type=int, default=64)
    ap.add_argument("--num_classes", type=int, default=2)
    ap.add_argument("--nodes", type=str, default=None,
                    help="comma-separated node ids (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda or cpu (default: cuda)")
    args = ap.parse_args(argv)

    from mpgnn_tpu_torch.graph.io import load_dat_files

    folder = args.folder.rstrip("/") + "/"
    graph, _, _ = load_dat_files(
        folder + args.node_file, folder + args.link_file,
        folder + args.label_file,
    )
    pred = MetapathPredictor.load(
        args.model_dir, graph, json.loads(args.metapaths), args.num_classes,
        args.hidden_dim, device=args.device, backend="csr",
    )
    ids: Optional[List[int]] = None
    if args.nodes:
        ids = [int(v) for v in args.nodes.split(",")]
    out = pred.predict(ids)
    if ids is None:
        print(json.dumps({"num_nodes": len(out),
                          "class_counts": np.bincount(out).tolist()}))
    else:
        print(json.dumps({str(i): int(c) for i, c in zip(ids, out)}))


if __name__ == "__main__":
    main()
