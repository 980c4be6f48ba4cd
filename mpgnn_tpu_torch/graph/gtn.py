"""GTN (Graph Transformer Network) format export, the reference's
``gtn_files`` (main.py:197-252): per-relation scipy CSR adjacency pickles
over each relation's own node set, the [train, val, test] label lists, and
the node-feature matrix.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from mpgnn_tpu_torch.graph.hetero import HeteroGraph, NodeSplit


def export_gtn(graph: HeteroGraph, split: NodeSplit, path: str) -> None:
    """Write ``edges.pkl`` (one [n_r, n_r] float64 ``csr_matrix`` a present
    relation, its nodes re-indexed in ascending id order), ``labels.pkl``
    ([[node, label], ...] for train, val, test) and ``node_features.pkl``
    into ``path``."""
    from scipy.sparse import csr_matrix

    os.makedirs(path, exist_ok=True)
    edges_list = []
    for r in graph.present_relations():
        src, dst = graph.rel_edges(r)
        node_ids, local = np.unique(np.concatenate([src, dst]),
                                    return_inverse=True)
        n = len(node_ids)
        edges_list.append(csr_matrix(
            (np.ones(len(src)), (local[:len(src)], local[len(src):])),
            shape=(n, n)))
    with open(os.path.join(path, "edges.pkl"), "wb") as f:
        pickle.dump(edges_list, f, protocol=pickle.HIGHEST_PROTOCOL)

    labels_list = [
        [[int(i), int(y)] for i, y in zip(idx, ys)]
        for idx, ys in ((split.train_idx, split.train_y),
                        (split.val_idx, split.val_y),
                        (split.test_idx, split.test_y))
    ]
    with open(os.path.join(path, "labels.pkl"), "wb") as f:
        pickle.dump(labels_list, f, protocol=pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(path, "node_features.pkl"), "wb") as f:
        pickle.dump(np.asarray(graph.x), f, protocol=pickle.HIGHEST_PROTOCOL)
