"""Loaders for the reference's on-disk ``.dat`` TSV formats, in numpy.

Formats:
  node.dat  : node_id \t feat_0 \t feat_1 ...
  link.dat  : src \t relation_id \t dst
  label.dat : node_id \t label
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.native import load_int_tsv


def read_node_features(path: str) -> np.ndarray:
    """node.dat -> [N, F] float32. Column 0 is the node id; the other
    columns are features, and columns that are empty on every line are
    dropped. A single column of strings is one-hot encoded over its sorted
    distinct values (the reference's ``pd.get_dummies`` on colour datasets);
    numeric files load as they are. Rows come back sorted by node id."""
    with open(path) as f:
        cells = [line.rstrip("\r\n").split("\t") for line in f
                 if line.strip("\r\n")]
    width = max((len(c) for c in cells), default=1)
    table = np.array([c + [""] * (width - len(c)) for c in cells], dtype=str)
    table = table[:, [j for j in range(width) if (table[:, j] != "").any()]]
    node_ids = table[:, 0].astype(np.float64).astype(np.int64)
    feats = table[:, 1:]
    if feats.shape[1] == 1 and not _is_numeric(feats[:, 0]):
        values, codes = np.unique(feats[:, 0], return_inverse=True)
        x = np.zeros((len(feats), len(values)), dtype=np.float32)
        x[np.arange(len(feats)), codes] = 1.0
    else:
        x = np.where(feats == "", "nan", feats).astype(np.float32)
    order = np.argsort(node_ids)
    if not np.array_equal(order, np.arange(len(node_ids))):
        x = x[order]
    return x


def _is_numeric(column: np.ndarray) -> bool:
    try:
        np.where(column == "", "nan", column).astype(np.float64)
    except ValueError:
        return False
    return True


def read_links(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """link.dat -> (src, rel, dst) int64 arrays in file order (no reverse
    edges are added)."""
    arr = load_int_tsv(path)
    if arr.shape[1] != 3:
        raise ValueError(f"{path}: expected 3 columns, got {arr.shape[1]}")
    return arr[:, 0], arr[:, 1], arr[:, 2]


def read_labels(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """label.dat -> (node_ids, labels)."""
    arr = load_int_tsv(path)
    return arr[:, 0], arr[:, 1]


def binarize_labels(labels: np.ndarray) -> List[np.ndarray]:
    """One-vs-rest binarization: a binary label vector passes through; a
    multi-class one yields one 0/1 vector per class, in sorted class
    order."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    if len(classes) > 2:
        return [(labels == c).astype(labels.dtype) for c in classes]
    return [labels]


def _graph(node_file: str, link_file: str, labels: np.ndarray) -> HeteroGraph:
    x = read_node_features(node_file)
    src, rel, dst = read_links(link_file)
    g = HeteroGraph(
        x, src, dst, rel, num_relations=int(rel.max()) + 1 if len(rel) else 0,
        labels=labels,
    )
    g.distinct_relations = int(len(np.unique(rel)))
    return g


def load_dat_files(
    node_file: str, link_file: str, label_file: str
) -> Tuple[HeteroGraph, np.ndarray, List[np.ndarray]]:
    """Generic loader: (graph, labels, binary_labels). ``num_relations`` is
    the largest relation id + 1; ``graph.distinct_relations`` counts the ids
    that occur."""
    _, labels = read_labels(label_file)
    return _graph(node_file, link_file, labels), labels, binarize_labels(labels)


def load_fb15k237(
    node_file: str, link_file: str, label_file: str
) -> Tuple[HeteroGraph, np.ndarray, List[np.ndarray], List[int]]:
    """FB15K-237 loader: only a subset of nodes carry labels, so it also
    returns the labeled node ids in the order of the label vector."""
    label_nodes, labels = read_labels(label_file)
    return (_graph(node_file, link_file, labels), labels,
            binarize_labels(labels), [int(v) for v in label_nodes])
