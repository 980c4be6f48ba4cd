"""Loaders for the reference's on-disk ``.dat`` TSV formats, in numpy.

Formats:
  node.dat  : node_id \t feat_0 \t feat_1 ...
  link.dat  : src \t relation_id \t dst
  label.dat : node_id \t label
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mpgnn_tpu_torch.graph.hetero import HeteroGraph, NodeSplit
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


# --------------------------------------------------------------------- split
def _find_unique_indices(nums: Sequence[int]) -> List[int]:
    """Indices of values occurring exactly once, in first-occurrence order
    (reference find_unique_indices, main.py:254-270)."""
    count = {}
    for i, num in enumerate(nums):
        if num in count:
            count[num][0] += 1
        else:
            count[num] = [1, i]
    return [idx for _, (occ, idx) in count.items() if occ == 1]


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Per-class draw counts, as sklearn's ``utils.extmath._approximate_mode``:
    floor each class's share, then hand the remaining draws out by largest
    remainder, breaking ties with ``rng.choice`` (called for every tie group
    that is reached, even one taken whole)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_split(labels: Sequence[int], test_size: float,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) positions of sklearn's ``train_test_split(...,
    stratify=labels, test_size=test_size, random_state=seed)``: the draws of
    ``StratifiedShuffleSplit._iter_indices`` on ``RandomState(seed)``, in
    the same order, so the index sets are identical."""
    y = np.asarray(labels)
    n = len(y)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("The least populated class in y has only 1 member, "
                         "which is too few for a stratified split")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must "
                         f"reach the number of classes ({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: List[int] = []
    test: List[int] = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def split_nodes(
    labels: np.ndarray,
    node_idx: Optional[Sequence[int]] = None,
    seed: int = 415,
) -> NodeSplit:
    """Stratified 90/10 then 80/20 split of the reference
    (splitting_node_and_labels, main.py:277-345): singleton-class members
    are pulled out first and appended to train; both stratified splits use
    ``seed`` as sklearn's ``random_state``, so the index sets are those of
    the reference (and of the JAX package) for the same inputs."""
    labels = np.asarray(labels)
    if node_idx is None:
        node_idx = list(range(len(labels)))
    else:
        node_idx = [int(v) for v in node_idx]
    lab = [int(v) for v in labels]

    unique_indices = _find_unique_indices(lab)
    nodes_removed: List[int] = []
    lab_removed: List[int] = []
    for idx in sorted(unique_indices, reverse=True):
        nodes_removed.append(node_idx.pop(idx))
        lab_removed.append(lab.pop(idx))

    node_arr = np.asarray(node_idx, dtype=np.int64)
    lab_arr = np.asarray(lab, dtype=np.int64)
    tr, te = _stratified_split(lab_arr, 0.1, seed)
    train_idx, test_idx = node_arr[tr], node_arr[te]
    train_y, test_y = lab_arr[tr], lab_arr[te]
    tr, va = _stratified_split(train_y, 0.2, seed)
    train_idx, val_idx = train_idx[tr], train_idx[va]
    train_y, val_y = train_y[tr], train_y[va]
    train_idx = np.concatenate([train_idx, np.asarray(nodes_removed,
                                                      dtype=np.int64)])
    train_y = np.concatenate([train_y, np.asarray(lab_removed,
                                                  dtype=np.int64)])
    return NodeSplit(node_idx=node_arr, train_idx=train_idx, train_y=train_y,
                     val_idx=val_idx, val_y=val_y, test_idx=test_idx,
                     test_y=test_y)


def mask_label_leak(x: np.ndarray, split: NodeSplit) -> np.ndarray:
    """Zero the feature rows of every split node (reference ``sn``,
    main.py:357-364), used where labels derive from features."""
    x = x.copy()
    for idx in (split.test_idx, split.val_idx, split.train_idx):
        x[np.asarray(idx, dtype=np.int64)] = 0.0
    return x
