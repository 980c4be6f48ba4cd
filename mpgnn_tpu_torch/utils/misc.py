"""Small helpers with reference counterparts outside the search flow:
the most frequent value (main.py:34-37), one-hot label encoding
(main.py:45-54), negative sampling (main.py:1020-1035), the confusion
matrix saved as ``.npy`` and text (main.py:1037-1053, without its plot),
the DBSCAN singleton-cluster finder (main.py:1162-1189) and class-balanced
undersampling (main.py:306-344). In numpy alone: the confusion matrix and
the cluster finder compute what sklearn's ``confusion_matrix`` and
``DBSCAN(eps=0.1, min_samples=1)`` give.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import numpy as np


def most_frequent(values: Sequence) -> object:
    """valore_piu_frequente (main.py:34-37): the most common value, the
    first seen on ties."""
    return Counter(values).most_common(1)[0][0]


def one_hot_encoding(labels: Sequence[int]) -> np.ndarray:
    """one_hot_encoding (main.py:45-54): [len(labels), distinct labels]
    float32, one column per distinct label in sorted order."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    out = np.zeros((len(labels), len(classes)), dtype=np.float32)
    for j, c in enumerate(classes):
        out[labels == c, j] = 1.0
    return out


def negative_sampling(
    labels: np.ndarray, rng: Optional[np.random.Generator] = None
) -> List[int]:
    """Balanced negative sampling (main.py:1020-1035): every positive index,
    then one more random negative index than there are positives, drawn
    with replacement from ``rng`` (default ``default_rng(0)``)."""
    rng = rng or np.random.default_rng(0)
    labels = np.asarray(labels).reshape(-1)
    mask = np.nonzero(labels == 1)[0].tolist()
    negatives = np.nonzero(labels == 0)[0]
    draws = rng.choice(negatives, size=len(mask) + 1, replace=True)
    return mask + draws.tolist()


def confusion_matrix(y_true: Sequence, y_pred: Sequence) -> np.ndarray:
    """[L, L] int64 counts, ``cm[i, j]`` the samples of true label i
    predicted as j, over the sorted union L of the labels in both."""
    y_true, y_pred = np.asarray(list(y_true)), np.asarray(list(y_pred))
    labels = np.unique(np.concatenate([y_true, y_pred]))
    t = np.searchsorted(labels, y_true)
    p = np.searchsorted(labels, y_pred)
    cm = np.zeros((len(labels), len(labels)), dtype=np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def save_confusion_matrix(
    y_true: Sequence[int], y_pred: Sequence[int], path_prefix: str
) -> np.ndarray:
    """The confusion matrix saved as ``<prefix>.npy`` and ``<prefix>.txt``
    (the reference plots it to a jpg, main.py:1047-1053)."""
    cm = confusion_matrix(y_true, y_pred)
    np.save(path_prefix + ".npy", cm)
    with open(path_prefix + ".txt", "w") as f:
        f.write(np.array2string(cm))
    return cm


def _dbscan_labels(x: np.ndarray, eps: float) -> np.ndarray:
    """Cluster ids of ``DBSCAN(eps, min_samples=1)`` on the 1-D values
    ``x``, as sklearn computes them: j is a neighbour of i where the
    squared distance, summed as sklearn's brute-force euclidean distances
    sum it, ``(x_i^2 + -2 x_i x_j) + x_j^2``, is at most ``eps^2``. That
    sum rounds differently for (i, j) and (j, i), so the neighbourhoods are
    not symmetric, and the clusters follow from sklearn's expansion order:
    points in index order, each unlabelled one opening a cluster that takes
    its neighbours depth first."""
    sq = x * x
    d2 = np.maximum((sq[:, None] + -2.0 * (x[:, None] * x[None, :]))
                    + sq[None, :], 0.0)
    near = d2 <= np.float64(eps) * np.float64(eps)
    labels = np.full(len(x), -1, dtype=np.int64)
    label = 0
    for i in range(len(x)):
        if labels[i] != -1:
            continue
        stack = []
        while True:
            if labels[i] == -1:
                labels[i] = label
                stack.extend(int(v) for v in np.flatnonzero(near[i])
                             if labels[v] == -1)
            if not stack:
                break
            i = stack.pop()
        label += 1
    return labels


def find_smallest_values(accuracies: Sequence[float], eps: float = 0.1):
    """The singleton-cluster outlier finder (main.py:1162-1189): ``[value]``
    of the first one-point cluster of ``DBSCAN(eps=0.1, min_samples=1)``
    on the values (``_dbscan_labels``), else the smallest value as a
    float."""
    arr = np.asarray(list(accuracies), dtype=np.float64)
    labels = _dbscan_labels(arr, eps)
    for label in np.unique(labels):
        idx = np.flatnonzero(labels == label)
        if len(idx) == 1:
            return [float(arr[idx[0]])]
    return float(arr.min())


def balanced_undersample(
    node_idx: Sequence[int],
    labels: Sequence[int],
    rng: Optional[np.random.Generator] = None,
):
    """Class-balanced undersampling to the smallest class's size (the
    reference's unused RandomUnderSampler branch, main.py:306-344), drawn
    from ``rng`` (default ``default_rng(42)``), class by class in sorted
    order. Returns (indices, labels)."""
    rng = rng or np.random.default_rng(42)
    node_idx = np.asarray(list(node_idx))
    labels = np.asarray(list(labels))
    classes, counts = np.unique(labels, return_counts=True)
    n_min = int(counts.min())
    keep = np.concatenate([
        rng.choice(np.nonzero(labels == c)[0], size=n_min, replace=False)
        for c in classes
    ])
    return node_idx[keep], labels[keep]
