"""Host-side graph helpers in numpy.

The JAX package binds a small C++ library for these (``mpgnn_tpu/native``)
and falls back to numpy where no compiler is found; the port keeps only the
numpy versions, which give the same results.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_int_tsv(path: str) -> np.ndarray:
    """Parse a whitespace-separated integer table into an [rows, cols] int64
    array. A file whose value count does not divide into its line count
    comes back as one column."""
    with open(path) as f:
        text = f.read()
    rows = sum(1 for line in text.splitlines() if line.strip())
    if rows == 0:
        return np.zeros((0, 0), dtype=np.int64)
    vals = np.fromstring(text, dtype=np.int64, sep=" ")
    if len(vals) % rows == 0:
        return vals.reshape(rows, len(vals) // rows)
    return vals.reshape(-1, 1)


def sort_by_relation(
    edge_type: np.ndarray, num_relations: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Stable permutation that groups edges by relation, and the [R + 1]
    offsets of each relation's segment."""
    edge_type = np.ascontiguousarray(edge_type, dtype=np.int32)
    order = np.argsort(edge_type, kind="stable").astype(np.int64)
    counts = np.bincount(edge_type, minlength=num_relations)
    rel_ptr = np.zeros(num_relations + 1, dtype=np.int64)
    np.cumsum(counts, out=rel_ptr[1:])
    return order, rel_ptr


def degrees(src: np.ndarray, num_nodes: int) -> np.ndarray:
    """Per-node out-degree of one relation's edges (int32)."""
    return np.bincount(
        np.asarray(src, dtype=np.int64), minlength=num_nodes
    ).astype(np.int32)


def build_ell(
    src: np.ndarray, dst: np.ndarray, num_nodes: int, max_degree: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """ELL neighbour table of one relation: ``(nbr [N, D] int32, mask [N, D]
    bool, largest out-degree)``. Row i holds the first ``max_degree``
    destinations of source i in input (file) order; unused slots are 0 and
    masked."""
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    nbr = np.zeros((num_nodes, max_degree), dtype=np.int32)
    mask = np.zeros((num_nodes, max_degree), dtype=bool)
    if len(src) == 0:
        return nbr, mask, 0
    deg = np.bincount(src, minlength=num_nodes)
    # a stable sort by source keeps file order inside each row; an edge's
    # slot is its rank inside its source's run
    order = np.argsort(src, kind="stable")
    rs, cs = src[order], dst[order]
    starts = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(len(src), dtype=np.int64) - starts[rs]
    keep = slot < max_degree
    nbr[rs[keep], slot[keep]] = cs[keep]
    mask[rs[keep], slot[keep]] = True
    return nbr, mask, int(deg.max())


def sort_block_col(rows: np.ndarray, cols: np.ndarray, bm: int) -> np.ndarray:
    """Edge permutation by (rows // bm, cols, index): edges grouped by row
    block, by column inside a block, stable."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if len(cols) == 0:
        return np.zeros(0, dtype=np.int64)
    # one sort of a combined key gives np.lexsort((cols, rows // bm))'s
    # permutation; with the index in the key, ties are broken as a stable
    # sort breaks them, and numpy's faster unstable sort is enough
    key = rows // bm * (int(cols.max()) + 1) + cols
    e = len(key)
    if (int(key.max()) + 1) * e < 2 ** 63:
        return np.argsort(key * e + np.arange(e))
    return np.argsort(key, kind="stable")
