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


def sort_block_col(rows: np.ndarray, cols: np.ndarray, bm: int) -> np.ndarray:
    """Edge permutation by (rows // bm, cols, index): edges grouped by row
    block, by column inside a block, stable."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    return np.lexsort((cols, rows // bm))
