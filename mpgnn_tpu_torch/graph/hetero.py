"""Heterogeneous graph with relation-sorted edge storage (host side, numpy).

Edges are sorted by relation once at build time and ``rel_ptr`` keeps the
static offsets of each relation's segment, so every per-relation view is a
plain slice. Aggregation semantics follow the reference: messages flow from
the dst column of ``link.dat`` into the src column, mean aggregation, zero
rows for sources with no edge of the selected relation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from mpgnn_tpu_torch.native import degrees, sort_by_relation


def _as_int32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int32))


@dataclasses.dataclass(frozen=True)
class NodeSplit:
    """Stratified train/val/test node split."""

    node_idx: np.ndarray   # all labeled node ids
    train_idx: np.ndarray
    train_y: np.ndarray
    val_idx: np.ndarray
    val_y: np.ndarray
    test_idx: np.ndarray
    test_y: np.ndarray

    @property
    def num_classes(self) -> int:
        return int(len(np.unique(
            np.concatenate([self.train_y, self.val_y, self.test_y])
        )))


class HeteroGraph:
    """A typed multigraph with relation-sorted edge storage.

    ``x`` is the [N, F] float32 node feature matrix; ``edge_src``,
    ``edge_dst`` and ``edge_type`` are [E] arrays in file order. The stable
    sort keeps file order inside each relation's segment.
    """

    def __init__(
        self,
        x: np.ndarray,
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        edge_type: np.ndarray,
        num_relations: Optional[int] = None,
        labels: Optional[np.ndarray] = None,
    ):
        x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
        edge_src = _as_int32(edge_src)
        edge_dst = _as_int32(edge_dst)
        edge_type = _as_int32(edge_type)
        if not (edge_src.shape == edge_dst.shape == edge_type.shape):
            raise ValueError("edge arrays must have identical shapes")

        self.x = x
        self.num_nodes = int(x.shape[0])
        self.feat_dim = int(x.shape[1])
        self.num_edges = int(edge_src.shape[0])
        self.num_relations = int(
            num_relations
            if num_relations is not None
            else (edge_type.max() + 1 if edge_type.size else 0)
        )
        self.labels = None if labels is None else np.asarray(labels)

        self.edge_src = edge_src
        self.edge_dst = edge_dst
        self.edge_type = edge_type

        order, rel_ptr = sort_by_relation(edge_type, self.num_relations)
        self.sorted_src = edge_src[order]
        self.sorted_dst = edge_dst[order]
        self.sorted_type = edge_type[order]
        self.rel_ptr = rel_ptr
        self.rel_counts = np.diff(rel_ptr).astype(np.int64)
        self._cache: Dict[Tuple[str, int], object] = {}

    def rel_slice(self, relation: int) -> Tuple[int, int]:
        """(start, end) offsets of a relation's edge segment."""
        return int(self.rel_ptr[relation]), int(self.rel_ptr[relation + 1])

    def rel_edges(self, relation: int) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) arrays of one relation, in file order."""
        s, e = self.rel_slice(relation)
        return self.sorted_src[s:e], self.sorted_dst[s:e]

    def rel_edges_csr(self, relation: int) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) of one relation with src sorted ascending (stable, so
        each source's neighbours stay in file order). Cached."""
        key = ("csr", int(relation))
        if key not in self._cache:
            src, dst = self.rel_edges(relation)
            order = np.argsort(src, kind="stable")
            self._cache[key] = (src[order], dst[order])
        return self._cache[key]

    def rel_degrees(self, relation: int) -> np.ndarray:
        """Per-node out-degree of one relation (int32, cached)."""
        key = ("deg", int(relation))
        if key not in self._cache:
            self._cache[key] = degrees(self.rel_edges(relation)[0],
                                       self.num_nodes)
        return self._cache[key]

    def __repr__(self) -> str:
        return (
            f"HeteroGraph(nodes={self.num_nodes}, edges={self.num_edges}, "
            f"relations={self.num_relations}, feat_dim={self.feat_dim})"
        )
