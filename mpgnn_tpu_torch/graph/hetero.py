"""Heterogeneous graph with relation-sorted edge storage (host side, numpy).

Edges are sorted by relation once at build time and ``rel_ptr`` keeps the
static offsets of each relation's segment, so every per-relation view is a
plain slice. Aggregation semantics follow the reference: messages flow from
the dst column of ``link.dat`` into the src column, mean aggregation, zero
rows for sources with no edge of the selected relation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mpgnn_tpu_torch.native import build_ell, degrees, sort_by_relation
from mpgnn_tpu_torch.utils.prof import span


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


@dataclasses.dataclass(frozen=True)
class RelationBatch:
    """A padded batch of per-relation edge lists: ``src`` / ``dst`` are
    ``[R, E_max]`` int32 whose padding points at node 0 and is masked out by
    ``mask``; ``relations`` holds the relation id of each row."""

    relations: np.ndarray  # [R] int32
    src: np.ndarray        # [R, E_max] int32
    dst: np.ndarray        # [R, E_max] int32
    mask: np.ndarray       # [R, E_max] bool
    counts: np.ndarray     # [R] int32 true edge counts

    @property
    def num_relations(self) -> int:
        return int(self.relations.shape[0])

    @property
    def max_edges(self) -> int:
        return int(self.src.shape[1])


class HeteroGraph:
    """A typed multigraph with relation-sorted edge storage.

    ``x`` is the [N, F] float32 node feature matrix; ``edge_src``,
    ``edge_dst`` and ``edge_type`` are [E] arrays in file order. The stable
    sort keeps file order inside each relation's segment; it is timed as
    the span ``graph.hetero``.
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

        with span("graph.hetero"):
            order, rel_ptr = sort_by_relation(edge_type, self.num_relations)
            self.sorted_src = edge_src[order]
            self.sorted_dst = edge_dst[order]
            self.sorted_type = edge_type[order]
        self.rel_ptr = rel_ptr
        self.rel_counts = np.diff(rel_ptr).astype(np.int64)
        self._cache: Dict[tuple, object] = {}

    def rel_slice(self, relation: int) -> Tuple[int, int]:
        """(start, end) offsets of a relation's edge segment."""
        return int(self.rel_ptr[relation]), int(self.rel_ptr[relation + 1])

    def rel_edges(self, relation: int) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) arrays of one relation, in file order."""
        s, e = self.rel_slice(relation)
        return self.sorted_src[s:e], self.sorted_dst[s:e]

    def present_relations(self) -> List[int]:
        """Relations with at least one edge, ascending."""
        return [r for r in range(self.num_relations) if self.rel_counts[r] > 0]

    def relation_batch(
        self,
        relations: Sequence[int],
        pad_to: Optional[int] = None,
        pad_multiple: int = 128,
    ) -> RelationBatch:
        """The edges of ``relations`` as one ``[R, E_max]`` batch, E_max the
        largest count (at least 1 and ``pad_to``) rounded up to a multiple
        of ``pad_multiple``."""
        rels = _as_int32(relations)
        counts = np.array([self.rel_counts[r] for r in rels], dtype=np.int32)
        e_max = max(int(counts.max()) if counts.size else 1, 1)
        if pad_to is not None:
            e_max = max(e_max, int(pad_to))
        e_max = -(-e_max // pad_multiple) * pad_multiple
        src = np.zeros((len(rels), e_max), dtype=np.int32)
        dst = np.zeros((len(rels), e_max), dtype=np.int32)
        mask = np.zeros((len(rels), e_max), dtype=bool)
        for i, r in enumerate(rels):
            s, d = self.rel_edges(int(r))
            src[i, :len(s)], dst[i, :len(s)], mask[i, :len(s)] = s, d, True
        return RelationBatch(relations=rels, src=src, dst=dst, mask=mask,
                             counts=counts)

    def edge_dictionary(
        self, relation: int, source_nodes: Sequence[int]
    ) -> Dict[int, List[int]]:
        """``{src: [dsts in file order]}`` of one relation, restricted to
        ``source_nodes``; sources without an edge are left out (the
        reference's create_edge_dictionary, main.py:387-407)."""
        src, dst = self.rel_edges(relation)
        wanted = set(int(v) for v in source_nodes)
        out: Dict[int, List[int]] = {}
        for s, d in zip(src.tolist(), dst.tolist()):
            if s in wanted:
                out.setdefault(s, []).append(d)
        return out

    def rel_edges_csr(self, relation: int) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) of one relation with src sorted ascending (stable, so
        each source's neighbours stay in file order). Cached."""
        key = ("csr", int(relation))
        if key not in self._cache:
            src, dst = self.rel_edges(relation)
            order = np.argsort(src, kind="stable")
            self._cache[key] = (src[order], dst[order])
        return self._cache[key]

    def rel_endpoint_nodes(self, relation: int) -> np.ndarray:
        """Sorted unique node ids incident to one relation's edges (cached):
        the relation's compact index space. Every node a per-relation
        scorer reads or writes is an endpoint, so the segment-form sweeps
        keep their state in [|endpoints|] instead of [N]."""
        key = ("nodes", int(relation))
        if key not in self._cache:
            src, dst = self.rel_edges(relation)
            self._cache[key] = np.unique(np.concatenate([src, dst]))
        return self._cache[key]

    def rel_degrees(self, relation: int) -> np.ndarray:
        """Per-node out-degree of one relation (int32, cached)."""
        key = ("deg", int(relation))
        if key not in self._cache:
            self._cache[key] = degrees(self.rel_edges(relation)[0],
                                       self.num_nodes)
        return self._cache[key]

    def rel_max_degree(self, relation: int) -> int:
        """Largest out-degree of one relation (at least 1)."""
        deg = self.rel_degrees(relation)
        return max(int(deg.max()) if deg.size else 0, 1)

    def neighbor_table(
        self, relation: int, max_degree: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ELL table of one relation (cached): ``(nbr [N, D], mask [N, D])``,
        row i the destinations of the edges ``(i, relation, d)`` in file
        order, D the largest out-degree (or ``max_degree`` if smaller)."""
        key = ("ell", int(relation), -1 if max_degree is None
               else int(max_degree))
        if key not in self._cache:
            src, dst = self.rel_edges(relation)
            d_max = self.rel_max_degree(relation)
            if max_degree is not None:
                d_max = min(d_max, int(max_degree))
            nbr, mask, _ = build_ell(src, dst, self.num_nodes, max(d_max, 1))
            self._cache[key] = (nbr, mask)
        return self._cache[key]

    def __repr__(self) -> str:
        return (
            f"HeteroGraph(nodes={self.num_nodes}, edges={self.num_edges}, "
            f"relations={self.num_relations}, feat_dim={self.feat_dim})"
        )
