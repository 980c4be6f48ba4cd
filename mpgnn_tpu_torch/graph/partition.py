"""Partitioned heterogeneous graphs for out-of-core, subgraph training.

A ``PartitionedHeteroGraph`` keeps the big arrays on the host (numpy, or
``np.memmap`` straight off ``graph.generate.load_npy_dir``'s files) and
serves **induced subgraphs over unions of node blocks**, the Cluster-GCN
recipe (Chiang et al., KDD'19): node blocks are fixed at partition time; a
training step takes the induced subgraph of q blocks' union (cross-block
edges inside the union kept) and runs a normal full-graph MPGNN step on it.
Only the sampled subgraph's feature rows are ever read.

Partitioning is degree-balanced greedy (METIS is not available, and for the
locality the synthetic and KG graphs show, balanced blocks are the
documented Cluster-GCN fallback). The JAX package pads each subgraph to
pow2 node and edge buckets under an extra pad relation, so that jit reuses a
few compiled step programs; the port compiles nothing, so a ``Subgraph``
here is the real part alone: the same nodes in the same order, the same
core mask, and each relation's edges in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mpgnn_tpu_torch.graph.hetero import HeteroGraph, NodeSplit


def partition_nodes(
    num_nodes: int,
    num_parts: int,
    edge_src: Optional[np.ndarray] = None,
    seed: int = 0,
) -> np.ndarray:
    """[N] int32 block id per node.

    Degree-balanced greedy: nodes in decreasing degree order go to the block
    with the smallest accumulated degree (ties -> smallest block), which
    keeps per-block induced-edge counts even. Without ``edge_src`` it is a
    seeded balanced random split. The same draws as the JAX package's, so
    the block ids are identical."""
    if num_parts <= 1:
        return np.zeros(num_nodes, dtype=np.int32)
    rng = np.random.default_rng(seed)
    part = np.empty(num_nodes, dtype=np.int32)
    if edge_src is None:
        perm = rng.permutation(num_nodes)
        for b in range(num_parts):
            part[perm[b::num_parts]] = b
        return part
    deg = np.bincount(np.asarray(edge_src), minlength=num_nodes).astype(
        np.int64
    )
    # jitter breaks ties between equal-degree nodes deterministically
    order = np.argsort(-(deg * num_nodes + rng.permutation(num_nodes)),
                       kind="stable")
    if num_nodes > 500_000:
        # multi-million-node fast path: snake round-robin over the
        # degree-sorted order (b0..bP-1, bP-1..b0, ...) — O(N) vectorized
        # instead of the O(N * P) python greedy loop below, and within ~1
        # hub degree of its load balance on power-law graphs (each P-wide
        # stripe of the sorted order spreads its near-equal degrees once
        # forward, once backward)
        lane = np.arange(num_nodes) % (2 * num_parts)
        lane = np.where(lane < num_parts, lane, 2 * num_parts - 1 - lane)
        part[order] = lane.astype(np.int32)
        return part
    load = np.zeros(num_parts, dtype=np.int64)
    count = np.zeros(num_parts, dtype=np.int64)
    for v in order:
        b = int(np.lexsort((count, load))[0])
        part[v] = b
        load[b] += deg[v] + 1
        count[b] += 1
    return part


@dataclasses.dataclass
class Subgraph:
    """One induced subgraph in local ids, ready for a training step.

    ``nodes`` maps local -> global id. With halo expansion ``core_mask``
    selects the sampled blocks' own nodes (the loss and the metrics take
    these; halo rows only feed their receptive fields). ``node_mask`` is
    all True: the port keeps no padded rows."""

    graph: HeteroGraph          # local-id induced subgraph
    nodes: np.ndarray           # [n] global node ids, ascending
    node_mask: np.ndarray       # [n] bool
    core_mask: np.ndarray       # [n] bool, True on the blocks' own nodes
    num_real_nodes: int
    num_real_edges: int


class PartitionedHeteroGraph:
    """Host-resident partitioned graph serving induced subgraphs.

    ``x`` may be an ``np.memmap`` (features never fully materialized); the
    edge arrays may be memmaps too. Only a sampled subgraph's rows are
    copied out."""

    def __init__(
        self,
        x: np.ndarray,
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        edge_type: np.ndarray,
        num_relations: int,
        num_parts: int,
        labels: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        self.x = x
        self.num_nodes = int(x.shape[0])
        self.feat_dim = int(x.shape[1])
        self.num_relations = int(num_relations)
        self.labels = labels
        self.num_parts = int(num_parts)
        self.edge_src = np.asarray(edge_src)
        self.edge_dst = np.asarray(edge_dst)
        self.edge_type = np.asarray(edge_type)
        self.part = partition_nodes(
            self.num_nodes, num_parts, self.edge_src, seed
        )
        self._block_nodes: List[np.ndarray] = [
            np.flatnonzero(self.part == b).astype(np.int64)
            for b in range(self.num_parts)
        ]
        self._sub_cache: Dict[Tuple, Subgraph] = {}

    @classmethod
    def from_graph(
        cls, graph: HeteroGraph, num_parts: int, seed: int = 0
    ) -> "PartitionedHeteroGraph":
        return cls(
            graph.x, graph.edge_src, graph.edge_dst, graph.edge_type,
            graph.num_relations, num_parts, labels=graph.labels, seed=seed,
        )

    def block_nodes(self, block: int) -> np.ndarray:
        return self._block_nodes[block]

    def subgraph(
        self, blocks: Sequence[int], halo_hops: int = 0, cache: bool = True,
        halo_relations: Optional[Sequence[int]] = None,
    ) -> Subgraph:
        """Induced subgraph of the union of ``blocks`` in local ids (global
        order), its edges in file order.

        ``halo_hops=L`` expands the node set L times along the aggregation
        direction (out[src] reads x[dst]), so every core node's L-hop
        receptive field is complete and its predictions and gradients are
        exact, not the cut-edge Cluster-GCN approximation; 0 keeps pure
        Cluster-GCN. ``halo_relations`` restricts the expansion to edges of
        those relations: a fixed metapath's hops read only its relations,
        and on power-law KGs any hub edge would pull the hub and the hub
        everything. Cached by (halo_hops, halo_relations, blocks)."""
        blocks_key = tuple(sorted(int(b) for b in set(blocks)))
        rel_key = (None if halo_relations is None
                   else tuple(sorted(set(int(r) for r in halo_relations))))
        key = (int(halo_hops), rel_key) + blocks_key
        if cache and key in self._sub_cache:
            return self._sub_cache[key]
        member = np.zeros(self.num_nodes, dtype=bool)
        for b in blocks_key:
            member[self._block_nodes[b]] = True
        core = member.copy()
        rel_ok = None
        if rel_key is not None and int(halo_hops) > 0:
            rel_ok = np.isin(self.edge_type, np.asarray(rel_key))
        for _ in range(int(halo_hops)):
            grew = member[self.edge_src]      # one pass over the edges a hop
            if rel_ok is not None:
                grew &= rel_ok
            member[self.edge_dst[grew]] = True
        nodes = np.flatnonzero(member)
        n = len(nodes)
        # global -> local map (a plain int64 array over N, memmap-safe)
        loc = np.full(self.num_nodes, -1, dtype=np.int64)
        loc[nodes] = np.arange(n, dtype=np.int64)
        keep = (loc[self.edge_src] >= 0) & (loc[self.edge_dst] >= 0)
        s = loc[self.edge_src[keep]]
        d = loc[self.edge_dst[keep]]
        t = self.edge_type[keep]
        labels_sub = None
        if self.labels is not None:
            labels_sub = np.asarray(self.labels)[nodes]
        g = HeteroGraph(
            np.asarray(self.x[nodes], dtype=np.float32), s, d, t,
            num_relations=self.num_relations, labels=labels_sub,
        )
        sub = Subgraph(
            graph=g, nodes=nodes.astype(np.int64),
            node_mask=np.ones(n, dtype=bool), core_mask=core[nodes],
            num_real_nodes=n, num_real_edges=len(s),
        )
        if cache:
            self._sub_cache[key] = sub
        return sub

    def edge_cut_fraction(self, blocks_per_step: int = 1) -> float:
        """Expected fraction of edges crossing a random q-block union: the
        Cluster-GCN information loss (q up -> loss down)."""
        same = self.part[self.edge_src] == self.part[self.edge_dst]
        within = float(np.mean(same)) if len(same) else 1.0
        q = blocks_per_step
        p_both = within + (1 - within) * max(q - 1, 0) / max(
            self.num_parts - 1, 1
        )
        return 1.0 - p_both

    def __repr__(self) -> str:
        return (
            f"PartitionedHeteroGraph(nodes={self.num_nodes}, "
            f"edges={len(self.edge_src)}, parts={self.num_parts}, "
            f"cut={self.edge_cut_fraction():.2%})"
        )


def locality_permutation(
    src: np.ndarray, dst: np.ndarray, num_nodes: int
) -> np.ndarray:
    """[N] old node ids in a BFS-clustered order (``old_of_new``).

    Contiguous-id block sharding (the halo backend) inherits whatever
    locality the file's node numbering happens to have; renumbering nodes by
    BFS discovery order clusters each neighborhood into a contiguous id
    range, so block partitions cut fewer edges and halos shrink. Seeds are
    taken in decreasing-degree order (hubs anchor their communities);
    traversal is frontier-vectorized (no per-node Python loop on the BFS
    itself). O(E) total.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    # undirected CSR of the union graph
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    order = np.argsort(u, kind="stable")
    u, v = u[order], v[order]
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=num_nodes), out=indptr[1:])
    deg = indptr[1:] - indptr[:-1]

    visited = np.zeros(num_nodes, bool)
    out = np.empty(num_nodes, np.int64)
    pos = 0
    seeds = np.argsort(-deg, kind="stable")
    si = 0
    while pos < num_nodes:
        while si < num_nodes and visited[seeds[si]]:
            si += 1
        if si >= num_nodes:
            break
        s0 = int(seeds[si])
        visited[s0] = True
        out[pos] = s0
        pos += 1
        frontier = np.array([s0], np.int64)
        while frontier.size:
            starts, lens = indptr[frontier], deg[frontier]
            total = int(lens.sum())
            if total == 0:
                break
            # vectorized flat-range concat: index of every frontier edge
            base = np.repeat(starts - np.concatenate(
                ([0], np.cumsum(lens)[:-1])
            ), lens)
            nbrs = v[base + np.arange(total)]
            nbrs = np.unique(nbrs)
            fresh = nbrs[~visited[nbrs]]
            if fresh.size == 0:
                break
            visited[fresh] = True
            out[pos: pos + fresh.size] = fresh
            pos += fresh.size
            frontier = fresh
    assert pos == num_nodes
    return out


def _permute_labels(labels, old_of_new, num_nodes):
    labels = np.asarray(labels)
    if len(labels) != num_nodes:
        raise ValueError(
            "locality_reorder needs per-node labels (len == num_nodes); "
            "labeled-subset tables would keep stale ids"
        )
    return labels[old_of_new]


def locality_reorder(graph: HeteroGraph, split: Optional[NodeSplit] = None):
    """Relabel a graph's nodes in BFS-clustered order, for halo sharding.

    Returns ``(graph2, split2, old_of_new)``: a new HeteroGraph whose node
    ids cluster neighbourhoods (features, labels and edges relabelled; the
    per-relation edge multisets unchanged, and aggregation is
    permutation-invariant) and the split with its indices remapped. Metrics
    on graph2 / split2 equal the originals; per-node outputs map back
    through ``old_of_new``."""
    old_of_new = locality_permutation(
        graph.edge_src, graph.edge_dst, graph.num_nodes
    )
    new_of_old = np.empty_like(old_of_new)
    new_of_old[old_of_new] = np.arange(graph.num_nodes, dtype=np.int64)
    graph2 = HeteroGraph(
        graph.x[old_of_new],
        new_of_old[graph.edge_src],
        new_of_old[graph.edge_dst],
        graph.edge_type,
        num_relations=graph.num_relations,
        labels=None if graph.labels is None else _permute_labels(
            graph.labels, old_of_new, graph.num_nodes
        ),
    )
    split2 = None
    if split is not None:
        def remap(a):
            return new_of_old[np.asarray(a, np.int64)]

        split2 = NodeSplit(
            node_idx=remap(split.node_idx),
            train_idx=remap(split.train_idx), train_y=split.train_y,
            val_idx=remap(split.val_idx), val_y=split.val_y,
            test_idx=remap(split.test_idx), test_y=split.test_y,
        )
    return graph2, split2, old_of_new
