"""Host-side search bookkeeping: bag construction, pseudo-relabeling,
dictionary cleaning, and the elbow-gap relation selections.

A copy of ``mpgnn_tpu/search/bags.py`` (numpy only), so that the port
imports nothing of the JAX package. These are the small, data-dependent,
order-sensitive pieces of the search, kept as faithful host-side
reproductions of the reference while the training runs on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mpgnn_tpu_torch.graph.hetero import HeteroGraph


def build_dictionaries(
    graph: HeteroGraph,
    relation: int,
    source_nodes: Sequence[int],
    node_labels: np.ndarray,
) -> Tuple[Dict[int, List[int]], Dict[int, List[float]]]:
    """(edge_dictionary, destination_dictionary) for one relation
    (create_edge_dictionary BAGS=False, main.py:387-424): ``{src: [dsts]}``
    restricted to the source set with empty sources pruned, and
    ``{dst: [labels of its sources]}`` in edge-file order.

    ``node_labels`` is node-indexed. (The reference's non-synthetic branch
    indexes labels by position in the source list (main.py:423), which is
    correct at hop 0 but reads wrong entries at later hops once labels are
    node-indexed tensors — a reference bug we do not reproduce.)"""
    src, dst = graph.rel_edges(relation)
    wanted = set(int(v) for v in source_nodes)
    edge_dict: Dict[int, List[int]] = {}
    dest_dict: Dict[int, List[float]] = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        if s in wanted:
            edge_dict.setdefault(s, []).append(d)
            dest_dict.setdefault(d, []).append(float(node_labels[s]))
    return edge_dict, dest_dict


def create_bags(
    edge_dict: Dict[int, List[int]],
    dest_dict: Dict[int, List[float]],
    positive_min_label: float = 0.9,
) -> Tuple[List[List[int]], np.ndarray]:
    """Multi-instance bag construction (create_bags, main.py:545-577).

    For each source (dict insertion order): destinations whose source-label
    minimum exceeds the threshold form one positive bag; every other
    destination becomes a singleton negative bag (deduplicated on insert);
    a final order-preserving dedup pass removes repeated bags."""
    bags: List[List[int]] = []
    labels: List[int] = []
    seen_neg = set()
    for key in edge_dict.keys():
        members: List[int] = []
        for value in edge_dict[key]:
            if min(dest_dict[value]) > positive_min_label:
                members.append(value)
            else:
                if value not in seen_neg:
                    seen_neg.add(value)
                    bags.append([value])
                    labels.append(0)
        if members:
            bags.append(members)
            labels.append(1)
    # order-preserving dedup of full bags (main.py:564-569)
    new_bags: List[List[int]] = []
    new_labels: List[int] = []
    seen = set()
    for b, l in zip(bags, labels):
        key = tuple(b)
        if key not in seen:
            seen.add(key)
            new_bags.append(b)
            new_labels.append(l)
    return new_bags, np.asarray(new_labels, dtype=np.float32)


def clean_dictionaries(
    x: np.ndarray,
    edge_dict: Dict[int, List[int]],
    dest_dict: Dict[int, List[float]],
    attribution: np.ndarray,
    threshold: float = 0.01,
) -> Tuple[Dict[int, List[int]], Dict[int, List[float]]]:
    """Feature-attribution filter (clean_dictionaries, main.py:456-477):
    drop sources whose feature. attribution dot-product is below the
    threshold; for each of their destinations remove ONE zero label from the
    destination's list (if present)."""
    edge_out = dict(edge_dict)
    dest_out = {k: list(v) for k, v in dest_dict.items()}
    for key in list(edge_dict.keys()):
        if float(np.dot(x[key], attribution)) < threshold:
            for destination in edge_out[key]:
                if 0 in dest_out[destination]:
                    dest_out[destination].remove(0)
            del edge_out[key]
    return edge_out, dest_out


def relabel_from_predictions(
    member_pred_max: np.ndarray,
    member_recorded: np.ndarray,
    num_nodes: int,
    threshold: float = 0.9,
) -> Tuple[List[int], np.ndarray]:
    """Pseudo-relabeling (relabel_nodes_inside_bags, main.py:596-634): a
    recorded bag member becomes label 1 iff any restart predicted it above
    the threshold. Returns (new source list = recorded members, node-indexed
    label vector)."""
    new_labels = np.zeros(num_nodes, dtype=np.float32)
    hit = member_recorded & (member_pred_max > threshold)
    new_labels[hit] = 1.0
    sources = np.nonzero(member_recorded)[0].tolist()
    return sources, new_labels


# ----------------------------------------------------------- gap selections
def flat_gap_selection(
    items: Sequence[Tuple[int, float]]
) -> List[Tuple[int, float]]:
    """Hop-0 elbow-gap cut (main.py:1336-1355): sort losses, find the
    largest adjacent gap, keep relations with loss <= the value before the
    gap; with fewer than 3 scored relations keep everything."""
    losses = sorted(l for _, l in items)
    diffs = np.diff(losses)
    if len(diffs) >= 2:
        cut = losses[int(np.argmax(diffs))]
        return [it for it in items if it[1] <= cut]
    return list(items)


def bag_gap_selection(
    items: Sequence[Tuple[int, float]],
    inclusive: bool = False,
) -> List[Tuple[int, float]]:
    """Bag-hop elbow-gap cut (main.py:1410-1424). Faithfully reproduces the
    reference's branching: with > 3 scored relations keep losses STRICTLY
    below the gap value; with 1 or 2 relations keep everything; with exactly
    3 relations (len(diffs) == 2) the reference's condition admits nothing —
    reproduced as-is for parity.

    The strict ``<`` is an upstream bug (hop 0 uses ``<=``,
    main.py:1353): when the largest gap sits right AFTER the best relation —
    i.e. exactly when one relation clearly wins — nothing survives and the
    metapath never extends. ``inclusive=True`` opts into the hop-0-style
    ``<=`` cut (and treats the 3-candidate case like the others), which
    materially improves planted-path recovery on >= 4-relation vocabularies
    (SearchConfig.bag_gap_inclusive)."""
    arr = sorted(l for _, l in items)
    diffs = np.diff(arr)
    if inclusive:
        if len(diffs) >= 2:
            cut = arr[int(np.argmax(diffs))]
            return [it for it in items if it[1] <= cut]
        return list(items)
    if len(diffs) > 2:
        cut = arr[int(np.argmax(diffs))]
        return [it for it in items if it[1] < cut]
    if len(diffs) in (0, 1):
        return list(items)
    return []


def connected_relations(
    graph: HeteroGraph,
    node_labels: Optional[np.ndarray] = None,
    source_nodes: Optional[Sequence[int]] = None,
    bag_members: Optional[Sequence[int]] = None,
) -> List[int]:
    """Candidate relation discovery (node_types_and_connected_relations,
    main.py:56-84), vectorized. Relations are returned in first-appearance
    (edge-file) order, matching the reference's append order:

    * bag mode: relations with an edge whose source is a bag member
    * synthetic hop 0: relations with an edge whose source has label 1
    * masked hop 0: relations with an edge whose source is in the mask
    """
    et = graph.edge_type
    es = graph.edge_src
    if bag_members is not None:
        sel = np.isin(es, np.asarray(list(bag_members), dtype=np.int64))
    elif source_nodes is not None:
        sel = np.isin(es, np.asarray(list(source_nodes), dtype=np.int64))
    else:
        lab = np.asarray(node_labels).reshape(-1)
        sel = lab[es] == 1
    rels = et[sel]
    _, first = np.unique(rels, return_index=True)
    return [int(rels[i]) for i in sorted(first)]
