"""Graph generators with planted metapaths, and the binary dataset layout.

* ``generate_synthetic_graph``: the reference's coloured generator
  (data/synthetic/create_graph_multi_metapath_deterministic.py:24-436),
  vectorized: colored nodes, typed edges whose relation vocabulary is chosen
  per (src-color, dst-color) pair from an (overlap x shared_relations) grid
  of tables, backward-reachability labels along up to three planted
  metapaths, sparsification of off-metapath edges;
* ``generate_powerlaw_kg``: a power-law knowledge graph with one planted
  metapath, the KG-scale stress workload;
* ``write_dat_files``: the reference's five text files; ``write_npy_dir`` /
  ``load_npy_dir``: per-array ``.npy`` files and a raw float32 feature
  memmap, for graphs beyond text scale.

Same algorithms and random streams as the JAX package's generators, so one
seed gives bit-identical arrays and byte-identical files in both packages.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

COLOR_LIST = ["red", "blue"]  # reference :36 (red=[0,1] one-hot col order)

# (overlap, shared_relations) -> {color-pair: relation ids}; reference :71-185
_RELATION_TABLES: Dict[int, Dict[str, List[int]]] = {
    0: {"red-red": [0], "red-blue": [1], "blue-red": [2], "blue-blue": [3]},
    1: {"red-red": [0, 1], "red-blue": [2, 3], "blue-red": [4, 5], "blue-blue": [6, 7]},
    2: {"red-red": [0, 1, 2], "red-blue": [3, 4], "blue-red": [5, 6, 7], "blue-blue": [8, 9]},
    3: {"red-red": [0, 1, 2], "red-blue": [3, 4, 5], "blue-red": [6, 7, 8, 9], "blue-blue": [10, 11, 12, 13]},
    4: {"red-red": [0, 1], "red-blue": [1], "blue-red": [2, 3], "blue-blue": [2]},
    5: {"red-red": [0, 7], "red-blue": [1, 2], "blue-red": [2, 3, 5], "blue-blue": [3, 4]},
    6: {"red-red": [0, 1, 2], "red-blue": [3, 4, 0], "blue-red": [5, 6, 7], "blue-blue": [8, 9, 2]},
    7: {"red-red": [0, 1, 2, 9], "red-blue": [3, 4, 5, 10], "blue-red": [6, 7, 8, 9], "blue-blue": [10, 11, 12, 13]},
    8: {"red-red": [0, 3], "red-blue": [1, 2], "blue-red": [2, 3], "blue-blue": [0, 1]},
    9: {"red-red": [0, 1, 5], "red-blue": [1, 2, 7], "blue-red": [4, 6, 5], "blue-blue": [7, 0, 3]},
    10: {"red-red": [0, 1, 2, 7], "red-blue": [3, 4, 0], "blue-red": [5, 6, 7], "blue-blue": [8, 9, 2, 3]},
    11: {"red-red": [0, 1, 2, 9, 8], "red-blue": [3, 4, 5, 10], "blue-red": [6, 7, 8, 9, 11], "blue-blue": [10, 11, 12, 13]},
    12: {k: list(range(4)) for k in ("red-red", "red-blue", "blue-red", "blue-blue")},
    13: {k: list(range(8)) for k in ("red-red", "red-blue", "blue-red", "blue-blue")},
    14: {k: list(range(10)) for k in ("red-red", "red-blue", "blue-red", "blue-blue")},
    15: {k: list(range(15)) for k in ("red-red", "red-blue", "blue-red", "blue-blue")},
}


def relation_table(overlap: int, shared_relations: int) -> Dict[str, List[int]]:
    """Select the relation vocabulary table (reference :54-69)."""
    return _RELATION_TABLES[overlap * 4 + shared_relations]


def generate_synthetic_graph(
    num_nodes: int,
    max_rel_for_node: int,
    metapath: str,
    overlap: int = 0,
    shared_relations: int = 0,
    seed: int = 0,
    out_dir: Optional[str] = None,
    planted_relations: Optional[Sequence[int]] = None,
    metapath2: Optional[str] = None,
    planted_relations2: Optional[Sequence[int]] = None,
    metapath3: Optional[str] = None,
    planted_relations3: Optional[Sequence[int]] = None,
    multiclass: bool = False,
):
    """Generate a synthetic colored graph with up to three planted metapaths.

    Returns a dict with in-memory arrays and (if ``out_dir``) writes the five
    reference-format files. ``metapath`` is a color path like
    ``"red-red-blue"``; the planted relation per hop is drawn from the
    color-pair table (reference :195-204) unless pinned via
    ``planted_relations``. With ``metapath2`` a second metapath is planted
    and node labels become the UNION of both reachability sets (reference
    :299-352: label1[k]=1 wherever label2[k]=1); sparsification applies only
    to metapath 1, as in the reference (:369-393).

    ``multiclass=True`` (a framework extension — the reference generator
    only emits binary labels) assigns one CLASS per planted path instead of
    the union: label c for the heads of path c (1-based; a later path wins
    ties, matching the one-vs-rest search's per-class binarization), 0 for
    background nodes. With K planted paths the dataset has K+1 classes, each
    non-background class carrying its own recoverable metapath — the
    signal-bearing multi-class workload for run.py's class loop
    (main.py:1214)."""
    rng = np.random.default_rng(seed)
    rel_table = relation_table(overlap, shared_relations)

    def pick_relations(path_str, pinned):
        cp = path_str.split("-")
        oc = [COLOR_LIST.index(c) for c in cp]
        if pinned is None:
            fwd = [
                int(rng.choice(rel_table[f"{cp[i]}-{cp[i+1]}"]))
                for i in range(len(cp) - 1)
            ]
        else:
            fwd = [int(r) for r in pinned]
        return oc, fwd

    order_colors, meta_fwd = pick_relations(metapath, planted_relations)
    metapath_length = len(meta_fwd)
    # Reference reverses both lists before use (:200-203): meta[0] becomes the
    # LAST relation on the path; labels propagate backwards from the far end.
    meta = meta_fwd[::-1]
    order_colors_rev = order_colors[::-1]

    # ------------------------------------------------------------- nodes
    colors = rng.integers(0, len(COLOR_LIST), size=num_nodes)
    node_feats = np.zeros((num_nodes, len(COLOR_LIST)), dtype=np.int64)
    node_feats[np.arange(num_nodes), colors] = 1

    # ------------------------------------------------------------- edges
    out_deg = rng.integers(1, max_rel_for_node + 1, size=num_nodes)
    E = int(out_deg.sum())
    src = np.repeat(np.arange(num_nodes), out_deg)
    # dst sampled uniformly from [0, num_nodes-1) excluding src (reference
    # :245 excludes self-loops; its off-by-one also excludes node N-1 as a
    # destination — reproduced for distributional parity).
    dst = rng.integers(0, num_nodes - 1, size=E)
    clash = dst == src
    while clash.any():
        dst[clash] = rng.integers(0, num_nodes - 1, size=int(clash.sum()))
        clash = dst == src
    # relation drawn uniformly from the color-pair vocabulary (:246-249)
    pair_key = colors[src] * len(COLOR_LIST) + colors[dst]
    rel = np.empty(E, dtype=np.int64)
    for sc in range(len(COLOR_LIST)):
        for dc in range(len(COLOR_LIST)):
            key = sc * len(COLOR_LIST) + dc
            sel = pair_key == key
            vocab = np.asarray(
                rel_table[f"{COLOR_LIST[sc]}-{COLOR_LIST[dc]}"], dtype=np.int64
            )
            rel[sel] = vocab[rng.integers(0, len(vocab), size=int(sel.sum()))]

    # ---------------------------------------- backward reachability labels
    # Hop 0 (reference :260-269): src has color oc_rev[1], edge has relation
    # m[0], dst has color oc_rev[0]. Hop k (:270-290): src color oc_rev[k+1]
    # (relaxed for the last hop), relation m[k], dst reachable at hop k-1
    # with color oc_rev[k].
    def backward_reachability(m, oc_rev):
        embs: List[np.ndarray] = []
        current = np.zeros(num_nodes, dtype=np.int64)
        L = len(m)
        for k in range(L):
            nxt = np.zeros(num_nodes, dtype=np.int64)
            dst_color_ok = colors[dst] == oc_rev[k]
            rel_ok = rel == m[k]
            if k == 0:
                src_ok = colors[src] == oc_rev[1]
                hit = src_ok & rel_ok & dst_color_ok
            elif k == L - 1:
                hit = rel_ok & dst_color_ok & (current[dst] == 1)
            else:
                src_ok = colors[src] == oc_rev[k + 1]
                hit = src_ok & rel_ok & dst_color_ok & (current[dst] == 1)
            nxt[src[hit]] = 1
            embs.append(nxt)
            current = nxt
        return embs, current

    embeddings, labels = backward_reachability(meta, order_colors_rev)
    labels = labels.copy()

    meta2 = meta3 = None
    extra_heads = []                         # per extra path: head mask
    for path_str, pinned in (
        (metapath2, planted_relations2), (metapath3, planted_relations3),
    ):
        if path_str is None:
            continue
        oc_k, fwd_k = pick_relations(path_str, pinned)
        meta_k = fwd_k[::-1]
        embs_k, labels_k = backward_reachability(meta_k, oc_k[::-1])
        embeddings = embeddings + embs_k     # appended to embedding.dat (:311)
        extra_heads.append(labels_k)
        if meta2 is None:
            meta2 = meta_k
        else:
            meta3 = meta_k
    if multiclass:
        # one class per planted path: 1 = path-1 heads, 2 = path-2 heads, ...
        # (later path wins overlaps), 0 = background
        y = np.zeros(num_nodes, dtype=np.int64)
        for ci, heads in enumerate([labels] + extra_heads, start=1):
            y[heads == 1] = ci
        labels = y
    else:
        for heads in extra_heads:
            labels[heads == 1] = 1           # label union (:349-352)

    # ------------------------------------------------- sparsification
    # Reference :369-393: an edge is KEPT unless, for some hop k, its source
    # is hop-k reachable, its destination has the hop-k color, and its
    # relation is NOT the hop-k planted relation — unless the same (source,
    # color) pair also matches the planted relation for some hop (bool=True
    # wins over False).
    emb_fwd = [embeddings[i] for i in range(metapath_length)][::-1]
    meta1 = meta[::-1]
    meta_c1 = order_colors_rev[::-1]
    keep_true = np.zeros(E, dtype=bool)
    keep_false = np.zeros(E, dtype=bool)
    for i in range(metapath_length):
        lbl = emb_fwd[i] == 1
        col_ok = colors[dst] == meta_c1[i]
        src_ok = lbl[src]
        keep_true |= (rel == meta1[i]) & col_ok & src_ok
    for i in range(metapath_length):
        lbl = emb_fwd[i] == 1
        col_ok = colors[dst] == meta_c1[i]
        src_ok = lbl[src]
        keep_false |= (rel != meta1[i]) & col_ok & src_ok & ~keep_true
    keep = ~keep_false
    src_k, rel_k, dst_k = src[keep], rel[keep], dst[keep]

    result = {
        "colors": colors,
        "node_features": node_feats,
        "src": src_k,
        "rel": rel_k,
        "dst": dst_k,
        "labels": labels,
        "embeddings": embeddings,
        "metapath_relations": meta,          # reversed order, as metapath.dat
        "metapath_relations_path_order": meta_fwd,
        "metapath_colors": order_colors_rev,
        "metapath_str": metapath,
        "metapath2_relations": meta2,        # None unless metapath2 given
        "metapath3_relations": meta3,        # None unless metapath3 given
    }

    if out_dir is not None:
        write_dat_files(out_dir, result)
    return result



def generate_powerlaw_kg(
    num_nodes: int,
    num_edges: int,
    num_relations: int,
    metapath_len: int = 2,
    alpha: float = 1.2,
    rel_alpha: float = 1.1,
    num_heads: Optional[int] = None,
    planted_edges_per_node: int = 2,
    feat_colors: int = 4,
    negatives_per_head: float = 1.0,
    seed: int = 0,
    out_dir: Optional[str] = None,
):
    """Power-law knowledge-graph generator — the KG-scale stress workload.

    A framework extension beyond the reference's uniform colored generator:
    FB15K-237-like statistics (SURVEY §2.1 configs #3/#4) with

    * node endpoint popularity ~ (rank+1)^-alpha  (hub in/out-degrees: one
      node can carry thousands of edges of one relation — the scorer's
      hub-degree/segment routing is exercised, not just uniform ELL);
    * relation sizes ~ (rank+1)^-rel_alpha over ``num_relations`` (a few
      huge relations, a long tail of tiny ones — realistic chunking skew);
    * ONE planted metapath of ``metapath_len`` relations with head nodes
      labeled 1 (background 0), recoverable by the search exactly like the
      uniform generator's plants: heads --mp_fwd[0]--> mids --...--> tails,
      planted relations also appear as background noise so scoring is a
      statistical problem, and each planted group carries a distinct color
      so the attribution filter has signal.

    Writes the standard five files when ``out_dir`` is given.  Returns the
    in-memory dict; ``metapath_relations`` is in discovery/eval order
    (reversed forward order), matching metapath.dat line 2."""
    rng = np.random.default_rng(seed)
    N, E, R, L = num_nodes, num_edges, num_relations, metapath_len
    if R < L + 1:
        raise ValueError("need at least metapath_len+1 relations")
    nh = num_heads or max(64, N // 100)

    # ---------------------------------------------------------- background
    # power-law endpoint popularity, decoupled from node id by a permutation
    pop = (np.arange(N, dtype=np.float64) + 1.0) ** (-alpha)
    pop /= pop.sum()
    perm_s, perm_d = rng.permutation(N), rng.permutation(N)
    src = perm_s[rng.choice(N, size=E, p=pop)]
    dst = perm_d[rng.choice(N, size=E, p=pop)]
    # relation sizes power-law over a permuted rank order
    rw = (np.arange(R, dtype=np.float64) + 1.0) ** (-rel_alpha)
    rw /= rw.sum()
    rel = rng.permutation(R)[rng.choice(R, size=E, p=rw)]

    # ------------------------------------------------------------- plant
    # forward chain of disjoint groups; relations drawn from the
    # permuted vocabulary (they also occur in the background noise)
    mp_fwd = rng.choice(R, size=L, replace=False).tolist()
    if (3 * L + 1) * (num_heads or max(64, N // 100)) > N:
        nh = N // (3 * L + 1)
    avail = rng.permutation(N)
    off = 0
    groups = []
    for _ in range(L + 1):
        groups.append(np.sort(avail[off : off + nh]))
        off += nh
    # decoy chains: for each hop i, fresh sources carrying mp_fwd[i]-edges
    # into a color-correct decoy group that LACKS the rest of the chain —
    # every proper prefix of the planted path is then non-discriminative,
    # so perfect classification requires recovering the FULL path
    decoys = []                              # (level, srcs, mids)
    for i in range(L):
        dsrc = avail[off : off + nh]
        off += nh
        dmid = avail[off : off + nh]
        off += nh
        decoys.append((i, dsrc, dmid))

    # separability sparsification (the KG analog of the reference's
    # :369-393 filter): drop background edges that MIMIC a planted hop —
    # same relation, destination inside the next group, source outside the
    # group — so the plant stays statistically recoverable. A vanishing
    # fraction of E; the power-law bulk is untouched.
    drop = np.zeros(len(src), dtype=bool)
    for i in range(L):
        in_next = np.zeros(N, dtype=bool)
        in_next[groups[i + 1]] = True
        in_cur = np.zeros(N, dtype=bool)
        in_cur[groups[i]] = True
        drop |= (rel == mp_fwd[i]) & in_next[dst] & ~in_cur[src]
    src, dst, rel = src[~drop], dst[~drop], rel[~drop]

    p_src, p_dst, p_rel = [], [], []
    k = planted_edges_per_node
    for i in range(L):
        s = np.repeat(groups[i], k)
        d = rng.choice(groups[i + 1], size=len(s))
        p_src.append(s)
        p_dst.append(d)
        p_rel.append(np.full(len(s), mp_fwd[i], dtype=np.int64))
    for i, dsrc, dmid in decoys:
        s = np.repeat(dsrc, k)
        d = rng.choice(dmid, size=len(s))
        p_src.append(s)
        p_dst.append(d)
        p_rel.append(np.full(len(s), mp_fwd[i], dtype=np.int64))
    src = np.concatenate([src] + p_src)
    dst = np.concatenate([dst] + p_dst)
    rel = np.concatenate([rel] + p_rel)
    order = rng.permutation(len(src))        # interleave plant with noise
    src, dst, rel = src[order], dst[order], rel[order]

    # ------------------------------------------------------------ features
    # distinct color per planted group (cycled if L+1 > feat_colors-1);
    # background nodes draw colors uniformly
    colors = rng.integers(0, feat_colors, size=N)
    for gi, grp in enumerate(groups):
        colors[grp] = gi % feat_colors
    for i, dsrc, dmid in decoys:
        colors[dmid] = (i + 1) % feat_colors  # color-correct, chain-broken
        # decoy sources take the level color too (level 0 = head color), so
        # neither the root transform nor the 1-hop color profile separates
        # them — only the full chain does
        colors[dsrc] = i % feat_colors
    feats = np.zeros((N, feat_colors), dtype=np.int64)
    feats[np.arange(N), colors] = 1

    # --------------------------------------------------------------- labels
    # PATTERN-defined, like the reference's backward reachability
    # (create_graph...py:259-297): label(v) = 1 iff v starts a chain
    # v -mp_fwd[0]-> u1 (color c1) -mp_fwd[1]-> u2 (color c2) ... on the
    # FINAL graph. Planted heads satisfy it by construction; background
    # nodes that accidentally match are (consistently) positive too —
    # group-membership labels would make accidental matches irreducible
    # label noise and cap the correct path's F1.
    group_colors = [gi % feat_colors for gi in range(L + 1)]
    reach = (colors == group_colors[L]).astype(np.int64)
    emb_rev = [reach]
    for i in range(L - 1, -1, -1):
        hit = (rel == mp_fwd[i]) & (reach[dst] == 1) \
            & (colors[dst] == group_colors[i + 1])
        nxt = np.zeros(N, dtype=np.int64)
        nxt[src[hit]] = 1
        if i > 0:                           # head color relaxed (ref :270-290)
            nxt &= (colors == group_colors[i]).astype(np.int64)
        reach = nxt
        emb_rev.append(reach)
    labels = reach.copy()

    # FB15K-style labeled-node set: all positives + the level-0 decoy
    # sources that stayed negative (the HARD negatives a prefix model
    # cannot separate) + a random negative sample. A KG's labels live on a
    # subset of entities (load_files_fb15k237 semantics, main.py:138-176);
    # scoring with a FIXED labeled source set is what separates informative
    # relations when positives are a small fraction of the graph.
    pos_nodes = np.nonzero(labels == 1)[0]
    hard_neg = decoys[0][1][labels[decoys[0][1]] == 0] if decoys else \
        np.zeros(0, np.int64)
    n_neg = int(round(negatives_per_head * len(pos_nodes)))
    bg = np.nonzero(labels == 0)[0]
    bg = np.setdiff1d(bg, hard_neg)
    n_rand = max(0, min(n_neg, len(bg)))
    negatives = np.concatenate([
        hard_neg, rng.choice(bg, size=n_rand, replace=False)
    ])
    label_nodes = np.sort(np.concatenate([pos_nodes, negatives]))

    meta = list(map(int, mp_fwd[::-1]))      # discovery/eval order
    result = {
        "colors": colors,
        "node_features": feats,
        "src": src.astype(np.int64),
        "rel": rel.astype(np.int64),
        "dst": dst.astype(np.int64),
        "labels": labels,
        # hop-k ground truth: reachability masks tail -> ... -> head
        "embeddings": emb_rev,
        "metapath_relations": meta,
        "metapath_relations_path_order": list(map(int, mp_fwd)),
        "metapath_colors": [int(colors[groups[i][0]]) for i in range(L + 1)][::-1],
        "metapath_str": "-".join(f"g{i}" for i in range(L + 1)),
        "metapath2_relations": None,
        "metapath3_relations": None,
        "groups": groups,
        "label_nodes": label_nodes,          # FB15K-style labeled subset
    }
    if out_dir is not None:
        write_dat_files(out_dir, result)
    return result


def write_dat_files(out_dir: str, g: dict) -> None:
    """Write the five reference-format files (reference :396-436)."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(g["colors"])
    with open(os.path.join(out_dir, "node.dat"), "w") as f:
        for i in range(n):
            f.write(str(i) + "\t" + "\t".join(str(v) for v in g["node_features"][i]) + "\n")
    with open(os.path.join(out_dir, "link.dat"), "w") as f:
        for s, r, d in zip(g["src"].tolist(), g["rel"].tolist(), g["dst"].tolist()):
            f.write(f"{s}\t{r}\t{d}\n")
    with open(os.path.join(out_dir, "label.dat"), "w") as f:
        # synthetic format: every node; KG format ('label_nodes' present):
        # only the labeled subset, like FB15K's label.dat
        rows = g.get("label_nodes")
        for i in (range(n) if rows is None else rows):
            f.write(f"{i}\t{int(g['labels'][i])}\n")
    with open(os.path.join(out_dir, "embedding.dat"), "w") as f:
        for i in range(n):
            f.write(str(i) + "\t" + "\t".join(str(int(e[i])) for e in g["embeddings"]) + "\t\n")
    with open(os.path.join(out_dir, "metapath.dat"), "w") as f:
        f.write(g["metapath_str"] + "\n")
        f.write(" ".join(str(v) for v in g["metapath_relations"]) + " \n")
        f.write(" ".join(str(v) for v in g["metapath_colors"]) + " ")
    # extra planted paths (framework extension): one file per path, line 2 =
    # relations in reversed (search-discovery) order like metapath.dat
    for key, fname in (("metapath2_relations", "metapath2.dat"),
                       ("metapath3_relations", "metapath3.dat")):
        if g.get(key) is not None:
            with open(os.path.join(out_dir, fname), "w") as f:
                f.write("\n")
                f.write(" ".join(str(v) for v in g[key]) + " \n")


def write_npy_dir(out_dir: str, g: dict, num_relations: int) -> None:
    """Binary dataset layout for beyond-text-scale graphs (100M+ edges).

    Per-array ``.npy`` files (loadable with ``np.load(..., mmap_mode='r')``
    — the out-of-core ingestion path ``load_npy_dir`` uses) plus the node
    features as a raw float32 memmap ``x.f32`` so training never
    materializes them in RAM. The ``.dat`` text files serialize the same
    graph in minutes of pure python I/O at this scale; this writes at disk
    bandwidth."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "src.npy"), g["src"].astype(np.int32))
    np.save(os.path.join(out_dir, "dst.npy"), g["dst"].astype(np.int32))
    np.save(os.path.join(out_dir, "rel.npy"), g["rel"].astype(np.int32))
    np.save(os.path.join(out_dir, "labels.npy"), g["labels"].astype(np.int8))
    np.save(os.path.join(out_dir, "label_nodes.npy"),
            g["label_nodes"].astype(np.int64))
    x = g["node_features"].astype(np.float32)
    mm = np.memmap(os.path.join(out_dir, "x.f32"), dtype=np.float32,
                   mode="w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({
            "num_nodes": int(x.shape[0]), "feat_dim": int(x.shape[1]),
            "num_edges": int(len(g["src"])),
            "num_relations": int(num_relations),
            "metapath_relations": list(map(int, g["metapath_relations"])),
        }, f)


def load_npy_dir(folder: str):
    """Load a ``write_npy_dir`` dataset with O(1) RAM for the big arrays.

    Returns ``(meta, x_memmap, src, dst, rel, labels, label_nodes)`` where
    ``x`` is a read-only float32 memmap and the edge arrays are
    ``mmap_mode='r'`` views — nothing is materialized until touched."""
    with open(os.path.join(folder, "meta.json")) as f:
        meta = json.load(f)
    x = np.memmap(os.path.join(folder, "x.f32"), dtype=np.float32, mode="r",
                  shape=(meta["num_nodes"], meta["feat_dim"]))
    ld = lambda n: np.load(os.path.join(folder, n), mmap_mode="r")  # noqa: E731
    return (meta, x, ld("src.npy"), ld("dst.npy"), ld("rel.npy"),
            ld("labels.npy"), ld("label_nodes.npy"))


def read_planted_metapath(folder: str) -> List[int]:
    """Read the planted relation sequence from metapath.dat (line 2).

    The stored order is the reference's reversed order, which is exactly the
    order MultiMetapathGNN applies relations hop-by-hop and the order the
    search engine discovers them (prepending each earlier hop, main.py:1427).
    """
    with open(os.path.join(folder, "metapath.dat")) as f:
        lines = f.read().splitlines()
    return [int(v) for v in lines[1].split()]
