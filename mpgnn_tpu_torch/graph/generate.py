"""Power-law knowledge-graph generator with one planted metapath.

Same algorithm and random stream as the JAX package's generator, so one seed
gives bit-identical arrays in both packages.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


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
