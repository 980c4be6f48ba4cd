"""The benchmark's graph generator: a typed graph of a configuration's
published counts, made on the device.

The edge list is drawn once from the configuration's ``structure_seed``:
each relation side's endpoints by the port's power-law convention (an
endpoint of rank k drawn with weight (k + 1)^-alpha, alpha 0 for a
uniform side), each rank placed on a node of its type by a permutation of
that side's own. ``--seed`` then relabels every node by one random
permutation and draws the features, the labels and the split. So every
seed gives the same shapes, per-relation edge counts and degree sequences,
and the program the same partitions and routing; only the values and the
node ids move.

Relations are numbered as the configuration lists them, then their reverses
(``rev_<name>``, src and dst swapped) in the same order. The arrays come
grouped by relation, each relation's edges in the order drawn (its file
order).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch


@dataclasses.dataclass
class Graph:
    """One seed's graph, on the device it was made on."""

    num_nodes: int
    relation_names: List[str]
    src: torch.Tensor          # [E] int64, grouped by relation
    dst: torch.Tensor          # [E] int64
    edge_type: torch.Tensor    # [E] int64
    rel_ptr: List[int]         # [R + 1] offsets of each relation's edges
    node_type: torch.Tensor    # [N] int64, index into the config's types
    x: torch.Tensor            # [N, F] float32
    labeled: torch.Tensor      # [L] node ids of the labeled type
    labels: torch.Tensor       # [L] class of each labeled node
    split: Dict[str, torch.Tensor]   # train / valid / test: positions in
                                     # ``labeled``

    @property
    def num_relations(self) -> int:
        return len(self.relation_names)

    def rel_edges(self, r: int):
        """(src, dst) of relation ``r``, in its file order."""
        a, b = self.rel_ptr[r], self.rel_ptr[r + 1]
        return self.src[a:b], self.dst[a:b]

    def relation_id(self, name: str) -> int:
        return self.relation_names.index(name)


def _draw(n: int, count: int, alpha: float, gen: torch.Generator,
          device) -> torch.Tensor:
    """``count`` endpoint ids in [0, n): rank k drawn with weight
    (k + 1)^-alpha (uniform at alpha 0), ranks then placed on ids by a
    random permutation."""
    if alpha == 0.0:
        return torch.randint(n, (count,), generator=gen, device=device)
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** -alpha
    cdf = torch.cumsum(w, 0)
    u = torch.rand(count, generator=gen, device=device,
                   dtype=torch.float64) * cdf[-1]
    rank = torch.searchsorted(cdf, u).clamp_max(n - 1)
    return torch.randperm(n, generator=gen, device=device)[rank]


def structure(gcfg: dict, device) -> Dict[str, object]:
    """The seed-independent part: per forward relation its (src, dst) local
    ids within their node types, drawn from ``structure_seed``."""
    gen = torch.Generator(device=device).manual_seed(
        int(gcfg["structure_seed"]))
    types = gcfg["node_types"]
    out = []
    for rel in gcfg["relations"]:
        a_src, a_dst = gcfg["degree_alpha"][rel["name"]]
        e = int(rel["edges"])
        s = _draw(int(types[rel["src"]]), e, float(a_src), gen, device)
        d = _draw(int(types[rel["dst"]]), e, float(a_dst), gen, device)
        out.append((s, d))
    return {"edges": out}


def generate(gcfg: dict, seed: int, device) -> Graph:
    """The graph of configuration ``gcfg`` (a config's ``graph``) under
    ``seed``, on ``device``."""
    device = torch.device(device)
    types = list(gcfg["node_types"])
    counts = [int(gcfg["node_types"][t]) for t in types]
    offsets = [0]
    for c in counts:
        offsets.append(offsets[-1] + c)
    n = offsets[-1]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    relabel = torch.randperm(n, generator=gen, device=device)

    names, srcs, dsts = [], [], []
    st = structure(gcfg, device)["edges"]
    for rel, (s, d) in zip(gcfg["relations"], st):
        names.append(rel["name"])
        srcs.append(relabel[s + offsets[types.index(rel["src"])]])
        dsts.append(relabel[d + offsets[types.index(rel["dst"])]])
    if gcfg.get("reverse_relations"):
        names += ["rev_" + r["name"] for r in gcfg["relations"]]
        srcs, dsts = srcs + dsts, dsts + srcs
    rel_ptr = [0]
    for s in srcs:
        rel_ptr.append(rel_ptr[-1] + int(s.numel()))
    edge_type = torch.repeat_interleave(
        torch.arange(len(srcs), device=device),
        torch.tensor([int(s.numel()) for s in srcs], device=device))

    node_type = torch.empty(n, dtype=torch.long, device=device)
    node_type[relabel] = torch.repeat_interleave(
        torch.arange(len(types), device=device),
        torch.tensor(counts, device=device))
    x = torch.randn(n, int(gcfg["feature_dim"]), generator=gen,
                    device=device)
    lt = types.index(gcfg["labeled_type"])
    labeled = relabel[offsets[lt]:offsets[lt + 1]]
    labels = torch.randint(int(gcfg["num_classes"]), (labeled.numel(),),
                           generator=gen, device=device)
    order = torch.randperm(labeled.numel(), generator=gen, device=device)
    split, at = {}, 0
    for part in ("train", "valid", "test"):
        k = int(gcfg["split"][part])
        split[part] = order[at:at + k]
        at += k
    return Graph(num_nodes=n, relation_names=names, src=torch.cat(srcs),
                 dst=torch.cat(dsts), edge_type=edge_type, rel_ptr=rel_ptr,
                 node_type=node_type, x=x, labeled=labeled, labels=labels,
                 split=split)


def scaled(gcfg: dict, factor: float) -> dict:
    """A copy of ``gcfg`` with every node, edge and split count divided by
    ``factor`` (at least 1 each): for tests on the CPU."""
    out = dict(gcfg)
    out["node_types"] = {t: max(1, int(c / factor))
                         for t, c in gcfg["node_types"].items()}
    out["relations"] = [dict(r, edges=max(1, int(r["edges"] / factor)))
                        for r in gcfg["relations"]]
    lt = out["node_types"][gcfg["labeled_type"]]
    tr = max(1, int(gcfg["split"]["train"] / factor))
    va = max(1, int(gcfg["split"]["valid"] / factor))
    out["split"] = {"train": tr, "valid": va, "test": max(1, lt - tr - va)}
    return out
