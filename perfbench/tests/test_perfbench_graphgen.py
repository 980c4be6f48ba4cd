"""Two seeds give the same work: shapes, per-relation edge counts, degree
sequences, the backend 'auto' resolves, and the csr blockings' kinds and
K1's shares; only the node ids, the features, the labels and the split
move. At a reduced size on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import graphgen, harness
from perfbench.drivers.train import hetero_graph
from perfbench.tests.perfbench_helpers import CHECKOUT

FACTOR = 200.0
SEEDS = (5, 2 ** 31 + 3)


@pytest.fixture(scope="module")
def graphs():
    bench = harness.load_benchmark(CHECKOUT)
    cfg = harness.config_of(bench, "mag_mpnetm_h64", CHECKOUT)
    g = graphgen.scaled(cfg["graph"], FACTOR)
    return cfg, g, [graphgen.generate(g, s, "cpu") for s in SEEDS]


def degree_sequences(graph):
    out = []
    for r in range(graph.num_relations):
        s, d = graph.rel_edges(r)
        for side in (s, d):
            deg = torch.bincount(side, minlength=graph.num_nodes)
            out.append(np.sort(deg.numpy()))
    return out


def test_counts_and_degrees(graphs):
    _, g, (a, b) = graphs
    assert a.rel_ptr == b.rel_ptr
    assert a.num_nodes == b.num_nodes == sum(g["node_types"].values())
    assert a.x.shape == b.x.shape
    assert {k: v.numel() for k, v in a.split.items()} == \
        {k: v.numel() for k, v in b.split.items()}
    for da, db in zip(degree_sequences(a), degree_sequences(b)):
        np.testing.assert_array_equal(da, db)
    assert not torch.equal(a.src, b.src)           # the ids moved
    assert not torch.equal(a.x, b.x)
    # each relation joins the types the configuration names
    for r, rel in enumerate(g["relations"]):
        s, d = a.rel_edges(r)
        types = list(g["node_types"])
        assert set(a.node_type[s].tolist()) == {types.index(rel["src"])}
        assert set(a.node_type[d].tolist()) == {types.index(rel["dst"])}


def test_the_program_routes_both_seeds_alike(graphs):
    from mpgnn_tpu_torch.ops import csr
    from mpgnn_tpu_torch.train import loops

    cfg, _, (a, b) = graphs
    seen = []
    for graph in (a, b):
        hg = hetero_graph(graph)
        mps = [[graph.relation_id(r) for r in mp]
               for mp in cfg["model"]["metapaths"]]
        backend = loops.resolve_backend("auto", hg, mps, budget_bytes=1)
        kinds = []
        for r in sorted({r for mp in mps for r in mp}):
            fwd, bwd = csr.build_csr_blocking(*hg.rel_edges(r),
                                              hg.num_nodes)
            for blk in (fwd, bwd):
                kinds.append((type(blk).__name__,
                              blk.col.shape[0] + blk.num_rows))
        seen.append((backend, kinds))
    assert seen[0] == seen[1]
