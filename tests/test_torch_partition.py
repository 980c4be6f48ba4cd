"""Out-of-core training (mpgnn_tpu_torch.graph.partition,
mpgnn_tpu_torch.train.stream) on the CPU against the JAX package's.

* ``partition_nodes``: identical block ids (the same draws), on the
  greedy path and the snake path past 500,000 nodes.
* ``subgraph``: the real part of the JAX package's padded subgraph: the
  same nodes in the same order, the same core mask and features, and each
  relation's edges in the same order. The JAX package's pow2 padding and
  pad relation are not ported.
* ``edge_cut_fraction``, ``__repr__``, ``locality_reorder``: identical.
* ``train_mpgnn_clustered`` on the 800-node planted graph of
  tests/test_partition.py (12 epochs, hidden 16, dropout 0, the JAX
  package's initial parameters): the same groups in the same order, final
  loss atol 1e-5, the three macro-F1s atol 1e-6 and the parameters atol
  1e-3 (tests/test_torch_train.py's bounds and reasons: float32 sums in
  other orders, which Adam's division by the gradients' RMS amplifies
  only in the parameters), for segment and csr (csr through K1/K2's plain
  versions), streaming and fused, grouped 2+2 and 2+2+1. In bf16 the
  bounds of tests/test_torch_bf16.py: loss atol 1e-3, F1s atol 1e-6,
  parameters atol 5e-2.
* resident and streaming give bitwise the same parameters; fused (groups at
  the common row count, zero rows outside the loss) gives the streaming
  run's parameters at atol 1e-6 with dropout 0."""

import jax
import numpy as np
import pytest
import torch

from mpgnn_tpu.config import MPGNNConfig as JConfig
from mpgnn_tpu.graph.generate import generate_synthetic_graph
from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.graph.io import split_nodes as j_split
from mpgnn_tpu.graph.partition import PartitionedHeteroGraph as JPart
from mpgnn_tpu.graph.partition import locality_reorder as j_reorder
from mpgnn_tpu.graph.partition import partition_nodes as j_partition
from mpgnn_tpu.models.mpgnn import init_mpgnn as j_init
from mpgnn_tpu.train.stream import train_mpgnn_clustered as j_clustered
from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph as TGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.graph.partition import PartitionedHeteroGraph as TPart
from mpgnn_tpu_torch.graph.partition import locality_reorder, partition_nodes
from mpgnn_tpu_torch.train.stream import (
    fit_mpgnn_clustered,
    train_mpgnn_clustered,
)
from mpgnn_tpu_torch.weights import params_from_jax

LOSS_ATOL, F1_ATOL, PARAM_ATOL = 1e-5, 1e-6, 1e-3
BF16_LOSS_ATOL, BF16_PARAM_ATOL = 1e-3, 5e-2
EPOCHS, HIDDEN = 12, 16


@pytest.fixture(scope="module")
def planted():
    g = generate_synthetic_graph(800, 4, "red-red-blue", seed=7)
    args = (g["node_features"].astype(np.float32), g["src"], g["dst"],
            g["rel"])
    return (JGraph(*args, num_relations=4, labels=g["labels"]),
            TGraph(*args, num_relations=4, labels=g["labels"]), g)


@pytest.mark.parametrize("n,parts,seed,with_edges", [
    (800, 4, 0, True), (800, 5, 3, True), (800, 4, 1, False),
    (600_001, 8, 2, True),
])
def test_partition_nodes_is_identical(n, parts, seed, with_edges):
    rng = np.random.default_rng(seed)
    src = (n * rng.random(3 * n) ** 2).astype(np.int64) if with_edges \
        else None
    want = j_partition(n, parts, src, seed=seed)
    got = partition_nodes(n, parts, src, seed=seed)
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("halo_hops", [0, 2])
@pytest.mark.parametrize("halo_relations", [None, [0, 1]])
@pytest.mark.parametrize("blocks", [[0, 2], [1, 2, 3]])
def test_subgraph_real_part_matches_jax(planted, halo_hops, halo_relations,
                                        blocks):
    jg, tg, _ = planted
    jsub = JPart.from_graph(jg, 4, seed=0).subgraph(
        blocks, halo_hops=halo_hops, halo_relations=halo_relations)
    sub = TPart.from_graph(tg, 4, seed=0).subgraph(
        blocks, halo_hops=halo_hops, halo_relations=halo_relations)
    n = jsub.num_real_nodes
    assert (sub.num_real_nodes, sub.num_real_edges) == (
        n, jsub.num_real_edges)
    assert sub.graph.num_nodes == n and sub.graph.num_edges == \
        jsub.num_real_edges
    np.testing.assert_array_equal(sub.nodes, jsub.nodes[:n])
    np.testing.assert_array_equal(sub.core_mask, jsub.core_mask[:n])
    assert sub.node_mask.all()
    np.testing.assert_array_equal(sub.graph.x, jsub.graph.x[:n])
    np.testing.assert_array_equal(sub.graph.labels, jsub.graph.labels[:n])
    assert sub.graph.num_relations == 4
    for r in range(4):
        for a, b in zip(sub.graph.rel_edges(r), jsub.graph.rel_edges(r)):
            np.testing.assert_array_equal(a, b)


def test_partitioned_graph_views_match_jax(planted, tmp_path):
    jg, tg, _ = planted
    jp, tp = JPart.from_graph(jg, 4, seed=0), TPart.from_graph(tg, 4, seed=0)
    np.testing.assert_array_equal(tp.part, jp.part)
    for b in range(4):
        np.testing.assert_array_equal(tp.block_nodes(b), jp.block_nodes(b))
    for q in (1, 2, 4):
        assert tp.edge_cut_fraction(q) == jp.edge_cut_fraction(q)
    assert repr(tp) == repr(jp)
    assert tp.subgraph([0, 1]) is tp.subgraph([1, 0])            # cached
    assert tp.subgraph([0, 1], halo_hops=1) is not tp.subgraph([0, 1])
    # memmap features are read only for the subgraph's rows
    path = tmp_path / "x.f32"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=tg.x.shape)
    mm[:] = tg.x
    mm.flush()
    x = np.memmap(path, dtype=np.float32, mode="r", shape=tg.x.shape)
    mp = TPart(x, tg.edge_src, tg.edge_dst, tg.edge_type, 4, 4, seed=0)
    sub = mp.subgraph([1], halo_hops=2)
    assert type(sub.graph.x) is np.ndarray
    np.testing.assert_array_equal(sub.graph.x, tg.x[sub.nodes])


def test_locality_reorder_matches_jax(planted):
    jg, tg, g = planted
    labels = g["labels"]
    jg2, js2, jold = j_reorder(jg, j_split(labels))
    tg2, ts2, told = locality_reorder(tg, split_nodes(labels))
    np.testing.assert_array_equal(told, jold)
    for name in ("x", "edge_src", "edge_dst", "edge_type", "labels"):
        np.testing.assert_array_equal(getattr(tg2, name), getattr(jg2, name))
    for name in ("node_idx", "train_idx", "train_y", "val_idx", "val_y",
                 "test_idx", "test_y"):
        np.testing.assert_array_equal(getattr(ts2, name), getattr(js2, name))


def _jax_start(feat_dim, metapaths, seed=0):
    """The port's MPNetm at the JAX trainer's initial parameters."""
    init_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    return params_from_jax(j_init(init_key, feat_dim, HIDDEN, 2, metapaths),
                           device="cpu")


def _assert_params_close(model, jparams, atol):
    want = params_from_jax(jparams, device="cpu")
    for (name, a), b in zip(model.named_parameters(), want.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def _run_both(planted, backend, fused, parts, dtype="float32"):
    jg, tg, g = planted
    labels = g["labels"]
    mp = [list(g["metapath_relations"])]
    jrep, rep = {}, {}
    want = j_clustered(
        JPart.from_graph(jg, parts, seed=0), mp, j_split(labels), 2,
        JConfig(epochs=EPOCHS, hidden_dim=HIDDEN, dropout=0.0,
                compute_dtype=dtype),
        backend=backend, fused=fused, report=jrep)
    got = fit_mpgnn_clustered(
        _jax_start(tg.feat_dim, mp), TPart.from_graph(tg, parts, seed=0),
        mp, split_nodes(labels), 2,
        MPGNNConfig(epochs=EPOCHS, hidden_dim=HIDDEN, dropout=0.0,
                    compute_dtype=dtype),
        None, backend=backend, fused=fused, report=rep)
    return want, got, jrep, rep


@pytest.mark.parametrize("backend,fused,parts", [
    ("segment", False, 4), ("segment", True, 5), ("csr", False, 5),
    ("csr", True, 4),
])
def test_clustered_training_matches_jax(planted, backend, fused, parts):
    want, got, jrep, rep = _run_both(planted, backend, fused, parts)
    assert abs(got.final_loss - want.final_loss) <= LOSS_ATOL
    for k in ("train_f1", "val_f1", "test_f1"):
        assert abs(getattr(got, k) - getattr(want, k)) <= F1_ATOL, k
    assert got.test_f1 > 0.9
    _assert_params_close(got.params, want.params, PARAM_ATOL)
    # the same groups (2+2, or 2+2+1 from 5 parts) of the same real sizes
    keys = ("blocks", "real_nodes", "real_edges", "mp_edges")
    assert [{k: g[k] for k in keys} for g in rep["groups"]] == \
        [{k: g[k] for k in keys} for g in jrep["groups"]]
    assert [len(g["blocks"]) for g in rep["groups"]] == \
        ([2, 2, 1] if parts == 5 else [2, 2])
    assert all(g["pad_nodes"] == g["real_nodes"] for g in rep["groups"])
    # the report carries the JAX package's keys: device memory only on a
    # card, and none of the fused scan's epoch blocks, which are not ported
    assert set(jrep) - {"device_peak_bytes", "first_block_s",
                        "steady_blocks_s", "eval_dispatch_s"} <= set(rep)
    assert set(rep["groups"][0]) == set(jrep["groups"][0])
    assert rep["steps"] == jrep["steps"] == EPOCHS * len(rep["groups"])
    assert rep["fused"] is fused and rep["resident"] is True
    assert len(rep["epoch_s"]) == EPOCHS


def test_bf16_clustered_training_matches_jax(planted):
    want, got, _, _ = _run_both(planted, "csr", False, 4, "bfloat16")
    assert abs(got.final_loss - want.final_loss) <= BF16_LOSS_ATOL
    for k in ("train_f1", "val_f1", "test_f1"):
        assert abs(getattr(got, k) - getattr(want, k)) <= F1_ATOL, k
    _assert_params_close(got.params, want.params, BF16_PARAM_ATOL)


@pytest.mark.parametrize("backend", ["segment", "csr"])
def test_resident_streaming_and_fused_agree(planted, backend):
    """5 parts, 2+2+1 groups of different sizes: the fused run's rows at
    the common row count are cut back to each group before its core-mask
    scatter."""
    _, tg, g = planted
    split = split_nodes(g["labels"])
    mp = [list(g["metapath_relations"])]
    cfg = MPGNNConfig(epochs=5, hidden_dim=HIDDEN, dropout=0.0)
    runs = {}
    for name, kw in (("resident", dict(resident=True)),
                     ("streaming", dict(resident=False)),
                     ("fused", dict(fused=True))):
        rep = {}
        runs[name] = (train_mpgnn_clustered(
            TPart.from_graph(tg, 5, seed=0), mp, split, 2, cfg,
            backend=backend, report=rep, device="cpu", **kw), rep)
    (res, rep_r), (st, rep_s), (fu, rep_f) = runs.values()
    assert rep_r["resident"] and not rep_s["resident"]
    sizes = [grp["real_nodes"] for grp in rep_s["groups"]]
    assert len(set(sizes)) == 3
    for a, b, c in zip(res.params.parameters(), st.params.parameters(),
                       fu.params.parameters()):
        assert torch.equal(a, b)
        np.testing.assert_allclose(c.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=0)
    assert (res.train_f1, res.val_f1, res.test_f1) == \
        (st.train_f1, st.val_f1, st.test_f1) == \
        (fu.train_f1, fu.val_f1, fu.test_f1)
    assert st.test_f1 > 0.9


def test_clustered_training_with_dropout_learns_the_planted_path(planted):
    """tests/test_partition.py's case and quality bar (its default
    backend, segment; dropout 0.6): the default halo, the metapath's
    length, makes receptive fields complete."""
    _, tg, g = planted
    res = train_mpgnn_clustered(
        TPart.from_graph(tg, 4, seed=0), [g["metapath_relations"]],
        split_nodes(g["labels"]), 2, MPGNNConfig(epochs=60, hidden_dim=32),
        blocks_per_step=2, seed=0, device="cpu")
    assert res.val_f1 > 0.95 and res.test_f1 > 0.9


@pytest.mark.parametrize("backend", ["segment", "csr"])
def test_host_hop_ops_at_fused_rows(planted, backend):
    """A group's operands at fused mode's common row count aggregate its
    rows exactly as at its own row count (csr: dedup off, K1's plain
    version) and leave the rows past its own at zero."""
    from mpgnn_tpu_torch.ops.csr import CsrBlocking
    from mpgnn_tpu_torch.models.mpgnn import hop_aggregate
    from mpgnn_tpu_torch.train.stream import host_hop_ops

    _, tg, g = planted
    mp = [list(g["metapath_relations"])]
    sub = TPart.from_graph(tg, 5, seed=0).subgraph([4], halo_hops=3)
    n, n_max = sub.num_real_nodes, sub.num_real_nodes + 37
    x = torch.randn(n, 8, generator=torch.Generator().manual_seed(0))
    x_pad = torch.cat([x, torch.zeros(n_max - n, 8)])
    own = host_hop_ops(sub, mp, backend)[0]
    fused = host_hop_ops(sub, mp, backend, fused_rows=n_max)[0]
    for a, b in zip(own, fused):
        if backend == "csr":
            assert all(isinstance(blk, CsrBlocking) and blk.num_rows == n_max
                       for blk in b[1:])
        want = hop_aggregate(x, a, n)
        got = hop_aggregate(x_pad, b, n_max)
        np.testing.assert_allclose(got[:n].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert not got[n:].any()


def test_fused_refuses_other_backends(planted):
    _, tg, g = planted
    with pytest.raises(ValueError, match="segment or csr"):
        train_mpgnn_clustered(
            TPart.from_graph(tg, 4, seed=0), [g["metapath_relations"]],
            split_nodes(g["labels"]), 2, MPGNNConfig(epochs=1),
            backend="ell", fused=True, device="cpu")
