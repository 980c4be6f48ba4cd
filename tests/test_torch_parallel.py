"""The port's parallel/ package (mesh, halo, shard, context) on gloo CPU
ranks against the JAX package on the same number of virtual CPU devices.

One pool of 4 ranks (``spawn_ranks``) runs every multi-rank check of this
file once (``_rank_checks``, a module-level function that imports nothing
of JAX); the tests hold its results against the JAX package's, computed in
this process (``jax.devices()[:P]`` of conftest's 8, the Pallas kernels in
interpret mode), and against the port's single-process runs. Inputs are
made from seeds with numpy; initial parameters are carried from the JAX
package with ``weights.params_from_jax``; dropout is 0 where runs are
compared.

Tolerances, with their reasons:
* halo plans, halo volume, ``halo_local='auto'``'s resolution: equal.
* node-sharded aggregation, values and gradients: 1e-5 (float32 sums in
  other orders; the JAX tests' own bound).
* bf16 aggregation at degree 1000: the JAX test's 2e-2 against the true
  mean, and the two packages within one bf16 ulp (2^-7 relative).
* node-sharded training (5 epochs, dropout 0): final loss rtol 1e-4 /
  atol 1e-5, validation and test F1 equal, against the JAX package's halo
  run and the port's single-process 'segment' and 'csr' runs. In bf16 the
  single-process reference is 'csr', which like the halo path sums each
  mean in float32 and rounds once (the port's bf16 'segment' sums in
  bf16), and the JAX run is held at tests/test_torch_bf16.py's training
  bound, atol 1e-3 (bf16 rounds at other places in the two frameworks),
  F1s equal. The bf16 case trains on a planted graph: on the toy's random
  labels (seed 9) the validation predictions sit at ties that one bf16
  ulp moves, and the halo run's F1 (0.2571) parted from both the
  single-process csr run's (0.3250) and the JAX run's (0.2755) at equal
  losses.
* edge-partitioned mean: 1e-5. Sharded (data, model) = (2, 2) step: five
  losses rtol 1e-5 against the JAX package's (2, 2) mesh.
* sweeps split over 2 ranks against the same chunks unsplit: 1e-6
  (every candidate's arithmetic is the same; only its rank differs).
"""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mpgnn_tpu_torch.config import MPGNNConfig, ScorerConfig
from mpgnn_tpu_torch.graph.generate import generate_synthetic_graph
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.ops.csr import ref_mean
from mpgnn_tpu_torch.parallel import context, halo, shard
from mpgnn_tpu_torch.parallel.mesh import (
    all_gather_rows,
    make_mesh,
    spawn_ranks,
)
from mpgnn_tpu_torch.train import loops
from mpgnn_tpu_torch.utils.prof import spans

WORLD = 4
AGG_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 training against the JAX package: the two frameworks round at other
# places (XLA fuses adds that PyTorch rounds one by one), the bound of
# tests/test_torch_bf16.py's train_mpgnn comparison
BF16_JAX_LOSS_TOL = dict(rtol=0, atol=1e-3)


# ------------------------------------------------------------------- inputs
def _random_relation(seed, n, e):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


def _skewed_relation(n, p):
    """The JAX test's skew (``test_distributed.py:210``): shard 0 reads many
    rows of shard 1, the other pairs a few."""
    rng = np.random.default_rng(0)
    s = n // p
    src = np.concatenate([rng.integers(0, s, 3000), rng.integers(0, n, 400)])
    dst = np.concatenate([rng.integers(s, 2 * s, 3000),
                          rng.integers(0, n, 400)])
    return src, dst


# (name, seed, N, E, F) of the JAX tests' aggregation inputs
AGG_CASES = {
    "reference": (3, 100, 700, 8),        # test_distributed.py:106
    "ppermute": (7, 120, 900, 8),         # :173
    "csr_vs_segment": (13, 140, 900, 8),  # :285
}


def _agg_inputs(case):
    seed, n, e, f = AGG_CASES[case]
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return src, dst, x


def _hub_inputs():
    """test_distributed.py:138: node 0 with 1000 edges over every shard,
    features rounded to bf16."""
    rng = np.random.default_rng(11)
    n, f, deg = 64, 8, 1000
    src = np.zeros(deg, np.int64)
    dst = rng.integers(0, n, deg)
    x = torch.from_numpy(rng.random((n, f)).astype(np.float32) + 0.6)
    return src, dst, x.bfloat16().float().numpy()


def _silent_inputs():
    """Every edge reads a row of block 0: at P = 2 rank 1 sends nothing."""
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 100, 600), rng.integers(0, 50, 600)
    return src, dst, rng.normal(size=(100, 8)).astype(np.float32)


def _toy_arrays(seed, n=96, e=500, f=4, r=3, c=2):
    """test_distributed.py:386's toy graph."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    labels = rng.integers(0, c, n)
    return (x, src, dst, rel), r, labels


def _toy(seed, **kw):
    arrays, r, labels = _toy_arrays(seed, **kw)
    return HeteroGraph(*arrays, num_relations=r), split_nodes(labels)


def _planted_arrays():
    """A planted graph (test_elastic.py's generator settings), whose labels
    a metapath explains: predictions sit far from ties."""
    g = generate_synthetic_graph(300, 4, "red-red-blue", seed=5)
    arrays = (g["node_features"].astype(np.float32), g["src"], g["dst"],
              g["rel"])
    return arrays, 4, g["labels"]


def _case_arrays(case):
    seed = TRAIN_CASES[case][0]
    return _planted_arrays() if seed is None else _toy_arrays(seed)


def _case_graph(case):
    arrays, r, labels = _case_arrays(case)
    return HeteroGraph(*arrays, num_relations=r), split_nodes(labels)


# training variants: (toy seed, or None for the planted graph, metapaths,
# config, class_weighted)
TRAIN_CASES = {
    "a2a_segment": (7, [[0, 1], [2]], dict(), False),
    "ppermute_segment": (11, [[0, 1]], dict(halo_exchange="ppermute"),
                         False),
    "a2a_csr": (15, [[0, 1]], dict(halo_local="csr"), False),
    "ppermute_csr": (7, [[0, 1], [2]], dict(halo_exchange="ppermute",
                                             halo_local="csr"), False),
    "ppermute_blocks": (11, [[0, 1]], dict(halo_exchange="ppermute",
                                           num_blocks=2), False),
    "bf16_bases": (None, [[0, 1]], dict(num_bases=2,
                                        compute_dtype="bfloat16",
                                        halo_local="csr"), True),
}
TRAIN_SEED = 3


def _train_cfg(case):
    return MPGNNConfig(hidden_dim=8, epochs=5, dropout=0.0,
                       **TRAIN_CASES[case][2])


# the sweeps: the JAX search tests' graph, cut
def _sweep_graph():
    g = generate_synthetic_graph(400, 4, "red-red-blue", seed=11)
    graph = HeteroGraph(g["node_features"].astype(np.float32), g["src"],
                        g["dst"], g["rel"], num_relations=4,
                        labels=g["labels"])
    return graph, g


SWEEP_CFG = ScorerConfig(epochs_flat=20, epochs_bags=10, max_restarts=3)


def _sweeps(graph, g, device):
    """The hop-0 sweep, a bag sweep and the batched evaluation of the
    search on ``graph``, each from its own seeded stream."""
    from mpgnn_tpu_torch.search.scoring import (
        score_bag_tasks,
        score_relations_flat,
    )
    from mpgnn_tpu_torch.train.batch_eval import evaluate_candidates

    labels = g["labels"].astype(np.float32)
    flat = score_relations_flat(graph, [0, 1, 2, 3], labels, None, SWEEP_CFG,
                                np.random.default_rng(0), device=device)
    rel = int(g["metapath_relations"][-1])
    src, dst = graph.rel_edges(rel)
    bags = [list(map(int, dst[src == s][:4])) for s in np.unique(src)[:12]]
    bag_labels = labels[np.unique(src)[:12]]
    tasks = [(0, [0, 1, 2, 3], bags, bag_labels),
             (1, [1, 2], bags[:6], bag_labels[:6])]
    bag = score_bag_tasks(graph, tasks, SWEEP_CFG, np.random.default_rng(1),
                          device=device)
    split = split_nodes(g["labels"])
    f1s = evaluate_candidates(
        graph, [[0], [1], [2], [0, 1], [1, 2], [2, 3], [3, 0]], split, 2,
        MPGNNConfig(epochs=5, hidden_dim=8), backend="segment",
        device=device)
    return flat, bag, f1s


def _sweep_arrays(flat, bag, f1s):
    out = {f"flat{r}": (s.loss, s.weights) for r, s in flat.items()}
    for tid, scores in bag.items():
        for r, s in scores.items():
            out[f"bag{tid}.{r}"] = (s.loss, s.weights, s.attribution,
                                    s.member_pred_max, s.num_restarts,
                                    s.degenerate)
    out["eval"] = f1s
    return out


# ------------------------------------------------------- the ranks' checks
def _flat_sweep_arrays():
    """test_distributed.py:60's relation-sweep batch arrays, R = 7."""
    rng = np.random.default_rng(0)
    return (rng.random((7, 16)).astype(np.float32),
            rng.integers(0, 16, (7, 16, 4)), rng.random((7, 16, 4)) > 0.3)


def _blocks(mesh, t):
    """Every rank's block of a node-sharded tensor, gathered in order."""
    return all_gather_rows(t.detach().contiguous(),
                           mesh.axis_group("nodes")).numpy()


def _exchanges() -> int:
    return spans().get("halo.exchange", {"calls": 0})["calls"]


def _aggregate(mesh, device, src, dst, x, exchange, local, grad):
    n = x.shape[0]
    plan = halo.build_halo_plan(src, dst, n, mesh.size, exchange)
    sh = plan.shard(mesh.axis_rank("nodes"), device, local)
    xl = halo.shard_graph_features(x, mesh, "nodes", device)
    xl.requires_grad_(grad)
    before = _exchanges()
    out = halo.halo_sharded_mean_aggregate(mesh, xl, sh)
    if grad:
        (out.float() ** 2).sum().backward()
    res = {"out": _blocks(mesh, out), "exchanges": _exchanges() - before}
    if grad:
        res["grad"] = _blocks(mesh, xl.grad)
    return res


def _train_halo(mesh, device, case, model):
    """(final loss, val F1, test F1) of the node-sharded run of ``case``
    from the carried ``model`` (copied: the ranks share its tensors)."""
    model = copy.deepcopy(model)
    _, mps, _, cw_on = TRAIN_CASES[case]
    g, split = _case_graph(case)
    cfg = _train_cfg(case)
    hop_ops = loops.build_hop_arrays(
        g, mps, backend="halo", device=device,
        dtype=loops.compute_dtype(cfg), mesh=mesh,
        halo_exchange=cfg.halo_exchange, halo_local=cfg.halo_local)
    x = halo.shard_graph_features(g.x, mesh, "nodes", device)
    cw = loops.class_weights(split.train_y, 2, cw_on)
    rows = halo.HaloRows(mesh, "nodes", x.shape[0], split, cw, device)
    _, val, test, loss = loops.fit_mpgnn(
        model, hop_ops, x, rows.split, torch.as_tensor(cw), cfg, None, 2,
        rows=rows)
    return loss, val, test


def _rank_checks(device, models, sharded_params):
    rank = dist.get_rank()
    out = {}
    mesh4 = make_mesh((4,), ("nodes",), device=device)
    mesh2 = make_mesh((2,), ("nodes",), ranks=[0, 1], device=device)
    for p, mesh in ((4, mesh4), (2, mesh2)):
        if mesh.rank is None:
            continue
        for case in AGG_CASES:
            src, dst, x = _agg_inputs(case)
            for exchange in halo.EXCHANGES:
                for local in halo.LOCALS:
                    out[("agg", p, case, exchange, local)] = _aggregate(
                        mesh, device, src, dst, x, exchange, local, True)
        if p == 2:                      # rank 1 sends no row
            src, dst, x = _silent_inputs()
            for exchange in halo.EXCHANGES:
                for local in halo.LOCALS:
                    out[("silent", exchange, local)] = _aggregate(
                        mesh, device, src, dst, x, exchange, local, True)
        # test_distributed.py:334, N = 7 padded to 8
        x = np.ones((7, 4), np.float32)
        out[("pad", p)] = _aggregate(mesh, device, np.array([0, 5]),
                                     np.array([5, 0]), x, "a2a", "segment",
                                     False)
        src, dst, x = _hub_inputs()
        for local in halo.LOCALS:
            plan = halo.build_halo_plan(src, dst, 64, p)
            sh = plan.shard(mesh.axis_rank("nodes"), device, local)
            xl = halo.shard_graph_features(x, mesh, "nodes", device)
            y = halo.halo_sharded_mean_aggregate(mesh, xl.bfloat16(), sh)
            out[("hub", p, local)] = _blocks(mesh, y.float())
    # training: the carried JAX parameters and the entry point from a seed
    for case, model in models.items():
        out[("train", case)] = _train_halo(mesh4, device, case, model)
    g, split = _toy(7)
    r = loops.train_mpgnn(g, [[0, 1], [2]], split, 2,
                          MPGNNConfig(hidden_dim=8, epochs=5, dropout=0.5),
                          seed=TRAIN_SEED, backend="halo", mesh=mesh4)
    out["entry"] = (r.final_loss, r.val_f1, r.test_f1)
    # the per-step form over the same pieces
    step, _, _, _ = halo.build_node_sharded_train_step(
        mesh4, g, [[0, 1], [2]], split, 2,
        MPGNNConfig(hidden_dim=8, dropout=0.0), seed=TRAIN_SEED)
    out["steps"] = [float(step()) for _ in range(3)]
    # halo_local='auto': the relation's edge count against the cutover
    g21, _ = _toy(21)
    kinds = []
    for cutover in (loops.CSR_EDGE_CUTOVER, 1):
        saved, loops.CSR_EDGE_CUTOVER = loops.CSR_EDGE_CUTOVER, cutover
        try:
            op = loops.build_hop_arrays(g21, [[0]], backend="halo",
                                        device=device, mesh=mesh4,
                                        halo_local="auto")[0][0]
        finally:
            loops.CSR_EDGE_CUTOVER = saved
        kinds.append(op[3].local)
    out["auto"] = kinds
    # edge partitioning and the sharded step on (data, model) = (2, 2)
    mesh22 = make_mesh((2, 2), ("data", "model"), device=device)
    src, dst = _random_relation(0, 64, 500)
    x = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    blk = [torch.as_tensor(shard.edge_block(a, mesh22))
           for a in (src, dst, np.ones(500, dtype=bool))]
    out["edge_partitioned"] = shard.edge_partitioned_aggregate(
        mesh22, torch.as_tensor(x), *blk, 64).numpy()
    g1, split1 = _toy(1, n=128, e=600, f=4, r=2)
    step = shard.build_sharded_train_step(
        mesh22, g1, [[0, 1]], split1, 2,
        MPGNNConfig(hidden_dim=16, dropout=0.0),
        init_params=sharded_params)
    out["sharded"] = [step() for _ in range(5)]
    # the sweeps split over ranks 0 and 1
    mesh_rel = make_mesh((2,), ("rel",), ranks=[0, 1], device=device)
    if mesh_rel.rank is not None:
        out["flat_args"] = shard.sharded_flat_sweep_args(
            mesh_rel, *_flat_sweep_arrays())
        graph, g = _sweep_graph()
        with context.sweep_mesh(mesh_rel):
            out["sweeps"] = _sweep_arrays(*_sweeps(graph, g, device))
    return out


# ------------------------------------------------------------ JAX helpers
def _jax_mesh(p, names=("nodes",), shape=None):
    import jax

    from mpgnn_tpu.parallel import make_mesh as j_mesh

    return j_mesh(shape or (p,), names, jax.devices()[:int(np.prod(
        shape or (p,)))])


def _jax_graph(arrays, r, labels=None):
    from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph

    return JGraph(*arrays, num_relations=r, labels=labels)


def _jax_train_init(case):
    """The JAX trainer's initial parameters of ``case`` (train_mpgnn's
    init key of TRAIN_SEED), as the port's MPNetm on the CPU."""
    import jax

    from mpgnn_tpu.models.mpgnn import init_mpgnn as j_init
    from mpgnn_tpu_torch.weights import params_from_jax

    _, mps, kw, _ = TRAIN_CASES[case]
    feat = _case_arrays(case)[0][0].shape[1]
    init_key, _ = jax.random.split(jax.random.PRNGKey(TRAIN_SEED))
    return params_from_jax(j_init(init_key, feat, 8, 2, mps,
                                  num_bases=kw.get("num_bases"),
                                  num_blocks=kw.get("num_blocks")),
                           device="cpu")


def _jax_sharded_init():
    import jax

    from mpgnn_tpu.models.mpgnn import init_mpgnn as j_init
    from mpgnn_tpu_torch.weights import params_from_jax

    return params_from_jax(j_init(jax.random.PRNGKey(0), 4, 16, 2,
                                  [[0, 1]]), device="cpu").state_dict()


@pytest.fixture(scope="module")
def ranks():
    """Rank 0's results of ``_rank_checks`` and every rank's, from one pool
    of 4 gloo CPU ranks."""
    models = {case: _jax_train_init(case) for case in TRAIN_CASES}
    res = spawn_ranks(_rank_checks, WORLD, (models, _jax_sharded_init()),
                      device="cpu", timeout_s=400)
    return res


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("exchange", ["a2a", "ppermute"])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_halo_plan_matches_jax(kind, p, exchange):
    """Per (owner, reader) pair the rows sent, and per shard each edge's
    (local source, global destination), equal the JAX plan's; so do the
    padded features."""
    from mpgnn_tpu.parallel.halo import build_halo_plan as j_plan
    from mpgnn_tpu.parallel.halo import pad_node_features as j_pad

    n = 512
    src, dst = (_random_relation(5, n, 3000) if kind == "uniform"
                else _skewed_relation(n, p))
    jp = j_plan(src, dst, n, p, exchange=exchange)
    tp = halo.build_halo_plan(src, dst, n, p, exchange)
    S = tp.block
    assert S == jp.block
    x = np.random.default_rng(1).normal(size=(n - 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(halo.pad_node_features(x, tp),
                                  j_pad(x, jp))
    s_idx, s_mask = np.asarray(jp.send_idx), np.asarray(jp.send_mask)
    r_off = np.concatenate([[0], np.cumsum(jp.round_sizes)]).astype(int)
    jbuf = []
    for rp in range(p):
        for q in range(p):
            if exchange == "a2a":
                want = s_idx[q, rp][s_mask[q, rp]]
            else:
                r = (rp - q) % p
                if r == 0:
                    continue
                lo, hi = r_off[r - 1], r_off[r]
                want = s_idx[q, lo:hi][s_mask[q, lo:hi]]
            np.testing.assert_array_equal(tp.halo_ids(q, rp) - q * S, want)
        # the JAX reader's halo buffer, row by row, as global ids
        if exchange == "a2a":
            H = jp.halo_max
            buf = np.concatenate([q * S + s_idx[q, rp] for q in range(p)])
            assert len(buf) == p * H
        else:
            buf = np.concatenate([
                (rp - r) % p * S + s_idx[(rp - r) % p, r_off[r - 1]:r_off[r]]
                for r in range(1, p)])
        jbuf.append(buf)
    for rp in range(p):
        m = np.asarray(jp.edge_mask[rp])
        j_src = np.asarray(jp.edge_src_local[rp])[m]
        j_slot = np.asarray(jp.edge_dst_slot[rp])[m]
        j_dst = np.where(j_slot < S, rp * S + j_slot,
                         jbuf[rp][np.maximum(j_slot - S, 0)])
        t_src, t_slot = tp.shard_edges(rp)
        t_buf = np.concatenate([tp.halo_ids(q, rp) for q in tp.recv_order(rp)]
                               + [np.zeros(0, np.int64)])
        t_dst = np.where(t_slot < S, rp * S + t_slot,
                         t_buf[np.maximum(t_slot - S, 0)]
                         if len(t_buf) else 0)
        np.testing.assert_array_equal(t_src, j_src)
        np.testing.assert_array_equal(t_dst, j_dst)
        np.testing.assert_array_equal(t_dst, dst[src // S == rp])


@pytest.mark.parametrize("exchange", ["a2a", "ppermute"])
@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_halo_volume_matches_jax_useful_rows(kind, exchange):
    from mpgnn_tpu.parallel.halo import build_halo_plan as j_plan
    from mpgnn_tpu.parallel.halo import halo_volume as j_volume

    n, p = 4096, 8
    src, dst = (_random_relation(1, n, 3400) if kind == "uniform"
                else _skewed_relation(n, p))
    want = j_volume(j_plan(src, dst, n, p, exchange=exchange), 16)
    got = halo.halo_volume(halo.build_halo_plan(src, dst, n, p, exchange),
                           16)
    for k in ("exchange", "useful_rows", "useful_bytes"):
        assert got[k] == want[k], k
    assert got["wire_rows"] == got["useful_rows"]


# ----------------------------------------------------------- aggregation
def _jax_halo(p, src, dst, x, exchange, local, grad):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from mpgnn_tpu.parallel.halo import (
        build_halo_csr_operands,
        build_halo_plan,
        halo_sharded_mean_aggregate,
        pad_node_features,
    )

    mesh = _jax_mesh(p)
    plan = build_halo_plan(src, dst, x.shape[0], p, exchange=exchange)
    x_sh = jax.device_put(pad_node_features(x, plan),
                          NamedSharding(mesh, PartitionSpec("nodes")))
    kw = {}
    if local == "csr":
        statics, arrays = build_halo_csr_operands(plan)
        kw = dict(csr_statics=statics, csr_arrays=arrays)

    def agg(x):
        return halo_sharded_mean_aggregate(mesh, x, plan, **kw)

    out = {"out": np.asarray(jax.jit(agg)(x_sh))}
    if grad:
        out["grad"] = np.asarray(jax.jit(jax.grad(
            lambda x: jnp.sum(agg(x).astype(jnp.float32) ** 2)))(x_sh))
    return out


@pytest.mark.parametrize("local", ["segment", "csr"])
@pytest.mark.parametrize("exchange", ["a2a", "ppermute"])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", list(AGG_CASES))
def test_halo_aggregate_matches_jax(ranks, case, p, exchange, local):
    """Node-sharded means and their gradients equal the single-process
    mean's, and the JAX package's on the same mesh size (at P = 4, and for
    the csr-against-segment inputs at P = 2 too: the JAX package's
    interpreted kernels take seconds a case)."""
    src, dst, x = _agg_inputs(case)
    got = ranks[0][("agg", p, case, exchange, local)]
    if p == 4 or case == "csr_vs_segment":
        want = _jax_halo(p, src, dst, x, exchange, local, True)
        np.testing.assert_allclose(got["out"], want["out"], **AGG_TOL)
        np.testing.assert_allclose(got["grad"], want["grad"], **AGG_TOL)
    xt = torch.tensor(x, requires_grad=True)
    ref = ref_mean(xt, src, dst, x.shape[0])
    (ref ** 2).sum().backward()
    n = x.shape[0]
    np.testing.assert_allclose(got["out"][:n], ref.detach().numpy(),
                               **AGG_TOL)
    np.testing.assert_allclose(got["grad"][:n], xt.grad.numpy(), **AGG_TOL)


@pytest.mark.parametrize("local", ["segment", "csr"])
@pytest.mark.parametrize("exchange", ["a2a", "ppermute"])
def test_halo_aggregate_with_a_silent_rank(ranks, exchange, local):
    """The exchange and its backward when a rank sends nothing (its
    collective still runs, with no rows): the single-process mean and its
    gradient."""
    src, dst, x = _silent_inputs()
    got = ranks[0][("silent", exchange, local)]
    xt = torch.tensor(x, requires_grad=True)
    ref = ref_mean(xt, src, dst, x.shape[0])
    (ref ** 2).sum().backward()
    np.testing.assert_allclose(got["out"], ref.detach().numpy(), **AGG_TOL)
    np.testing.assert_allclose(got["grad"], xt.grad.numpy(), **AGG_TOL)


@pytest.mark.parametrize("local", ["segment", "csr"])
@pytest.mark.parametrize("exchange", ["a2a", "ppermute"])
def test_halo_exchange_is_one_span_each_way(ranks, exchange, local):
    """Each exchange, forward and backward, is one call of the span
    ``halo.exchange`` on every rank of the mesh, a rank that sends nothing
    too; a forward alone is one."""
    for r in range(WORLD):
        got = ranks[r][("agg", 4, "reference", exchange, local)]
        assert got["exchanges"] == 2, r
    for r in (0, 1):
        assert ranks[r][("silent", exchange, local)]["exchanges"] == 2, r
    assert all(ranks[r][("pad", 4)]["exchanges"] == 1 for r in range(WORLD))


@pytest.mark.parametrize("p", [2, 4])
def test_halo_padded_rows_zero(ranks, p):
    out = ranks[0][("pad", p)]["out"]
    want = _jax_halo(p, np.array([0, 5]), np.array([5, 0]),
                     np.ones((7, 4), np.float32), "a2a", "segment",
                     False)["out"]
    np.testing.assert_array_equal(out, want)
    assert np.all(out[0] == 1.0) and np.all(out[5] == 1.0)
    assert np.all(out[1:5] == 0.0) and np.all(out[6:] == 0.0)


@pytest.mark.parametrize("local", ["segment", "csr"])
@pytest.mark.parametrize("p", [2, 4])
def test_halo_aggregate_bf16_high_degree(ranks, p, local):
    """A degree-1000 hub in bf16: the float32 sums keep its mean (JAX's
    bound against the true mean), within a bf16 ulp of the JAX package's."""
    import jax.numpy as jnp

    src, dst, x = _hub_inputs()
    got = ranks[0][("hub", p, local)][0]
    np.testing.assert_allclose(got, x[dst].mean(axis=0), rtol=2e-2,
                               atol=2e-2)
    want = _jax_halo(p, src, dst, x.astype(jnp.bfloat16), "a2a", local,
                     False)["out"]
    np.testing.assert_allclose(got, np.asarray(want, np.float32)[0],
                               rtol=2 ** -7, atol=0)


# ------------------------------------------------------------- training
def _jax_halo_train(case):
    from mpgnn_tpu.config import MPGNNConfig as JConfig
    from mpgnn_tpu.graph.io import split_nodes as j_split
    from mpgnn_tpu.train.loops import train_mpgnn as j_train

    _, mps, kw, cw_on = TRAIN_CASES[case]
    arrays, r, labels = _case_arrays(case)
    cfg = JConfig(hidden_dim=8, epochs=5, dropout=0.0, **kw)
    return j_train(_jax_graph(arrays, r), mps, j_split(labels), 2, cfg,
                   seed=TRAIN_SEED, backend="halo", mesh=_jax_mesh(4),
                   class_weighted=cw_on)


def _port_single(case, backend):
    _, mps, _, cw_on = TRAIN_CASES[case]
    g, split = _case_graph(case)
    cfg = _train_cfg(case)
    cw = loops.class_weights(split.train_y, 2, cw_on)
    _, val, test, loss = loops.fit_mpgnn(
        _jax_train_init(case), loops.build_hop_arrays(
            g, mps, backend, device="cpu", dtype=loops.compute_dtype(cfg)),
        torch.from_numpy(g.x), loops.split_tensors(split, "cpu"),
        torch.from_numpy(cw), cfg, None, 2)
    return loss, val, test


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_halo_training_matches_jax_and_single_process(ranks, case):
    loss, val, test = ranks[0][("train", case)]
    for r in ranks[1:]:
        assert r[("train", case)] == (loss, val, test)
    want = _jax_halo_train(case)
    bf16 = TRAIN_CASES[case][2].get("compute_dtype") == "bfloat16"
    np.testing.assert_allclose(loss, want.final_loss,
                               **(BF16_JAX_LOSS_TOL if bf16 else LOSS_TOL))
    assert (val, test) == (want.val_f1, want.test_f1)
    for backend in (("csr",) if bf16 else ("segment", "csr")):
        s_loss, s_val, s_test = _port_single(case, backend)
        np.testing.assert_allclose(loss, s_loss, **LOSS_TOL)
        assert (val, test) == (s_val, s_test), backend


def test_train_mpgnn_halo_entry_point_matches_segment(ranks):
    """train_mpgnn(backend='halo', mesh=...) from a seed, dropout on: the
    whole-graph masks are drawn on every rank, so on the CPU (whose
    generator fills a tensor in order) the run is the single-process
    run's."""
    g, split = _toy(7)
    ref = loops.train_mpgnn(g, [[0, 1], [2]], split, 2,
                            MPGNNConfig(hidden_dim=8, epochs=5, dropout=0.5),
                            seed=TRAIN_SEED, backend="segment", device="cpu")
    loss, val, test = ranks[0]["entry"]
    np.testing.assert_allclose(loss, ref.final_loss, **LOSS_TOL)
    assert (val, test) == (ref.val_f1, ref.test_f1)


@pytest.mark.slow
def test_node_sharded_train_step_matches_replicated(ranks):
    """build_node_sharded_train_step's losses against the single-process
    step from the same seed (test_distributed.py:367's comparison)."""
    g, split = _toy(7)
    cfg = MPGNNConfig(hidden_dim=8, dropout=0.0)
    model, _ = loops.seeded_init(4, 8, 2, [[0, 1], [2]], TRAIN_SEED, "cpu")
    hop_ops = loops.build_hop_arrays(g, [[0, 1], [2]], device="cpu")
    opt = loops.make_optimizer(model, cfg)
    x = torch.from_numpy(g.x)
    parts = loops.split_tensors(split, "cpu")
    w = torch.ones(len(split.train_y))
    want = [float(loops.train_step(model, opt, x, hop_ops, None, parts[0],
                                   parts[1], w, cfg, None,
                                   torch.float32).detach())
            for _ in range(3)]
    np.testing.assert_allclose(ranks[0]["steps"], want, **LOSS_TOL)


def test_halo_local_auto_resolves_as_jax(ranks, monkeypatch):
    """'auto' takes segment below CSR_EDGE_CUTOVER and csr at or above it,
    on the relation's edge count, as the JAX package decides."""
    from mpgnn_tpu.train import loops as j_loops

    arrays, r, _ = _toy_arrays(21)
    jg = _jax_graph(arrays, r)
    want = []
    for cutover in (j_loops.CSR_EDGE_CUTOVER, 1):
        monkeypatch.setattr(j_loops, "CSR_EDGE_CUTOVER", cutover)
        op = j_loops.build_hop_arrays(jg, [[0]], backend="halo",
                                      mesh=_jax_mesh(4), halo_local="auto")
        want.append("segment" if op[0][0][6] is None else "csr")
    assert want == ["segment", "csr"]
    assert ranks[0]["auto"] == want


# --------------------------------------------- edge partition and shard step
def test_edge_partitioned_aggregate_matches_jax(ranks):
    import jax.numpy as jnp

    from mpgnn_tpu.parallel import edge_partitioned_aggregate as j_agg
    from mpgnn_tpu.parallel import shard_edges as j_shard

    src, dst = _random_relation(0, 64, 500)
    x = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    mesh = _jax_mesh(8, ("data", "model"), (4, 2))
    arrs = [j_shard(a, mesh)[0] for a in (src.astype(np.int32),
                                          dst.astype(np.int32),
                                          np.ones(500, dtype=bool))]
    want = np.asarray(j_agg(mesh, jnp.asarray(x),
                            *map(jnp.asarray, arrs), 64))
    for r in ranks:
        np.testing.assert_allclose(r["edge_partitioned"], want, **AGG_TOL)


def test_sharded_train_step_matches_jax_2x2(ranks):
    """Five steps on (data, model) = (2, 2) from the JAX package's initial
    parameters: the losses of the JAX step on a (2, 2) mesh."""
    import jax

    from mpgnn_tpu.config import MPGNNConfig as JConfig
    from mpgnn_tpu.graph.io import split_nodes as j_split
    from mpgnn_tpu.parallel import build_sharded_train_step as j_build

    arrays, r, labels = _toy_arrays(1, n=128, e=600, f=4, r=2)
    mesh = _jax_mesh(4, ("data", "model"), (2, 2))
    step, params, opt = j_build(mesh, _jax_graph(arrays, r), [[0, 1]],
                                j_split(labels), 2,
                                JConfig(hidden_dim=16, dropout=0.0))
    want = []
    for i in range(5):
        params, opt, loss = step(params, opt, jax.random.PRNGKey(i))
        want.append(float(loss))
    for res in ranks:
        np.testing.assert_allclose(res["sharded"], want, rtol=1e-5)


# ----------------------------------------------------------------- sweeps
def test_sweeps_split_over_two_ranks_match_unsplit(ranks, monkeypatch):
    """The hop-0 sweep, a two-task bag sweep and the batched evaluation with
    their batch axes split over 2 ranks equal the same chunks (padded to 2
    as under the mesh) computed whole in one process."""
    from mpgnn_tpu_torch.search import scoring
    from mpgnn_tpu_torch.train import batch_eval

    monkeypatch.setattr(scoring, "sweep_devices", lambda: 2)
    monkeypatch.setattr(batch_eval, "sweep_devices", lambda: 2)
    graph, g = _sweep_graph()
    want = _sweep_arrays(*_sweeps(graph, g, "cpu"))
    for res in ranks[:2]:
        got = res["sweeps"]
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "eval":
                assert got[k].keys() == want[k].keys()
                np.testing.assert_allclose(list(got[k].values()),
                                           list(want[k].values()),
                                           rtol=0, atol=1e-6)
                continue
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                           err_msg=k)


def test_sharded_flat_sweep_args_split_as_jax(ranks):
    """Each rank's block of the relation axis, padded by repeating the last
    relation as the JAX package pads it (``shard.py:217-235``)."""
    for k, a in enumerate(_flat_sweep_arrays()):
        padded = np.concatenate([a, a[-1:]])
        got = np.concatenate([ranks[0]["flat_args"][k],
                              ranks[1]["flat_args"][k]])
        np.testing.assert_array_equal(got, padded)


# ------------------------------------------------------------ mesh specs
def test_mesh_spec_parses_as_jax():
    """test_mesh_search.py:47's specs over 8 ranks."""
    assert context.parse_mesh_spec("8", 8) == (["rel"], [8])
    assert context.parse_mesh_spec("data=4,model=2", 8) == (
        ["data", "model"], [4, 2])
    assert context.parse_mesh_spec("data=-1,model=2", 8) == (
        ["data", "model"], [4, 2])
    with pytest.raises(ValueError):
        context.parse_mesh_spec("data=3", 8)
    assert context.get_sweep_mesh() is None
    marker = object()
    with context.sweep_mesh(marker):
        assert context.get_sweep_mesh() is marker
    assert context.get_sweep_mesh() is None
    assert context.sweep_devices() == 1
    assert context.sweep_slice(5) == slice(0, 5)


# ------------------------------------------------------ the whole search
def _search_inputs(seed):
    """test_mesh_search.py's graph and configuration."""
    from mpgnn_tpu_torch.config import SearchConfig

    g = generate_synthetic_graph(800, 4, "red-red-blue", seed=seed)
    graph = HeteroGraph(g["node_features"].astype(np.float32), g["src"],
                        g["dst"], g["rel"], num_relations=4,
                        labels=g["labels"])
    cfg = SearchConfig(mpgnn=MPGNNConfig(epochs=60, hidden_dim=16),
                       scorer=ScorerConfig(max_restarts=4),
                       max_extension_hops=1)
    return g, graph, split_nodes(g["labels"]), cfg


def _search(seed, device):
    from mpgnn_tpu_torch.search import find_metapaths

    g, graph, split, cfg = _search_inputs(seed)
    res = find_metapaths(graph, g["labels"].astype(np.float32), split, 2,
                         config=cfg, dataset="synthetic", seed=0,
                         device=device)
    return dict(metapaths=res.metapaths, discovered=res.discovered,
                test_f1=res.test_f1, val_f1_by_path=res.val_f1_by_path,
                planted=list(g["metapath_relations"]))


def _search_ranks(device):
    """The search on ranks 0-1 as one 'rel' axis, then on all 4 as
    'data=2,model=2' (the ranks that skip the first wait in the second)."""
    out = {}
    mesh2 = context.mesh_from_spec("rel=2", device=device, ranks=[0, 1])
    if mesh2.rank is not None:
        with context.sweep_mesh(mesh2):
            out["rel2"] = _search(11, device)
    with context.sweep_mesh(context.mesh_from_spec("data=2,model=2",
                                                   device=device)):
        out["2d"] = _search(3, device)
    return out


@pytest.mark.slow
def test_mesh_search_matches_single_process():
    """test_mesh_search.py:74: the whole search with its sweeps split over
    2 ranks gives the single-process search's SearchResult; on a factored
    2 x 2 mesh (:101) it finds the planted path."""
    res = spawn_ranks(_search_ranks, WORLD, device="cpu", timeout_s=1800,
                      pg_timeout_s=1500)
    want = _search(11, "cpu")
    for r in res[:2]:
        assert r["rel2"] == want
        assert want["planted"] in r["rel2"]["discovered"]
    for r in res:
        assert r["2d"] == res[0]["2d"]
        assert r["2d"]["planted"] in r["2d"]["discovered"]
        assert r["2d"]["test_f1"] >= 0.9
