"""'auto' routing and the backends it reaches, on the CPU against the JAX
package: ``train_mpgnn`` with 'auto', 'ell', 'ell2', 'dense' and
'onehot'; ``resolve_backend`` and ``resolve_eval_backend``; the batched
evaluation's 'auto' (routed per length group) and 'dense' (grouped
products, K4's plain version here) forms; the run CLI's default.

The dense budget and the csr cutover are pinned in both packages, so the
decisions do not depend on the constants measured on the card.

Tolerances, with their reasons:
* ``train_mpgnn`` (20 epochs, dropout 0, the JAX trainer's initial
  parameters carried across): final loss atol 1e-4, macro-F1s atol 1e-6
  (the same predictions) and every trained parameter atol 1e-4: float32
  sums in other orders on both sides, through 20 Adam steps. 'onehot' is
  held against JAX's 'segment' run: the JAX package's own 'onehot'
  training raises (ROADMAP.md, section C).
* the batched 'dense' evaluation (20 epochs, dropout 0, JAX's per-candidate
  initial parameters carried into the stack): validation log-probabilities
  atol 1e-2 and validation F1 atol 2e-2. Both sides multiply bf16(A) by
  bf16(h); JAX sums in float32 and the port's CPU path (K4's plain
  version) in float64, and where the two float32 results of a hop differ
  in the last bit, the next hop's bf16 rounding of h can differ by one
  bf16 step (2^-8 relative), which 20 Adam steps carry into the logits.
  A validation node that near its decision boundary flips the F1 by one
  node's share.
* decisions, and the mixed 'auto' evaluation against its explicit
  subsets: equal."""

import jax
import numpy as np
import pytest
import torch

from mpgnn_tpu.config import MPGNNConfig as JConfig
from mpgnn_tpu.graph.generate import generate_synthetic_graph
from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.graph.io import split_nodes as j_split
from mpgnn_tpu.models.mpgnn import init_mpgnn as j_init
from mpgnn_tpu.train import batch_eval as jbatch
from mpgnn_tpu.train import loops as jloops
from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.train import batch_eval, loops
from mpgnn_tpu_torch.weights import params_from_jax, stack_params_from_jax

BUDGET = 1 << 30
LOSS_ATOL = 1e-4
F1_ATOL = 1e-6
PARAM_ATOL = 1e-4
DENSE_LOGP_ATOL = 1e-2
DENSE_F1_ATOL = 2e-2


@pytest.fixture
def pinned(monkeypatch):
    """The dense budget and the csr cutover, the same in both packages;
    returns a setter for the cutover."""
    monkeypatch.setattr(jloops, "auto_dense_budget_bytes", lambda *a: BUDGET)
    monkeypatch.setattr(loops, "auto_dense_budget_bytes", lambda *a: BUDGET)

    def cutover(edges):
        monkeypatch.setattr(jloops, "CSR_EDGE_CUTOVER", edges)
        monkeypatch.setattr(loops, "CSR_EDGE_CUTOVER", edges)

    cutover(1_000_000)
    return cutover


@pytest.fixture(scope="module")
def planted():
    g = generate_synthetic_graph(800, 4, "red-red-blue", seed=7)
    arrays = (g["node_features"].astype(np.float32), g["src"], g["dst"],
              g["rel"])
    return (JGraph(*arrays, num_relations=4), HeteroGraph(*arrays,
                                                          num_relations=4),
            g)


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("backend", ["auto", "ell", "ell2", "dense",
                                     "onehot"])
def test_train_mpgnn_matches_jax(planted, pinned, monkeypatch, backend):
    jg, tg, g = planted
    metapaths = [list(g["metapath_relations"]), [2]]
    seed, epochs, hidden = 3, 20, 16
    # the JAX package's train_mpgnn(backend='onehot') raises (its onehot
    # blockings, device arrays, go into an lru_cache key): its aggregation
    # is the segment mean, so its run is held against JAX's segment one
    want = jloops.train_mpgnn(
        jg, metapaths, j_split(g["labels"]), 2,
        JConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0), seed=seed,
        backend="segment" if backend == "onehot" else backend)
    init_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    carried = params_from_jax(
        j_init(init_key, tg.feat_dim, hidden, 2, metapaths), device="cpu")
    monkeypatch.setattr(loops, "seeded_init", lambda *a: (carried, 0))
    got = loops.train_mpgnn(
        tg, metapaths, split_nodes(g["labels"]), 2,
        MPGNNConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0),
        seed=seed, backend=backend, device="cpu")
    assert abs(got.final_loss - want.final_loss) <= LOSS_ATOL
    np.testing.assert_allclose(
        (got.train_f1, got.val_f1, got.test_f1),
        (want.train_f1, want.val_f1, want.test_f1), rtol=0, atol=F1_ATOL)
    trained = params_from_jax(want.params, device="cpu").state_dict()
    for k, v in got.params.state_dict().items():
        torch.testing.assert_close(v, trained[k], rtol=0, atol=PARAM_ATOL)


def test_train_mpgnn_auto_takes_the_resolved_backend(planted, pinned,
                                                     monkeypatch):
    _, tg, g = planted
    seen = []
    real = loops.build_hop_arrays
    monkeypatch.setattr(loops, "build_hop_arrays",
                        lambda *a, **k: seen.append(k["backend"])
                        or real(*a, **k))
    cfg = MPGNNConfig(epochs=2, hidden_dim=8)
    split = split_nodes(g["labels"])
    loops.train_mpgnn(tg, [[0, 1]], split, 2, cfg, backend="auto",
                      device="cpu")
    monkeypatch.setattr(loops, "auto_dense_budget_bytes", lambda *a: 0)
    loops.train_mpgnn(tg, [[0, 1]], split, 2, cfg, backend="auto",
                      device="cpu")
    pinned(int(tg.rel_counts[0]))
    loops.train_mpgnn(tg, [[0, 1]], split, 2,
                      MPGNNConfig(epochs=2, hidden_dim=8, backend="auto"),
                      device="cpu")
    assert seen == ["dense", "segment", "csr"]


def test_the_cpu_budget_is_the_jax_packages():
    assert loops.auto_dense_budget_bytes("cpu") \
        == jloops.auto_dense_budget_bytes() == 4 << 30


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("metapaths", [[[0, 1]], [[0], [1, 2, 3]],
                                       [[3, 3, 3]], [[2]]])
@pytest.mark.parametrize("budget", [None, 0, "exact", "one_short"])
@pytest.mark.parametrize("cutover", [1, "largest", 2_000_000])
def test_resolve_backend_decides_as_jax(planted, pinned, metapaths, budget,
                                        cutover):
    jg, tg, _ = planted
    uniq = {r for mp in metapaths for r in mp}
    need = 2 * len(uniq) * tg.num_nodes ** 2 * 4
    budget = {"exact": need, "one_short": need - 1}.get(budget, budget)
    if cutover == "largest":
        cutover = int(max(tg.rel_counts[r] for r in uniq))
    pinned(cutover)
    want = jloops.resolve_backend("auto", jg, metapaths, budget)
    assert loops.resolve_backend("auto", tg, metapaths, budget) == want
    for explicit in ("segment", "csr", "onehot"):
        assert loops.resolve_backend(explicit, tg, metapaths, budget) \
            == explicit


def test_resolve_backend_cases_of_the_jax_tests(planted, pinned):
    """tests/test_train.py's cases: dense under the budget, segment past
    it, csr past it from the cutover."""
    jg, tg, _ = planted
    mps = [[0, 1]]
    tight = 2 * 2 * tg.num_nodes ** 2 * 4 - 1
    assert loops.resolve_backend("auto", tg, mps) == "dense"
    assert loops.resolve_backend("auto", tg, mps, tight) == "segment"
    saved = tg.rel_counts.copy()
    try:
        tg.rel_counts[0] = 2_000_000
        assert loops.resolve_backend("auto", tg, mps, tight) == "csr"
    finally:
        tg.rel_counts[:] = saved


@pytest.mark.parametrize("paths", [[[1, 0]], [[0], [3]], [[2, 2], [1, 3]]])
@pytest.mark.parametrize("cutover", [1, "largest", "above"])
@pytest.mark.parametrize("backend", [None, "auto", "segment", "dense"])
def test_resolve_eval_backend_decides_as_jax(planted, pinned, paths, cutover,
                                             backend):
    jg, tg, _ = planted
    largest = int(max(tg.rel_counts[r] for p in paths for r in p))
    pinned({"largest": largest, "above": largest + 1}.get(cutover, cutover))
    jcfg, cfg = JConfig(backend="auto"), MPGNNConfig(backend="auto")
    assert batch_eval.resolve_eval_backend(backend, cfg, tg, paths) \
        == jbatch.resolve_eval_backend(backend, jcfg, jg, paths)


def test_mixed_auto_evaluation_is_the_union_of_its_subsets(planted, pinned):
    """tests/test_train.py's mixed-routing case: a group past the cutover
    runs csr, the others segment, and the mixed call returns exactly the
    explicit calls' results, csr's first."""
    _, tg, g = planted
    split = split_nodes(g["labels"])
    cfg = MPGNNConfig(epochs=15, hidden_dim=8, backend="auto")
    order = np.argsort(tg.rel_counts)
    big, s0, s1 = int(order[-1]), int(order[0]), int(order[1])
    assert tg.rel_counts[big] > tg.rel_counts[s1]
    pinned(int(tg.rel_counts[big]))
    paths_csr, paths_seg = [[big]], [[s0, s1]]
    assert batch_eval.resolve_eval_backend(None, cfg, tg, paths_csr) == "csr"
    assert batch_eval.resolve_eval_backend(None, cfg, tg,
                                           paths_seg) == "segment"
    mixed = batch_eval.evaluate_candidates(tg, paths_seg + paths_csr, split,
                                           2, cfg, seed=3, device="cpu")
    a = batch_eval.evaluate_candidates(tg, paths_csr, split, 2, cfg, seed=3,
                                       backend="csr", device="cpu")
    b = batch_eval.evaluate_candidates(tg, paths_seg, split, 2, cfg, seed=3,
                                       backend="segment", device="cpu")
    assert list(mixed.items()) == list({**a, **b}.items())


# -------------------------------------------------- batched 'dense' (K4)
def test_batched_dense_matches_jax(monkeypatch):
    """The port's batched 'dense' evaluation against the JAX package's
    ``evaluate_candidates(backend='dense')`` on a 400-node planted graph:
    validation F1s, and the validation log-probabilities of the final
    forward (read from JAX's run with a ``jax.debug.callback`` on its
    log_softmax)."""
    g = generate_synthetic_graph(400, 4, "red-red-blue", seed=7)
    arrays = (g["node_features"].astype(np.float32), g["src"], g["dst"],
              g["rel"])
    jg, tg = JGraph(*arrays, num_relations=4), HeteroGraph(*arrays,
                                                           num_relations=4)
    paths = [[0], [3], [1, 0], [2, 0], [1, 1], [3, 0]]
    seed, epochs, hidden = 4, 20, 16
    jcfg = JConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0)
    seen = []
    real_log_softmax = jax.nn.log_softmax

    def recorded(x, axis=-1):
        out = real_log_softmax(x, axis=axis)
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), out)
        return out

    monkeypatch.setattr(jax.nn, "log_softmax", recorded)
    want, want_logp = {}, {}
    for length in (1, 2):
        group = [p for p in paths if len(p) == length]
        seen.clear()
        want.update(jbatch.evaluate_candidates(
            jg, group, j_split(g["labels"]), 2, jcfg, seed=seed,
            backend="dense"))
        want_logp.update(zip(map(str, group), seen[-1]))
    monkeypatch.setattr(jax.nn, "log_softmax", real_log_softmax)

    def carried(c, input_dim, hidden_dim, num_classes, length, seed_, dev):
        keys = jax.random.split(jax.random.PRNGKey(seed_), c)
        return stack_params_from_jax(
            [j_init(keys[i], input_dim, hidden_dim, num_classes,
                    [[0] * length]) for i in range(c)], device=dev), 0

    stacks = {}
    real_train_chunk = batch_eval.train_chunk

    def kept(graph, chunk, *args):
        f1s, stack = real_train_chunk(graph, chunk, *args)
        stacks[len(chunk[0])] = (chunk, stack)
        return f1s, stack

    monkeypatch.setattr(batch_eval, "init_stack", carried)
    monkeypatch.setattr(batch_eval, "train_chunk", kept)
    split = split_nodes(g["labels"])
    got = batch_eval.evaluate_candidates(
        tg, paths, split, 2,
        MPGNNConfig(epochs=epochs, hidden_dim=hidden, dropout=0.0),
        seed=seed, backend="dense", device="cpu")
    assert list(got) == [str(p) for p in paths]
    x, cpu = torch.from_numpy(tg.x), torch.device("cpu")
    for chunk, stack in stacks.values():
        first = batch_eval.stack_hop_aggregate(
            x.expand(len(chunk), -1, -1),
            batch_eval.stacked_hop(tg, [p[0] for p in chunk], "dense", cpu))
        hops = [batch_eval.stacked_hop(tg, [p[j] for p in chunk], "dense",
                                       cpu) for j in range(1, len(chunk[0]))]
        with torch.no_grad():
            logp = stack(x, hops, first)[:, split.val_idx].numpy()
        for k, p in enumerate(chunk):
            np.testing.assert_allclose(
                logp[k], want_logp[str(p)][split.val_idx], rtol=0,
                atol=DENSE_LOGP_ATOL)
            assert abs(got[str(p)] - want[str(p)]) <= DENSE_F1_ATOL, p
    assert len(set(want.values())) > 1


def test_batched_dense_shares_one_product_per_relation(planted,
                                                       monkeypatch):
    """Each hop runs one grouped product per unique relation of the hop,
    forward and backward, and none per candidate."""
    from mpgnn_tpu_torch.ops import conv

    _, tg, g = planted
    calls = []
    real = conv.dense_matmul
    monkeypatch.setattr(conv, "dense_matmul",
                        lambda a, x: calls.append(x.shape) or real(a, x))
    paths = [[0, 1], [2, 1], [1, 1], [3, 2]]
    batch_eval.evaluate_candidates(
        tg, paths, split_nodes(g["labels"]), 2,
        MPGNNConfig(epochs=3, hidden_dim=8), backend="dense", device="cpu")
    n, f, h = tg.num_nodes, tg.feat_dim, 8
    # hop 0: relations 0, 1, 2, 3 once each; then per epoch hop 1's
    # relations 1 (3 candidates) and 2 forward and backward, and the final
    # forward
    hop0 = [(n, f)] * 4
    epoch = [(n, 3 * h), (n, h)]
    assert sorted(calls) == sorted(hop0 + (epoch * 2) * 3 + epoch)


def test_dense_chunk_cap_counts_only_unbuilt_operands(planted):
    """The dense chunk cap takes 4 N^2 bytes off the budget for each
    relation of the group whose bf16 operand is not built yet (a built
    one is already off the free memory); the evaluation forgets its bf16
    operands when it ends and keeps the float32 ones of train_mpgnn."""
    _, _, g = planted
    tg = HeteroGraph(g["node_features"].astype(np.float32), g["src"],
                     g["dst"], g["rel"], num_relations=4)
    cpu, cfg = torch.device("cpu"), MPGNNConfig(epochs=1, hidden_dim=8)
    group = [[0, 1], [2, 1], [1, 1]]
    n = tg.num_nodes
    per = 4 * n * (tg.feat_dim + (batch_eval._NH_PER_HOP
                                  + batch_eval._NH_PER_DENSE_HOP) * 8 * 2)

    def cap(unbuilt):
        return int((batch_eval._CPU_BUDGET_BYTES - unbuilt * 4 * n * n)
                   // per)

    assert batch_eval._chunk_cap(tg, group, cfg, "dense", cpu) == cap(3)
    loops.relation_operand(tg, 1, "pallas", cpu)
    assert batch_eval._chunk_cap(tg, group, cfg, "dense", cpu) == cap(2)
    loops.train_mpgnn(tg, [[0]], split_nodes(g["labels"]), 2, cfg,
                      backend="dense", device="cpu")
    batch_eval.evaluate_candidates(tg, group, split_nodes(g["labels"]), 2,
                                   cfg, backend="dense", device="cpu")
    assert sorted(k[:2] for k in tg._operand_cache) == [("dense", 0)]


def test_operand_cache_keys_the_card_with_its_index(monkeypatch):
    """A caller's 'cuda' and a tensor's 'cuda:0' are one cache key, so the
    batched evaluation (which passes its features' device) and the greedy
    stage (the caller's) share each relation's operand."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert loops.device_key(torch.device("cuda")) == "cuda:0"
    assert loops.device_key("cuda:0") == loops.device_key("cuda") == "cuda:0"
    assert loops.device_key(torch.device("cpu")) == "cpu"
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert loops.device_key("cuda") == "cuda:1"


# ---------------------------------------------------------------- the CLI
def test_cli_default_resolves_as_the_jax_cli():
    """Without --backend both CLIs take 'auto'; on the README's dataset
    the port's CLI on the CPU resolves every metapath set and length group
    as ``python -m mpgnn_tpu.run --platform cpu`` does (the CPU budget,
    each package's own cutover)."""
    from mpgnn_tpu.graph.io import load_dat_files as j_load
    from mpgnn_tpu.run import build_argparser as j_parser
    from mpgnn_tpu_torch.graph.io import load_dat_files
    from mpgnn_tpu_torch.run import build_argparser

    argv = ["--hidden_dim", "64", "--dataset", "synthetic", "--folder",
            "data/synthetic_multiclass", "--node_file", "node.dat",
            "--link_file", "link.dat", "--label_file", "label.dat"]
    args, jargs = build_argparser().parse_args(argv), \
        j_parser().parse_args(argv)
    assert args.backend == jargs.backend == "auto"
    files = [f"data/synthetic_multiclass/{f}" for f in
             ("node.dat", "link.dat", "label.dat")]
    tg, jg = load_dat_files(*files)[0], j_load(*files)[0]
    cfg, jcfg = (MPGNNConfig(backend=args.backend),
                 JConfig(backend=jargs.backend))
    rels = list(range(tg.num_relations))
    sets = [[[r] for r in rels], [rels], [[r, s] for r in rels for s in rels]]
    for mps in sets:
        want = jloops.resolve_backend(jargs.backend, jg, mps)
        assert loops.resolve_backend(
            args.backend, tg, mps, loops.auto_dense_budget_bytes("cpu")) \
            == want
        assert batch_eval.resolve_eval_backend(None, cfg, tg, mps) \
            == jbatch.resolve_eval_backend(None, jcfg, jg, mps)
