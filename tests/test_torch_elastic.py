"""Elastic training (``parallel/elastic.py``) on gloo CPU ranks against the
JAX package's ``train_elastic`` on as many virtual CPU devices.

One pool of 4 ranks runs every check (``_elastic_checks``, which imports
nothing of JAX): a checkpoint's round trip and its resume on 2 of the 4
ranks, ``train_elastic`` with a fault injected at step 5 (4 -> 2 ranks),
with faults at steps 5 and 9 (4 -> 2 -> 1), and the give-up below
``min_devices`` after a first recovery (4 -> 2, then below 2). Both
packages start from the JAX package's initial parameters of seed 0 at
dropout 0.

Tolerances, with their reasons: checkpointed tensors equal; a step's loss
after the resize within 1e-5 of the same step on the larger mesh and of
the JAX package's (float32 sums split another way); ``train_elastic``'s
losses within 1e-5 of the JAX package's, with equal recoveries, steps and
final rank counts.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.graph.generate import generate_synthetic_graph
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.parallel import elastic
from mpgnn_tpu_torch.parallel.mesh import make_mesh, spawn_ranks
from mpgnn_tpu_torch.parallel.shard import build_sharded_train_step

WORLD = 4
LOSS_TOL = dict(rtol=1e-5, atol=0)
CFG = dict(epochs=1, hidden_dim=8, dropout=0.0)
FAULT_STEP, NUM_STEPS, EVERY = 5, 12, 4
FAULT_STEPS = (5, 9)


def _setup():
    """test_elastic.py's graph and split (the generators agree bitwise)."""
    g = generate_synthetic_graph(300, 4, "red-red-blue", seed=5)
    graph = HeteroGraph(g["node_features"].astype(np.float32), g["src"],
                        g["dst"], g["rel"], num_relations=4,
                        labels=g["labels"])
    return graph, [list(g["metapath_relations"])], split_nodes(g["labels"])


def _fault(step):
    if step == FAULT_STEP and not _fault.fired:
        _fault.fired = True
        raise RuntimeError("injected chip loss")


def _faults(steps):
    """A fault hook that fails once at each of ``steps``."""
    fired = set()

    def hook(step):
        if step in steps and step not in fired:
            fired.add(step)
            raise RuntimeError(f"injected chip loss at step {step}")
    return hook


def _always_fault(step):
    raise RuntimeError("persistent failure")


def _elastic_checks(device, params, ckpt_dir):
    graph, mp, split = _setup()
    cfg = MPGNNConfig(**CFG)
    out = {}
    # a checkpoint of the (data, model) = (2, 2) step, resumed on 2 ranks
    mesh4 = make_mesh((2, 2), device=device)
    step4 = build_sharded_train_step(mesh4, graph, mp, split, 2, cfg,
                                     init_params=params)
    ck = os.path.join(ckpt_dir, "ck.pt")
    elastic.save_train_state(ck, 3, step4)
    s, ph, oh = elastic.load_train_state(ck)
    now, opt_now = step4.host_state()
    out["roundtrip"] = (s == 3 and all(torch.equal(ph[k], now[k])
                                       for k in now)
                        and sorted(oh) == sorted(opt_now))
    mesh2 = make_mesh(None, ranks=[0, 1], device=device)
    if mesh2.rank is not None:
        step2, start = elastic.resume_train_step(ck, mesh2, graph, mp, split,
                                                 2, cfg)
        out["resume"] = (start, mesh2.size, step2())
    out["before"] = step4()
    dist.barrier()
    # train_elastic with a fault at FAULT_STEP on every rank
    _fault.fired = False
    res = elastic.train_elastic(
        graph, mp, split, 2, num_steps=NUM_STEPS,
        ckpt_path=os.path.join(ckpt_dir, "run.pt"), cfg=cfg,
        checkpoint_every=EVERY, fault_hook=_fault, init_params=params,
        device=device)
    out["elastic"] = (res.losses, res.steps_run, res.recoveries,
                      res.final_device_count, res.left)
    # two faults: 4 -> 2 -> 1 ranks, ranks 1-3 leaving
    res = elastic.train_elastic(
        graph, mp, split, 2, num_steps=NUM_STEPS,
        ckpt_path=os.path.join(ckpt_dir, "twice.pt"), cfg=cfg,
        checkpoint_every=EVERY, fault_hook=_faults(FAULT_STEPS),
        init_params=params, device=device)
    out["twice"] = (res.losses, res.steps_run, res.recoveries,
                    res.final_device_count, res.left)
    # the give-up: 4 -> 2 ranks, then 2 -> 1 is below min_devices = 2
    try:
        res = elastic.train_elastic(
            graph, mp, split, 2, num_steps=4,
            ckpt_path=os.path.join(ckpt_dir, "gave_up.pt"), cfg=cfg,
            min_devices=2, fault_hook=_always_fault, init_params=params,
            device=device)
        out["give_up"] = ("left", res.recoveries) if res.left else None
    except RuntimeError as e:
        out["give_up"] = str(e)
    return out


def _jax_setup():
    from mpgnn_tpu.graph.generate import generate_synthetic_graph as j_gen
    from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
    from mpgnn_tpu.graph.io import split_nodes as j_split

    g = j_gen(300, 4, "red-red-blue", seed=5)
    graph = JGraph(g["node_features"].astype(np.float32), g["src"],
                   g["dst"], g["rel"], num_relations=4, labels=g["labels"])
    return graph, [list(g["metapath_relations"])], j_split(g["labels"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax

    from mpgnn_tpu.models.mpgnn import init_mpgnn as j_init
    from mpgnn_tpu_torch.weights import params_from_jax

    graph, mp, _ = _jax_setup()
    params = params_from_jax(j_init(jax.random.PRNGKey(0), graph.feat_dim, 8,
                                    2, mp), device="cpu").state_dict()
    return spawn_ranks(_elastic_checks, WORLD,
                       (params, str(tmp_path_factory.mktemp("elastic"))),
                       device="cpu", timeout_s=300)


def _jax_cfg():
    from mpgnn_tpu.config import MPGNNConfig as JConfig

    return JConfig(**CFG)


def test_checkpoint_roundtrip_and_resize(ranks):
    """Saved tensors come back equal; the state resumed on 2 of 4 ranks
    takes the step the (2, 2) mesh takes, and the JAX package's."""
    import jax

    from mpgnn_tpu.parallel.mesh import make_mesh as j_mesh
    from mpgnn_tpu.parallel.shard import build_sharded_train_step as j_build

    assert all(r["roundtrip"] for r in ranks)
    start, size, loss2 = ranks[0]["resume"]
    assert (start, size) == (3, 2) and ranks[1]["resume"] == ranks[0][
        "resume"]
    for r in ranks:
        np.testing.assert_allclose(r["before"], loss2, **LOSS_TOL)
    graph, mp, split = _jax_setup()
    step, p, o = j_build(j_mesh((4, 1), devices=jax.devices()[:4]), graph,
                         mp, split, 2, _jax_cfg())
    _, _, want = step(p, o, jax.random.PRNGKey(9))
    np.testing.assert_allclose(loss2, float(want), **LOSS_TOL)


def test_train_elastic_recovers_as_jax(ranks, tmp_path):
    """A fault at step 5 on every rank: both packages recover once onto 2
    ranks (devices) from the step-4 checkpoint and end with the same
    losses; ranks 2 and 3 leave."""
    import jax

    from mpgnn_tpu.parallel.elastic import train_elastic as j_elastic

    fired = {"done": False}

    def fault(step):
        if step == FAULT_STEP and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("injected chip loss")

    graph, mp, split = _jax_setup()
    want = j_elastic(graph, mp, split, 2, num_steps=NUM_STEPS,
                     ckpt_path=str(tmp_path / "ck"), cfg=_jax_cfg(),
                     devices=jax.devices()[:4], checkpoint_every=EVERY,
                     seed=0, fault_hook=fault)
    for r in ranks[:2]:
        losses, steps, recoveries, count, left = r["elastic"]
        assert (steps, recoveries, count, left) == (
            want.steps_run, want.recoveries, want.final_device_count, False)
        np.testing.assert_allclose(losses, want.losses, **LOSS_TOL)
    for r in ranks[2:]:
        assert r["elastic"][-1] is True
    assert want.recoveries == 1 and want.final_device_count == 2


def test_train_elastic_recovers_twice_as_jax(ranks, tmp_path):
    """Faults at steps 5 and 9 on every rank: both packages shrink 4 -> 2
    from the step-4 checkpoint, then 2 -> 1 from the step-8 one, and end
    with the same losses, steps and counts; ranks 2 and 3 leave at the
    first recovery, rank 1 at the second."""
    import jax

    from mpgnn_tpu.parallel.elastic import train_elastic as j_elastic

    graph, mp, split = _jax_setup()
    want = j_elastic(graph, mp, split, 2, num_steps=NUM_STEPS,
                     ckpt_path=str(tmp_path / "ck"), cfg=_jax_cfg(),
                     devices=jax.devices()[:4], checkpoint_every=EVERY,
                     seed=0, fault_hook=_faults(FAULT_STEPS))
    assert (want.recoveries, want.final_device_count) == (2, 1)
    losses, steps, recoveries, count, left = ranks[0]["twice"]
    assert (steps, recoveries, count, left) == (
        want.steps_run, want.recoveries, want.final_device_count, False)
    np.testing.assert_allclose(losses, want.losses, **LOSS_TOL)
    assert [r["twice"][-1] for r in ranks] == [False, True, True, True]


def test_train_elastic_gives_up_below_min_devices(ranks, tmp_path):
    """A fault at every step with min_devices = 2: both packages recover
    once (4 -> 2) and re-raise at the second failure, where 1 rank would
    be below the minimum; ranks 2 and 3 leave at the recovery."""
    import jax

    from mpgnn_tpu.parallel.elastic import train_elastic as j_elastic

    graph, mp, split = _jax_setup()
    calls = []

    def fault(step):
        calls.append(step)
        _always_fault(step)

    with pytest.raises(RuntimeError, match="persistent"):
        j_elastic(graph, mp, split, 2, num_steps=4,
                  ckpt_path=str(tmp_path / "ck"), cfg=_jax_cfg(),
                  devices=jax.devices()[:4], min_devices=2,
                  fault_hook=fault)
    assert calls == [0, 0]
    for r in ranks[:2]:
        assert r["give_up"] is not None and "persistent" in r["give_up"]
    for r in ranks[2:]:
        assert r["give_up"] == ("left", 1)
