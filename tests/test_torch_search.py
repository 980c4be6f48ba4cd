"""The port's search engine and CLI (mpgnn_tpu_torch.search.engine,
mpgnn_tpu_torch.run) on the CPU against the JAX package's.

* With ``train_mpgnn`` replaced in both engines by one deterministic stub
  (F1s from the metapaths), the whole search must take the same decisions:
  equal ``discovered``, ``val_f1_by_path``, ``metapaths`` and ``test_f1``
  (the JAX engine's ``batched_eval=False`` branch, ``backend='segment'``).
* Unstubbed (small MPNetm), the planted metapath is discovered, as
  tests/test_search_integration.py checks for the JAX package.
* A search interrupted in its final evaluation resumes from its frontier
  checkpoint to the uninterrupted result; the CLI's per-class checkpoint
  is the JAX package's file format.
* The batched final evaluation (the default) and the per-candidate one
  (``batched_eval=False``, which the stubbed cases drive) select the same
  metapaths from the same validation F1s."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mpgnn_tpu.config import MPGNNConfig as JMPGNNConfig
from mpgnn_tpu.config import ScorerConfig as JScorerConfig
from mpgnn_tpu.config import SearchConfig as JSearchConfig
from mpgnn_tpu.graph.generate import generate_synthetic_graph
from mpgnn_tpu.graph.hetero import HeteroGraph as JGraph
from mpgnn_tpu.graph.io import split_nodes as j_split
from mpgnn_tpu.search import engine as jeng
from mpgnn_tpu.search import scoring as jscoring
from mpgnn_tpu_torch.config import MPGNNConfig, ScorerConfig, SearchConfig
from mpgnn_tpu_torch.benchmarks import bench_parallel
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.search import engine as teng
from mpgnn_tpu_torch.search import scoring as tscoring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORER = dict(epochs_flat=20, epochs_bags=10, max_restarts=3)
BUDGET = 1_000_000


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread in this module's searches, as
    tests/test_torch_warm.py runs: the tier-1 run shares the cores among
    several workers, where PyTorch's intra-op pool waits on descheduled
    threads at every parallel op (100-200x slower than alone); the CLI's
    child processes get OMP_NUM_THREADS=1. Both sides of every comparison
    run under it."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def pinned_budget(monkeypatch):
    monkeypatch.setattr(jscoring, "_MEM_BUDGET_ENTRIES", BUDGET)
    monkeypatch.setattr(tscoring, "_MEM_BUDGET_ENTRIES", BUDGET)


class _Res:
    def __init__(self, val_f1, test_f1):
        self.val_f1, self.test_f1 = val_f1, test_f1


def _stub_train(calls=None, fail_after=None):
    """A deterministic stand-in for train_mpgnn: F1s from the metapaths."""
    def train(graph, metapaths, split, num_classes, cfg=None, seed=0,
              x_override=None, **kw):
        if calls is not None:
            calls.append([list(m) for m in metapaths])
            if fail_after is not None and len(calls) > fail_after:
                raise RuntimeError("interrupted")
        key = sum((i + 1) * (r + 3) for m in metapaths
                  for i, r in enumerate(m))
        return _Res((key * 37 % 101) / 101.0,
                    (key * 53 % 97) / 97.0 + 0.01 * len(metapaths))
    return train


def _case(seed, n=400, metapath="red-red-blue"):
    g = generate_synthetic_graph(n, 4, metapath, seed=seed)
    args = (g["node_features"].astype(np.float32), g["src"], g["dst"],
            g["rel"])
    labels = g["labels"]
    return (HeteroGraph(*args, num_relations=4),
            JGraph(*args, num_relations=4), labels, g["metapath_relations"])


def _configs(hops=2, **kw):
    return (SearchConfig(max_extension_hops=hops,
                         scorer=ScorerConfig(**SCORER),
                         mpgnn=MPGNNConfig(epochs=10, hidden_dim=8), **kw),
            JSearchConfig(max_extension_hops=hops,
                          scorer=JScorerConfig(**SCORER),
                          mpgnn=JMPGNNConfig(epochs=10, hidden_dim=8), **kw))


@pytest.mark.parametrize("seed,kw", [
    (3, {}),
    (5, dict(bag_gap_inclusive=True, max_extensions_per_state=2)),
])
def test_stubbed_search_matches_jax(monkeypatch, seed, kw):
    g, jg, labels, _ = _case(seed)
    monkeypatch.setattr(teng, "train_mpgnn", _stub_train())
    monkeypatch.setattr(jeng, "train_mpgnn", _stub_train())
    cfg, jcfg = _configs(**kw)
    got = teng.find_metapaths(g, labels.astype(np.float32),
                              split_nodes(labels), 2, cfg, seed=0,
                              backend="segment", batched_eval=False,
                              device="cpu")
    want = jeng.find_metapaths(jg, labels.astype(np.float32),
                               j_split(labels), 2, jcfg, seed=0,
                               batched_eval=False)
    assert len(want.discovered) > 2
    assert got.discovered == want.discovered
    assert got.val_f1_by_path == want.val_f1_by_path
    assert got.metapaths == want.metapaths
    assert got.test_f1 == want.test_f1
    assert set(got.stage_s) >= {"hop0", "hop1", "final_eval", "greedy"}


def test_search_discovers_planted_metapath():
    g, _, labels, planted = _case(3, n=500)
    cfg, _ = _configs(hops=1)
    res = teng.find_metapaths(g, labels.astype(np.float32),
                              split_nodes(labels), 2, cfg, seed=0,
                              backend="segment", device="cpu")
    assert planted in res.discovered
    assert 0.0 <= res.test_f1 <= 1.0
    assert set(res.val_f1_by_path) == {str(p) for p in res.discovered}


def test_frontier_resume_equals_uninterrupted(monkeypatch, tmp_path):
    g, _, labels, _ = _case(3)
    cfg, _ = _configs()
    split = split_nodes(labels)
    kw = dict(seed=0, backend="segment", batched_eval=False, device="cpu")
    monkeypatch.setattr(teng, "train_mpgnn", _stub_train())
    whole = teng.find_metapaths(g, labels.astype(np.float32), split, 2, cfg,
                                **kw)
    ck = str(tmp_path / "frontier.pkl")
    calls = []
    monkeypatch.setattr(teng, "train_mpgnn", _stub_train(calls, 3))
    with pytest.raises(RuntimeError, match="interrupted"):
        teng.find_metapaths(g, labels.astype(np.float32), split, 2, cfg,
                            frontier_checkpoint=ck, **kw)
    assert os.path.exists(ck)
    calls = []
    monkeypatch.setattr(teng, "train_mpgnn", _stub_train(calls))
    resumed = teng.find_metapaths(g, labels.astype(np.float32), split, 2,
                                  cfg, frontier_checkpoint=ck, **kw)
    # the three candidates evaluated before the fault are not trained again
    assert calls[0] == [whole.discovered[3]]
    assert resumed.discovered == whole.discovered
    assert resumed.val_f1_by_path == whole.val_f1_by_path
    assert resumed.metapaths == whole.metapaths
    assert resumed.test_f1 == whole.test_f1


def test_cap_frontier_cases():
    items = [(7, 0.5), (3, 0.0), (9, 0.25), (1, 0.25)]
    assert teng._cap_frontier(items, SearchConfig(), "hop 1", "[x]") == items
    cfg2 = SearchConfig(max_extensions_per_state=2)
    assert teng._cap_frontier(items, cfg2, "hop 1", "[x]") == [(3, 0.0),
                                                               (9, 0.25)]
    cfg9 = SearchConfig(max_extensions_per_state=9)
    assert teng._cap_frontier(items, cfg9, "hop 1", "[x]") == items
    jcfg2 = JSearchConfig(max_extensions_per_state=2)
    assert (teng._cap_frontier(items, cfg2, "h", "p")
            == jeng._cap_frontier(items, jcfg2, "h", "p"))


def test_all_negative_labels_give_an_empty_result():
    g = generate_synthetic_graph(300, 3, "red-red-blue", seed=33)
    graph = HeteroGraph(g["node_features"].astype(np.float32), g["src"],
                        g["dst"], g["rel"], num_relations=4)
    labels = np.zeros(300, dtype=np.int64)
    labels[:4] = 1
    cfg = SearchConfig(mpgnn=MPGNNConfig(epochs=10, hidden_dim=8),
                       scorer=ScorerConfig(max_restarts=2),
                       max_extension_hops=1)
    res = teng.find_metapaths(graph, np.zeros(300, np.float32),
                              split_nodes(labels), 2, cfg, seed=0,
                              backend="segment", device="cpu")
    assert res.metapaths == [] and res.discovered == []
    assert res.test_f1 == 0.0


@pytest.mark.parametrize("backend", ["segment", "csr"])
def test_batched_eval_selects_as_the_per_candidate_one(backend):
    g, _, labels, _ = _case(3)
    cfg, _ = _configs()
    runs = [teng.find_metapaths(g, labels.astype(np.float32),
                                split_nodes(labels), 2, cfg, seed=0,
                                backend=backend, batched_eval=batched,
                                device="cpu")
            for batched in (True, False)]
    assert len(runs[0].discovered) > 2
    assert runs[0].discovered == runs[1].discovered
    assert runs[0].val_f1_by_path.keys() == runs[1].val_f1_by_path.keys()
    for k, v in runs[1].val_f1_by_path.items():
        assert abs(runs[0].val_f1_by_path[k] - v) <= 1e-6, k
    assert runs[0].metapaths == runs[1].metapaths
    assert runs[0].test_f1 == runs[1].test_f1


def test_a_single_model_backend_trains_each_candidate_with_it(monkeypatch):
    """``backend='pallas'`` in the config (the CLI's ``--backend pallas``)
    with the batched default: every final and greedy model trains through
    ``train_mpgnn`` with 'pallas', none through the batched evaluation."""
    g, _, labels, _ = _case(3)
    cfg, _ = _configs()
    cfg = dataclasses.replace(
        cfg, mpgnn=dataclasses.replace(cfg.mpgnn, backend="pallas"))
    seen = []
    real = teng.train_mpgnn

    def spy(*args, **kw):
        seen.append(kw["backend"])
        return real(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the batched evaluation ran")

    monkeypatch.setattr(teng, "train_mpgnn", spy)
    monkeypatch.setattr(teng, "evaluate_candidates", refuse)
    res = teng.find_metapaths(g, labels.astype(np.float32),
                              split_nodes(labels), 2, cfg, seed=0,
                              device="cpu")
    assert len(res.discovered) > 2
    assert len(seen) > len(res.discovered)
    assert set(seen) == {"pallas"}


# ------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ds"))
    generate_synthetic_graph(300, 4, "red-red-blue", seed=3, out_dir=out)
    return out


def _cli(dataset, *extra):
    cmd = [sys.executable, "-m", "mpgnn_tpu_torch.run", "--device", "cpu",
           "--hidden_dim", "8", "--dataset", "synthetic", "--folder",
           dataset, "--node_file", "node.dat", "--link_file", "link.dat",
           "--label_file", "label.dat", "--epochs", "10", "--max_hops", "1",
           *extra]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=300)


def test_cli_runs_and_resumes_from_a_jax_checkpoint(dataset, tmp_path):
    from mpgnn_tpu.search.engine import SearchResult as JResult
    from mpgnn_tpu.utils.checkpoint import SearchCheckpoint as JCheckpoint

    ck = str(tmp_path / "ck.json")
    r = _cli(dataset, "--pickle_filename", ck)
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["dataset"] == "synthetic"
    assert set(summary) == {"dataset", "classes", "wall_s"}
    assert set(summary["classes"]["0"]) == {"metapaths", "test_f1"}
    with open(ck) as f:
        assert "0" in json.load(f)

    jck = str(tmp_path / "jax.json")
    JCheckpoint(jck).save(0, JResult(metapaths=[[2, 1]], test_f1=0.75,
                                     val_f1_by_path={"[2, 1]": 0.5},
                                     discovered=[[1], [2, 1]]))
    r = _cli(dataset, "--pickle_filename", jck, "--no_warm")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "restored from checkpoint" in r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["classes"]["0"] == {"metapaths": [[2, 1]],
                                       "test_f1": 0.75}


@pytest.mark.parametrize("flag,item", [
    (["--mesh", "8"], "does not multiply to the 1 ranks"),
    (["--mesh", "1", "--retries", "1"], "--max-restarts"),
    (["--dropout_rng", "rbg"], "does not inherit"),
    (["--dropout_rng", "threefry"], "does not inherit"),
])
def test_cli_refuses_what_is_not_ported(capsys, monkeypatch, flag, item):
    """Under torchrun (one rank here: WORLD_SIZE=1) a mesh spec must fit
    torchrun's ranks, and torchrun, not --retries, restarts them."""
    from mpgnn_tpu_torch.run import main

    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit):
        main(["--hidden_dim", "8", "--dataset", "synthetic", "--folder", ".",
              "--node_file", "n", "--link_file", "l", "--label_file", "l",
              *flag])
    assert item in capsys.readouterr().err


def test_cli_launch_needs_every_mesh_size(capsys, monkeypatch):
    """Without torchrun the CLI starts the spec's ranks itself, so every
    size must be given: -1 (inferred from torchrun's count) is refused."""
    from mpgnn_tpu_torch.run import main

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        main(["--hidden_dim", "8", "--dataset", "synthetic", "--folder", ".",
              "--node_file", "n", "--link_file", "l", "--label_file", "l",
              "--mesh", "data=-1,model=2"])
    assert "-1 only under torchrun" in capsys.readouterr().err


# --mesh from one command: the CLI as its own launcher and supervisor
MESH_TIMEOUT_S = 300
@pytest.fixture(scope="module")
def dataset500(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ds500"))
    generate_synthetic_graph(500, 4, "red-red-blue", seed=3, out_dir=out)
    return out


def _cli_line(dataset, extra):
    return [sys.executable, "-m", "mpgnn_tpu_torch.run", "--device", "cpu",
            "--hidden_dim", "8", "--dataset", "synthetic", "--folder",
            dataset, "--node_file", "node.dat", "--link_file", "link.dat",
            "--label_file", "label.dat", "--epochs", "20", "--max_hops", "1",
            "--no_warm", *extra]


def _cli_env(env_extra=None):
    """The children's environment: no torchrun variables, one intra-op
    thread a process."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", **(env_extra or {}))
    return env


def _cli_session(dataset, extra, env_extra=None):
    """The CLI in a session of its own (its ranks too), killed whole if it
    outlives MESH_TIMEOUT_S (``bench_parallel.run_session``)."""
    rc, out, err = bench_parallel.run_session(
        _cli_line(dataset, extra), _cli_env(env_extra), MESH_TIMEOUT_S,
        cwd=REPO)
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.fixture(scope="module")
def single_run(dataset500):
    return _cli_session(dataset500, [])[0]


def test_cli_mesh_launches_its_ranks(dataset500, single_run):
    """``--mesh 2`` without torchrun starts 2 ranks (gloo on the CPU) and
    prints the single-process run's summary once."""
    summary, err = _cli_session(dataset500, ["--mesh", "2"])
    assert summary["classes"] == single_run["classes"]
    assert summary["dataset"] == single_run["dataset"]
    assert err.count("sweep mesh active") == 2


def test_cli_mesh_retries_a_failed_rank(dataset500, single_run, tmp_path):
    """``--mesh 2 --retries 1`` with rank 1 failing on its first attempt:
    the launcher kills rank 0 at once, logs the attempt, starts both ranks
    again and ends with rc 0 and the unfailed run's summary."""
    marker = tmp_path / "failed_once"
    env = bench_parallel.rank_site_env(str(tmp_path),
                                       MPGNN_FAIL_ONCE=str(marker))
    summary, err = _cli_session(dataset500, ["--mesh", "2", "--retries", "1"],
                                env)
    assert marker.exists()
    assert "[supervisor] attempt 1 exited rc=3; retrying" in err
    assert summary["classes"] == single_run["classes"]


@pytest.mark.parametrize("sig", ["SIGTERM", "SIGHUP"])
def test_cli_mesh_launcher_takes_its_ranks_down(dataset500, tmp_path, sig):
    """A launcher stopped by SIGTERM or SIGHUP (a ``timeout``, a scheduler)
    kills its ranks before it exits, and does not retry: no rank outlives
    it."""
    import signal
    import time

    pids = tmp_path / "pids"
    pids.mkdir()
    env = _cli_env(bench_parallel.rank_site_env(str(tmp_path),
                                                MPGNN_HOLD_RANKS=str(pids)))
    log = tmp_path / "stderr"
    with open(log, "w") as err:
        p = subprocess.Popen(
            _cli_line(dataset500, ["--mesh", "2", "--retries", "1"]),
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=err,
            start_new_session=True)
    ranks = []
    try:
        deadline = time.monotonic() + MESH_TIMEOUT_S
        while len(ranks) < 2:
            assert p.poll() is None, log.read_text()[-3000:]
            assert time.monotonic() < deadline, "the ranks did not start"
            time.sleep(0.1)
            ranks = [int(t) for t in (f.read_text() for f in pids.iterdir())
                     if t]
        p.send_signal(getattr(signal, sig))
        rc = p.wait(timeout=60)
        assert rc == 128 + getattr(signal, sig), log.read_text()[-3000:]
        alive = []
        for pid in ranks:
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        assert not alive, f"ranks {alive} outlived their launcher"
        assert "[supervisor]" not in log.read_text()
    finally:
        for pid in ranks:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
        p.wait()


def _stub_eval(graph, paths, split, num_classes, cfg=None, seed=0,
               x_override=None, backend=None, existing=None, sink=None,
               **kw):
    """The batched evaluation's stand-in: each candidate's validation F1
    from ``_stub_train``."""
    train = _stub_train()
    return {str(list(p)): train(graph, [list(p)], split, num_classes).val_f1
            for p in paths}


def _stub_both_engines(monkeypatch):
    import mpgnn_tpu.train.batch_eval as j_batch

    monkeypatch.setattr(teng, "train_mpgnn", _stub_train())
    monkeypatch.setattr(teng, "evaluate_candidates", _stub_eval)
    monkeypatch.setattr(jeng, "train_mpgnn", _stub_train())
    monkeypatch.setattr(j_batch, "evaluate_candidates", _stub_eval)


def _acm_fixture(folder):
    """A DBLP-style folder (tests/test_train.py's layout): node.dat,
    link.dat and labels_{train,val,test}.dat, the labels a three-class
    planted graph's, split 60/20/20 in a seeded order."""
    g = generate_synthetic_graph(300, 4, "red-red-blue",
                                 metapath2="blue-red", multiclass=True,
                                 seed=3, out_dir=folder)
    order = np.random.default_rng(0).permutation(300)
    for name, part in (("train", order[:180]), ("val", order[180:240]),
                       ("test", order[240:])):
        with open(os.path.join(folder, f"labels_{name}.dat"), "w") as f:
            for i in part:
                f.write(f"{i}\t{g['labels'][i]}\n")
    return folder


def test_cli_acm_style_dataset_matches_jax(tmp_path, capsys, monkeypatch):
    """``--dataset DBLP`` reads the pre-split labels and trains each class
    on that split, as the JAX CLI does: with the MPNetm training stubbed in
    both engines, the same per-class metapaths and test F1s."""
    from mpgnn_tpu.run import main as j_main
    from mpgnn_tpu_torch.run import main

    folder = _acm_fixture(str(tmp_path / "dblp"))
    argv = ["--hidden_dim", "8", "--dataset", "DBLP", "--folder", folder,
            "--node_file", "node.dat", "--link_file", "link.dat",
            "--label_file", "unused.dat", "--epochs", "10", "--max_hops",
            "1"]
    _stub_both_engines(monkeypatch)
    j_main(argv + ["--no_warm"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["dataset"] == "DBLP" and len(got["classes"]) == 3
    assert got["classes"] == want["classes"]
    assert any(c["metapaths"] for c in got["classes"].values())


def test_cli_trace_dir_writes_a_trace(dataset, tmp_path, capsys,
                                      monkeypatch):
    """``--trace_dir`` profiles each class's search into one Chrome trace
    JSON, with the spans timed in it beside it (one class here: binary
    labels)."""
    from mpgnn_tpu_torch.run import main

    monkeypatch.setattr(teng, "train_mpgnn", _stub_train())
    monkeypatch.setattr(teng, "evaluate_candidates", _stub_eval)
    trace_dir = str(tmp_path / "trace")
    main(["--device", "cpu", "--hidden_dim", "8", "--dataset", "synthetic",
          "--folder", dataset, "--node_file", "node.dat", "--link_file",
          "link.dat", "--label_file", "label.dat", "--epochs", "10",
          "--max_hops", "1", "--trace_dir", trace_dir])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(summary["classes"]) == ["0"]
    name, spans_name = sorted(os.listdir(trace_dir), reverse=True)
    assert name.startswith("trace-") and name.endswith(".json")
    assert spans_name == "spans-" + name[len("trace-"):]
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    with open(os.path.join(trace_dir, spans_name)) as f:
        spans = json.load(f)
    assert spans["score.epochs"]["traced_calls"] >= 1


def test_cli_trains_labels_with_gaps(tmp_path, capsys):
    """Label ids with gaps (fb15k-237-continent's are 0, 1, 3 and 6): the
    CLI gives the model one output a label id, so every label has its
    output. (The JAX CLI sizes it by the count of distinct labels, and its
    NLL gathers NaN for the labels past the last output.)"""
    from mpgnn_tpu_torch.run import main

    folder = _acm_fixture(str(tmp_path / "gaps"))
    for name in ("train", "val", "test"):
        path = os.path.join(folder, f"labels_{name}.dat")
        rows = [line.split() for line in open(path)]
        with open(path, "w") as f:
            for node, label in rows:
                f.write(f"{node}\t{3 * int(label)}\n")
    main(["--device", "cpu", "--hidden_dim", "8", "--dataset", "IMDB",
          "--folder", folder, "--node_file", "node.dat", "--link_file",
          "link.dat", "--label_file", "unused.dat", "--epochs", "5",
          "--max_hops", "1"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["dataset"] == "IMDB" and len(summary["classes"]) == 3
    for cls in summary["classes"].values():
        assert 0.0 < cls["test_f1"] <= 1.0 and cls["metapaths"]


def _gapped_labels(folder, factor):
    """data/synthetic_multiclass with each label id times ``factor`` (1:
    the folder as it is)."""
    import shutil

    shutil.copytree(os.path.join(REPO, "data", "synthetic_multiclass"),
                    folder)
    path = os.path.join(folder, "label.dat")
    rows = [line.split() for line in open(path)]
    with open(path, "w") as f:
        for node, label in rows:
            f.write(f"{node}\t{factor * int(label)}\n")
    return folder


def test_baseline_cli_trains_labels_with_gaps(tmp_path, capsys):
    """The RGCN baseline CLI on label ids with gaps (0, 3, 6): one output a
    label id, so every label has its output, and the run ends with finite
    F1s. (With the count of distinct labels, 3 outputs, label 6 would
    index past the last output of the class-weighted NLL.) One intra-op
    thread: the tier-1 run's workers share the cores, where PyTorch's
    thread pool waits on descheduled threads at every parallel op."""
    import torch

    from mpgnn_tpu_torch import rgcn_baseline

    folder = _gapped_labels(str(tmp_path / "gaps"), 3)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = rgcn_baseline.main(["--folder", folder, "--metapath_length",
                                  "2", "--hidden_dim", "8", "--epochs", "5",
                                  "--platform", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert res["params"].linear.weight.shape[0] == 7
    assert np.isfinite(res["final_loss"])
    for k in ("train_f1", "val_f1", "test_f1"):
        assert 0.0 < res[k] <= 1.0, (k, res[k])
    assert "test F1" in capsys.readouterr().out


def test_baseline_class_count_and_weights_match_jax_without_gaps():
    """On gap-free labels the baseline sizes the model as the JAX baseline
    does (max id + 1 is the count of distinct labels), with the JAX
    weights. With gaps, an empty class is counted once and every weight
    scales by the same factor (the class counts' ratio), which the weighted
    mean of the NLL cancels; and macro-F1 leaves the empty classes out, so
    the gapped ids give the JAX F1s of the gap-free ones."""
    import jax.numpy as jnp
    import torch

    from mpgnn_tpu.rgcn_baseline import balanced_class_weights as j_bcw
    from mpgnn_tpu.train.metrics import macro_f1 as j_macro_f1
    from mpgnn_tpu_torch.graph.io import load_dat_files
    from mpgnn_tpu_torch.rgcn_baseline import balanced_class_weights
    from mpgnn_tpu_torch.train.metrics import macro_f1

    folder = os.path.join(REPO, "data", "synthetic_multiclass")
    _, labels, _ = load_dat_files(*(os.path.join(folder, f) for f in (
        "node.dat", "link.dat", "label.dat")))
    c = len(np.unique(labels))
    assert int(np.max(labels)) + 1 == c
    y = np.asarray(split_nodes(labels).train_y)
    np.testing.assert_array_equal(balanced_class_weights(y, c), j_bcw(y, c))
    gapped = balanced_class_weights(3 * y, 3 * (c - 1) + 1)
    np.testing.assert_allclose(gapped[3 * np.arange(c)] * (3 * (c - 1) + 1),
                               j_bcw(y, c) * c, rtol=1e-6)
    rng = np.random.default_rng(0)
    preds = rng.integers(0, c, len(y))
    want = float(j_macro_f1(jnp.asarray(preds), jnp.asarray(y), c))
    got = float(macro_f1(torch.as_tensor(3 * preds), torch.as_tensor(3 * y),
                         3 * (c - 1) + 1))
    assert abs(got - want) <= 1e-7
