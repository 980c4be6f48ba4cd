"""The first-call warmer (``mpgnn_tpu_torch.utils.warm``) on the CPU: the
counterparts of ``tests/test_warm.py``'s failure and equality tests, its
key dedupe, that a warm leaves the default generator alone, and the
CLI's ``--no_warm``."""

import json
import logging

import numpy as np
import pytest
import torch

from mpgnn_tpu_torch.config import MPGNNConfig, ScorerConfig, SearchConfig
from mpgnn_tpu_torch.graph.generate import generate_synthetic_graph
from mpgnn_tpu_torch.graph.hetero import HeteroGraph
from mpgnn_tpu_torch.graph.io import split_nodes
from mpgnn_tpu_torch.utils import warm
from mpgnn_tpu_torch.utils.warm import ProgramWarmer, get_warmer

CLI_LINE = ["--platform", "cpu", "--hidden_dim", "8", "--dataset",
            "synthetic", "--node_file", "node.dat", "--link_file",
            "link.dat", "--label_file", "label.dat", "--epochs", "5",
            "--max_hops", "1"]


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """These tests run searches of many small PyTorch ops beside warm
    threads. The tier-1 run shares the cores among several workers, and
    PyTorch's intra-op thread pool then waits on descheduled threads at
    every parallel op (over 100x slower on a loaded host); one thread
    keeps each test a core's work. Every comparison runs both sides under
    the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def planted():
    g = generate_synthetic_graph(400, 4, "red-red-blue", seed=11)
    graph = HeteroGraph(
        g["node_features"].astype(np.float32), g["src"], g["dst"], g["rel"],
        num_relations=4, labels=g["labels"],
    )
    return graph, g


def test_warm_bag_signature_best_effort_on_failure(caplog):
    """A nonsense signature fails inside its warm: logged and recorded,
    not raised (``tests/test_warm.py``'s case), and so does an unknown
    form."""
    warmer = ProgramWarmer(max_workers=1)
    with caplog.at_level(logging.WARNING, logger="mpgnn_tpu_torch.warm"):
        warmer.warm_bag_signature(-1, -1, -1, -1, -1, -1, 3, 0.1,
                                  device="cpu")
        warmer.warm_flat_signature(4, 16, 2, 3, 0.1, mode="dense",
                                   device="cpu")
        warmer.wait(timeout=60)
    assert sorted(k for k, _ in warmer.failures) == [
        ("bag", "ell", "cpu"), ("flat", "dense", "cpu")]
    assert all(msg.startswith("ValueError") for _, msg in warmer.failures)
    assert sum("failed" in r.getMessage() for r in caplog.records) == 2


def test_keys_are_deduplicated(monkeypatch):
    """A stage is warmed once a form (or backend) and device, whatever
    shapes its requests carry."""
    calls = []
    for stage in ("flat", "bag"):
        monkeypatch.setattr(warm, f"_{stage}",
                            lambda *a, s=stage: calls.append((s,) + a[:2]))
    warmer = ProgramWarmer(max_workers=2)
    for r, n in ((1, 10), (4, 100), (8, 1000)):
        warmer.warm_flat_signature(r, n, 4, 100, 0.1, mode="ell",
                                   device="cpu")
        warmer.warm_flat_signature(r, n, 128, 100, 0.1, mode="seg", C=128,
                                   device="cpu")
        warmer.warm_bag_signature(r, n, 4, 8, 2, 3, 50, 0.1, device="cpu")
    warmer.wait(timeout=60)
    assert not any(t.is_alive() for t in warmer._threads)
    dev = torch.device("cpu")
    assert sorted(calls, key=str) == sorted(
        [("flat", dev, "ell"), ("flat", dev, "seg"), ("bag", dev, "ell")],
        key=str)
    assert not warmer.failures


def test_concurrent_requests_claim_each_key_once(monkeypatch):
    """Many threads requesting the same stages at once, with the
    interpreter switching threads as often as it can: each key is warmed
    exactly once, and every warm ends."""
    import sys
    import threading

    calls = []
    monkeypatch.setattr(warm, "_flat", lambda *a: calls.append(a[1]))
    warmer = ProgramWarmer(max_workers=3)

    def request():
        for i in range(50):
            warmer.warm_flat_signature(1, 8, 2, 2, 0.1,
                                       mode=("ell", "seg", "x")[i % 3],
                                       C=8, device="cpu")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=request) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        warmer.wait(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads + warmer._threads)
    assert sorted(calls) == ["ell", "seg", "x"]
    assert len(warmer._threads) == 3 and not warmer.failures


def test_warms_leave_the_default_generator_alone(planted):
    """Every warm on the CPU runs without a failure and draws nothing from
    the default generator."""
    graph, g = planted
    state = torch.get_rng_state()
    warmer = ProgramWarmer()
    warmer.poke_device("cpu")
    warmer.warm_flat(graph, [0, 1, 2, 3], ScorerConfig(epochs_flat=7),
                     device="cpu")
    for mode in ("ell", "seg"):
        warmer.warm_flat_signature(2, 400, 128, 7, 0.1, mode=mode, C=128,
                                   device="cpu")
        warmer.warm_bag_signature(2, 400, 128, 8, 2, 2, 5, 0.1, mode=mode,
                                  C=128, P=16, device="cpu")
    for backend in ("segment", "csr"):
        warmer.warm_eval(graph, [[0, 1]], None, 2, MPGNNConfig(hidden_dim=8),
                         0, None, backend=backend, device="cpu")
    warmer.wait(timeout=300)
    assert not any(t.is_alive() for t in warmer._threads)
    assert not warmer.failures, warmer.failures
    assert torch.equal(torch.get_rng_state(), state)
    warmer.shutdown()
    warmer.poke_device("cpu")          # after shutdown: nothing starts
    assert all(not t.is_alive() for t in warmer._threads)


def test_warmed_search_matches_unwarmed(planted):
    """``tests/test_warm.py``'s case: the same result bit for bit, with the
    warmer's threads running beside the search."""
    from mpgnn_tpu_torch.search import find_metapaths

    graph, g = planted
    split = split_nodes(g["labels"])
    cfg = SearchConfig(
        max_extension_hops=2,
        scorer=ScorerConfig(epochs_flat=25, epochs_bags=15, max_restarts=3),
        mpgnn=MPGNNConfig(epochs=40, hidden_dim=16, backend="csr"),
    )
    kw = dict(num_classes=2, config=cfg, dataset="synthetic", seed=0,
              device="cpu")
    labels = np.asarray(g["labels"], np.float32)
    plain = find_metapaths(graph, labels, split, **kw)
    warmer = ProgramWarmer(max_workers=2)
    warmed = find_metapaths(graph, labels, split, warmer=warmer, **kw)
    warmer.wait(timeout=300)
    assert not warmer.failures, warmer.failures
    assert {k[0] for k in warmer._seen} >= {"flat", "bag", "eval"}
    assert warmed.metapaths == plain.metapaths
    assert warmed.discovered == plain.discovered
    assert warmed.val_f1_by_path == plain.val_f1_by_path
    assert warmed.test_f1 == plain.test_f1


def test_cli_no_warm_starts_no_warmer(monkeypatch, capsys, tmp_path):
    """``run.py`` pokes the device before the graph loads and shuts the
    warmer down at its end; with ``--no_warm`` no warm starts. Both print
    the same summary (a three-class planted graph of 300 nodes)."""
    from mpgnn_tpu_torch.run import main

    folder = str(tmp_path / "ds")
    generate_synthetic_graph(300, 4, "red-red-blue", metapath2="blue-red",
                             multiclass=True, seed=3, out_dir=folder)

    submitted = []
    real = ProgramWarmer._submit

    def record(self, key, fn, *args):
        submitted.append(key)
        return real(self, key, fn, *args)

    monkeypatch.setattr(ProgramWarmer, "_submit", record)
    outs = []
    for extra in (["--no_warm"], []):
        submitted.clear()
        main(CLI_LINE + ["--folder", folder] + extra)
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out.pop("wall_s")
        outs.append(out)
        if extra:
            assert submitted == []
        else:
            assert submitted[0] == ("poke", "cpu")
            assert ("eval", "segment", "cpu") in submitted
    assert outs[0] == outs[1]
    # the CLI shut its warmer down; the next one is new
    used = warm._global_warmer
    assert used._closed and not used.failures
    assert get_warmer() is not used and not get_warmer()._closed
    assert get_warmer(enabled=False) is None


def test_bench_warm_turns_and_stage_log():
    """The warm bench alternates warm, cold, cold, warm, ..., reads each
    class's stage times from the engine's log lines, and refuses to run
    without a card."""
    from mpgnn_tpu_torch.benchmarks import bench_warm

    assert bench_warm.run_order(3) == ["warm", "cold", "cold", "warm",
                                       "warm", "cold"]
    log = "\n".join([
        "x hop-0 losses: {0: 0.1} -> survivors [0] (1.5s)",
        "x hop 1: swept 1 states / 2 (state, relation) instances in 0.5s",
        "x final eval of 3 candidates: 7.25s",
        "x final meta: [[0]] test F1 1.0000 (greedy 2.0s)",
        "x hop-0 losses: {1: 0.2} -> survivors [1] (0.25s)",
        "x final eval of 1 candidates: 1.0s",
        "x final meta: [[1]] test F1 0.5000 (greedy 0.5s)"])
    assert bench_warm.stage_times(log) == [
        dict(hop0=1.5, hop1=0.5, final_eval=7.25, greedy=2.0),
        dict(hop0=0.25, final_eval=1.0, greedy=0.5)]
    if not torch.cuda.is_available():
        assert bench_warm.main([]) == 2
