"""The port covers the JAX package's public API: every public top-level
name of ``mpgnn_tpu`` (a function, class or constant of any of its
modules, read with ``ast``, so that no JAX is imported) has a counterpart
of the same name somewhere in ``mpgnn_tpu_torch``, or is dropped by design
with its reason below. Each dropped name stands in ``ROADMAP.md``'s "What
the port does not inherit", which gives the reasons at length."""

import ast
import os
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_MODELS = ("the functional model API: the port's models are nn.Modules "
           "(MPNetm, MetapathNet, RgcnNet, RelConv*) holding their "
           "parameters")
_GSPMD = ("GSPMD placement: the port writes its collectives out and splits "
          "a sweep with parallel.context.sweep_slice / gather_sweep")
_AOT = "the ahead-of-time store of the batched evaluation: nothing compiles"
DROPPED = {
    # models/mpgnn.py, models/relconv.py
    "LinearParams": _MODELS,
    "init_linear": _MODELS,
    "MPGNNParams": _MODELS,
    "mpgnn_forward": _MODELS,
    "MetapathNetParams": _MODELS,
    "metapath_net_forward": _MODELS,
    "RGCNConvParams": _MODELS,
    "RGCNBasisConvParams": _MODELS,
    "RGCNBlockConvParams": _MODELS,
    "RGCNNetParams": _MODELS,
    "rgcn_net_forward": _MODELS,
    "relconv_apply": _MODELS,
    # models/scorer.py
    "scorer_forward_flat": "the scorer's functional forwards: the sweeps "
                           "call flat_forward_* and bag_forward_*",
    "scorer_forward_bags": "the scorer's functional forwards: the sweeps "
                           "call flat_forward_* and bag_forward_*",
    # native/, ops/pallas_*.py
    "get_lib": "native/graphio.cpp is native.py, in numpy: no library",
    "pallas_dense_conv": "a Pallas entry point: K3 is ops.conv.dense_conv "
                         "on csrc/dense_matmul.cu",
    "make_csr_aggregate": "a jit closure over the Pallas kernels: "
                          "ops.csr.csr_mean_aggregate takes the blockings",
    # parallel/
    "shard_sweep": _GSPMD,
    "replicate_sweep": _GSPMD,
    "shard_sweep_tree": _GSPMD,
    "replicated": _GSPMD,
    "shard_along": _GSPMD,
    "abstract_with_batch_sharding": "an ahead-of-time helper: nothing "
                                    "compiles",
    "abstract_replicated": "an ahead-of-time helper: nothing compiles",
    # train/
    "eval_aot_keys": _AOT,
    "claim_aot_keys": _AOT,
    "split_hop_ops": "jit's split of static hop kinds from array "
                     "arguments: eager calls take the operands as they are",
    "retag_hop_ops": "jit's split of static hop kinds from array "
                     "arguments: eager calls take the operands as they are",
    "make_dropout_key": "dropout masks come from a torch.Generator seeded "
                        "from the run's seed ('rbg' is not inherited)",
    # search/scoring.py
    "warm_retrain_signatures": "the retrain rounds run the bag sweep's "
                               "forms, which score_bag_tasks warms (a warm "
                               "is keyed on its form, not its shapes)",
    # utils/prof.py
    "enable_compilation_cache": "XLA's persistent cache: nothing compiles "
                                "ahead; the kernels build once a checkout",
}
# Ported in the last slice, so never on the list above.
PORTED = ("ProgramWarmer", "get_warmer", "segment_max", "segment_argmax",
          "masked_segment_mean", "segment_count", "ell_max_gather")


def public_names(package: str) -> dict:
    """{name: [module path]} of every public top-level def, class and
    assignment of every module of ``package``."""
    out = {}
    for path in sorted((ROOT / package).rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            names = []
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names = [node.name]
            elif isinstance(node, ast.Assign):
                names = [t.id for t in node.targets
                         if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                names = [node.target.id]
            for name in names:
                if not name.startswith("_"):
                    out.setdefault(name, []).append(
                        str(path.relative_to(ROOT)))
    return out


@pytest.fixture(scope="module")
def names():
    return public_names("mpgnn_tpu"), public_names("mpgnn_tpu_torch")


def test_every_jax_name_has_a_counterpart_or_a_reason(names):
    jax_names, port_names = names
    missing = {n: where for n, where in jax_names.items()
               if n not in port_names and n not in DROPPED}
    assert not missing, f"no counterpart and no reason: {missing}"


def test_the_dropped_names_are_jax_names_without_a_counterpart(names):
    """The list holds no stale entry: each name is in the JAX package, has
    no counterpart, and is not one of the names ported last."""
    jax_names, port_names = names
    assert set(DROPPED) <= set(jax_names)
    assert not set(DROPPED) & set(port_names)
    assert not set(DROPPED) & set(PORTED)
    assert set(PORTED) <= set(jax_names) & set(port_names)


def test_the_dropped_names_stand_in_the_roadmap():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    absent = [n for n in DROPPED if f"`{n}`" not in roadmap]
    assert not absent, f"not in ROADMAP.md: {absent}"
    assert all(DROPPED.values())


def test_warm_module_imports_no_jax():
    tree = ast.parse((ROOT / "mpgnn_tpu_torch/utils/warm.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert roots & {"jax", "jaxlib", "mpgnn_tpu", "optax"} == set()
    assert "mpgnn_tpu_torch" in roots
    assert os.path.exists(ROOT / "mpgnn_tpu/utils/warm.py")
