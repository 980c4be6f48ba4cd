"""The module check compares whole top-level names: the JAX package and
JAX are caught, the port (whose name begins with the JAX package's) is
not."""

from __future__ import annotations

from perfbench import harness


def test_whole_top_level_names():
    mods = ["mpgnn_tpu_torch", "mpgnn_tpu_torch.ops.csr", "torch",
            "jaxtyping", "mpgnn_tpu_tools", "numpy"]
    assert harness.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "mpgnn_tpu", "mpgnn_tpu.ops.pallas_csr"]
    assert harness.forbidden_modules(mods + bad) == sorted(bad)


def test_the_harness_and_the_reference_load_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.');"
            "import perfbench.drivers.train, perfbench.control,"
            " perfbench.run;"
            "from perfbench import harness;"
            "import perfbench.models.mpnetm;"
            "import mpgnn_tpu_torch.train.loops;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(harness.ROOT.parent), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_port():
    import re

    for path in (harness.ROOT / "reference").glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(mpgnn_tpu|jax)", text,
                             re.M), path
