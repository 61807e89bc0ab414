"""No module the benchmark loads is JAX's or the JAX package's, compared by
whole top-level name; the reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.tiny import ROOT


@pytest.mark.parametrize("names, found", [
    (["multimodalvc_tpu_torch", "multimodalvc_tpu_torch.ops.attention", "torch"], []),
    (["multimodalvc_tpu", "multimodalvc_tpu_torch"], ["multimodalvc_tpu"]),
    (["multimodalvc_tpu.models.speech"], ["multimodalvc_tpu"]),
    (["jax._src.core", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "optax"], ["flax", "optax"]),
    (["jaxtyping", "optaxx", "flaxen"], []),
])
def test_top_level_names_compared_whole(names, found):
    assert harness.forbidden_modules(names) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for name in _imports(path):
        assert name.split(".")[0] not in ("multimodalvc_tpu_torch",) + harness.FORBIDDEN, name


def test_no_file_of_the_benchmark_imports_jax():
    for path in (ROOT / "perfbench").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_a_cell_loads_no_jax():
    """What a run imports (the harness, the runners, the port's modules on
    their paths) leaves no JAX module in ``sys.modules``."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from perfbench import harness, control, series;"
        "from perfbench.runners import train, synth;"
        "import multimodalvc_tpu_torch.tasks, multimodalvc_tpu_torch.models.speech,"
        " multimodalvc_tpu_torch.models.vocoder, multimodalvc_tpu_torch.runtime.trainer;"
        "from perfbench.trace import Ranges; Ranges().attention();"
        "print(harness.forbidden_modules())"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(USE_FLAX="0", USE_JAX="0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
