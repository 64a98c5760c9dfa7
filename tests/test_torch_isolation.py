"""The port stands alone: nothing in ``src/repro_torch`` or ``chip_smoke.py``
imports JAX or the JAX package, nor do the mesh tests' rank bodies
(``tests/torch_mesh_ranks.py``), and importing the port loads no JAX."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the parity suites import both frameworks)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_mesh_ranks.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"lc.py", "ops.py", "index.py", "chip_smoke.py", "mesh.py",
            "local.py", "annotate.py", "partition.py", "model.py",
            "layers.py", "ssm.py", "convert.py", "tokens.py",
            "olmo_1b.py", "adamw.py", "grad_utils.py", "steps.py",
            "fault.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.api, repro_torch.core.lc, "
            "repro_torch.kernels.ops, repro_torch.data.synth, "
            "repro_torch.cascade, repro_torch.candidates, "
            "repro_torch.serving, repro_torch.checkpoint, "
            "repro_torch.launch.mesh, repro_torch.launch.local, "
            "repro_torch.launch.search, repro_torch.sharding.annotate, "
            "repro_torch.kernels.partition, repro_torch.models.model, "
            "repro_torch.models.convert, repro_torch.models.parity, "
            "repro_torch.optim.adamw, repro_torch.optim.grad_utils, "
            "repro_torch.launch.steps, repro_torch.runtime.fault, "
            "repro_torch.configs, "
            "repro_torch.data.tokens; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
