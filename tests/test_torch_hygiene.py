"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package (``repro``), and
importing the port pulls neither into the process. Only the tests import
both."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names: list[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            names.append(str(node.args[0].value))
    return names


def test_port_has_the_expected_layout():
    pkg = ROOT / "src" / "repro_torch"
    for sub in ("ml", "data", "core", "sql", "relational", "exec", "tensor", "kernels"):
        assert (pkg / sub / "__init__.py").exists(), sub
    assert sorted(p.name for p in (pkg / "kernels" / "csrc").glob("*.cu")) == [
        "errors.cu", "featurize.cu", "gather_join.cu", "segment_agg.cu",
        "tree_gemm.cu",
    ]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    """Importing every module of the port pulls in neither JAX nor the
    reference package, and builds no kernel: the CUDA library is built at
    first launch, so the CPU tests can import everything without nvcc."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]), bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) > 20 and bad.strip() == "[]", out.stdout
