"""The port stands alone: nothing under src/repro_torch, and not
chip_smoke.py, imports JAX or the reference package, and the port imports
with JAX made unimportable."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch_threads  # noqa: F401  (the worker's share of the cores)

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FILES = sorted(PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def test_the_port_has_modules():
    assert len(FILES) > 20


def _bad_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    return bad


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_or_reference_imports(path):
    bad = _bad_imports(path)
    assert not bad, f"{path}: imports {bad}"


def test_chip_smoke_has_no_jax_or_reference_imports():
    path = SRC.parent / "chip_smoke.py"
    assert not _bad_imports(path), path


def test_imports_with_jax_blocked():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="repro_torch."))
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
