"""PyTorch port: the import rules.

The port (`pmdfc_tpu_torch/`) and `chip_smoke.py` import neither JAX nor
anything of the JAX package `pmdfc_tpu` (they keep their own copies of
what they need), and importing the port builds and loads nothing: the
CUDA kernel is compiled at its first launch.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "pmdfc_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "pmdfc_tpu")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_tells_the_packages_apart():
    assert _forbidden("pmdfc_tpu.kv") and _forbidden("jax.numpy")
    assert _forbidden("pmdfc_tpu")
    assert not _forbidden("pmdfc_tpu_torch.kv")


def test_importing_the_port_builds_nothing_and_pulls_no_jax():
    """Import every module of the port in a fresh interpreter whose
    subprocess launcher raises: no build may start, no library may load,
    and neither jax nor pmdfc_tpu may end up in sys.modules."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in SOURCES if p.name != "chip_smoke.py")
    code = f"""
import subprocess, sys, importlib
def refuse(*a, **k):
    raise AssertionError("a subprocess was started during import")
subprocess.run = subprocess.Popen = refuse
for m in {mods!r}:
    importlib.import_module(m)
from pmdfc_tpu_torch.ops import _build
assert not _build._LOADED and not _build.BUILD_LOG
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "pmdfc_tpu")]
assert not bad, bad
print("ok", len({mods!r}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
