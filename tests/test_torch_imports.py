"""PyTorch port: the import rules.

The port (`pmdfc_tpu_torch/`) and `chip_smoke.py` import neither JAX nor
anything of the JAX package `pmdfc_tpu`, nor the JAX system's operator
tools under the repo's root `tools/` (they keep their own copies of what
they need, `pmdfc_tpu_torch.tools`), and importing the port builds and
loads nothing: the CUDA kernel is compiled at its first launch, the
engine at the first `Engine()`, from the port's own copy of its source —
nothing under the top-level `native/` is opened, built or loaded.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)

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
    return top in ("jax", "jaxlib", "pmdfc_tpu", "tools")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_tells_the_packages_apart():
    assert _forbidden("pmdfc_tpu.kv") and _forbidden("jax.numpy")
    assert _forbidden("pmdfc_tpu")
    assert not _forbidden("pmdfc_tpu_torch.kv")
    assert _forbidden("tools.check_teledump") and _forbidden("tools")
    assert not _forbidden("pmdfc_tpu_torch.tools.check_teledump")


@pytest.mark.parametrize("line", [
    "from tools.check_teledump import check",
    "import tools.check_teledump as chk",
    "from tools import tracetool",
    "import tools",
])
def test_a_port_file_importing_the_root_tools_is_caught(tmp_path, line):
    """A planted port file that reaches into the root `tools` package (the
    JAX system's operator tools) fails the import rule; the same file
    importing the port's own copies passes."""
    bad = tmp_path / "pmdfc_tpu_torch" / "bench" / "planted.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(f"def gate(doc):\n    {line}\n    return doc\n")
    assert [m for m in _imported_modules(bad) if _forbidden(m)]
    bad.write_text("def gate(doc):\n    from pmdfc_tpu_torch.tools."
                   "check_teledump import check\n    return check(doc)\n")
    assert not [m for m in _imported_modules(bad) if _forbidden(m)]


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


def test_port_never_touches_the_jax_packages_native_directory():
    """Build and drive the port's engine and serving stack in a fresh
    interpreter that records every path it stats or opens, every library
    it loads and every command it runs: nothing lies under the top-level
    `native/` (the JAX package's engine source and library), and the
    engine comes from the port's own copy, `pmdfc_tpu_torch/native/`."""
    code = f"""
import builtins, ctypes, os, subprocess
seen = []
def spy(mod, name):
    real = getattr(mod, name)
    def f(*a, **k):
        # a command is an argv list: record each of its elements (the
        # source path of a compile is one of them), else the path itself
        if a and isinstance(a[0], (list, tuple)):
            seen.extend(str(x) for x in a[0])
        elif a:
            seen.append(str(a[0]))
        return real(*a, **k)
    setattr(mod, name, f)
for mod, name in ((os, "stat"), (builtins, "open"), (subprocess, "run"),
                  (subprocess, "Popen"), (ctypes, "CDLL")):
    spy(mod, name)
import numpy as np
from pmdfc_tpu_torch.client import CleanCacheClient, EngineBackend
from pmdfc_tpu_torch.config import IndexConfig, KVConfig
from pmdfc_tpu_torch.runtime import Engine, KVServer
eng = Engine(num_queues=1, queue_cap=1 << 6, batch=64, arena_pages=64,
             page_bytes=64)
with KVServer(KVConfig(index=IndexConfig(capacity=1 << 10), page_words=16),
              engine=eng, device="cpu") as srv:
    cc = CleanCacheClient(EngineBackend(srv, slice_pages=8))
    cc.put_pages(np.array([1]), np.array([2]), np.ones((1, 16), np.uint32))
    assert cc.get_pages(np.array([1]), np.array([2]))[1].all()
jax_native = {str(ROOT / "native")!r}
bad = [p for p in seen if p == jax_native or p.startswith(jax_native + os.sep)]
assert not bad, bad
own = {str(ROOT / "pmdfc_tpu_torch" / "native" / "runtime.cpp")!r}
assert own in seen, "the port's own engine source was not consulted"
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_operator_tools_run_where_jax_is_absent(tmp_path):
    """In interpreters where importing jax or pmdfc_tpu raises (the
    prelude `chip_smoke.py` gives phase 16's children): the port's operator
    tools the smoke and the port's docs lean on import, `python -m
    pmdfc_tpu_torch.tools.teledump --local --out` writes this process's
    registry, and `python -m pmdfc_tpu_torch.tools.check_teledump` passes
    the document it wrote."""
    import chip_smoke

    def run(argv):
        proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    out = run([sys.executable, "-c", chip_smoke.NO_JAX_PRELUDE + (
        "import pmdfc_tpu_torch.tools.check_teledump\n"
        "import pmdfc_tpu_torch.tools.tracetool\n"
        "import pmdfc_tpu_torch.tools.proftool\n"
        "try:\n    import jax\nexcept ImportError:\n    print('refused')\n")])
    assert out.strip() == "refused"
    doc = tmp_path / "local.json"
    run(chip_smoke.no_jax_argv("pmdfc_tpu_torch.tools.teledump", "--local",
                               "--out", str(doc)))
    assert '"telemetry"' in doc.read_text()
    out = run(chip_smoke.no_jax_argv("pmdfc_tpu_torch.tools.check_teledump",
                                     str(doc)))
    assert out.startswith("[check_teledump] OK: telemetry snapshot")
