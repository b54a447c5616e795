"""Build and load the port's native libraries.

Each `ops/csrc/<name>.cu` holds a plain C entry point. It is compiled by
`nvcc` for Hopper (`sm_90a`) into `build/pmdfc_tpu_torch/lib<name>.so` at
the repo root and loaded with `ctypes`, at the first launch — never at
import, so the package imports on machines without a CUDA toolkit. A
library older than its source is rebuilt.

Host code (`native/runtime.cpp`, the coalescing engine) builds the same
way with `g++` (`build_host`, `load_host`), with the flags of the JAX
package's `native/Makefile`, into `build/pmdfc_tpu_torch/libpmdfc_<name>.so`.
It needs no GPU, so it builds and runs on any machine with a C++ compiler.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "ops" / "csrc"
NATIVE = PKG / "native"
BUILD_DIR = PKG.parent / "build" / "pmdfc_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the JAX package's native/Makefile flags
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared"]

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()  # guarded-by: _LOADED
# name -> (seconds, the compiler's output, incl. nvcc's -Xptxas -v) of the
# builds this process ran
BUILD_LOG: dict[str, tuple[float, str]] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("no C++ compiler (g++) to build the engine")
    return path


def _compile(name: str, src: Path, lib: Path, argv: list[str]) -> Path:
    """Run `argv + [-o tmp, src]` unless `lib` is at least as new as
    `src`; the library appears atomically, so concurrent builds (test
    workers) never load a partial file."""
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.monotonic()
    try:
        proc = subprocess.run([*argv, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{argv[0]} failed for {src}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOG[name] = (time.monotonic() - t0, proc.stdout + proc.stderr)
    return lib


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists."""
    return _compile(name, CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so",
                    [nvcc(), *NVCC_FLAGS])


def build_host(name: str) -> Path:
    """Compile `native/<name>.cpp` with g++ unless an up-to-date
    `libpmdfc_<name>.so` exists."""
    return _compile(name, NATIVE / f"{name}.cpp",
                    BUILD_DIR / f"libpmdfc_{name}.so", [cxx(), *CXX_FLAGS])


def _load(key: str, compile_fn, name: str) -> ctypes.CDLL:
    with _LOCK:
        if key not in _LOADED:
            _LOADED[key] = ctypes.CDLL(str(compile_fn(name)))
        return _LOADED[key]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    return _load(name, build, name)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of `native/<name>.cpp`, built on first use."""
    return _load(f"native/{name}", build_host, name)
