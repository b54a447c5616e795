"""Build and load the port's CUDA kernels.

Each `ops/csrc/<name>.cu` holds a plain C entry point. It is compiled by
`nvcc` for Hopper (`sm_90a`) into `build/pmdfc_tpu_torch/lib<name>.so` at
the repo root and loaded with `ctypes`, at the first launch — never at
import, so the package imports on machines without a CUDA toolkit. A
library older than its source is rebuilt.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pmdfc_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# name -> (seconds, nvcc's output incl. -Xptxas -v) of builds this process ran
BUILD_LOG: dict[str, tuple[float, str]] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.monotonic()
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOG[name] = (time.monotonic() - t0, proc.stdout + proc.stderr)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(build(name)))
        return _LOADED[name]
