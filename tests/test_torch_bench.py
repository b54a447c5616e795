"""PyTorch port: `pmdfc_tpu_torch/bench/families.py` runs end to end on the
CPU at a tiny size and prints one JSON object per family, importing the
package from the tree it is given."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

pytestmark = pytest.mark.torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_family_timing_script_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "pmdfc_tpu_torch/bench/families.py"),
         "--device", "cpu", "--capacity", "2048", "--batch", "256",
         "--get-batch", "128", "--reps", "1", "--tree", str(ROOT)],
        capture_output=True, text=True, check=True, timeout=120).stdout
    rows = [json.loads(line) for line in out.splitlines()]
    assert [r["family"] for r in rows] == [
        "cuckoo", "ccp", "level", "path", "static", "hotring"]
    for r in rows:
        assert r["package"] == str(ROOT / "pmdfc_tpu_torch")
        assert r["fill_keys"] == (3 * r["slots"] // 4) // 256 * 256
        assert r["insert_ms_median"] > 0 and r["get_values_ms_median"] > 0
