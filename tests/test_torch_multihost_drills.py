"""PyTorch port: `tests/test_multihost.py`'s workload-driver drill, on
both packages.

The JAX suite is `slow` as a whole. Its driver drill runs
`bench.multihost_bench --procs 2`: two processes of two devices each
join one grid (JAX through `jax.distributed`, the port through
`torch.distributed` over gloo on the CPU), fill a sharded KV and read
every key back. Here each package's driver runs as the JAX drill runs
it, at 2^12 keys in batches of 2^10 over 2^13 slots, held to the JAX
drill's own checks: the record's metric, every key served, two
processes of four devices in all, no empty shard. The fixed fields of
the two records must be equal. On the card, phase 12 runs the port's
driver with two gloo ranks. The two-process sharded-KV drill runs both
packages in `test_torch_multihost.py`.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

import pmdfc_tpu.bench.multihost_bench as jmh
import pmdfc_tpu_torch.bench.multihost_bench as tmh

pytestmark = pytest.mark.torch

SIZE = ["--procs", "2", "--n", str(1 << 12), "--batch", str(1 << 10),
        "--capacity", str(1 << 13), "--timeout", "240"]


def _record(module: str, *extra) -> dict:
    p = subprocess.run([sys.executable, "-m", module, *SIZE, *extra],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_multihost_bench_smoke():
    jrec = _record(jmh.__name__)
    trec = _record(tmh.__name__, "--device", "cpu")
    for rec in (jrec, trec):
        assert rec["metric"] == "multihost_get_mops"
        assert rec["hits"] == rec["n"]
        assert rec["procs"] == 2 and rec["devices"] == 4
        assert rec["shard_occupancy_min"] > 0
    for k in ("metric", "n", "hits", "procs", "devices"):
        assert trec[k] == jrec[k], k
