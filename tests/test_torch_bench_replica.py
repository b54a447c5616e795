"""PyTorch port: the replica availability soak against its JAX twin
(`pmdfc_tpu_torch/bench/replica_soak.py` vs `pmdfc_tpu/bench/`).

Both run at smoke sizes on the CPU (the port's nodes with `--device
cpu`): three real-KV `NetServer`s behind a `ReplicaGroup` (rf 2) serve a
seeded zipf storm twice, without faults and under a rolling
kill/cold-restore. Which node answers, and when a hedge or breaker
fires, depends on host timing, so the test compares the schedule the
seed fixes (`kill_cycles` and the configuration) and the no-fault hit
rate, and holds the gates on both packages: zero wrong bytes, no serve
error (port), `hit_rate_ratio >= 0.8`, repair pages moved, at least one
breaker opening. Exempt as timing: `fault_hit_rate`, `hit_rate_ratio`,
`hit_rate_floor`, `hedges_fired`, `failovers`, `repair_pages`,
`breaker_opens`, `load_shed_gets`. The two soaks run once for the
module; each check is a test of its own over their rows.
"""

from __future__ import annotations

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from test_torch_bench_sweeps import _json_objects, run_twin_mains

pytestmark = pytest.mark.torch

FIXED = ("n_replicas", "rf", "keys", "steps", "batch", "zipf", "page_words",
         "kill_cycles", "nofault_hit_rate")


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("PMDFC_COMPILE_CACHE", "0")


@pytest.fixture(scope="module")
def soak():
    """Each package's `--smoke` soak, run once for the module's checks ->
    (JAX's rc, JAX's last row, the port's rc, the port's last row)."""
    from pmdfc_tpu.bench import replica_soak as jrs
    from pmdfc_tpu_torch.bench import replica_soak as trs

    out = run_twin_mains(jrs.main, ["--smoke"], trs.main,
                         ["--device", "cpu", "--smoke"])
    (jrc, jout), (trc, tout) = out["jax"], out["port"]
    return jrc, jout[-1] if jout else {}, trc, tout[-1] if tout else {}


def test_replica_soak_stays_available_like_jax(soak):
    """Both soaks pass their own gates (exit 0)."""
    jrc, _, trc, _ = soak
    assert jrc == 0
    assert trc == 0


@pytest.mark.parametrize("key", FIXED)
def test_replica_soak_fixes_what_the_seed_fixes_like_jax(soak, key):
    _, j, _, t = soak
    assert t[key] == j[key], key


def test_replica_soak_serves_no_wrong_byte_and_no_serve_error(soak):
    t = soak[3]
    assert t["wrong_bytes"] == 0 and t["serve_errors"] == 0


def test_replica_soak_keeps_its_hit_ratio_and_repairs(soak):
    t = soak[3]
    assert t["hit_rate_ratio"] >= 0.8 and t["repair_pages"] > 0


def test_replica_soak_reports_every_field_jax_reports(soak):
    _, j, _, t = soak
    assert set(j) <= set(t)


def test_replica_soak_fails_on_a_wrong_byte(monkeypatch, capsys):
    from pmdfc_tpu_torch.bench import replica_soak as trs
    from pmdfc_tpu_torch.client import replica

    real = replica.ReplicaGroup.get

    def corrupt(self, keys):
        out, found = real(self, keys)
        if found.any():
            out = out.copy()
            out[found.nonzero()[0][0], 1] ^= 1
        return out, found

    monkeypatch.setattr(replica.ReplicaGroup, "get", corrupt)
    assert trs.main(["--device", "cpu", "--smoke", "--steps", "40"]) == 1
    assert _json_objects(capsys.readouterr().out)[-1]["wrong_bytes"] > 0
