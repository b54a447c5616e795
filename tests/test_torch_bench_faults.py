"""PyTorch port: the containment soak and the recovery soak against their
JAX twins (`pmdfc_tpu_torch/bench/{containment_soak,recovery_soak}.py` vs
`pmdfc_tpu/bench/`).

Each harness runs next to its JAX twin on the CPU at smoke sizes (the
port with `--device cpu`; the recovery soak's crashbox children are
spawned processes of each package). What the seed fixes is compared:
the containment drill's isolation (one poisoned op isolated within
`ceil(log2 b)` bisection failures, its NACK, the shard quarantined and
re-admitted, every expired op refused before the device) and the
recovery soak's acknowledged keys and RPO bound. Exempt as host timing,
held by the gates instead: the storm and ramp goodputs, the healthy and
baseline hit fractions, the quarantined misses, and the recovery arms'
AUCs, t90 steps, replayed pages and `miss_recovering` (gated > 0), and
`pages_lost` (gated by the RPO bound). Each pair of soaks runs once
for the module; each check is a test of its own over their rows.
"""

from __future__ import annotations

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from test_torch_bench_sweeps import run_twin_mains

pytestmark = pytest.mark.torch

RECOVERY_FIXED = ("keys", "steps", "batch", "page_words", "rpo_ops",
                  "acked_keys", "rpo_bound", "torn_bytes")


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("PMDFC_COMPILE_CACHE", "0")


def _rows(out):
    (jrc, jout), (trc, tout) = out["jax"], out["port"]
    return jrc, jout[-1] if jout else {}, trc, tout[-1] if tout else {}


@pytest.fixture(scope="module")
def containment():
    """Each package's `--smoke` containment soak, run once for the
    module's checks -> (JAX's rc, JAX's last row, the port's rc, the
    port's last row)."""
    from pmdfc_tpu.bench import containment_soak as jcs
    from pmdfc_tpu_torch.bench import containment_soak as tcs

    return _rows(run_twin_mains(jcs.main, ["--smoke"], tcs.main,
                                ["--device", "cpu", "--smoke"]))


@pytest.fixture(scope="module")
def recovery():
    """Each package's `--smoke` recovery soak, run once for the module's
    checks (as `containment`)."""
    from pmdfc_tpu.bench import recovery_soak as jrs
    from pmdfc_tpu_torch.bench import recovery_soak as trs

    return _rows(run_twin_mains(jrs.main, ["--smoke"], trs.main,
                                ["--device", "cpu", "--smoke"]))


def test_containment_soak_isolates_like_jax(containment):
    """Both soaks pass their own gates (exit 0)."""
    jrc, _, trc, _ = containment
    assert jrc == 0
    assert trc == 0


def test_containment_soak_serves_no_error_on_the_cpu(containment):
    t = containment[3]
    assert t["serve_errors"] == 0 and t["device"] == "cpu"


def test_containment_soak_isolates_the_poisoned_op_within_its_bound(
        containment):
    t = containment[3]
    assert t["isolation"]["poison_ops"] == 1
    assert t["isolation"]["bisect_failures"] <= t["bound"] == 2
    assert t["isolation"]["nacks_sent"] >= 1


def test_containment_soak_quarantines_and_readmits_the_shard(containment):
    t = containment[3]
    assert t["readmitted"] and t["quarantined_misses"] > 0


def test_containment_soak_proof_arm_sheds_by_deadline_only(containment):
    t = containment[3]
    assert t["proof"]["poison_ops"] == 0 and t["proof"]["deadline_shed"] > 0


def test_containment_soak_fails_when_the_quarantine_attribution_breaks(
        monkeypatch, capsys):
    """A plane whose stats lose the `miss_quarantined` lane fails the
    shard-kill drill's accounting identity."""
    from pmdfc_tpu_torch.bench import containment_soak as tcs
    from pmdfc_tpu_torch.parallel import shard

    real = shard.ShardedKV.stats

    def stats(self):
        st = dict(real(self))
        st["miss_quarantined"] = 0
        return st

    monkeypatch.setattr(shard.ShardedKV, "stats", stats)
    assert tcs.main(["--device", "cpu", "--smoke"]) == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and "miss" in out


def test_recovery_soak_recovers_like_jax(recovery):
    """Both soaks pass their own gates (exit 0)."""
    jrc, _, trc, _ = recovery
    assert jrc == 0
    assert trc == 0


@pytest.mark.parametrize("key", RECOVERY_FIXED)
def test_recovery_soak_fixes_what_the_seed_fixes_like_jax(recovery, key):
    _, j, _, t = recovery
    assert t[key] == j[key], key


def test_recovery_soak_serves_no_wrong_byte_and_no_serve_error(recovery):
    t = recovery[3]
    assert t["wrong_bytes"] == 0 and t["serve_errors"] == 0


def test_recovery_soak_loses_no_more_than_its_rpo_bound(recovery):
    t = recovery[3]
    assert t["pages_lost"] <= t["rpo_bound"] and t["miss_recovering"] > 0


def test_recovery_soak_warm_restart_beats_cold(recovery):
    t = recovery[3]
    assert t["warm_auc"] > t["cold_auc"]
