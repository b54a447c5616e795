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
`pages_lost` (gated by the RPO bound).
"""

from __future__ import annotations

import pytest

from test_torch_bench_sweeps import _jax_main, _json_objects

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("PMDFC_COMPILE_CACHE", "0")


def test_containment_soak_isolates_like_jax(monkeypatch, capsys):
    from pmdfc_tpu.bench import containment_soak as jcs
    from pmdfc_tpu_torch.bench import containment_soak as tcs

    rc, _ = _jax_main(jcs.main, ["--smoke"], monkeypatch, capsys)
    assert rc == 0
    assert tcs.main(["--device", "cpu", "--smoke"]) == 0
    t = _json_objects(capsys.readouterr().out)[-1]
    assert t["serve_errors"] == 0 and t["device"] == "cpu"
    assert t["isolation"]["poison_ops"] == 1
    assert t["isolation"]["bisect_failures"] <= t["bound"] == 2
    assert t["isolation"]["nacks_sent"] >= 1
    assert t["readmitted"] and t["quarantined_misses"] > 0
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


def test_recovery_soak_recovers_like_jax(monkeypatch, capsys):
    from pmdfc_tpu.bench import recovery_soak as jrs
    from pmdfc_tpu_torch.bench import recovery_soak as trs

    rc, jout = _jax_main(jrs.main, ["--smoke"], monkeypatch, capsys)
    assert rc == 0
    assert trs.main(["--device", "cpu", "--smoke"]) == 0
    j, t = jout[-1], _json_objects(capsys.readouterr().out)[-1]
    for k in ("keys", "steps", "batch", "page_words", "rpo_ops",
              "acked_keys", "rpo_bound", "torn_bytes"):
        assert t[k] == j[k], k
    assert t["wrong_bytes"] == 0 and t["serve_errors"] == 0
    assert t["pages_lost"] <= t["rpo_bound"] and t["miss_recovering"] > 0
    assert t["warm_auc"] > t["cold_auc"]
