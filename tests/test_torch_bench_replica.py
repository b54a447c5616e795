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
`breaker_opens`, `load_shed_gets`.
"""

from __future__ import annotations

import pytest

from test_torch_bench_sweeps import _jax_main, _json_objects

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("PMDFC_COMPILE_CACHE", "0")


def test_replica_soak_stays_available_like_jax(monkeypatch, capsys):
    from pmdfc_tpu.bench import replica_soak as jrs
    from pmdfc_tpu_torch.bench import replica_soak as trs

    rc, jout = _jax_main(jrs.main, ["--smoke"], monkeypatch, capsys)
    assert rc == 0
    assert trs.main(["--device", "cpu", "--smoke"]) == 0
    j, t = jout[-1], _json_objects(capsys.readouterr().out)[-1]
    for k in ("n_replicas", "rf", "keys", "steps", "batch", "zipf",
              "page_words", "kill_cycles", "nofault_hit_rate"):
        assert t[k] == j[k], k
    assert t["wrong_bytes"] == 0 and t["serve_errors"] == 0
    assert t["hit_rate_ratio"] >= 0.8 and t["repair_pages"] > 0
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
