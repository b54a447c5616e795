"""PyTorch port: the elastic-membership sweep against its JAX twin
(`pmdfc_tpu_torch/bench/elastic_sweep.py` vs `pmdfc_tpu/bench/`).

Both run at smoke sizes on the CPU (the port's nodes with `--device
cpu`): a `ReplicaGroup` on the placement ring scales 3 -> 5 -> 2 under a
seeded zipf storm, with live migration and the dual-read window. The
test compares what the seed fixes (five transitions, the
consistent-hashing expectation `expected_frac`, the configuration) and
holds the gates on both packages: zero wrong bytes, no serve error
(port), pages moved, the moved share within 2x the expectation, a
hit-rate ratio >= 0.75, a valid teledump. Exempt as timing: the hit
rates, `hit_rate_floor`, `moved_pages`, `owed_frac`,
`migration_dropped`, `miss_routed`.
"""

from __future__ import annotations

import pytest

from test_torch_bench_sweeps import _jax_main, _json_objects

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("PMDFC_COMPILE_CACHE", "0")


def test_elastic_sweep_scales_like_jax(monkeypatch, capsys):
    from pmdfc_tpu.bench import elastic_sweep as jes
    from pmdfc_tpu_torch.bench import elastic_sweep as tes

    rc, jout = _jax_main(jes.main, ["--smoke"], monkeypatch, capsys)
    assert rc == 0
    assert tes.main(["--device", "cpu", "--smoke"]) == 0
    j, t = jout[-1], _json_objects(capsys.readouterr().out)[-1]
    for k in ("metric", "transport", "n_start", "rf", "vnodes", "keys",
              "steps", "batch", "zipf", "page_words", "transitions",
              "expected_frac"):
        assert t[k] == j[k], k
    assert t["wrong_bytes"] == 0 and t["serve_errors"] == 0
    assert t["moved_pages"] > 0 and t["value"] >= 0.75
    assert set(j) <= set(t)
