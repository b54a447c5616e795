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
`migration_dropped`, `miss_routed`. The two sweeps run once for the
module; each check is a test of its own over their rows.
"""

from __future__ import annotations

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from test_torch_bench_sweeps import run_twin_mains

pytestmark = pytest.mark.torch

FIXED = ("metric", "transport", "n_start", "rf", "vnodes", "keys", "steps",
         "batch", "zipf", "page_words", "transitions", "expected_frac")


@pytest.fixture(scope="module")
def sweep():
    """Each package's `--smoke` sweep, run once for the module's checks ->
    (JAX's rc, JAX's last row, the port's rc, the port's last row)."""
    from pmdfc_tpu.bench import elastic_sweep as jes
    from pmdfc_tpu_torch.bench import elastic_sweep as tes

    out = run_twin_mains(jes.main, ["--smoke"], tes.main,
                         ["--device", "cpu", "--smoke"])
    (jrc, jout), (trc, tout) = out["jax"], out["port"]
    return jrc, jout[-1] if jout else {}, trc, tout[-1] if tout else {}


def test_elastic_sweep_scales_like_jax(sweep):
    """Both sweeps pass their own gates (exit 0)."""
    jrc, _, trc, _ = sweep
    assert jrc == 0
    assert trc == 0


@pytest.mark.parametrize("key", FIXED)
def test_elastic_sweep_fixes_what_the_seed_fixes_like_jax(sweep, key):
    _, j, _, t = sweep
    assert t[key] == j[key], key


def test_elastic_sweep_serves_no_wrong_byte_and_no_serve_error(sweep):
    t = sweep[3]
    assert t["wrong_bytes"] == 0 and t["serve_errors"] == 0


def test_elastic_sweep_moves_pages_and_keeps_the_hit_ratio(sweep):
    t = sweep[3]
    assert t["moved_pages"] > 0 and t["value"] >= 0.75


def test_elastic_sweep_reports_every_field_jax_reports(sweep):
    _, j, _, t = sweep
    assert set(j) <= set(t)
