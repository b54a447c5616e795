"""PyTorch port: the serving soak, the fast-path sweep and the QoS soak
against their JAX twins (`pmdfc_tpu_torch/bench/{soak,fastpath_sweep,
qos_soak}.py` vs `pmdfc_tpu/bench/`).

Each harness runs next to its JAX twin on the CPU at smoke sizes (the
port with `--device cpu`). Their counters depend on host timing — the
soak runs for a wall-clock duration, the sweeps and arms for timed
windows — so the test holds every harness's gates on both packages and
compares only what the seed fixes (the configuration each row echoes,
the resident pools). Exempt as timing: the soak's `served`,
`verified_pages`, `misses`, `deletes`, `evictions`, `kv_deletes` and
rates; every latency, rate and ratio of the fast-path sweep; the QoS
arms' verb counts, denials, lane counters and `miss_shed`. Each pair of
harnesses runs once for the module; each check is a test of its own
over their rows.
"""

from __future__ import annotations

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from test_torch_bench_sweeps import _json_objects, run_twin_mains

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("PMDFC_COMPILE_CACHE", "0")


SOAK = ["--minutes", "0.05", "--threads", "3", "--verb", "64",
        "--capacity", "4096", "--keyspace", "512", "--engine-batch", "512"]


def _rows(out):
    (jrc, jout), (trc, tout) = out["jax"], out["port"]
    return jrc, jout[-1] if jout else {}, trc, tout[-1] if tout else {}


@pytest.fixture(scope="module")
def soak():
    """Each package's soak, run once for the module's checks -> (JAX's
    exit code, JAX's last row, the port's, the port's last row)."""
    from pmdfc_tpu.bench import soak as jsoak
    from pmdfc_tpu_torch.bench import soak as tsoak

    return _rows(run_twin_mains(jsoak.main, SOAK, tsoak.main,
                                ["--device", "cpu", *SOAK]))


@pytest.fixture(scope="module")
def fastpath():
    """Each package's `--smoke` fast-path sweep, run once (as `soak`). The
    port's takes the best of four timed rounds per mode, not two, for the
    p50s its gate compares (`ratio_p50 > 1.0`): on a loaded host two
    rounds of 20 GETs a connection left the ratio to the scheduler (JAX's
    smoke fixes its own two rounds)."""
    from pmdfc_tpu.bench import fastpath_sweep as jfp
    from pmdfc_tpu_torch.bench import fastpath_sweep as tfp

    return _rows(run_twin_mains(jfp.main, ["--smoke"], tfp.main,
                                ["--device", "cpu", "--smoke", "--rounds",
                                 "4"]))


@pytest.fixture(scope="module")
def qos():
    """Each package's `--smoke` QoS soak, run once (as `soak`)."""
    from pmdfc_tpu.bench import qos_soak as jqs
    from pmdfc_tpu_torch.bench import qos_soak as tqs

    return _rows(run_twin_mains(jqs.main, ["--smoke"], tqs.main,
                                ["--device", "cpu", "--smoke"]))


def test_soak_serves_verified_pages_like_jax(soak):
    """Both soaks pass their own gates (exit 0)."""
    jrc, _, trc, _ = soak
    assert jrc == 0
    assert trc == 0


@pytest.mark.parametrize("side", ["jax", "port"])
def test_soak_serves_no_mismatch_and_keeps_the_clean_cache_invariant(
        soak, side):
    row = soak[1] if side == "jax" else soak[3]
    assert row["mismatches"] == 0 and row["deleted_hits"] == 0
    assert row["clean_cache_invariant_ok"] and row["verified_pages"] > 0


def test_soak_attributes_every_miss_and_serves_no_error(soak):
    t = soak[3]
    assert t["causes_ok"] and t["serve_errors"] == 0


@pytest.mark.parametrize("key", ["metric", "unit", "threads", "verb"])
def test_soak_echoes_its_configuration_like_jax(soak, key):
    _, j, _, t = soak
    assert t[key] == j[key], key


def test_soak_reports_every_field_jax_reports(soak):
    _, j, _, t = soak
    assert set(j) <= set(t)


def test_soak_fails_on_a_wrong_page(monkeypatch, capsys):
    """A server that serves one wrong word makes the soak exit 2."""
    from pmdfc_tpu_torch.bench import soak as tsoak
    from pmdfc_tpu_torch.client import backends

    real = backends.EngineBackend.get
    hit = {"n": 0}

    def corrupt(self, keys):
        out, found = real(self, keys)
        if found.any() and hit["n"] == 0:
            hit["n"] += 1
            out = out.copy()
            out[found.nonzero()[0][0], 3] ^= 1
        return out, found

    monkeypatch.setattr(backends.EngineBackend, "get", corrupt)
    assert tsoak.main(["--device", "cpu", *SOAK]) == 2
    assert _json_objects(capsys.readouterr().out)[-1]["mismatches"] == 1


def test_fastpath_sweep_serves_both_modes_like_jax(fastpath):
    """Both sweeps pass their own gates (exit 0): both modes served
    verified bytes, the fast path engaged and beat the verb path's
    p50."""
    jrc, _, trc, _ = fastpath
    assert jrc == 0
    assert trc == 0


def test_fastpath_sweep_serves_no_error_on_the_cpu(fastpath):
    t = fastpath[3]
    assert t["serve_errors"] == 0 and t["device"] == "cpu"


def test_fastpath_sweep_reports_every_field_jax_reports(fastpath):
    _, j, _, t = fastpath
    assert set(j) <= set(t)


def test_fastpath_sweep_fails_on_a_wrong_fast_read(monkeypatch):
    """A fast read that serves one wrong word fails the sweep."""
    from pmdfc_tpu_torch.bench import fastpath_sweep as tfp
    from pmdfc_tpu_torch.runtime import net

    real = net.TcpBackend.get

    def corrupt(self, keys):
        out, found = real(self, keys)
        if self.fastpath and found.any():
            out = out.copy()
            out[found.nonzero()[0][0], 0] ^= 1
        return out, found

    monkeypatch.setattr(net.TcpBackend, "get", corrupt)
    with pytest.raises(RuntimeError, match="served bytes != fill bytes"):
        tfp.main(["--device", "cpu", "--smoke"])


def test_qos_soak_sheds_the_antagonist_like_jax(qos):
    """Both packages' smokes pass the machinery gate over the real KV (exit
    0): the antagonist shed at the edge with every shed in `miss_shed`,
    `misses == Σ miss_*` on the wire doc, the compliant lane never shed,
    both teledumps valid."""
    jrc, _, trc, _ = qos
    assert jrc == 0
    assert trc == 0


def test_qos_soak_arms_end_with_no_serve_error(qos):
    t = qos[3]
    assert t["serve_errors"] == 0 and t["backend"] == "direct"


def test_qos_soak_sheds_only_the_antagonist(qos):
    t = qos[3]
    assert t["miss_shed"] > 0 and t["lanes"]["good"]["shed_edge"] == 0


def test_qos_soak_reports_every_field_and_lane_counter_jax_reports(qos):
    _, j, _, t = qos
    assert set(j) <= set(t)
    assert set(t["lanes"]["good"]) == set(j["lanes"]["good"])
