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
arms' verb counts, denials, lane counters and `miss_shed`.
"""

from __future__ import annotations

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)

from test_torch_bench_sweeps import _jax_main, _json_objects

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("PMDFC_COMPILE_CACHE", "0")


SOAK = ["--minutes", "0.05", "--threads", "3", "--verb", "64",
        "--capacity", "4096", "--keyspace", "512", "--engine-batch", "512"]


def test_soak_serves_verified_pages_like_jax(monkeypatch, capsys):
    from pmdfc_tpu.bench import soak as jsoak
    from pmdfc_tpu_torch.bench import soak as tsoak

    with pytest.raises(SystemExit) as ex:
        _jax_main(jsoak.main, SOAK, monkeypatch, capsys)
    assert ex.value.code == 0
    jrow = _json_objects(capsys.readouterr().out)[-1]
    assert tsoak.main(["--device", "cpu", *SOAK]) == 0
    trow = _json_objects(capsys.readouterr().out)[-1]
    for row in (jrow, trow):
        assert row["mismatches"] == 0 and row["deleted_hits"] == 0
        assert row["clean_cache_invariant_ok"] and row["verified_pages"] > 0
    assert trow["causes_ok"] and trow["serve_errors"] == 0
    for k in ("metric", "unit", "threads", "verb"):
        assert trow[k] == jrow[k], k
    assert set(jrow) <= set(trow)


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


def test_fastpath_sweep_serves_both_modes_like_jax(monkeypatch, capsys):
    from pmdfc_tpu.bench import fastpath_sweep as jfp
    from pmdfc_tpu_torch.bench import fastpath_sweep as tfp

    rc, jout = _jax_main(jfp.main, ["--smoke"], monkeypatch, capsys)
    assert rc == 0
    assert tfp.main(["--device", "cpu", "--smoke"]) == 0
    tout = _json_objects(capsys.readouterr().out)
    assert tout[-1]["serve_errors"] == 0 and tout[-1]["device"] == "cpu"
    assert set(jout[-1]) <= set(tout[-1])


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


def test_qos_soak_sheds_the_antagonist_like_jax(monkeypatch, capsys):
    """Both packages' smokes pass the machinery gate over the real KV: the
    antagonist shed at the edge with every shed in `miss_shed`, `misses
    == Σ miss_*` on the wire doc, the compliant lane never shed, both
    teledumps valid; the port's arms also end with no serve error."""
    from pmdfc_tpu.bench import qos_soak as jqs
    from pmdfc_tpu_torch.bench import qos_soak as tqs

    rc, jout = _jax_main(jqs.main, ["--smoke"], monkeypatch, capsys)
    assert rc == 0
    assert tqs.main(["--device", "cpu", "--smoke"]) == 0
    tout = _json_objects(capsys.readouterr().out)
    t = tout[-1]
    assert t["serve_errors"] == 0 and t["backend"] == "direct"
    assert t["miss_shed"] > 0 and t["lanes"]["good"]["shed_edge"] == 0
    assert set(jout[-1]) <= set(t)
    assert set(t["lanes"]["good"]) == set(jout[-1]["lanes"]["good"])
