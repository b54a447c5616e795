"""PyTorch port: the four `tests/test_chaos.py` drills JAX marks `slow`,
on both packages.

`test_torch_chaos.py` runs every chaos drill through the port and holds
the two packages' `ChaosProxy` to the same fault decisions; the drills
JAX runs in its own tier-1 suite stay there. The four `slow` ones run
here on both packages, each under the JAX drill's own invariants (their
outcome depends on timing): the long soak and the long windowed soak at
200 of their 600 steps with both kill/restore cycles (JAX's `_soak` and
the port's `chip_smoke.chaos_soak`, the soak phase 14 runs on the card),
the reconnect storm after phase failures, and the NACKed ops' failed
spans. What the seed fixes is compared exactly: the restores, the
poisoned probe, the found masks of the poisoned reads.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import test_chaos as jchaos
import test_torch_chaos as tchaos
import torch_threads  # noqa: F401 (one torch thread a worker)
from test_torch_smoke import smoke  # noqa: F401 (the fixture)
from torch_twin import JAX as _JAX
from torch_twin import PORT as _PORT
from torch_twin import fresh_jax_registry, registries, same  # noqa: F401
from torch_twin import stop
from torch_twin import twin as twin_of

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

W = 16
RATES = {k: v * 2 for k, v in jchaos.RATES.items()}  # the long soaks'
assert jchaos.RATES == tchaos.RATES
JAX = types.SimpleNamespace(**vars(_JAX), name="jax")
PORT = types.SimpleNamespace(**vars(_PORT), name="port")
PKGS = (JAX, PORT)


def twin(drill, *args):
    return twin_of(drill, *args, pkgs=PKGS)


def _cfg(p):
    c = p.config
    return c.KVConfig(index=c.IndexConfig(capacity=1 << 12),
                      bloom=c.BloomConfig(num_bits=1 << 13), paged=True,
                      page_words=W)


def _long(smoke, tmp_path, pipe):  # noqa: F811
    """Each package's long soak at 200 steps, kills at 70 and 150 -> the
    seeded outcome."""
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    j = jchaos._soak(steps=200, seed=9, rates=RATES, kill_at=(70, 150),
                     tmp_path=tmp_path / "jax", pipe=pipe)
    t = tchaos._soak(smoke, tmp_path / "port", 200, 9, RATES, (70, 150),
                     pipe=pipe)
    out = []
    for side, s in (("jax", j), ("port", t)):
        assert s["wrong_bytes"] == 0 and s["restores"] == 2, (side, s)
        assert s["corrupt_detected"] > 0, (side, s)
        assert tchaos._fired(s["chaos"]) > 0, (side, s)
        out.append((s["restores"], s["poisoned"]))
    same(*out, "long soak")


def test_chaos_soak_long(smoke, tmp_path):  # noqa: F811
    _long(smoke, tmp_path, pipe=False)


def test_chaos_soak_long_pipelined(smoke, tmp_path):  # noqa: F811
    _long(smoke, tmp_path, pipe=True)


def test_reconnect_storm_after_phase_failures_is_backoff_bounded(
        monkeypatch):
    """Rung 3 without containment: every poisoned op drops the connection
    and degrades to a miss; once the server is gone, hundreds of ops cost
    a handful of dials (each round's redials cut to 0.25 s, as in the
    port's twin)."""
    monkeypatch.setenv("PMDFC_CONTAINMENT", "off")

    def drill(p):
        f = p.failure
        plan = f.FaultPlan()
        shared = f.FaultyBackend(p.backends.DirectBackend(p.KV(_cfg(p))),
                                 plan)
        srv = p.net.NetServer(lambda: shared, net=p.config.NetConfig(
            flush_timeout_us=20_000, settle_us=2_000)).start()
        keys = tchaos._keys(8, seed=31)
        plan.poison_keys(keys)
        rc = f.ReconnectingClient(
            lambda: p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                     keepalive_s=None, op_timeout_s=5.0),
            page_words=W, retry_delay_s=0.02, max_retry_delay_s=0.3,
            backoff=2.0, seed=31)
        masks = []
        try:
            for _ in range(6):
                _, found = rc.get(keys)
                masks.append(found)
                deadline = time.time() + 0.25
                while not rc.connected and time.time() < deadline:
                    rc.get(keys[:1])
                    time.sleep(0.01)
            assert rc.stats()["disconnects"] >= 3, (p.name, rc.stats())
        finally:
            stop(srv)
        rc.get(keys)
        backoffs0 = rc.stats()["reconnect_backoffs"]
        t_end = time.monotonic() + 0.7
        ops = 0
        while time.monotonic() < t_end:
            _, found = rc.get(keys)
            assert not found.any()
            ops += 1
        attempts = rc.stats()["reconnect_backoffs"] - backoffs0
        assert ops > 50, (p.name, ops)
        assert 2 <= attempts <= 10, (p.name, attempts)
        rc.close()
        return masks

    masks = twin(drill)
    assert not np.any(masks)


def test_nacked_ops_close_spans_as_failed_v2_records():
    def drill(p):
        reg = p.tele.configure(p.config.TelemetryConfig(
            ring_capacity=1 << 15))
        f = p.failure
        plan = f.FaultPlan()
        shared = f.FaultyBackend(p.backends.DirectBackend(p.KV(_cfg(p))),
                                 plan)
        srv = p.net.NetServer(lambda: shared, net=p.config.NetConfig(
            flush_timeout_us=20_000, settle_us=2_000)).start()
        keys = tchaos._keys(8, seed=33)
        try:
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None) as be:
                assert be.nack
                be.get(tchaos._keys(4, seed=34))
                plan.poison_keys(keys)
                out, found = be.get(keys)
                assert not found.any()
        finally:
            stop(srv)
        nacked = [r for r in reg.ring
                  if r.get("kind") == "span" and not r.get("ok", True)
                  and str(r.get("err", "")).startswith("nack:")]
        assert nacked, f"{p.name}: no FAILED span carries the nack cause"
        srcs = sorted({r["src"] for r in nacked})
        assert {"client", "server"} <= set(srcs)
        assert [r for r in nacked if "span" in r and "trace" in r]
        errs = sorted({r["err"] for r in nacked})
        return found, out, srcs, errs

    twin(drill)
