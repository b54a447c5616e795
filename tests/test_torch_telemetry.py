"""PyTorch port: the telemetry host modules against the JAX package's.

The port keeps its own copies of `runtime/telemetry.py`,
`runtime/sanitizer.py`, `runtime/timeseries.py`, `runtime/workload.py`,
`runtime/qos.py` and `runtime/slo.py`. Fed the same call sequence, on a
clock injected into both (every module reads `time` through its module
global), each must give the same results: registry snapshots, the text
exporter and the `pmdfc-telemetry` schema check, with the `recompile`
scope at 0 in both (the port has no backend-compile listener); the
sanitizer's lock ranks and its order check; time-series windows; the
workload sketches; QoS deficit-round-robin drains, shed ladders and
token buckets; the SLO watchdog's transitions.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import pmdfc_tpu.config as jconfig
import pmdfc_tpu.runtime.qos as jqos
import pmdfc_tpu.runtime.sanitizer as jsan
import pmdfc_tpu.runtime.slo as jslo
import pmdfc_tpu.runtime.telemetry as jtele
import pmdfc_tpu.runtime.timeseries as jts
import pmdfc_tpu.runtime.workload as jwl
import pmdfc_tpu_torch.config as tconfig
import pmdfc_tpu_torch.runtime.qos as tqos
import pmdfc_tpu_torch.runtime.sanitizer as tsan
import pmdfc_tpu_torch.runtime.slo as tslo
import pmdfc_tpu_torch.runtime.telemetry as ttele
import pmdfc_tpu_torch.runtime.timeseries as tts
import pmdfc_tpu_torch.runtime.workload as twl
from tools.check_teledump import check

pytestmark = pytest.mark.torch

JAX = types.SimpleNamespace(config=jconfig, tele=jtele, san=jsan, ts=jts,
                            wl=jwl, qos=jqos, slo=jslo)
PORT = types.SimpleNamespace(config=tconfig, tele=ttele, san=tsan, ts=tts,
                             wl=twl, qos=tqos, slo=tslo)
PKGS = (JAX, PORT)


class _Clock:
    """A `time` module stand-in whose clocks advance only by `tick`."""

    def __init__(self):
        self.t = 1000.0

    def tick(self, s: float) -> None:
        self.t += s

    def reset(self) -> None:
        """Back to the start: each package runs from the same instant."""
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def perf_counter(self):
        return self.t

    def monotonic_ns(self):
        return int(self.t * 1e9)

    def sleep(self, s):
        self.t += s


@pytest.fixture()
def clock(monkeypatch):
    """One injected clock for every telemetry module of both packages,
    and a fresh registry in each."""
    c = _Clock()
    for p in PKGS:
        for mod in (p.tele, p.ts, p.wl, p.qos, p.slo):
            monkeypatch.setattr(mod, "time", c)
        p.tele.configure(p.config.TelemetryConfig(ring_capacity=256))
    yield c
    for p in PKGS:
        p.tele.configure()


def _drive_registry(p, clock):
    """The same scopes, counters, gauges, histograms, rungs and spans."""
    clock.reset()
    tele = p.tele
    tele.scope("recompile", {"programs": 0}, unique=False)
    net = tele.scope("net", {"ops": 0, "flushes": 0, "fastpath_hits": 0,
                             "fastpath_stale": 0})
    net.set("dir_epoch", 7)
    kv = tele.scope("kv")
    rng = np.random.default_rng(5)
    for i in range(40):
        net.inc("ops", int(rng.integers(1, 9)))
        net.inc("flushes")
        net.inc("fastpath_hits", 3)
        net.inc("fastpath_stale", i % 2)
        net.max("flush_max", int(rng.integers(0, 500)))
        net.set("staging_depth", int(rng.integers(0, 64)))
        net.observe("get_us", float(rng.exponential(300.0)))
        kv.set("hits", i * 7)
        kv.set("utilization", i / 40)
        clock.tick(0.01)
    for i in range(3):
        tele.rung("phase_failure", tier="engine", requests=i)
    tele.record_span("client", "get", 12345, True, dur_us=42.0)
    tele.record_event("note", what="x")
    return tele.snapshot()


def test_registry_snapshot_render_and_schema_match_jax(clock):
    ja = _drive_registry(JAX, clock)
    tb = _drive_registry(PORT, clock)
    assert ja == tb
    assert tb["schema"] == "pmdfc-telemetry-v2"
    assert JAX.tele.render() == PORT.tele.render()
    assert check({"telemetry": ja}) == check({"telemetry": tb}) == []
    rc = {k: v for k, v in tb["counters"].items()
          if k.startswith("recompile.")}
    assert rc == {"recompile.programs": 0}
    # the port never registers the JAX compile listener's metrics
    assert "recompile.backend_compiles" not in tb["counters"]


def test_sanitizer_ranks_and_order_check(monkeypatch):
    assert JAX.san.HIERARCHY == PORT.san.HIERARCHY
    assert JAX.san.HOLD_WATCH == PORT.san.HOLD_WATCH
    results = []
    for p in PKGS:
        p.san.configure(on=True, hold_ms=60_000)
        p.san.reset()
        try:
            outer = p.san.lock("KV._lock")           # rank 65
            inner = p.san.lock("NetServer.op_lock")  # rank 30
            rl = p.san.rlock("KV._lock")
            with inner:
                with outer:  # ascending ranks: legal
                    pass
            with outer:
                with inner:  # descending: an inversion
                    pass
            with rl:
                with rl:  # reentrant: legal
                    pass
            with pytest.raises(RuntimeError):
                with inner:
                    inner.acquire()  # self-deadlock: raised, not hung
            results.append([(v["kind"], v.get("held"), v.get("lock"))
                            for v in p.san.violations()])
        finally:
            p.san.reset()
            p.san.configure(on=False)
    assert results[0] == results[1]
    assert [k for k, *_ in results[1]] == ["inversion", "reacquire"]


def test_timeseries_windows_on_an_injected_clock(clock):
    windows = []
    for p in PKGS:
        clock.reset()
        reg = p.tele.get()
        col = p.ts.Collector(interval_s=0.5, capacity=8, registry=reg)
        sc = p.tele.scope("net", {"ops": 0})
        out = []
        for i in range(12):
            sc.inc("ops", i)
            sc.set("depth", i * 3)
            sc.observe("get_us", 100.0 + 10 * i)
            clock.tick(0.5)
            out.append(col.tick())
        out.append(col.ring.snapshot())
        out.append(p.tele.snapshot()["series"])
        windows.append(out)
    assert windows[0] == windows[1]
    assert len(windows[1][-2]["windows"]) == 8  # the ring's capacity


def test_workload_sketches_match_jax(clock):
    snaps = []
    rng = np.random.default_rng(8)
    batches = [np.stack([rng.zipf(1.3, 256).astype(np.uint32) & 0xFF,
                         rng.integers(0, 1 << 32, 256, dtype=np.uint32)],
                        -1).astype(np.uint32) for _ in range(20)]
    for p in PKGS:
        clock.reset()
        sk = p.wl.WorkloadSketch()
        out = []
        for i, b in enumerate(batches):
            sk.observe(b)
            clock.tick(0.7)
            if i % 5 == 4:
                out.append(sk.snapshot())
        snaps.append(out)
    assert snaps[0] == snaps[1]
    assert snaps[1][-1]["working_set"] > 0


class _Op:
    def __init__(self, tid, count, mt=5):
        self.tid, self.count, self.mt = tid, count, mt


def test_qos_drr_shed_ladder_and_token_bucket(clock):
    def run(p):
        clock.reset()
        c = p.config
        cfg = c.QosConfig(tenant_bits=4, quantum_ops=16, shed_threshold=40,
                          shed_batch=8, tenants=(
                              c.TenantConfig(tid=1, weight=3, priority=2),
                              c.TenantConfig(tid=2, weight=1, priority=0,
                                             rate_ops_per_s=100.0,
                                             burst_ops=20)))
        plane = p.qos.QosPlane(cfg, "net9")
        rng = np.random.default_rng(2)
        out = []
        ops = [_Op(int(rng.integers(0, 3)), int(rng.integers(1, 40)))
               for _ in range(60)]
        for op in ops:
            out.append(plane.admit(op.tid, op.count))
            plane.stage(op)
            clock.tick(0.003)
        out.append(p.qos.tag_oids(np.array([7, 8], np.uint32), 2,
                                  4).tolist())
        out.append(plane.resolve(np.array([[0x20000007, 1]], np.uint32)))
        victims = plane.shed_overflow(lambda o: o.mt == 5)
        out.append([ops.index(v) for v in victims])
        while plane.depth():
            out.append([ops.index(o) for o in plane.drain(7)])
        b = p.qos.TokenBucket(50.0, 10)
        for i in range(30):
            out.append(b.take(1 + i % 3))
            clock.tick(0.02)
        out.append(b.set_rate(5.0))
        out.append(p.tele.snapshot()["counters"])
        return out

    assert run(JAX) == run(PORT)


def test_slo_watchdog_transitions_match_jax(clock):
    def run(p):
        clock.reset()
        tele = p.tele
        cfg = p.slo.SloConfig(targets=(
            p.slo.SloTarget("p99", "latency_p99", "svc.get_us", 500.0),
            p.slo.SloTarget("hit", "ratio_min", "svc.hits", 0.5,
                            denominator="svc.gets")),
            burn_windows=2, min_count=4)
        sc = tele.scope("svc", {"hits": 0, "gets": 0}, unique=False)
        wd = p.slo.SloWatchdog(cfg)
        out = []
        rng = np.random.default_rng(4)
        for w in range(10):
            bad = 3 <= w <= 6
            for _ in range(8):
                sc.observe("get_us", float(900 if bad else 100)
                           + float(rng.integers(0, 50)))
                sc.inc("gets")
                sc.inc("hits", 0 if bad else 1)
            clock.tick(1.0)
            out.append([(b["target"].name, round(float(b["value"]), 6),
                         b["count"]) for b in wd.tick()])
        out.append(dict(wd.stats))
        return out

    a, b = run(JAX), run(PORT)
    assert a == b
    assert any(a[:-1])  # the bad windows breached
