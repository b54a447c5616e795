"""PyTorch port: the `tests/test_autotune.py` drills that
`test_torch_autotune.py`'s scenarios do not walk, on both controllers.

Each drill runs on JAX's package and on the port's with the same scripted
clock and series windows (the `_Clock`, light and fan-in windows of the
JAX suite), each controller bound to its own package's `NetServer`,
`ReplicaGroup`, `ReconnectingClient`, `KV` and duck-typed client. The
drill returns its transcript (knob vectors and live knob values per tick,
the decision records without their wall stamp, last-known-good vectors,
final `ctl` scopes, gate answers, balloon states), and the two transcripts
must be equal. Each drill also asserts the JAX drill's own invariants on
both packages: the clock step-back, the wedged flush window, hysteresis
across a gap, the provisional and adopted last-known-good windows, the
envelope widened to hold the static point, the unbounded migrate rate,
disabled hedging, the hedge walk, the migrate rate's static conformance,
an SLO breach's revert and its flight dump, `KV.balloon_state`, the
window gate, `set_window` live over `TcpBackend`, the window kept across a
reconnect, and `check_autotune`'s pins, through the root checker and the
port's copy of it alike.
"""

from __future__ import annotations

import glob
import json
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import (fresh_jax_registry, registries,  # noqa: F401
                        same, stop)

import pmdfc_tpu.client.backends as jbackends
import pmdfc_tpu.client.replica as jreplica
import pmdfc_tpu.config as jconfig
import pmdfc_tpu.kv as jkv
import pmdfc_tpu.runtime.autotune as jautotune
import pmdfc_tpu.runtime.failure as jfailure
import pmdfc_tpu.runtime.net as jnet
import pmdfc_tpu.runtime.slo as jslo
import pmdfc_tpu.runtime.telemetry as jtele
import pmdfc_tpu.runtime.timeseries as jts
import pmdfc_tpu_torch.client.backends as tbackends
import pmdfc_tpu_torch.client.replica as treplica
import pmdfc_tpu_torch.config as tconfig
import pmdfc_tpu_torch.kv as tkv
import pmdfc_tpu_torch.runtime.autotune as tautotune
import pmdfc_tpu_torch.runtime.failure as tfailure
import pmdfc_tpu_torch.runtime.net as tnet
import pmdfc_tpu_torch.runtime.slo as tslo
import pmdfc_tpu_torch.runtime.telemetry as ttele
import pmdfc_tpu_torch.runtime.timeseries as tts
from pmdfc_tpu_torch.tools import check_teledump as tcheck
from tools import check_teledump as jcheck

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

JAX = types.SimpleNamespace(
    config=jconfig, autotune=jautotune, net=jnet, slo=jslo, tele=jtele,
    ts=jts, backends=jbackends, replica=jreplica, failure=jfailure,
    KV=lambda cfg: jkv.KV(cfg))
PORT = types.SimpleNamespace(
    config=tconfig, autotune=tautotune, net=tnet, slo=tslo, tele=ttele,
    ts=tts, backends=tbackends, replica=treplica, failure=tfailure,
    KV=lambda cfg: tkv.KV(cfg, device="cpu"))
PKGS = (JAX, PORT)
# the root checker and the port's own copy of it
CHECKERS = (jcheck, tcheck)


def twin(drill, *args):
    """`drill(pkg, *args)` on JAX, then on the port: equal transcripts."""
    a, b = (drill(p, *args) for p in PKGS)
    same(a, b, drill.__name__)
    return b


class _Clock:
    def __init__(self):
        self.t = 0.0

    def win(self, counters=None, gauges=None, hists=None):
        self.t += 1.0
        return {"t": self.t, "dt_s": 1.0, "counters": counters or {},
                "gauges": gauges or {}, "hists": hists or {}}


def _light(clk, pfx):
    return clk.win(
        counters={pfx + "coalesced_ops": 100},
        gauges={pfx + "staging_depth": 1},
        hists={pfx + "flush_ops_hist":
               {"count": 100, "sum": 105, "p50": 1, "p95": 2, "p99": 2}})


def _fanin(clk, pfx, staging=200):
    return clk.win(
        counters={pfx + "coalesced_ops": 4000},
        gauges={pfx + "staging_depth": staging},
        hists={pfx + "flush_ops_hist":
               {"count": 40, "sum": 4000, "p50": 90, "p95": 120,
                "p99": 140}})


def _fresh(p, dump_dir=None):
    cfg = (p.config.TelemetryConfig(dump_dir=dump_dir) if dump_dir
           else p.config.TelemetryConfig())
    reg = p.tele.configure(cfg)
    ring = p.ts.SeriesRing(capacity=256, interval_s=1.0)
    reg.series_sink = ring
    return reg, ring


def _srv(p, **net):
    return p.net.NetServer(lambda: p.backends.LocalBackend(page_words=8),
                           net=p.config.NetConfig(**net))


def _group(p, **kw):
    ring = kw.pop("ring", p.config.RingConfig())
    eps = [p.backends.LocalBackend(8, 256) for _ in range(2)]
    return p.replica.ReplicaGroup(
        eps, page_words=8,
        cfg=p.config.ReplicaConfig(n_replicas=2, rf=1, repair_interval_s=0,
                                   ring=ring, **kw))


def _strip(decs):
    return [{k: v for k, v in d.items() if k != "t"} for d in decs]


def _ctl(p, **kw):
    return p.autotune.AutotuneController(p.config.AutotuneConfig(**kw))


class _FakeWindowBackend:
    def __init__(self, window=32):
        self.window = window

    def set_window(self, n):
        self.window = max(1, int(n))
        return self.window

    def close(self):
        pass


# -- convergence and the loop's guards ----------------------------------------


def _hedge(p):
    _, ring = _fresh(p)
    group = _group(p)
    try:
        ctl = _ctl(p, hysteresis_windows=1)
        ctl.bind_group(group)
        clk = _Clock()
        trail = []

        def push(p99, n):
            for _ in range(n):
                ring.push(clk.win(
                    counters={group.counters.prefix + ".gets": 100},
                    hists={"net.client.get_us":
                           {"count": 100, "sum": 2e6 if p99 > 1000 else 5e4,
                            "p50": 20000 if p99 > 1000 else 300,
                            "p95": 35000 if p99 > 1000 else 800,
                            "p99": p99}}))
                trail.append((_strip(ctl.tick()), group.hedge_ms_live()))

        push(40000, 12)
        up = group.hedge_ms_live()
        assert 50.0 < up <= ctl.cfg.hedge_ms_hi
        push(1000, 16)
        down = group.hedge_ms_live()
        assert ctl.cfg.hedge_ms_lo <= down < up
        assert ctl.knob_values()["hedge_ms"] == down
        return trail, dict(ctl.stats)
    finally:
        group.close()


def test_hedge_tracks_wire_p99():
    twin(_hedge)


def _migrate(p):
    _, ring = _fresh(p)
    group = _group(p)
    try:
        mig = group.migrator
        static = mig.cfg.migrate_pages_per_s
        out = [mig.rate() == static, mig.set_rate(512.0), mig.rate(),
               group.set_migrate_rate(1024.0), mig.set_rate(None) == static,
               mig.rate() == static]
        ctl = _ctl(p, hysteresis_windows=1)
        ctl.bind_group(group)
        clk = _Clock()
        mp = mig.scope.prefix + "."
        gp = group.counters.prefix + ".gets"
        for active in (0,) * 4 + (1,) * 6:
            ring.push(clk.win(counters={gp: 10},
                              gauges={mp + "lag": 500, mp + "active": active}))
            out.append((_strip(ctl.tick()), mig.rate()))
        assert out[:6] == [True, 512.0, 512.0, 1024.0, True, True]
        assert all(r == static for _, r in out[6:10])  # idle: no walk
        assert static < mig.rate() <= ctl.cfg.migrate_pps_hi
        return out, dict(ctl.stats)
    finally:
        group.close()


def test_migrate_rate_live_and_static_conformance():
    twin(_migrate)


def _no_knob(p, **cfg):
    _fresh(p)
    group = _group(p, **cfg)
    try:
        ctl = _ctl(p)
        ctl.bind_group(group)
        return (ctl.knob_values(), group.migrator.rate(),
                group.hedge_ms_live())
    finally:
        group.close()


def test_unbounded_migrate_rate_gets_no_knob():
    def drill(p):
        out = _no_knob(p, ring=p.config.RingConfig(migrate_pages_per_s=0))
        assert "migrate_pps" not in out[0] and "hedge_ms" in out[0]
        assert out[1] == 0.0  # still unbounded
        return out

    twin(drill)


def test_disabled_hedging_gets_no_knob():
    def drill(p):
        out = _no_knob(p, hedge_ms=0.0)
        assert "hedge_ms" not in out[0]
        assert out[2] == 0.0  # hedging stays off
        return out

    twin(drill)


def test_envelope_widens_to_contain_static_point():
    def drill(p):
        reg, _ = _fresh(p)
        srv = _srv(p, flush_timeout_us=50000)
        ctl = _ctl(p)
        ctl.bind_server(srv)
        assert ctl.stats["knob_dwell_us_hi"] == 50000.0  # widened
        assert ctl.stats["knob_dwell_us"] == 50000.0
        snap = reg.snapshot()
        assert [c.check_autotune(snap) for c in CHECKERS] == [[], []]
        return dict(ctl.stats), ctl.knob_values()

    twin(drill)


def test_bind_unconnected_reconnecting_client_assumes_default():
    def drill(p):
        _fresh(p)
        rc = p.failure.ReconnectingClient(lambda: _FakeWindowBackend(),
                                          page_words=8)
        ctl = _ctl(p)
        ctl.bind_client(rc)
        default = float(p.config.NetConfig.window)
        assert ctl.knob_values()["window"] == default
        assert ctl._lkg["window"] == default
        return ctl.knob_values(), dict(ctl._lkg), sorted(ctl._lkg_pending)

    twin(drill)


def test_provisional_window_lkg_adopts_first_real_sighting():
    def drill(p):
        _, ring = _fresh(p)
        srv = _srv(p)
        rc = p.failure.ReconnectingClient(lambda: _FakeWindowBackend(64),
                                          page_words=8)
        ctl = _ctl(p)
        ctl.bind_server(srv)
        ctl.bind_client(rc)
        provisional = dict(ctl._lkg)
        assert provisional["window"] == float(p.config.NetConfig.window)
        rc._ensure(force=True)  # the client connects: its window is real
        clk = _Clock()
        ring.push(_light(clk, srv.stats.prefix + "."))
        decs = _strip(ctl.tick())
        assert ctl._lkg["window"] == 64.0  # adopted, not the fallback
        assert ctl.stats["knob_window"] == 64.0
        return provisional, decs, dict(ctl._lkg), dict(ctl.stats)

    twin(drill)


def test_controller_move_never_adopted_as_lkg_sighting():
    def drill(p):
        _, ring = _fresh(p)
        srv = _srv(p)
        rc = p.failure.ReconnectingClient(lambda: _FakeWindowBackend(),
                                          page_words=8)
        ctl = _ctl(p, hysteresis_windows=1)
        ctl.bind_server(srv)
        ctl.bind_client(rc)
        assert "window" in ctl._lkg_pending
        pfx = srv.stats.prefix + "."
        clk = _Clock()
        ring.push(_fanin(clk, pfx))
        first = _strip(ctl.tick())
        default = float(p.config.NetConfig.window)
        assert ctl.knob_values()["window"] > default
        assert rc.window is not None
        ring.push(clk.win(counters={pfx + "coalesced_ops": 10}))
        second = _strip(ctl.tick())
        assert "window" not in ctl._lkg_pending
        assert ctl._lkg["window"] == default
        return first, second, rc.window, dict(ctl._lkg), dict(ctl.stats)

    twin(drill)


def test_clock_stepback_keeps_loop_alive():
    def drill(p):
        _, ring = _fresh(p)
        srv = _srv(p)
        ctl = _ctl(p)
        ctl.bind_server(srv)
        pfx = srv.stats.prefix + "."
        clk = _Clock()
        trail = []
        for _ in range(3):
            ring.push(_light(clk, pfx))
            trail.append(_strip(ctl.tick()))
        seen = ctl.stats["windows_seen"]
        clk.t = -1000.0  # the wall clock steps far behind
        ring.push(_light(clk, pfx))
        trail.append(_strip(ctl.tick()))
        assert ctl.stats["windows_seen"] == seen + 1  # still evaluating
        return trail, dict(ctl.stats), srv.flush_knobs()

    twin(drill)


def test_wedged_flush_window_keeps_up_streak_and_is_not_starvation():
    def drill(p):
        _, ring = _fresh(p)
        srv = _srv(p)
        ctl = _ctl(p, hysteresis_windows=2, starve_windows=2)
        ctl.bind_server(srv)
        pfx = srv.stats.prefix + "."
        clk = _Clock()
        d0 = srv.flush_knobs()[0]
        trail = []
        for _ in range(3):
            ring.push(clk.win(gauges={pfx + "staging_depth": 200}))
            trail.append((_strip(ctl.tick()), srv.flush_knobs()))
        assert srv.flush_knobs()[0] > d0  # the UP streak landed
        assert ctl.stats["governor_freezes"] == 0
        assert ctl.stats["reverts"] == 0
        return trail, dict(ctl.stats)

    twin(drill)


def test_hysteresis_requires_consecutive_windows():
    def drill(p):
        _, ring = _fresh(p)
        srv = _srv(p)
        ctl = _ctl(p, hysteresis_windows=2)
        ctl.bind_server(srv)
        pfx = srv.stats.prefix + "."
        clk = _Clock()
        d0 = srv.flush_knobs()
        trail = []
        for _ in range(6):
            ring.push(_light(clk, pfx))
            trail.append(_strip(ctl.tick()))
            ring.push(clk.win(counters={pfx + "coalesced_ops": 10}))
            trail.append(_strip(ctl.tick()))
        assert srv.flush_knobs() == d0
        assert ctl.stats["decisions"] == 0
        return trail, dict(ctl.stats)

    twin(drill)


def test_breach_freezes_reverts_and_dumps(tmp_path):
    def drill(p):
        root = tmp_path / p.config.__name__.split(".")[0]
        root.mkdir()
        _, ring = _fresh(p, dump_dir=str(root))
        srv = _srv(p)
        wd = p.slo.SloWatchdog(p.slo.SloConfig(targets=()))
        ctl = p.autotune.AutotuneController(
            p.config.AutotuneConfig(hysteresis_windows=2, freeze_windows=3),
            watchdog=wd)
        ctl.bind_server(srv)
        pfx = srv.stats.prefix + "."
        clk = _Clock()
        for _ in range(6):
            ring.push(_light(clk, pfx))
            ctl.tick()
        walked, lkg = srv.flush_knobs(), dict(ctl._lkg)
        assert walked[0] < p.config.NetConfig.flush_timeout_us
        wd.stats.inc("breaches")
        ring.push(_light(clk, pfx))
        out = _strip(ctl.tick())
        assert srv.flush_knobs() == (lkg["dwell_us"], lkg["settle_us"])
        assert ctl.frozen() and ctl.stats["reverts"] == 1
        assert any(d.get("why") == "slo_breach" for d in out)
        dumps = glob.glob(str(root / "flight_autotune_revert_*.json"))
        assert len(dumps) == 1
        with open(dumps[0]) as f:
            doc = json.load(f)
        assert [c.check_flight(doc) for c in CHECKERS] == [[], []]
        assert doc["detail"]["reason"] == "slo_breach"
        ring.push(_light(clk, pfx))
        frozen = _strip(ctl.tick())
        assert frozen == []
        for _ in range(4):
            ring.push(_light(clk, pfx))
            ctl.tick()
        assert not ctl.frozen()
        return (walked, lkg, out, doc["detail"], doc["rung"], frozen,
                dict(ctl.stats))

    twin(drill)


# -- the balloon surface and the live-knob hooks ------------------------------


def test_kv_balloon_state_surface():
    def drill(p):
        c = p.config
        flat = p.KV(c.KVConfig(index=c.IndexConfig(capacity=256),
                               page_words=8, bloom=None))
        assert flat.balloon_state() is None
        tiered = p.KV(c.KVConfig(index=c.IndexConfig(capacity=256),
                                 page_words=8, bloom=None,
                                 tier=c.TierConfig(balloon_step=64)))
        st = tiered.balloon_state()
        assert st is not None and st["step"] == 64 and st["free"] >= 0
        via = p.backends.DirectBackend(tiered).balloon_state()
        assert via == st
        return flat.balloon_state(), st, via

    twin(drill)


def test_window_gate_semantics():
    def drill(p):
        g = p.net._WindowGate(2)
        out = [g.acquire(timeout=0.1), g.acquire(timeout=0.1), g.active,
               g.acquire(timeout=0.05), g.set_limit(3),
               g.acquire(timeout=0.1)]
        g.set_limit(1)
        out.append(g.acquire(timeout=0.05))
        for _ in range(3):
            g.release()
        out.append(g.active)
        g.release()  # over-release tolerated
        out += [g.active, g.acquire(timeout=0.1), g.limit]
        assert out == [True, True, 2, False, 3, True, False, 0, 0, True, 1]
        return out

    twin(drill)


def test_tcp_set_window_live_mid_traffic():
    def drill(p):
        _fresh(p)
        srv = _srv(p).start()
        try:
            be = p.net.TcpBackend("127.0.0.1", srv.port, page_words=8,
                                  keepalive_s=None)
            keys = np.array([[1, 2], [3, 4]], np.uint32)
            pages = np.arange(16, dtype=np.uint32).reshape(2, 8)
            be.put(keys, pages)
            win = be.set_window(4)
            out, found = be.get(keys)
            assert found.all() and (out == pages).all()
            limit = be._window_sem.limit
            assert (win, limit) == (4, 4)
            be.close()
            return win, limit, out, found
        finally:
            stop(srv)

    twin(drill)


def test_reconnecting_client_window_survives_reconnect():
    def drill(p):
        built = []

        def factory():
            be = _FakeWindowBackend()
            built.append(be)
            return be

        rc = p.failure.ReconnectingClient(factory, page_words=8)
        out = [rc.set_window(64)]   # before the first connect
        be = rc._ensure(force=True)
        assert be is built[0]
        out += [built[0].window, rc.window]
        rc.set_window(16)           # attached: forwarded at once
        out.append(built[0].window)
        with rc._lock:
            rc._be = None
        be2 = rc._ensure(force=True)  # a reconnect's fresh backend
        assert be2 is built[1]
        out += [built[1].window, len(built)]
        assert out == [64, 64, 64, 16, 16, 2]
        return out

    twin(drill)


def test_check_autotune_pins():
    good = {
        "gauges": {"ctl0.knob_dwell_us": 150.0,
                   "ctl0.knob_dwell_us_lo": 100.0,
                   "ctl0.knob_dwell_us_hi": 20000.0,
                   "ctl0.frozen": 0},
        "counters": {"ctl0.decisions": 3, "ctl0.reverts": 1},
    }

    def variant(edit):
        doc = json.loads(json.dumps(good))
        edit(doc)
        return doc

    docs = {
        "good": good,
        "oob": variant(lambda d: d["gauges"].update(
            {"ctl0.knob_dwell_us": 50.0})),
        "drift": variant(lambda d: d["counters"].update(
            {"ctl0.reverts": 9})),
        "no-lo": variant(lambda d: d["gauges"].pop("ctl0.knob_dwell_us_lo")),
        "no-hi": variant(lambda d: d["gauges"].pop("ctl0.knob_dwell_us_hi")),
        "orphan": variant(lambda d: d["gauges"].pop("ctl0.knob_dwell_us")),
        "frozen": variant(lambda d: d["gauges"].update({"ctl0.frozen": 7})),
        "empty": {"gauges": {}, "counters": {}},
    }
    errs = [{k: c.check_autotune(d) for k, d in docs.items()}
            for c in CHECKERS]
    assert errs[0] == errs[1]
    e = errs[1]
    assert e["good"] == [] and e["empty"] == [] and e["no-lo"]
    assert any("outside its declared envelope" in x for x in e["oob"])
    assert any("decisions" in x for x in e["drift"])
    assert any("envelope siblings" in x for x in e["no-hi"])
    assert any("without its knob value" in x for x in e["orphan"])
    assert any("frozen" in x for x in e["frozen"])
    # and the knobs a live port controller publishes pass, as JAX's do
    pins = []
    for p in PKGS:
        reg, ring = _fresh(p)
        srv = _srv(p)
        ctl = _ctl(p, hysteresis_windows=1)
        ctl.bind_server(srv)
        ctl.bind_client(_FakeWindowBackend())
        clk = _Clock()
        for _ in range(6):
            ring.push(_fanin(clk, srv.stats.prefix + "."))
            ctl.tick()
        snap = reg.snapshot()
        pins.append(({k: v for k, v in snap["gauges"].items()
                      if ".knob_" in k},
                     [c.check_autotune(snap) for c in CHECKERS]))
    same(*pins, "pins")
    assert pins[1][1] == [[], []] and pins[1][0]
