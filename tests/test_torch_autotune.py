"""PyTorch port: the closed-loop controller against the JAX controller.

The scripted series windows of `tests/test_autotune.py` (its `_Clock`,
light and fan-in windows) drive both packages' `AutotuneController`s,
each bound to its own package's `NetServer`, `ReplicaGroup`, watchdog
and a duck-typed client, balloon and admission gate. Per tick, the knob
vector, the flush knobs the server reads, the decision records (their
wall stamp aside) and at the end the `ctl` scope must be identical:
convergence under light load and under fan-in, hedge tracking, the
migration rate, freeze and revert on an SLO breach, starvation, the
envelope clamps of the balloon and the admission threshold, and the kill
switch leaving both controllers inert. Then the port's own piece: the
controller's balloon and admission calls into a `KV` run under the KV's
device and lock.
"""

from __future__ import annotations

import threading
import types

import pytest

import pmdfc_tpu.client.backends as jbackends
import pmdfc_tpu.client.replica as jreplica
import pmdfc_tpu.config as jconfig
import pmdfc_tpu.runtime.autotune as jautotune
import pmdfc_tpu.runtime.net as jnet
import pmdfc_tpu.runtime.slo as jslo
import pmdfc_tpu.runtime.telemetry as jtele
import pmdfc_tpu.runtime.timeseries as jts
import pmdfc_tpu_torch.client.backends as tbackends
import pmdfc_tpu_torch.client.replica as treplica
import pmdfc_tpu_torch.config as tconfig
import pmdfc_tpu_torch.runtime.autotune as tautotune
import pmdfc_tpu_torch.runtime.net as tnet
import pmdfc_tpu_torch.runtime.slo as tslo
import pmdfc_tpu_torch.runtime.telemetry as ttele
import pmdfc_tpu_torch.runtime.timeseries as tts

pytestmark = pytest.mark.torch

JAX = types.SimpleNamespace(
    config=jconfig, autotune=jautotune, net=jnet, slo=jslo, tele=jtele,
    ts=jts, backends=jbackends, replica=jreplica)
PORT = types.SimpleNamespace(
    config=tconfig, autotune=tautotune, net=tnet, slo=tslo, tele=ttele,
    ts=tts, backends=tbackends, replica=treplica)


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


class _FakeClient:
    def __init__(self, window=32):
        self.window = window

    def set_window(self, n):
        self.window = max(1, int(n))
        return self.window


class _FakeBalloon:
    """A circulating/parked pool with a TinyLFU gate and scripted
    pressure, ghost-readmit and demotion lanes (the JAX drills' fakes
    in one)."""

    def __init__(self, parked=4096, pressure=100, ghost=0, churn=0):
        self.circulating, self.parked = 2048, parked
        self.pressure, self.ghost, self.churn = pressure, ghost, churn
        self.th = 8
        self.calls = []
        self._n = 0

    def balloon_state(self):
        return {"cold_rows": self.circulating + self.parked,
                "circulating": self.circulating, "parked": self.parked,
                "free": 64, "step": 1024}

    def balloon_grow(self, rows):
        take = min(rows, self.parked)
        self.parked -= take
        self.circulating += take
        self.calls.append(("grow", rows))
        return True

    def balloon_shrink(self, rows):
        take = min(rows, self.circulating)
        self.circulating -= take
        self.parked += take
        self.calls.append(("shrink", rows))
        return True

    def admit_state(self):
        return {"threshold": self.th}

    def set_admit_threshold(self, v):
        self.th = int(v)
        self.calls.append(("admit", int(v)))
        return True

    def stats(self):
        self._n += 1
        n = self._n
        return {"gets": 1000 * n, "miss_evicted": self.pressure * n,
                "miss_parked": 0, "ghost_readmits": self.ghost * n,
                "demotions": self.churn * n, "capacity": 4096}


def _fresh(pkg, dump_dir=None):
    cfg = (pkg.config.TelemetryConfig(dump_dir=dump_dir) if dump_dir
           else pkg.config.TelemetryConfig())
    reg = pkg.tele.configure(cfg)
    ring = pkg.ts.SeriesRing(capacity=256, interval_s=1.0)
    reg.series_sink = ring
    return reg, ring


def _server(pkg, **net):
    return pkg.net.NetServer(
        lambda: pkg.backends.LocalBackend(page_words=8),
        net=pkg.config.NetConfig(**net))


def _group(pkg, **kw):
    eps = [pkg.backends.LocalBackend(8, 256) for _ in range(2)]
    return pkg.replica.ReplicaGroup(
        eps, page_words=8,
        cfg=pkg.config.ReplicaConfig(n_replicas=2, rf=1,
                                     repair_interval_s=0,
                                     ring=pkg.config.RingConfig(), **kw))


def _strip(decs):
    return [{k: v for k, v in d.items() if k != "t"} for d in decs]


def _drive(ctl, ring, windows, probe=lambda: None):
    """Push each window, tick, record (knob vector, probe, decisions)."""
    out = []
    for w in windows:
        ring.push(w)
        decs = ctl.tick()
        out.append((ctl.knob_values(), probe(), _strip(decs),
                    ctl.frozen()))
    return out


def _final(ctl):
    return dict(ctl.stats) if ctl.stats is not None else None


# -- scenarios: each returns what must agree between the packages --------


def _light_walk(pkg):
    _, ring = _fresh(pkg)
    srv = _server(pkg)
    ctl = pkg.autotune.AutotuneController(
        pkg.config.AutotuneConfig(hysteresis_windows=2))
    ctl.bind_server(srv)
    pfx = srv.stats.prefix + "."
    clk = _Clock()
    traj = _drive(ctl, ring, [_light(clk, pfx) for _ in range(16)],
                  srv.flush_knobs)
    assert traj[-1][1] == (ctl.cfg.dwell_us_lo, ctl.cfg.settle_us_lo)
    return traj, _final(ctl)


def _fanin_walk(pkg):
    _, ring = _fresh(pkg)
    srv = _server(pkg)
    cl = _FakeClient(window=32)
    ctl = pkg.autotune.AutotuneController(
        pkg.config.AutotuneConfig(hysteresis_windows=2))
    ctl.bind_server(srv)
    ctl.bind_client(cl)
    pfx = srv.stats.prefix + "."
    clk = _Clock()
    wins = ([_fanin(clk, pfx) for _ in range(30)]
            + [_light(clk, pfx) for _ in range(10)])
    traj = _drive(ctl, ring, wins, lambda: (srv.flush_knobs(), cl.window))
    assert max(t[1][1] for t in traj) == ctl.cfg.window_hi
    return traj, _final(ctl)


def _hedge_and_migrate(pkg):
    _, ring = _fresh(pkg)
    group = _group(pkg)
    try:
        ctl = pkg.autotune.AutotuneController(
            pkg.config.AutotuneConfig(hysteresis_windows=1))
        ctl.bind_group(group)
        clk = _Clock()
        gp = group.counters.prefix + ".gets"
        mp = group.migrator.scope.prefix + "."

        def wire(p99, active):
            return clk.win(
                counters={gp: 100},
                gauges={mp + "lag": 500, mp + "active": active},
                hists={"net.client.get_us":
                       {"count": 100, "sum": 2e6, "p50": p99 / 2,
                        "p95": p99 * 0.9, "p99": p99}})

        wins = ([wire(40000, 0)] * 6 + [wire(40000, 1)] * 6
                + [wire(1000, 1)] * 16)
        traj = _drive(ctl, ring, wins,
                      lambda: (group.hedge_ms_live(), group.migrator.rate()))
        assert max(t[1][0] for t in traj) > 50.0
        return traj, _final(ctl)
    finally:
        group.close()


def _breach_revert(pkg, tmp_path):
    _, ring = _fresh(pkg, dump_dir=str(tmp_path))
    srv = _server(pkg)
    wd = pkg.slo.SloWatchdog(pkg.slo.SloConfig(targets=()))
    ctl = pkg.autotune.AutotuneController(
        pkg.config.AutotuneConfig(hysteresis_windows=2, freeze_windows=3),
        watchdog=wd)
    ctl.bind_server(srv)
    pfx = srv.stats.prefix + "."
    clk = _Clock()
    traj = _drive(ctl, ring, [_light(clk, pfx) for _ in range(6)],
                  srv.flush_knobs)
    wd.stats.inc("breaches")
    traj += _drive(ctl, ring, [_light(clk, pfx) for _ in range(8)],
                   srv.flush_knobs)
    assert any(d.get("why") == "slo_breach" for t in traj for d in t[2])
    dumps = sorted(p.name.split("_")[1] for p in tmp_path.iterdir()
                   if p.name.startswith("flight_autotune_revert"))
    return traj, _final(ctl), dumps


def _starvation(pkg):
    _, ring = _fresh(pkg)
    srv = _server(pkg)
    ctl = pkg.autotune.AutotuneController(
        pkg.config.AutotuneConfig(hysteresis_windows=2, starve_windows=3,
                                  freeze_windows=2))
    ctl.bind_server(srv)
    pfx = srv.stats.prefix + "."
    clk = _Clock()
    wins = [_light(clk, pfx) for _ in range(6)] + [clk.win()
                                                   for _ in range(12)]
    traj = _drive(ctl, ring, wins, srv.flush_knobs)
    assert ctl.stats["reverts"] == 1
    return traj, _final(ctl)


def _balloon_and_admit(pkg, **fake):
    _, ring = _fresh(pkg)
    srv = _server(pkg)
    bal = _FakeBalloon(**fake)
    ctl = pkg.autotune.AutotuneController(
        pkg.config.AutotuneConfig(hysteresis_windows=1, balloon_every=1,
                                  balloon_max_extents=3))
    ctl.bind_server(srv)
    ctl.bind_balloon(bal)
    pfx = srv.stats.prefix + "."
    clk = _Clock()
    wins = [clk.win(counters={pfx + "coalesced_ops": 50},
                    gauges={pfx + "staging_depth": 1}) for _ in range(60)]
    traj = _drive(ctl, ring, wins, lambda: (bal.circulating, bal.th))
    vals = ctl.knob_values()
    cfg = ctl.cfg
    assert -3 <= vals["balloon_x"] <= 3
    assert cfg.admit_lo <= vals["admit_thresh"] <= cfg.admit_hi
    return traj, _final(ctl), bal.calls


def _kill_switch(pkg):
    reg, ring = _fresh(pkg)
    srv = _server(pkg)
    ctl = pkg.autotune.AutotuneController(pkg.config.AutotuneConfig())
    ctl.bind_server(srv)
    ctl.bind_balloon(_FakeBalloon())
    assert not ctl.enabled and ctl.stats is None
    pfx = srv.stats.prefix + "."
    clk = _Clock()
    traj = _drive(ctl, ring, [_light(clk, pfx) for _ in range(8)],
                  srv.flush_knobs)
    assert all(t[2] == [] for t in traj)
    assert srv.flush_knobs() == (float(pkg.config.NetConfig.flush_timeout_us),
                                 float(pkg.config.NetConfig.settle_us))
    snap = reg.snapshot()
    assert not any(".knob_" in k for k in snap["gauges"])
    return traj, _final(ctl)


SCENARIOS = {
    "light": _light_walk,
    "fanin": _fanin_walk,
    "hedge-migrate": _hedge_and_migrate,
    "starvation": _starvation,
    "balloon-pressure": lambda pkg: _balloon_and_admit(pkg, pressure=100),
    "balloon-saturated": lambda pkg: _balloon_and_admit(pkg, parked=1024),
    "admit-ghost": lambda pkg: _balloon_and_admit(pkg, pressure=0,
                                                  ghost=100),
    "admit-churn": lambda pkg: _balloon_and_admit(pkg, pressure=0,
                                                  churn=500),
}


@pytest.fixture(autouse=True)
def _reset():
    yield
    jtele.configure()
    ttele.configure()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controllers_walk_identically(name):
    want = SCENARIOS[name](JAX)
    got = SCENARIOS[name](PORT)
    assert got == want


def test_breach_freezes_and_reverts_identically(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _breach_revert(JAX, tmp_path / "j")
    got = _breach_revert(PORT, tmp_path / "t")
    assert got == want
    assert got[2] == ["autotune"]  # one attributable revert dump


def test_kill_switch_leaves_both_inert(monkeypatch):
    monkeypatch.setenv("PMDFC_AUTOTUNE", "off")
    assert _kill_switch(PORT) == _kill_switch(JAX)


def test_config_validation_matches_jax():
    bad = [dict(dwell_us_lo=500, dwell_us_hi=100), dict(up_frac=0.0),
           dict(down_frac=1.0), dict(hysteresis_windows=0),
           dict(interval_s=0), dict(admit_lo=9.0, admit_hi=2.0),
           dict(qos_rate_hi_frac=0.5), dict(balloon_every=0)]
    for kw in bad:
        for m in (jconfig, tconfig):
            with pytest.raises(ValueError):
                m.AutotuneConfig(**kw)
    import dataclasses

    assert (dataclasses.asdict(tconfig.AutotuneConfig())
            == dataclasses.asdict(jconfig.AutotuneConfig()))


def test_balloon_calls_run_under_the_kv_device_and_lock(monkeypatch):
    """The controller's balloon, admission and stats calls into a port
    `KV` do device work from the controller's thread: each enters the
    KV's device (`KV._on_device`) with the KV's lock held — the stats
    pull from the daemon's own ticks, the balloon and admission writes
    from a knob walk run on a thread of its own."""
    import sys
    import time

    from pmdfc_tpu_torch.kv import KV

    cfg = tconfig.KVConfig(
        index=tconfig.IndexConfig(capacity=1 << 10),
        bloom=tconfig.BloomConfig(num_bits=1 << 13), page_words=16,
        tier=tconfig.TierConfig(balloon_step=64,
                                admit=tconfig.AdmitConfig()))
    kv = KV(cfg, device="cpu")
    seen = []
    real = KV._on_device

    def spy(self):
        seen.append((threading.current_thread().name,
                     sys._getframe(1).f_code.co_name,
                     self._lock._is_owned()))
        return real(self)

    monkeypatch.setattr(KV, "_on_device", spy)
    _, ring = _fresh(PORT)
    srv = _server(PORT)
    ctl = tautotune.AutotuneController(tconfig.AutotuneConfig(
        hysteresis_windows=1, balloon_every=1, interval_s=0.01))
    ctl.bind_server(srv)
    ctl.bind_balloon(kv)
    assert {"balloon_x", "admit_thresh"} <= set(ctl.knob_values())
    pfx = srv.stats.prefix + "."
    clk = _Clock()
    for _ in range(4):
        ring.push(clk.win(counters={pfx + "coalesced_ops": 50}))
    ctl.start()
    try:
        deadline = time.monotonic() + 10
        while not any(t == "autotune-ctl" for t, _, _ in seen):
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        ctl.stop()

    def walk():
        with ctl._lock:
            ctl._knobs["balloon_x"].setter(-1)
            ctl._knobs["admit_thresh"].setter(3)

    th = threading.Thread(target=walk, name="knob-walk")
    th.start()
    th.join()
    assert kv.admit_state()["threshold"] == 3
    mine = {(t, f) for t, f, owned in seen if owned}
    assert all(owned for _, _, owned in seen)
    assert ("autotune-ctl", "stats") in mine
    for f in ("balloon_state", "balloon_shrink", "set_admit_threshold"):
        assert ("knob-walk", f) in mine, (f, sorted(mine))
