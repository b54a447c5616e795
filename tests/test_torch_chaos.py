"""PyTorch port: `tests/test_chaos.py`'s twins, and phase 14 rehearsed.

The seeded soaks run through the port's `NetServer`, `ChaosProxy`,
`ReconnectingClient`, `IntegrityBackend` and `checkpoint` on the CPU, at
the JAX test's size (16-word pages, 2^12 slots, 256 keys, verbs of 1-15
keys), with `chip_smoke.chaos_soak` — the soak phase 14 runs on the card
at 2^18 slots of 4 KiB pages. Their outcome depends on timing, so each is
held to the JAX test's invariants on the JAX test's seed: zero wrong
bytes, the torn snapshot refused, the restored hit set equal to the
durable one, `corrupt_detected > 0` (the pool poisoned in place). The
soaks the JAX suite marks `slow` run here at a rehearsal size (a third
of their steps, both kill cycles). The two packages' `ChaosProxy` make
the same fault decisions for one seed and one frame sequence. Last,
phase 14 itself at a tiny size, and a rehearsal that fails it when one
wrong page is served.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from test_torch_smoke import KEYS, smoke  # noqa: F401 (the fixture)
from torch_twin import PKGS, PORT, registries, stop  # noqa: F401

import chip_smoke
from pmdfc_tpu_torch.ops import fused

pytestmark = pytest.mark.torch

W = 16
RATES = {"flip": 0.04, "truncate": 0.02, "duplicate": 0.04,
         "delay": 0.02, "reorder": 0.02}
assert RATES == chip_smoke.CHAOS_RATES


def _cfg():
    c = PORT.config
    return c.KVConfig(index=c.IndexConfig(capacity=1 << 12),
                      bloom=c.BloomConfig(num_bits=1 << 13), paged=True,
                      page_words=W)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 1:2].astype(np.uint32) * 3 + 1) * np.arange(
        1, W + 1, dtype=np.uint32)


def _soak(smoke, tmp_path, steps, seed, rates, kill_at, pipe=False):
    st = chip_smoke.chaos_soak(smoke, _cfg(), steps=steps, seed=seed,
                               rates=rates, kill_at=kill_at,
                               root=str(tmp_path), pipe=pipe)
    st.pop("kv")
    return st


def _fired(chaos: dict) -> int:
    return sum(v for k, v in chaos.items()
               if k.endswith("_frames") and k != "forwarded_frames")


def _server(kv):
    return PORT.net.NetServer(lambda: PORT.backends.DirectBackend(kv)).start()


def _client(port, pipe=False, timeout=1.0, seed=0):
    f = PORT.failure

    def factory():
        return PORT.net.TcpBackend("127.0.0.1", port, page_words=W,
                                   keepalive_s=None, op_timeout_s=timeout,
                                   pipeline=pipe, window=8)

    return f.ReconnectingClient(factory, page_words=W, retry_delay_s=0.005,
                                max_retry_delay_s=0.1, seed=seed)


def test_chaos_soak_short(smoke, tmp_path):
    s = _soak(smoke, tmp_path, 120, 5, RATES, (60,))
    chip_smoke.chaos_gates("short", s, 1)
    assert s["wrong_bytes"] == 0 and s["restores"] == 1
    assert s["poisoned"] == 1 and s["corrupt_detected"] > 0


def test_chaos_soak_long(smoke, tmp_path):
    """The JAX test's long soak (`slow` there: 600 steps) at a rehearsal
    size: 200 steps at doubled rates with both kill/restore cycles."""
    rates = {k: v * 2 for k, v in RATES.items()}
    s = _soak(smoke, tmp_path, 200, 9, rates, (70, 150))
    chip_smoke.chaos_gates("long", s, 2)
    assert _fired(s["chaos"]) > 0


def test_chaos_extent_verbs_degrade_to_drop_conn():
    kv = PORT.KV(_cfg())
    kv.insert_extent(np.array([1, 1], np.uint32),
                     np.array([0, 4096], np.uint32), 4)
    srv = _server(kv)
    try:
        with PORT.failure.ChaosProxy("127.0.0.1", srv.port, seed=21) as px:
            rc = _client(px.port, timeout=10.0, seed=21)
            probe = np.stack([np.full(8, 7, np.uint32),
                              np.arange(512, 520, dtype=np.uint32)], -1)
            vals, found = rc.get_extent(probe[:1])
            assert rc.connected and not found.any()
            px.flip_next(1)
            assert rc.insert_extent([7, 512], [3, 1 << 20], 40) == 40
            assert srv.stats["bad_frames"] >= 1
            deadline = time.time() + 5
            while not rc.connected and time.time() < deadline:
                rc.get_extent(probe[:1])
                time.sleep(0.02)
            vals, found = rc.get_extent(probe)
            assert not found.any(), "a torn INSEXT frame registered an extent"
            assert rc.insert_extent([7, 512], [3, 1 << 20], 40) == 0
            px.flip_next(1)
            vals, found = rc.get_extent(probe)
            assert not found.any() and (vals == 0).all()
            deadline = time.time() + 5
            ok = False
            while time.time() < deadline:
                vals, found = rc.get_extent(probe)
                if found.all():
                    ok = True
                    break
                time.sleep(0.02)
            assert ok, "extent path never recovered after the flipped frame"
            want = (3 << 32 | 1 << 20) + (probe[:, 1].astype(np.int64)
                                          - 512) * 4096
            got = (vals[:, 0].astype(np.int64) << 32) | vals[:, 1]
            assert (got == want).all()
            assert px.stats["flipped_frames"] == 2
            rc.close()
    finally:
        stop(srv)


def test_chaos_stats_verb_degrades_to_drop_conn():
    kv = PORT.KV(_cfg())
    srv = _server(kv)
    try:
        with PORT.failure.ChaosProxy("127.0.0.1", srv.port, seed=22) as px:
            tcp = PORT.net.TcpBackend
            be = tcp("127.0.0.1", px.port, page_words=W, keepalive_s=None,
                     op_timeout_s=1.0)
            snap = be.stats()
            assert "puts" in snap and "corrupt_pages" in snap
            px.flip_next(1)
            with pytest.raises((ConnectionError, OSError)):
                be.stats()
            assert srv.stats["bad_frames"] >= 1
            be.close()
            be2 = tcp("127.0.0.1", px.port, page_words=W, keepalive_s=None,
                      op_timeout_s=1.0)
            snap2 = be2.server_stats()
            assert "puts" in snap2 and "corrupt_pages" in snap2
            be2.close()
    finally:
        stop(srv)


def _decisions(p, seed: int, frames, armed=()):
    """The fault decisions `ChaosProxy._pump` takes for a frame sequence
    (one `_draw` per frame, then the flip's position and bit or the
    truncation's cut, from the proxy's seeded rng)."""
    px = p.failure.ChaosProxy("127.0.0.1", 9, seed=seed, rates=RATES)
    try:
        for fault, n in armed:
            px.arm(fault, n)
        hdr = p.net._HDR.size
        out = []
        for n in frames:
            fault = px._draw()
            if fault == "flip":
                lo = hdr if n > hdr else 0
                out.append((fault, px._rng.randrange(lo, n),
                            px._rng.randrange(8)))
            elif fault == "truncate":
                out.append((fault, px._rng.randrange(1, max(2, n))))
            else:
                out.append(fault)
        return out
    finally:
        px.close()


def test_chaos_soak_deterministic_schedule(smoke, tmp_path):
    """Same seed => same op and fault schedule: two port soaks agree on
    every deterministic counter, and the two packages' proxies take the
    same fault decisions for one seed and one frame sequence."""
    a = _soak(smoke, tmp_path, 60, 13, {}, ())
    b = _soak(smoke, tmp_path, 60, 13, {}, ())
    assert a["found_gets"] == b["found_gets"] and a["gets"] == b["gets"]
    assert a["wrong_bytes"] == b["wrong_bytes"] == 0
    rng = np.random.default_rng(13)
    frames = [int(x) for x in rng.integers(20, 4200, 400)]
    armed = (("delay", 2), ("flip", 1))
    got = [_decisions(p, 13, frames, armed) for p in PKGS]
    assert got[0] == got[1]
    assert {f if isinstance(f, str) else f[0] for f in got[1]
            if f is not None} \
        >= {"flip", "truncate", "duplicate", "delay", "reorder"}


def test_chaos_soak_short_pipelined(smoke, tmp_path):
    s = _soak(smoke, tmp_path, 120, 5, RATES, (60,), pipe=True)
    chip_smoke.chaos_gates("short pipelined", s, 1)
    assert s["restores"] == 1 and s["poisoned"] == 1


def test_chaos_pipelined_replies_match_seq_or_drop():
    shared = PORT.backends.LocalBackend(page_words=W, capacity=1 << 13)
    srv = PORT.net.NetServer(lambda: shared).start()
    try:
        with PORT.failure.ChaosProxy("127.0.0.1", srv.port, seed=31) as px:
            rc = _client(px.port, pipe=True, seed=31)
            deadline = time.time() + 5
            while not rc.connected and time.time() < deadline:
                rc.get(_keys(1, seed=999))
                time.sleep(0.01)
            assert rc.connected, "could not establish the windowed conn"
            wrong, errs, stop_flag = [], [], [False]

            def worker(i):
                try:
                    keys = _keys(32, seed=300 + i)
                    pages = _pages(keys)
                    r = 0
                    while not stop_flag[0] and r < 4000:
                        r += 1
                        rc.put(keys, pages)
                        out, found = rc.get(keys)
                        bad = (out[found] != pages[found]).any(axis=1)
                        if bad.any():
                            wrong.append((i, int(bad.sum())))
                except Exception as e:  # noqa: BLE001 - invariant 1
                    errs.append((i, repr(e)))

            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(4)]
            for t in ts:
                t.start()
            for fault in ("duplicate", "reorder", "flip", "duplicate",
                          "truncate", "reorder", "flip"):
                time.sleep(0.05)
                px.arm(fault, 1)
            deadline = time.time() + 20
            while _fired(px.stats) == 0 and time.time() < deadline \
                    and any(t.is_alive() for t in ts):
                time.sleep(0.02)
            stop_flag[0] = True
            for t in ts:
                t.join(60)
            assert not any(t.is_alive() for t in ts), "stuck waiter"
            assert not errs, errs
            assert not wrong, f"mis-delivered pages: {wrong}"
            assert _fired(px.stats) > 0, "no fault actually landed"
            rc.close()
    finally:
        stop(srv)


def test_chaos_soak_long_pipelined(smoke, tmp_path):
    """The JAX test's long windowed soak (`slow` there) at a rehearsal
    size: 200 steps at doubled rates, both kill/restore cycles."""
    rates = {k: v * 2 for k, v in RATES.items()}
    s = _soak(smoke, tmp_path, 200, 9, rates, (70, 150), pipe=True)
    chip_smoke.chaos_gates("long pipelined", s, 2)
    assert _fired(s["chaos"]) > 0


def test_soak_leaves_attributable_trace(smoke, tmp_path):
    reg = PORT.tele.configure(PORT.config.TelemetryConfig(
        ring_capacity=1 << 15))
    s = _soak(smoke, tmp_path, 120, 5, RATES, (), pipe=True)
    assert s["wrong_bytes"] == 0
    spans = [r for r in reg.ring if r.get("kind") == "span"]
    client = [r for r in spans if r["src"] == "client"]
    server_traces = {r["trace"] for r in spans if r["src"] == "server"}
    completed = [r for r in client if r["ok"]]
    failed = [r for r in client if not r["ok"]]
    assert len(completed) >= 10, "soak barely completed any verbs"
    missing = [r for r in completed if r["trace"] not in server_traces]
    assert not missing, f"{len(missing)} completed verbs lack a server span"
    assert s["client"]["disconnects"] > 0
    assert failed and all(r.get("err") for r in failed)
    if s["chaos"].get("flipped_frames", 0) > 0:
        assert reg._rungs["bad_frame"] > 0


def test_reconnect_storm_after_phase_failures_is_backoff_bounded(
        monkeypatch):
    monkeypatch.setenv("PMDFC_CONTAINMENT", "off")
    f = PORT.failure
    plan = f.FaultPlan()
    shared = f.FaultyBackend(PORT.backends.DirectBackend(PORT.KV(_cfg())),
                             plan)
    srv = PORT.net.NetServer(lambda: shared, net=PORT.config.NetConfig(
        flush_timeout_us=20_000, settle_us=2_000)).start()
    keys = _keys(8, seed=31)
    plan.poison_keys(keys)
    rc = f.ReconnectingClient(
        lambda: PORT.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                    keepalive_s=None, op_timeout_s=5.0),
        page_words=W, retry_delay_s=0.02, max_retry_delay_s=0.3,
        backoff=2.0, seed=31)
    try:
        # the JAX drill (`slow` there) redials for up to 5 s a round;
        # every redial meets a poisoned op again, so the rehearsal stops
        # each round's redials after 0.25 s
        for _ in range(6):
            _, found = rc.get(keys)
            assert not found.any()
            deadline = time.time() + 0.25
            while not rc.connected and time.time() < deadline:
                rc.get(keys[:1])
                time.sleep(0.01)
        assert rc.stats()["disconnects"] >= 3, rc.stats()
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
    assert ops > 50, f"degraded ops were not cheap ({ops})"
    assert 2 <= attempts <= 10, f"{attempts} dial attempts in 0.7 s"
    rc.close()


def test_nacked_ops_close_spans_as_failed_v2_records():
    reg = PORT.tele.configure(PORT.config.TelemetryConfig(
        ring_capacity=1 << 15))
    f = PORT.failure
    plan = f.FaultPlan()
    shared = f.FaultyBackend(PORT.backends.DirectBackend(PORT.KV(_cfg())),
                             plan)
    srv = PORT.net.NetServer(lambda: shared, net=PORT.config.NetConfig(
        flush_timeout_us=20_000, settle_us=2_000)).start()
    keys = _keys(8, seed=33)
    try:
        with PORT.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                 keepalive_s=None) as be:
            assert be.nack
            be.get(_keys(4, seed=34))
            plan.poison_keys(keys)
            _, found = be.get(keys)
            assert not found.any()
    finally:
        stop(srv)
    nacked = [r for r in reg.ring
              if r.get("kind") == "span" and not r.get("ok", True)
              and str(r.get("err", "")).startswith("nack:")]
    assert nacked, "no FAILED span carries the nack cause"
    assert {"client", "server"} <= {r["src"] for r in nacked}
    assert [r for r in nacked if "span" in r and "trace" in r]


# -- phase 14 rehearsed -------------------------------------------------

CHAOS_TINY = (("CHAOS_INDEX", dict(capacity=1 << 12)),
              ("CHAOS_BLOOM_BITS", 1 << 13), ("CHAOS_PAGE_WORDS", 16),
              ("CHAOS_STEPS", 40), ("CHAOS_VERB", 16), ("CHAOS_PROBE", 16),
              ("CHAOS_GET_B", 256), ("XRAY_INDEX", dict(capacity=1 << 9)),
              ("XRAY_BLOOM_BITS", 1 << 12), ("XRAY_KEYS", 1 << 10),
              ("XRAY_STEPS", 16), ("XRAY_VERB", 256),
              ("DRILL_INDEX", dict(capacity=1 << 10)), ("DRILL_VERB", 16))


@pytest.fixture
def chaos_smoke(smoke, monkeypatch, tmp_path):
    for name, value in CHAOS_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "chaos_dir", lambda: tmp_path / "chaos")
    return smoke


def test_chaos_phase_and_its_kernels_lines(chaos_smoke, capsys):
    """Phase 14 at a tiny size: both soaks, the xray soak with teletop
    against two live port servers, the wire drills (the card's
    counterparts of the JAX suites' `slow` drills), and kernel against
    plain on both GET paths."""
    entries = chip_smoke.run_chaos(chaos_smoke)
    assert [e["path"] for e in entries] == ["chaos", "xray-plane"]
    assert [e["name"] for e in entries] == ["fused_get_linear_flat",
                                            "fused_get_linear_tiered"]
    for e in entries:
        assert set(e) == KEYS
        assert e["launches"] > 0 and e["max_abs_err"] == 0
        assert e["bound_by"] == "bytes" and e["library_ms"] is None
    out = capsys.readouterr().out
    for needle in ("soak unpipelined", "soak pipelined",
                   "restored hit set == durable", "teletop rows",
                   "poison bisection over 4 connections", "deadline:",
                   "deadline 0 served all", "verb", "spans closed failed",
                   "withheld by either side", "plane quarantine: shard",
                   "PMDFC_CONTAINMENT=off: no quarantine", "qos: 4 verbs",
                   "PMDFC_QOS=off: no plane", "reconnect storm:",
                   "phase 14 took", "kernel == plain"):
        assert needle in out, needle


def test_chaos_phase_fails_when_a_get_serves_a_wrong_page(chaos_smoke,
                                                          monkeypatch):
    """The xray soak's plane GETs serving one wrong page (one word of one
    hit flipped, the proxy's faults off so the reply arrives): phase 14
    fails."""
    monkeypatch.setattr(chip_smoke, "XRAY_RATES", {})
    counted = fused.fused_get
    calls = [0]

    def wrong(keys, *args, **kw):
        out = counted(keys, *args, **kw)
        calls[0] += 1
        hits = (out[1] == 0).nonzero().flatten()
        if calls[0] > 8 and len(hits) and calls[0] < 1 << 30:
            out[0][hits[0], 0] ^= 1
            calls[0] = 1 << 30
        return out

    monkeypatch.setattr(fused, "fused_get", wrong)
    with pytest.raises(AssertionError, match="a hit's page differs"):
        chip_smoke.run_xray(chaos_smoke, "CPU rehearsal")
