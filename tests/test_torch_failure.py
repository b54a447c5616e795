"""PyTorch port: the failure layer against the JAX package's.

The port keeps its own copy of `runtime/failure.py`. On the same seeds,
with a clock injected into both copies where the drill is timed:

- `CircuitBreaker` walks closed → open → half-open → open (widened) →
  half-open → closed, with the same jittered cooldowns;
- `ReconnectingClient` over a pipelined `TcpBackend` degrades to legal
  misses when the server dies with a window of verbs in flight, drops
  puts and journals invalidates while it is down, then reconnects to a
  restarted server and replays the journal;
- one `ChaosProxy` drill: a delayed frame still answers, a flipped one
  drops the connection (the server counts a bad frame) and the client
  degrades and reconnects through the proxy;
- `ShardQuarantine` trips a shard, its blocked GETs and PUTs land in
  `KV.account_quarantined` (so `misses == Σ miss_*` holds with
  `miss_quarantined`), its invalidations journal and replay at
  re-admission.
"""

from __future__ import annotations

import socket
import threading
import time
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import timeless

import pmdfc_tpu.client.backends as jbackends
import pmdfc_tpu.config as jconfig
import pmdfc_tpu.kv as jkv
import pmdfc_tpu.runtime.failure as jfailure
import pmdfc_tpu.runtime.net as jnet
import pmdfc_tpu_torch.client.backends as tbackends
import pmdfc_tpu_torch.config as tconfig
import pmdfc_tpu_torch.kv as tkv
import pmdfc_tpu_torch.runtime.failure as tfailure
import pmdfc_tpu_torch.runtime.net as tnet

pytestmark = pytest.mark.torch

W = 16
JAX = types.SimpleNamespace(config=jconfig, net=jnet, backends=jbackends,
                            failure=jfailure, kv=lambda cfg: jkv.KV(cfg))
PORT = types.SimpleNamespace(config=tconfig, net=tnet, backends=tbackends,
                             failure=tfailure,
                             kv=lambda cfg: tkv.KV(cfg, device="cpu"))
PKGS = (JAX, PORT)


class _Clock:
    def __init__(self):
        self.t = 500.0

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


def _kv(p):
    c = p.config
    return p.kv(c.KVConfig(index=c.IndexConfig(capacity=1 << 10),
                           bloom=c.BloomConfig(num_bits=1 << 13),
                           page_words=W, evicted_sketch_bits=1 << 10))


def _stop(srv):
    """Stop without waiting out a blocked accept() (see test_torch_net)."""
    try:
        srv._lsock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.stop()


def _keys(n, hi=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([np.full(n, hi, np.uint32),
                     rng.choice(1 << 20, n, replace=False).astype(np.uint32)],
                    -1)


def _same(a, b, where=""):
    """Deep equality: numpy arrays by dtype and value."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


def _pages(keys):
    return (keys[:, 0] * 7 + keys[:, 1])[:, None] + np.arange(
        W, dtype=np.uint32)


def test_circuit_breaker_state_walk_matches_jax(monkeypatch):
    walks = []
    for p in PKGS:
        clock = _Clock()
        monkeypatch.setattr(p.failure, "time", clock)
        br = p.failure.CircuitBreaker(failures_to_open=3, cooldown_s=0.5,
                                      max_cooldown_s=4.0, backoff=2.0,
                                      jitter=0.25, seed=7)
        out = []

        def step(what, *a):
            r = getattr(br, what)(*a)
            out.append((what, r, br.state, round(br.down_for(), 9)))

        step("record_success")
        for kind in ("timeout", "bad_frame", "timeout"):
            step("record_failure", kind)        # the third opens it
        step("allow")                           # open: shed
        clock.sleep(0.4)
        step("ready")
        clock.sleep(0.4)
        step("ready")                           # half-open, no probe spent
        step("allow")                           # the probe
        step("allow")                           # no second probe
        step("record_failure", "digest")        # reopen, cooldown widened
        clock.sleep(0.9)
        step("allow")
        clock.sleep(0.5)
        step("allow")
        step("record_success")                  # closed
        step("force_open", 2.0)
        clock.sleep(2.1)
        step("allow")
        step("record_success")
        out.append(dict(br.stats))
        walks.append(out)
    assert walks[0] == walks[1]
    states = [s for _, _, s, _ in walks[1][:-1]]
    assert {"closed", "open", "half_open"} <= set(states)


def _server(p, kv, port=0):
    shared = p.backends.DirectBackend(kv)
    return p.net.NetServer(lambda: shared, port=port,
                           net=p.config.NetConfig()).start(), shared


def test_reconnecting_client_degrades_mid_window_then_replays(monkeypatch):
    runs = []
    for p in PKGS:
        kv = _kv(p)
        srv, shared = _server(p, kv)
        port = srv.port
        gate, entered = threading.Event(), threading.Event()
        real_get = shared.get

        def held_get(keys):  # the flush that serves the window blocks
            entered.set()
            gate.wait(10)
            return real_get(keys)

        def factory():
            return p.net.TcpBackend("127.0.0.1", port, page_words=W,
                                    keepalive_s=None, window=8,
                                    op_timeout_s=10.0)

        rc = p.failure.ReconnectingClient(factory, page_words=W,
                                          retry_delay_s=0.01, seed=3)
        keys = _keys(64, seed=1)
        rc.put(keys, _pages(keys))
        out = [rc.get(keys)]
        # a window of 4 GETs in flight when the server dies
        shared.get = held_get
        res = [None] * 4
        threads = [threading.Thread(
            target=lambda i=i: res.__setitem__(
                i, rc.get(keys[16 * i:16 * (i + 1)]))) for i in range(4)]
        for t in threads:
            t.start()
        assert entered.wait(10)
        stopper = threading.Thread(target=_stop, args=(srv,))
        stopper.start()
        time.sleep(0.2)   # the connections are down; release the flush
        gate.set()
        for t in threads:
            t.join(10)
        stopper.join(10)
        out.append(sorted((bool(f.any()), int(o.sum())) for o, f in res))
        # down: gets miss, puts drop, invalidates journal
        out.append(rc.get(keys[:8]))
        rc.put(keys[:8], _pages(keys[:8]) + 1)
        out.append(rc.invalidate(keys[:4]))
        # the server restarts on its port with the same store
        shared.get = real_get
        srv2, _ = _server(p, kv, port=port)
        try:
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                o, f = rc.get(keys[4:])
                if f.all():
                    break
                time.sleep(0.02)
            out.append(rc.get(keys))
        finally:
            rc.close()
            _stop(srv2)
        s = rc.stats()
        out.append({k: s[k] for k in ("dropped_puts",
                                      "replayed_invalidates")})
        assert s["disconnects"] >= 1 and s["reconnects"] >= 1
        runs.append(out)
    a, b = runs
    _same(a, b, "reconnect drill")
    window = b[1]
    assert window == [(False, 0)] * 4  # every in-window verb: a legal miss
    final_out, final_found = b[-2]
    assert not final_found[:4].any() and final_found[4:].all()
    assert np.array_equal(final_out[4:], _pages(_keys(64, seed=1))[4:])


def test_chaos_proxy_delay_and_drop(monkeypatch):
    runs = []
    for p in PKGS:
        kv = _kv(p)
        srv, _ = _server(p, kv)
        proxy = p.failure.ChaosProxy("127.0.0.1", srv.port, seed=5,
                                     delay_s=0.05)

        def factory():
            return p.net.TcpBackend("127.0.0.1", proxy.port, page_words=W,
                                    keepalive_s=None, op_timeout_s=5.0)

        rc = p.failure.ReconnectingClient(factory, page_words=W,
                                          retry_delay_s=0.01, seed=3)
        try:
            keys = _keys(32, seed=2)
            rc.put(keys, _pages(keys))
            out = []
            proxy.delay_next(1)
            t0 = time.monotonic()
            out.append(rc.get(keys))          # delayed, still answered
            assert time.monotonic() - t0 >= 0.05
            proxy.flip_next(1)
            out.append(rc.get(keys))          # a corrupted frame: dropped
            deadline = time.monotonic() + 10
            while not rc.get(keys[:1])[1].all():
                assert time.monotonic() < deadline
                time.sleep(0.02)
            out.append(rc.get(keys))          # reconnected through it
            s = rc.stats()
            out.append((s["disconnects"] >= 1, s["reconnects"] >= 1,
                        int(srv.stats["bad_frames"])))
            out.append({k: proxy.stats[k] for k in ("delayed_frames",
                                                    "flipped_frames")})
        finally:
            rc.close()
            proxy.close()
            _stop(srv)
        runs.append(out)
    a, b = runs
    _same(a, b, "chaos drill")
    assert b[0][1].all() and b[2][1].all()
    assert not b[1][1].any()  # the dropped verb degraded to a miss
    assert b[3] == (True, True, 1)  # the flipped request: one bad frame
    assert b[4] == {"delayed_frames": 1, "flipped_frames": 1}


def test_shard_quarantine_feeds_account_quarantined(monkeypatch):
    """The plane's accounting of a quarantined shard, over one KV: blocked
    GET rows are `account_quarantined` misses, blocked PUT rows acked
    drops, invalidations journal and replay at re-admission."""
    runs = []
    for p in PKGS:
        clock = _Clock()
        monkeypatch.setattr(p.failure, "time", clock)
        kv = _kv(p)
        q = p.failure.ShardQuarantine(4, failures_to_open=2, cooldown_s=0.5,
                                      seed=11)
        keys = _keys(128, seed=4)
        shards = keys[:, 1] % 4
        kv.insert(keys, _pages(keys))
        out = []
        for _ in range(2):
            out.append(q.note_failure(2, "timeout"))
        out.append(q.quarantined())
        blocked, probing = q.gate(shards)
        out.append((int(blocked.sum()), probing))
        # a GET launch: blocked rows never reach the device
        kv.account_quarantined(int(blocked.sum()))
        _, found = kv.get(keys[~blocked])
        out.append(int(found.sum()))
        # a PUT launch: blocked rows drop acked
        kv.account_quarantined(0, int(blocked.sum()))
        q.journal_invalidations(2, keys[blocked][:5])
        clock.sleep(1.0)
        blocked2, probing2 = q.gate(shards)   # half-open: one probe
        out.append((int(blocked2.sum()), probing2))
        out.append(q.note_success(2))         # re-admitted
        ks, overflowed = q.drain_journal(2)
        out.append((ks.tolist(), overflowed))
        out.append(np.asarray(kv.delete(ks)).tolist())
        out.append(q.report())
        s = kv.stats()
        out.append(timeless(s))
        assert s["miss_quarantined"] == int(blocked.sum()) > 0
        assert s["misses"] == sum(s[c] for c in tkv.MISS_CAUSE_NAMES)
        runs.append(out)
    _same(runs[0], runs[1], "quarantine drill")
