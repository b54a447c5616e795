"""PyTorch port: `tests/test_replica.py`'s network drills, drill by drill.

Each drill runs the JAX drill's script on both packages: N `NetServer`s
over `KV`s (the JAX drill's `CFG`: 16-word pages, 2^12 slots; the port
with `device="cpu"`), each optionally behind a seeded `ChaosProxy`,
fronted by a `ReplicaGroup` over `ReconnectingClient`-wrapped
`TcpBackend`s. The breaker's state machine is deterministic (jitter 0)
and its transcript is compared exactly. The network drills depend on
timing (hedges, breaker cooldowns, reconnects), so each package is held
to the JAX drill's own invariants, and what the seed fixes is compared
exactly: the keys, the placement (`_members`), the subset whose primary
is slowed, the fault schedule, the found masks of the deterministic
reads and the rejoined server's holdings. The three drills JAX marks
`slow` run here at a smaller depth of the same widths: the rolling
kill/restore at 120 of its 240 steps, the multi-endpoint chaos soak at
130 of its 520 (the schedules scaled), the hedge at its own size.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import JAX as _JAX
from torch_twin import PORT as _PORT
from torch_twin import fresh_jax_registry, registries, same  # noqa: F401
from torch_twin import stop
from torch_twin import twin as twin_of

import pmdfc_tpu.client.replica as jrep
import pmdfc_tpu_torch.client.replica as trep

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

W = 16
JAX = types.SimpleNamespace(**vars(_JAX), name="jax", replica=jrep)
PORT = types.SimpleNamespace(**vars(_PORT), name="port", replica=trep)
PKGS = (JAX, PORT)


def twin(drill, *args):
    return twin_of(drill, *args, pkgs=PKGS)


def _cfg(p):
    c = p.config
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


def _fast(p, **kw):
    """The JAX suite's `_FAST_CFG` (breaker cooldown 0.05 s)."""
    d = dict(n_replicas=3, rf=2, hedge_ms=50.0, breaker_failures=3,
             breaker_cooldown_s=0.05, breaker_max_cooldown_s=0.4,
             repair_interval_s=0.0, repair_batch=64)
    d.update(kw)
    return p.config.ReplicaConfig(**d)


class _Cluster:
    """The JAX suite's `_Cluster` over package `p`: N real-KV NetServers,
    optionally chaos-proxied, killed and cold-restored per endpoint; the
    endpoint factories dial the live port."""

    def __init__(self, p, n: int, seed: int = 0, rates: dict | None = None):
        self.p, self.n, self.seed, self.rates = p, n, seed, rates
        self.kvs: list = [None] * n
        self.servers: list = [None] * n
        self.proxies: list = [None] * n
        self.ports = [0] * n
        self.fired = 0
        for i in range(n):
            self._bring_up(i)

    def _bring_up(self, i: int) -> None:
        p = self.p
        kv = p.KV(_cfg(p))
        srv = p.net.NetServer(lambda kv=kv: p.backends.DirectBackend(kv)
                              ).start()
        self.kvs[i], self.servers[i] = kv, srv
        port = srv.port
        if self.rates is not None:
            px = p.failure.ChaosProxy(
                "127.0.0.1", srv.port, seed=self.seed * 97 + i,
                rates=self.rates, delay_s=0.02, reorder_wait_s=0.05)
            self.proxies[i] = px
            port = px.port
        self.ports[i] = port

    def kill(self, i: int) -> None:
        if self.servers[i] is not None:
            stop(self.servers[i])
            self.servers[i] = None
        if self.proxies[i] is not None:
            self.fired += _fired(self.proxies[i])
            self.proxies[i].close()
            self.proxies[i] = None
        self.kvs[i] = None

    def restore(self, i: int) -> None:
        self.kill(i)
        self._bring_up(i)

    def endpoint(self, i: int):
        p = self.p

        def factory(i=i):
            return p.net.TcpBackend("127.0.0.1", self.ports[i], page_words=W,
                                    keepalive_s=None, op_timeout_s=10.0)

        return p.failure.ReconnectingClient(
            factory, page_words=W, retry_delay_s=0.005,
            max_retry_delay_s=0.05, seed=self.seed * 31 + i)

    def group(self, cfg, seed: int = 0):
        return self.p.replica.ReplicaGroup(
            [self.endpoint(i) for i in range(self.n)], page_words=W,
            cfg=cfg, seed=seed)

    def close(self) -> None:
        for i in range(self.n):
            self.kill(i)


def _fired(px) -> int:
    return sum(v for k, v in px.stats.items()
               if k.endswith("_frames") and k != "forwarded_frames")


def _drain_repair(g, deadline_s: float = 5.0) -> None:
    end = time.time() + deadline_s
    while time.time() < end:
        g.repair_tick()
        if not g._repair_pending:
            return
        time.sleep(0.01)


def _close_in(g, i: int, probe, deadline_s: float = 5.0) -> None:
    """Drive GETs until endpoint i's half-open probe closes its breaker."""
    deadline = time.time() + deadline_s
    while g.breakers[i].state != "closed" and time.time() < deadline:
        g.get(probe)
        time.sleep(0.01)


def _storm(g, keys, pages, steps: int, seed: int, on_step=None) -> dict:
    """The JAX suite's seeded put/get storm -> hit and wrong-byte counts
    (the loop finishing without an exception is invariant 1)."""
    rng = np.random.default_rng(seed)
    stats = {"gets": 0, "hits": 0, "wrong_bytes": 0, "zeroed": True,
             "ops": []}
    for step in range(steps):
        if on_step is not None:
            on_step(step)
        op = rng.integers(4)
        lo = int(rng.integers(0, len(keys) - 16))
        n = int(rng.integers(1, 16))
        sel = slice(lo, lo + n)
        stats["ops"].append((int(op), lo, n))
        if op == 0:
            g.put(keys[sel], pages[sel])
        else:
            out, found = g.get(keys[sel])
            stats["gets"] += n
            stats["hits"] += int(found.sum())
            good = pages[sel]
            stats["wrong_bytes"] += int(
                (out[found] != good[found]).any(axis=1).sum())
            stats["zeroed"] &= not out[~found].any()
    return stats


def test_breaker_state_machine():
    """closed -> open at the threshold (shedding while open) -> half-open
    after the cooldown -> a failed probe re-opens with a widened cooldown
    -> a probe success closes; the transcript equal on both packages."""
    def drill(p):
        br = p.failure.CircuitBreaker(
            failures_to_open=3, cooldown_s=0.05, max_cooldown_s=1.0,
            backoff=2.0, jitter=0.0, half_open_probes=1, seed=0)
        seen = [(br.state, br.allow())]
        br.record_failure("timeout")
        br.record_failure("bad_frame")
        seen.append(br.state)
        br.record_success()
        for _ in range(2):
            br.record_failure("timeout")
        seen.append(br.state)
        br.record_failure("digest")
        seen.append(br.state)
        seen.append((br.allow(), br.stats["shed_ops"] >= 1))
        time.sleep(0.06)
        seen.append((br.ready(), br.state))
        seen.append((br.allow(), br.allow()))
        br.record_failure("timeout")
        seen.append((br.state, br.stats["reopens"]))
        time.sleep(0.06)
        seen.append(br.state)
        time.sleep(0.06)
        seen.append(br.allow())
        br.record_success()
        seen.append(br.state)
        return seen, dict(br.stats)

    seen, st = twin(drill)
    assert seen == [("closed", True), "closed", "closed", "open",
                    (False, True), (True, "half_open"), (True, False),
                    ("open", 1), "open", True, "closed"]
    assert st["closes"] == 1 and st["timeouts"] == 4
    assert st["bad_frames"] == 1 and st["digest_mismatches"] == 1


def test_kill_one_server_failover_serves_and_breaker_opens():
    def drill(p):
        cl = _Cluster(p, 3, seed=11)
        g = cl.group(_fast(p, breaker_cooldown_s=1.0,
                           breaker_max_cooldown_s=4.0), seed=11)
        try:
            keys = _keys(192, seed=11)
            pages = _pages(keys)
            g.put(keys, pages)
            out, found = g.get(keys)
            assert found.all() and (out == pages).all()
            held = [cl.kvs[i].get(keys)[1] for i in range(3)]
            cl.kill(0)
            for _ in range(3):
                out, found = g.get(keys)
                assert (out[found] == pages[found]).all()
            assert g.breakers[0].state == "open"
            out, found = g.get(keys)
            assert found.all() and (out == pages).all()
            assert g.counters["failover_gets"] > 0
            return g._members(keys), held, found
        finally:
            g.close()
            cl.close()

    members, held, _ = twin(drill)
    for i in range(3):
        np.testing.assert_array_equal(held[i], (members == i).any(axis=1))


def test_hedged_get_fires_on_slow_primary():
    """The JAX drill (`slow` there) at its own size: a slowed, not dead,
    primary; the hedge fires, the secondary serves every key, and the
    GET's wall stays under the armed delay. One hedged GET runs before
    the timed one: the secondaries serve the hedge at widths the plain
    GET never asked them for, and JAX's side traced and lowered those
    programs (~0.6 s) inside the timed window, which a loaded host
    pushed past the 0.55 s bound."""
    def drill(p):
        cl = _Cluster(p, 3, seed=23, rates={})
        cfg = p.config.ReplicaConfig(n_replicas=3, rf=2, hedge_ms=40.0,
                                     breaker_failures=10,
                                     repair_interval_s=0)
        g = cl.group(cfg, seed=23)
        try:
            keys = _keys(96, seed=23)
            g.put(keys, _pages(keys))
            sub = keys[np.asarray(g._members(keys))[:, 0] == 0]
            assert len(sub) >= 8
            g.get(sub)
            cl.proxies[0].delay_next(8, seconds=0.6)
            g.get(sub)
            time.sleep(0.7)  # the warm-up's delayed primary reply drains
            cl.proxies[0].delay_next(8, seconds=0.6)
            t0 = time.monotonic()
            out, found = g.get(sub)
            dt = time.monotonic() - t0
            assert found.all() and (out == _pages(sub)).all()
            assert g.counters["hedges_fired"] >= 1
            assert dt < 0.55, f"{p.name}: hedged GET took {dt:.2f}s"
            return sub, found
        finally:
            g.close()
            cl.close()

    twin(drill)


def test_rejoin_triggers_bloom_guided_repair():
    def drill(p):
        cl = _Cluster(p, 3, seed=31)
        g = cl.group(_fast(p, breaker_cooldown_s=1.0,
                           breaker_max_cooldown_s=4.0), seed=31)
        try:
            keys = _keys(192, seed=31)
            pages = _pages(keys)
            g.put(keys[:96], pages[:96])
            cl.kill(1)
            for _ in range(3):
                g.put(keys[96:], pages[96:])
            assert g.breakers[1].state == "open"
            cl.restore(1)
            # the widened cooldown (1 s) is waited out, then probed in
            _close_in(g, 1, keys[:16], deadline_s=10.0)
            assert g.breakers[1].state == "closed", "rejoin never probed in"
            _drain_repair(g)
            assert g.counters["repair_pages"] > 0
            assert g.counters["repair_rounds"] >= 1
            owned = (g._members(keys) == 1).any(axis=1)
            out, found = cl.kvs[1].get(keys[owned])
            assert found.all() and (out == pages[owned]).all()
            return owned, cl.kvs[1].get(keys)[1]
        finally:
            g.close()
            cl.close()

    owned, held = twin(drill)
    np.testing.assert_array_equal(held, owned)


def test_all_replicas_down_is_a_legal_miss():
    def drill(p):
        cl = _Cluster(p, 2, seed=41)
        cfg = p.config.ReplicaConfig(n_replicas=2, rf=2, breaker_failures=2,
                                     breaker_cooldown_s=0.05,
                                     repair_interval_s=0)
        g = cl.group(cfg, seed=41)
        try:
            keys = _keys(32, seed=41)
            pages = _pages(keys)
            g.put(keys, pages)
            cl.close()
            for _ in range(cfg.breaker_failures + 1):
                out, found = g.get(keys)
            assert not found.any() and (out == 0).all()
            g.put(keys, pages)
            hit = g.invalidate(keys)
            assert not hit.any()
            assert g.counters["load_shed_gets"] > 0
            return found, out, hit
        finally:
            g.close()

    twin(drill)


def _rolling(p, steps: int, schedule: dict) -> dict:
    keys = _keys(224, seed=55)
    pages = _pages(keys)
    cl0 = _Cluster(p, 3, seed=55)
    g0 = cl0.group(_fast(p), seed=55)
    try:
        g0.put(keys, pages)
        base = _storm(g0, keys, pages, steps, seed=55)
    finally:
        g0.close()
        cl0.close()
    assert base["wrong_bytes"] == 0 and base["zeroed"]
    base_rate = base["hits"] / max(1, base["gets"])
    cl = _Cluster(p, 3, seed=55)
    g = cl.group(_fast(p), seed=55)
    try:
        g.put(keys, pages)

        def on_step(step):
            act = schedule.get(step)
            if act is not None:
                getattr(cl, act[0])(act[1])
                if act[0] == "restore":
                    _close_in(g, act[1], keys[:8])
                    _drain_repair(g)
            g.repair_tick()

        faulted = _storm(g, keys, pages, steps, seed=55, on_step=on_step)
        assert faulted["wrong_bytes"] == 0 and faulted["zeroed"]
        rate = faulted["hits"] / max(1, faulted["gets"])
        assert rate >= 0.8 * base_rate, (p.name, rate, base_rate)
        assert g.breakers[0].stats["opens"] >= 1
        _drain_repair(g)
        assert g.counters["repair_pages"] > 0
        out, found = g.get(keys)
        assert (out[found] == pages[found]).all()
        assert found.mean() >= base_rate - 0.05, (p.name, found.mean())
        return {"ops": faulted["ops"], "base_ops": base["ops"],
                "base_hits": base["hits"]}
    finally:
        g.close()
        cl.close()


def test_rolling_kill_restore_drill():
    """The acceptance drill (`slow` in JAX; on the card phase 13's
    `replica_soak` and phase 18 (f2)) at 120 of its 240 steps, the
    schedule halved: one server down at any instant, each victim probed
    back in and repaired before the next kill."""
    schedule = {15: ("kill", 0), 45: ("restore", 0),
                60: ("kill", 1), 90: ("restore", 1)}
    out = twin(_rolling, 120, schedule)
    assert out["base_hits"] > 0


def _chaos_soak(p, steps: int, schedule: dict) -> dict:
    rates = {"flip": 0.02, "truncate": 0.01, "duplicate": 0.02,
             "delay": 0.01}
    keys = _keys(224, seed=77)
    pages = _pages(keys)
    cl = _Cluster(p, 3, seed=77, rates=rates)
    cfg = p.config.ReplicaConfig(
        n_replicas=3, rf=2, hedge_ms=30.0, breaker_failures=4,
        breaker_cooldown_s=0.05, breaker_max_cooldown_s=0.4,
        repair_interval_s=0.0, repair_batch=64)
    g = cl.group(cfg, seed=77)
    try:
        g.put(keys, pages)

        def on_step(step):
            act = schedule.get(step)
            if act is not None:
                getattr(cl, act[0])(act[1])
            g.repair_tick()

        s = _storm(g, keys, pages, steps, seed=77, on_step=on_step)
        assert s["wrong_bytes"] == 0 and s["zeroed"] and s["hits"] > 0
        fired = cl.fired + sum(_fired(px) for px in cl.proxies
                               if px is not None)
        assert fired > 0, "chaos never landed"
        # at a quarter of the JAX drill's steps the storm can end inside a
        # rejoined node's breaker cooldown: probe each back in first
        for i in sorted({i for act, i in schedule.values()
                         if act == "restore"}):
            _close_in(g, i, keys[:8])
        _drain_repair(g)
        assert g.counters["repair_pages"] > 0, p.name
        out, found = g.get(keys)
        assert (out[found] == pages[found]).all()
        return {"ops": s["ops"], "members": g._members(keys),
                "rates": dict(cl.proxies[1].rates)}
    finally:
        g.close()
        cl.close()


def test_multi_endpoint_chaos_soak():
    """The JAX drill (`slow` there; on the card phase 18 (f2) at 2^11-key
    verbs) at 130 of its 520 steps, the kill/restore schedule scaled:
    chaos on every endpoint, zero wrong bytes, faults fired, repair heals
    the rejoined replicas."""
    schedule = {15: ("kill", 2), 50: ("restore", 2),
                70: ("kill", 0), 105: ("restore", 0)}
    twin(_chaos_soak, 130, schedule)


class _DropNextPut:
    """A bare backend over a `KV` whose next `drop` puts raise a transport
    error (the group feeds its breaker for it)."""

    def __init__(self, p, kv):
        self.inner = p.backends.DirectBackend(kv)
        self.drop = 0

    def put(self, keys, pages):
        if self.drop:
            self.drop -= 1
            raise ConnectionError("put dropped in flight")
        self.inner.put(keys, pages)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_a_put_dropped_on_a_closed_breaker_member_stays_lost_in_both():
    """A behaviour both packages share (ROADMAP Queue 3 item 9): a fan-out
    put that fails on one member whose breaker stays closed is covered by
    the other, and nothing copies it again. Repair is queued only when a
    breaker goes from open to closed, so however many ticks run, the
    member never holds its keys and rf 2 stays unmet until its breaker
    next closes."""
    def drill(p):
        kvs = [p.KV(_cfg(p)) for _ in range(3)]
        eps = [_DropNextPut(p, kv) for kv in kvs]
        g = p.replica.ReplicaGroup(eps, page_words=W,
                                   cfg=_fast(p, breaker_failures=4), seed=91)
        try:
            keys = _keys(64, seed=91)
            pages = _pages(keys)
            eps[1].drop = 1
            g.put(keys, pages)
            for _ in range(8):
                g.repair_tick()
            owned = (np.asarray(g._members(keys)) == 1).any(axis=1)
            held = kvs[1].get(keys)[1]
            out, found = g.get(keys)
            assert g.breakers[1].state == "closed"
            assert owned.any() and not held[owned].any()
            assert found.all() and (out == pages).all()
            counters = dict(g.counters)
            assert counters["load_shed_puts"] == 0
            assert counters["repair_rounds"] == counters["repair_pages"] == 0
            return owned, held, found, g.breakers[1].stats["timeouts"]
        finally:
            g.close()

    owned, held, _, timeouts = twin(drill)
    np.testing.assert_array_equal(held, np.zeros_like(owned))
    assert timeouts == 1
