"""PyTorch port: `ReplicaGroup` (`client/replica.py`) against the JAX
package — placement, fan-out and the elastic transitions.

Hermetic drills (`LocalBackend` endpoints, no sockets) run the same
script through the JAX group and the port's group: fan-out put / get /
invalidate, grow with the dual-read window and migration, shrink,
replace, `miss_routed` mid-move, the invalidate that survives an
ownership round trip, the repair journal dropping moved keys, a lost
migrator claim retiring its spare, `close` joining the repair thread,
and the ring-off static map. Each drill asserts the JAX drill's invariants on
both, and their observables must be equal: every op's result, the
placement (`_members`, ring owners), every endpoint's final store (keys
and bytes) and the group's counters. Counters that depend on timing are
not compared, and repair and migration are driven by manual ticks.

Then the JAX network drills' twins over the port's `NetServer`s: one
server killed mid-traffic (failover, the breaker opens), and every
replica down (the legal miss). The rejoin drills are in
`test_torch_replica_rejoin.py`.
"""

from __future__ import annotations

import collections
import socket
import time
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

import pmdfc_tpu.client.backends as jbe
import pmdfc_tpu.client.replica as jrep
import pmdfc_tpu.cluster.ring as jring
import pmdfc_tpu.config as jconf
import pmdfc_tpu.runtime.failure as jfail
import pmdfc_tpu_torch.client.backends as tbe
import pmdfc_tpu_torch.client.replica as trep
import pmdfc_tpu_torch.cluster.ring as tring
import pmdfc_tpu_torch.config as tconf
import pmdfc_tpu_torch.runtime.failure as tfail
from pmdfc_tpu_torch.client.backends import DirectBackend
from pmdfc_tpu_torch.client.replica import ReplicaGroup
from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                    ReplicaConfig)
from pmdfc_tpu_torch.kv import KV
from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend
from pmdfc_tpu_torch.utils.hashing_np import hash_u64_np

pytestmark = pytest.mark.torch

W = 16
PKGS = {
    "jax": types.SimpleNamespace(
        ReplicaGroup=jrep.ReplicaGroup, LocalBackend=jbe.LocalBackend,
        ReplicaConfig=jconf.ReplicaConfig, RingConfig=jconf.RingConfig,
        moved_mask=jring.moved_mask, OPEN=jfail.CircuitBreaker.OPEN),
    "torch": types.SimpleNamespace(
        ReplicaGroup=trep.ReplicaGroup, LocalBackend=tbe.LocalBackend,
        ReplicaConfig=tconf.ReplicaConfig, RingConfig=tconf.RingConfig,
        moved_mask=tring.moved_mask, OPEN=tfail.CircuitBreaker.OPEN),
}
# counters that depend on timing, not on the script
_TIMED = ("lat", "_ms", "_s", "hedge", "lag")


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 1:2].astype(np.uint32) * 3 + 1) * np.arange(
        1, W + 1, dtype=np.uint32)


def _group(p, eps, rf=2, ring=None, **kw):
    cfg = p.ReplicaConfig(n_replicas=len(eps), rf=rf, repair_interval_s=0,
                          ring=ring, **kw)
    return p.ReplicaGroup(eps, page_words=W, cfg=cfg)


def _stores(eps) -> list:
    return [sorted((k, bytes(v.tobytes())) for k, v in e._store.items())
            for e in eps]


def _counters(g) -> dict:
    return {k: v for k, v in g.stats()["group"].items()
            if not any(t in k for t in _TIMED)}


# -- the drills: each runs on one package, asserts the JAX invariants and
# returns what must be equal across the two packages


def _fanout(p):
    eps = [p.LocalBackend(W) for _ in range(3)]
    obs = {}
    with _group(p, eps) as g:
        keys = _keys(128, seed=3)
        pages = _pages(keys)
        g.put(keys, pages)
        assert sum(len(e._store) for e in eps) == 2 * 128
        obs["stores_after_put"] = _stores(eps)
        out, found = g.get(keys)
        assert found.all() and (out == pages).all()
        obs["members"] = g._members(keys)
        obs["hit"] = g.invalidate(keys)
        assert obs["hit"].all() and sum(len(e._store) for e in eps) == 0
        obs["after"] = g.get(keys)
        assert not obs["after"][1].any()
        obs["counters"] = _counters(g)
    return obs


def _grow(p):
    eps = [p.LocalBackend(W) for _ in range(3)]
    g = _group(p, eps)
    obs = {}
    try:
        keys = _keys(384, seed=21)
        pages = _pages(keys)
        g.put(keys, pages)
        old_ring = g.ring
        eps.append(p.LocalBackend(W))
        assert g.add_endpoint(eps[-1]) == 3
        assert g.migrator.active()
        owed = int(p.moved_mask(old_ring, g.ring, keys, 2).sum())
        assert g.migrator.lag() == owed > 0
        obs["owed"] = owed
        obs["mid"] = g.get(keys)
        assert obs["mid"][1].all() and (obs["mid"][0] == pages).all()
        assert g.drain_migration(20)
        assert dict(g.migrator.scope)["moved_pages"] >= owed
        own = g.ring.owners_np(keys, 2)
        obs["owners"] = own
        for e in range(4):
            mask = (own == e).any(axis=1)
            o, f = eps[e].get(keys[mask])
            assert f.all() and (o == pages[mask]).all()
        obs["stores"] = _stores(eps)
        obs["counters"] = _counters(g)
    finally:
        g.close()
    return obs


def _shrink(p):
    eps = [p.LocalBackend(W) for _ in range(3)]
    g = _group(p, eps)
    obs = {}
    try:
        keys = _keys(256, seed=23)
        pages = _pages(keys)
        g.put(keys, pages)
        g.remove_endpoint(0)
        assert g.migrator.active()
        obs["mid"] = g.get(keys)
        assert obs["mid"][1].all() and (obs["mid"][0] == pages).all()
        assert g.drain_migration(20)
        assert 0 in g._dead and g.breakers[0].state == p.OPEN
        assert g.ring.members == (1, 2)
        obs["after"] = g.get(keys)
        assert obs["after"][1].all() and (obs["after"][0] == pages).all()
        assert not (g._members(keys) == 0).any()
        obs["stores"] = _stores(eps)
        obs["counters"] = _counters(g)
    finally:
        g.close()
    return obs


def _replace(p):
    eps = [p.LocalBackend(W) for _ in range(3)]
    g = _group(p, eps)
    obs = {}
    try:
        keys = _keys(256, seed=29)
        pages = _pages(keys)
        g.put(keys, pages)
        eps.append(p.LocalBackend(W))
        assert g.replace_endpoint(1, eps[-1]) == 3
        assert g.breakers[1].state == p.OPEN
        obs["mid"] = g.get(keys)
        assert obs["mid"][1].all() and (obs["mid"][0] == pages).all()
        assert g.drain_migration(20)
        assert 1 in g._dead and g.ring.members == (0, 2, 3)
        assert dict(g.migrator.scope)["moved_replace"] > 0
        obs["stores"] = _stores(eps)
        obs["counters"] = _counters(g)
    finally:
        g.close()
    return obs


def _miss_routed(p):
    eps = [p.LocalBackend(W) for _ in range(2)]
    g = _group(p, eps, rf=1, ring=p.RingConfig(migrate_pages_per_s=1e-6,
                                               migrate_burst=1))
    obs = {}
    try:
        keys = _keys(256, seed=31)
        g.put(keys, _pages(keys))
        eps.append(p.LocalBackend(W))
        g.add_endpoint(eps[-1])
        assert g.migrator.active()
        for e in eps[:2]:
            e._store.clear()
        obs["get"] = g.get(keys)
        assert not obs["get"][1].any()
        grp = g.stats()["group"]
        assert grp["misses"] == (grp["miss_replica_exhausted"]
                                 + grp["miss_digest"] + grp["miss_routed"]
                                 + grp["miss_remote"])
        moved = int(p.moved_mask(*g.migrator.rings(), keys, 1).sum())
        assert grp["miss_routed"] == moved > 0
        obs["counters"] = _counters(g)
    finally:
        g.close()
    return obs


def _invalidate_round_trip(p):
    eps = [p.LocalBackend(W) for _ in range(3)]
    g = _group(p, eps)
    obs = {}
    try:
        keys = _keys(300, seed=61)
        pages = _pages(keys)
        g.put(keys, pages)
        eps.append(p.LocalBackend(W))
        g.add_endpoint(eps[-1])
        assert g.drain_migration(20)
        g.invalidate(keys[:32])
        g.remove_endpoint(0)
        assert g.drain_migration(20)
        g.remove_endpoint(1)
        assert g.drain_migration(20)
        out, found = g.get(keys)
        assert not found[:32].any()
        assert found[32:].all() and (out[32:] == pages[32:]).all()
        obs["get"] = (out, found)
        obs["stores"] = _stores(eps)
        obs["counters"] = _counters(g)
    finally:
        g.close()
    return obs


def _repair_journal_drop(p):
    eps = [p.LocalBackend(W) for _ in range(3)]
    g = _group(p, eps)
    obs = {}
    try:
        keys = _keys(256, seed=37)
        g.put(keys, _pages(keys))
        with g._repair_lock:
            g._repair_pending[0] = collections.deque(
                map(tuple, keys.tolist()))
        owned = int((g._members(keys) == 0).any(axis=1).sum())
        deadline = time.time() + 10
        while time.time() < deadline:
            g.repair_tick()
            with g._repair_lock:
                if not g._repair_pending.get(0):
                    break
        with g._repair_lock:
            assert not g._repair_pending.get(0)
        grp = g.stats()["group"]
        assert grp["repair_dropped"] == len(keys) - owned > 0
        obs["stores"] = _stores(eps)
        obs["counters"] = _counters(g)
    finally:
        g.close()
    return obs


def _ring_off(p):
    eps = [p.LocalBackend(W) for _ in range(3)]
    g = _group(p, eps)
    obs = {}
    try:
        keys = _keys(512, seed=41)
        h = hash_u64_np(keys[:, 0], keys[:, 1], seed=0x5EC0_11D5)
        prim = (h % np.uint32(3)).astype(np.int64)
        want = (prim[:, None] + np.arange(2)) % 3
        assert (g._members(keys) == want).all()
        assert g.ring is None and g.migrator is None
        with pytest.raises(RuntimeError):
            g.add_endpoint(p.LocalBackend(W))
        with pytest.raises(RuntimeError):
            g.remove_endpoint(0)
        g.put(keys, _pages(keys))
        for e in range(3):
            assert len(eps[e]._store) == int((want == e).any(axis=1).sum())
        obs["stores"] = _stores(eps)
        obs["hit"] = g.invalidate(keys[:64])
        obs["counters"] = _counters(g)
    finally:
        g.close()
    return obs


def _lost_claim_retires_spare(p):
    """A membership op that loses the migrator's claim after registering
    its new endpoint retires that slot; placement stays as it was."""
    eps = [p.LocalBackend(W) for _ in range(3)]
    g = _group(p, eps)
    try:
        def boom(*a, **k):
            raise RuntimeError("claim lost")

        g.migrator.start = boom
        n0, epoch0 = g.n, g.ring.epoch
        with pytest.raises(RuntimeError, match="claim lost"):
            g.replace_endpoint(1, p.LocalBackend(W))
        assert g.n == n0 + 1 and n0 in g._dead
        assert not g.breakers[n0].ready()
        assert g.ring.epoch == epoch0 and g.ring.members == (0, 1, 2)
        assert 1 not in g._dead and g.breakers[1].state == "closed"
        with pytest.raises(RuntimeError, match="claim lost"):
            g.add_endpoint(p.LocalBackend(W))
        assert n0 + 1 in g._dead
        return {"dead": sorted(g._dead), "n": g.n,
                "ring": g.ring.describe(), "counters": _counters(g)}
    finally:
        g.close()


def _close_joins_repair_thread(p):
    """close() joins the repair thread, is idempotent, and the context
    manager's exit does the same."""
    g = p.ReplicaGroup([p.LocalBackend(W) for _ in range(2)], page_words=W,
                       cfg=p.ReplicaConfig(n_replicas=2, rf=1,
                                           repair_interval_s=0.01))
    t = g._repair_thread
    assert t is not None and t.is_alive()
    g.close()
    assert g._repair_thread is None and not t.is_alive()
    g.close()
    with p.ReplicaGroup([p.LocalBackend(W)], page_words=W,
                        cfg=p.ReplicaConfig(n_replicas=1, rf=1,
                                            repair_interval_s=0.01)) as g2:
        assert g2._repair_thread.is_alive()
    assert g2._repair_thread is None
    return {}


DRILLS = {"fanout": _fanout, "grow": _grow, "shrink": _shrink,
          "replace": _replace, "miss_routed": _miss_routed,
          "invalidate_round_trip": _invalidate_round_trip,
          "repair_journal_drop": _repair_journal_drop,
          "lost_claim_retires_spare": _lost_claim_retires_spare,
          "close_joins_repair_thread": _close_joins_repair_thread}


def _equal(a, b, path="obs"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("drill", list(DRILLS))
def test_hermetic_drill_matches_jax(drill):
    _equal(DRILLS[drill](PKGS["jax"]), DRILLS[drill](PKGS["torch"]))


def test_ring_off_conformance_matches_jax(monkeypatch):
    monkeypatch.setenv("PMDFC_RING", "off")
    _equal(_ring_off(PKGS["jax"]), _ring_off(PKGS["torch"]))


def test_replica_map_stable_spread_and_distinct():
    g = ReplicaGroup([tbe.LocalBackend(W) for _ in range(5)], page_words=W,
                     cfg=ReplicaConfig(n_replicas=5, rf=3,
                                       repair_interval_s=0))
    ref = jrep.ReplicaGroup([jbe.LocalBackend(W) for _ in range(5)],
                            page_words=W, cfg=jconf.ReplicaConfig(
                                n_replicas=5, rf=3, repair_interval_s=0))
    try:
        keys = _keys(512, seed=7)
        m1 = g._members(keys)
        assert (m1 == g._members(keys)).all()
        assert m1.shape == (512, 3)
        for row in m1[:64]:
            assert len(set(row.tolist())) == 3
        assert (np.bincount(m1[:, 0], minlength=5) > 0).all()
        np.testing.assert_array_equal(m1, ref._members(keys))
    finally:
        g.close()
        ref.close()


# -- network drills over the port's NetServers

CFG = KVConfig(index=IndexConfig(capacity=1 << 12),
               bloom=BloomConfig(num_bits=1 << 13), paged=True, page_words=W)
# every case on FAST_CFG asserts a tripped breaker reads "open": its
# cooldown (1 s, up to 1.25 s with jitter) outlasts what a loaded host
# takes between the verb that trips it and the read
FAST_CFG = ReplicaConfig(
    n_replicas=3, rf=2, hedge_ms=50.0, breaker_failures=3,
    breaker_cooldown_s=1.0, breaker_max_cooldown_s=4.0,
    repair_interval_s=0.0, repair_batch=64)


def _stop(srv):
    try:
        srv._lsock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.stop()


class _Cluster:
    """N port `NetServer`s over `KV(device="cpu")`; endpoint factories
    track each slot's current port."""

    def __init__(self, n: int, seed: int = 0):
        self.seed = seed
        self.kvs: list = [None] * n
        self.servers: list = [None] * n
        self.ports = [0] * n
        for i in range(n):
            self.bring_up(i)

    def bring_up(self, i: int, kv=None) -> None:
        kv = kv if kv is not None else KV(CFG, device="cpu")
        srv = NetServer(lambda kv=kv: DirectBackend(kv)).start()
        self.kvs[i], self.servers[i], self.ports[i] = kv, srv, srv.port

    def kill(self, i: int) -> None:
        if self.servers[i] is not None:
            _stop(self.servers[i])
            self.servers[i] = None
        self.kvs[i] = None

    def endpoint(self, i: int) -> ReconnectingClient:
        def factory(i=i):
            return TcpBackend("127.0.0.1", self.ports[i], page_words=W,
                              keepalive_s=None, op_timeout_s=10.0)

        return ReconnectingClient(factory, page_words=W,
                                  retry_delay_s=0.005,
                                  max_retry_delay_s=0.05,
                                  seed=self.seed * 31 + i)

    def group(self, cfg, seed=0) -> ReplicaGroup:
        return ReplicaGroup([self.endpoint(i) for i in range(len(self.kvs))],
                            page_words=W, cfg=cfg, seed=seed)

    def close(self) -> None:
        for i in range(len(self.kvs)):
            self.kill(i)


def test_kill_one_server_failover_serves_and_breaker_opens():
    cl = _Cluster(3, seed=11)
    g = cl.group(FAST_CFG, seed=11)
    try:
        keys = _keys(192, seed=11)
        pages = _pages(keys)
        g.put(keys, pages)
        out, found = g.get(keys)
        assert found.all() and (out == pages).all()
        # each server holds exactly the keys the ring gives it
        own = g.ring.owners_np(keys, 2)
        for i in range(3):
            mask = (own == i).any(axis=1)
            assert cl.kvs[i].get(keys[mask])[1].all()
            assert cl.kvs[i].stats()["puts"] == int(mask.sum())
        cl.kill(0)
        for _ in range(FAST_CFG.breaker_failures):
            out, found = g.get(keys)
            assert (out[found] == pages[found]).all()
        assert g.breakers[0].state == "open"
        out, found = g.get(keys)
        assert found.all(), f"{int((~found).sum())} keys lost with rf=2"
        assert (out == pages).all()
        assert g.counters["failover_gets"] > 0
    finally:
        g.close()
        cl.close()


def test_all_replicas_down_is_a_legal_miss():
    cl = _Cluster(2, seed=41)
    cfg = ReplicaConfig(n_replicas=2, rf=2, breaker_failures=2,
                        breaker_cooldown_s=0.05, repair_interval_s=0)
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
        assert not g.invalidate(keys).any()
        assert g.counters["load_shed_gets"] > 0
    finally:
        g.close()
