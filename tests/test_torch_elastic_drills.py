"""PyTorch port: `tests/test_elastic.py`'s drills on both packages.

The hermetic migration drills (grow, shrink, replace, `miss_routed`, the
ownership round trip, the repair journal, the lost claim, `close`) are
twinned in `test_torch_replica.py`; the rest are here, each under the
name of the JAX drill it twins:

- the ring's properties (batch against scalar owners, immutable epochs,
  the measured ~rf/N move) on `HashRing`s of both packages built alike:
  owner sets, positions and moved masks must be equal;
- `TokenBucket` and `CircuitBreaker` (timed drills: each package held to
  the JAX drill's invariants, the untimed grants and states compared);
- `PMDFC_RING=off`, both halves, and `MSG_RINGNOTE` / `MSG_HANDOFF` over
  each package's own `NetServer` and `TcpBackend`;
- the two `slow` drills over real `NetServer`s, at their own sizes: the
  breaker-driven auto-replacement, and the 3 -> 5 -> 2 chaos scale (220
  steps, five membership changes). Their reconnect backoff gates which
  ops land, so both packages are held to the drills' invariants (zero
  wrong bytes,
  the hit-rate bound against the no-churn run, five transitions, moved
  keys within the owed bound, the miss-cause sum, a flight dump that
  passes the schema) and compared on what is not timed (the members,
  the spares built, the replacement count).

Card counterparts: phase 18 (d) of `chip_smoke.py` (the auto-replacement
under 2^11-key GETs) and phase 13's `elastic_sweep` (the 3 -> 5 -> 2
soak).
"""

from __future__ import annotations

import glob
import json
import time
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import (counters, fresh_jax_registry,  # noqa: F401
                        registries, same, stop)

from pmdfc_tpu import config as jconf
from pmdfc_tpu import kv as jkv
from pmdfc_tpu.client import backends as jbe
from pmdfc_tpu.client import replica as jrep
from pmdfc_tpu.cluster import migrate as jmig
from pmdfc_tpu.cluster import ring as jring
from pmdfc_tpu.runtime import failure as jfail
from pmdfc_tpu.runtime import net as jnet
from pmdfc_tpu.runtime import telemetry as jtele
from pmdfc_tpu_torch import config as tconf
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.client import backends as tbe
from pmdfc_tpu_torch.client import replica as trep
from pmdfc_tpu_torch.cluster import migrate as tmig
from pmdfc_tpu_torch.cluster import ring as tring
from pmdfc_tpu_torch.runtime import failure as tfail
from pmdfc_tpu_torch.runtime import net as tnet
from pmdfc_tpu_torch.runtime import telemetry as ttele
from pmdfc_tpu_torch.utils.hashing_np import hash_u64_np
from tools.check_teledump import check_flight

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures(
    "fresh_jax_registry")]

W = 16

JAX = types.SimpleNamespace(
    conf=jconf, KV=jkv.KV, ring=jring, mig=jmig, fail=jfail, net=jnet,
    be=jbe, ReplicaGroup=jrep.ReplicaGroup, tele=jtele)
PORT = types.SimpleNamespace(
    conf=tconf, KV=lambda cfg: tkv.KV(cfg, device="cpu"), ring=tring,
    mig=tmig, fail=tfail, net=tnet, be=tbe, ReplicaGroup=trep.ReplicaGroup,
    tele=ttele)


def twin(drill, *args):
    """`drill(pkg, *args)` on JAX, then on the port; equal observables."""
    a, b = drill(JAX, *args), drill(PORT, *args)
    same(a, b, drill.__name__)
    return b


def _cfg(p):
    c = p.conf
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


def _group(p, eps, rf=2, **kw):
    return p.ReplicaGroup(eps, page_words=W, cfg=p.conf.ReplicaConfig(
        n_replicas=len(eps), rf=rf, repair_interval_s=0, **kw))


# --- 1. ring properties ----------------------------------------------------


def test_ring_owner_identity_batch_vs_scalar():
    def drill(p):
        r = p.ring.HashRing(range(5), vnodes=32, seed=1234)
        keys = _keys(512, seed=3)
        own = r.owners_np(keys, 3)
        assert own.shape == (512, 3)
        assert (own[:, 0] != own[:, 1]).all()
        assert (own[:, 1] != own[:, 2]).all()
        assert (own[:, 0] != own[:, 2]).all()
        for i in range(128):
            assert r.owner_set(tuple(keys[i]), 3) == tuple(own[i])
        r2 = p.ring.HashRing(range(5), vnodes=32, seed=1234)
        assert (r2.owners_np(keys, 3) == own).all()
        prim = np.bincount(own[:, 0], minlength=5)
        assert (prim > 0).all(), prim
        return {"own": own, "prim": prim}
    twin(drill)


def test_ring_epoch_monotonic_and_immutable():
    def drill(p):
        r1 = p.ring.HashRing(range(3), vnodes=16)
        r2 = r1.join(7)
        r3 = r2.leave(0)
        r4 = r3.replace(1, 9)
        assert (r1.epoch, r2.epoch, r3.epoch, r4.epoch) == (1, 2, 3, 4)
        assert r1.members == (0, 1, 2) and r2.members == (0, 1, 2, 7)
        assert r3.members == (1, 2, 7) and r4.members == (2, 7, 9)
        with pytest.raises(ValueError):
            r1.join(2)
        with pytest.raises(ValueError):
            r1.leave(9)
        with pytest.raises(ValueError):
            p.ring.HashRing([0]).leave(0)
        keys = _keys(256, seed=5)
        assert (r1.positions(keys) == r4.positions(keys)).all()
        return {"pos": r1.positions(keys),
                "owners": [r.owners_np(keys, 2) for r in (r1, r2, r3, r4)],
                "rings": [r.describe() for r in (r1, r2, r3, r4)]}
    twin(drill)


def test_ring_stability_measured_join_and_leave():
    def drill(p):
        n, rf = 8, 2
        keys = _keys(20000, seed=11)
        r = p.ring.HashRing(range(n), vnodes=64)
        r2 = r.join(n)
        prim = r.owners_np(keys, 1)[:, 0] != r2.owners_np(keys, 1)[:, 0]
        exp = 1.0 / (n + 1)
        assert 0.3 * exp < prim.mean() < 2.0 * exp
        moved = p.ring.moved_mask(r, r2, keys, rf)
        exp_set = rf / (n + 1)
        assert 0.3 * exp_set < moved.mean() < 2.0 * exp_set
        r3 = r2.leave(n)
        left = p.ring.moved_mask(r2, r3, keys, rf)
        assert 0.3 * exp_set < left.mean() < 2.0 * exp_set
        o1, o2 = r.owners_np(keys, rf), r2.owners_np(keys, rf)
        untouched = ~(o2 == n).any(axis=1)
        assert (o1[untouched] == o2[untouched]).all()
        return {"prim": prim, "moved": moved, "left": left}
    twin(drill)


def test_token_bucket_rate_bound():
    def drill(p):
        tb = p.mig.TokenBucket(rate=1000.0, burst=100)
        first = [tb.take(50), tb.take(100), tb.take(100)]
        assert first == [50, 50, 0]
        time.sleep(0.05)
        got = tb.take(1000)
        assert 20 <= got <= 100, got
        assert p.mig.TokenBucket(rate=0, burst=1).take(10**6) == 10**6
        return first
    twin(drill)


def test_breaker_force_open_semantics():
    def drill(p):
        cb = p.fail.CircuitBreaker
        br = cb(failures_to_open=3, cooldown_s=0.01, jitter=0.0)
        br.force_open()
        assert br.state == cb.OPEN and not br.ready()
        time.sleep(0.05)
        assert br.state == cb.OPEN and not br.allow()
        assert br.stats["forced_opens"] == 1
        br2 = cb(failures_to_open=3, cooldown_s=0.01, jitter=0.0)
        br2.force_open(0.03)
        assert not br2.ready()
        time.sleep(0.05)
        assert br2.ready() and br2.allow()
        br2.record_success()
        assert br2.state == cb.CLOSED
        return {"permanent": (br.state, dict(br.stats)),
                "quarantine": (br2.state, dict(br2.stats))}
    twin(drill)


def test_breaker_down_for_latch():
    def drill(p):
        cb = p.fail.CircuitBreaker
        br = cb(failures_to_open=1, cooldown_s=0.01, jitter=0.0)
        assert br.down_for() == 0.0
        br.record_failure()
        assert br.state == cb.OPEN
        t0 = br.down_for()
        assert t0 > 0.0
        time.sleep(0.02)
        assert br.ready()
        br.record_failure()
        assert br.down_for() > t0
        br.record_success()
        assert br.down_for() == 0.0
        return (br.state, dict(br.stats))
    twin(drill)


# --- 2. conformance and the wire -------------------------------------------


def _serve(p, kv):
    return p.net.NetServer(lambda: p.be.DirectBackend(kv)).start()


def test_ring_off_conformance(monkeypatch):
    def drill(p):
        eps = [p.be.LocalBackend(W) for _ in range(3)]
        g = _group(p, eps)
        try:
            keys = _keys(512, seed=41)
            h = hash_u64_np(keys[:, 0], keys[:, 1], seed=0x5EC0_11D5)
            prim = (h % np.uint32(3)).astype(np.int64)
            want = (prim[:, None] + np.arange(2)) % 3
            assert (g._members(keys) == want).all()
            assert g.ring is None and g.migrator is None
            with pytest.raises(RuntimeError):
                g.add_endpoint(p.be.LocalBackend(W))
            with pytest.raises(RuntimeError):
                g.remove_endpoint(0)
            pages = _pages(keys)
            g.put(keys, pages)
            sizes = [len(e._store) for e in eps]
            for e in range(3):
                assert sizes[e] == int((want == e).any(axis=1).sum())
        finally:
            g.close()
        srv = _serve(p, p.KV(_cfg(p)))
        try:
            be = p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None)
            assert not be.elastic
            assert be.ring_note(1, 3) is None
            be.handoff(keys[:4], pages[:4])
            out, found = be.get(keys[:4])
            assert found.all() and (out == pages[:4]).all()
            assert srv.stats["ring_notes"] == 0
            assert srv.stats["handoff_pages"] == 0
            be.close()
        finally:
            stop(srv)
        return {"members": want, "sizes": sizes, "out": out}
    monkeypatch.setenv("PMDFC_RING", "off")
    twin(drill)


def test_ring_note_bumps_directory_epoch_and_handoff_counts():
    def drill(p):
        kv = p.KV(_cfg(p))
        srv = _serve(p, kv)
        try:
            be = p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None, directory=True)
            assert be.elastic
            keys = _keys(64, seed=43)
            pages = _pages(keys)
            be.put(keys, pages)
            assert be.dir_refresh()
            out, found = be.get(keys)
            assert found.all() and (out == pages).all()
            e0 = kv.dir_epoch
            new_epoch = be.ring_note(epoch=7, members=4)
            assert new_epoch == e0 + 1
            assert not be.directory.ready()
            assert srv.stats["ring_notes"] == 1
            assert srv.stats["ring_epoch"] == 7
            out, found = be.get(keys)
            assert found.all() and (out == pages).all()
            assert be.dir_refresh() and be.directory.ready()
            k2 = keys.copy()
            k2[:, 0] ^= 0x8000
            be.handoff(k2, pages)
            out, found = be.get(k2)
            assert found.all() and (out == pages).all()
            assert srv.stats["handoff_pages"] == len(k2)
            be.close()
            st = {k: int(srv.stats[k]) for k in (
                "ring_notes", "ring_epoch", "handoff_pages")}
        finally:
            stop(srv)
        # the epoch starts at a random word in both packages (a restarted
        # server never reuses one): only its step is compared
        return {"bump": new_epoch - e0, "srv": st,
                "stats": counters(kv.stats())}
    twin(drill)


# --- 3. the real-server drills ---------------------------------------------


class _Cluster:
    """N `NetServer`s of one package over `KV`s, spawned and stopped
    mid-soak (slots append-only, ports stable per slot)."""

    def __init__(self, p, n: int):
        self.p, self.kvs, self.servers, self.ports = p, [], [], []
        for _ in range(n):
            self.spawn()

    def spawn(self) -> int:
        kv = self.p.KV(_cfg(self.p))
        srv = _serve(self.p, kv)
        self.kvs.append(kv)
        self.servers.append(srv)
        self.ports.append(srv.port)
        return len(self.servers) - 1

    def stop(self, i: int) -> None:
        if self.servers[i] is not None:
            stop(self.servers[i])
            self.servers[i] = None
            self.kvs[i] = None

    def endpoint(self, i: int):
        p = self.p

        def factory(i=i):
            return p.net.TcpBackend("127.0.0.1", self.ports[i],
                                    page_words=W, keepalive_s=None,
                                    op_timeout_s=10.0)

        return p.fail.ReconnectingClient(factory, page_words=W,
                                         retry_delay_s=0.005,
                                         max_retry_delay_s=0.05,
                                         seed=97 + i)

    def close(self) -> None:
        for i in range(len(self.servers)):
            self.stop(i)


def test_breaker_driven_auto_replacement():
    def drill(p):
        cl = _Cluster(p, 3)
        spares: list = []

        def spare_factory(failed_slot):
            i = cl.spawn()
            spares.append((failed_slot, i))
            return cl.endpoint(i)

        cfg = p.conf.ReplicaConfig(
            n_replicas=3, rf=2, repair_interval_s=0, hedge_ms=0,
            breaker_failures=2, breaker_cooldown_s=30.0, breaker_jitter=0.0,
            auto_replace_after_s=0.05,
            ring=p.conf.RingConfig(migrate_pages_per_s=0))
        g = p.ReplicaGroup([cl.endpoint(i) for i in range(3)], page_words=W,
                           cfg=cfg, spare_factory=spare_factory)
        try:
            keys = _keys(256, seed=53)
            pages = _pages(keys)
            g.put(keys, pages)
            g.repair_tick()
            assert dict(g.counters)["auto_replacements"] == 0
            cl.stop(1)
            for i in range(0, 96, 8):
                g.get(keys[i:i + 8])
            assert g.breakers[1].state != p.fail.CircuitBreaker.CLOSED
            assert g.breakers[1].down_for() > 0
            time.sleep(0.08)
            g.repair_tick()
            assert dict(g.counters)["auto_replacements"] == 1
            assert spares == [(1, 3)]
            assert g.ring.members == (0, 2, 3)
            assert g.drain_migration(30)
            assert 1 in g._dead
            g.repair_tick()
            assert dict(g.counters)["auto_replacements"] == 1
            out, found = g.get(keys)
            assert (out[found] == pages[found]).all()
            assert int(found.sum()) >= int(0.8 * len(keys)), int(found.sum())
            return {"spares": spares, "members": g.ring.members,
                    "dead": sorted(g._dead), "epoch": g.ring.epoch,
                    "auto": dict(g.counters)["auto_replacements"]}
        finally:
            g.close()
            cl.close()
    twin(drill)


def _storm(g, keys, pages, steps, seed, on_step=None) -> dict:
    rng = np.random.default_rng(seed)
    st = {"gets": 0, "hits": 0, "wrong_bytes": 0}
    for step in range(steps):
        if on_step is not None:
            on_step(step)
        op = rng.integers(4)
        lo = int(rng.integers(0, len(keys) - 16))
        sel = slice(lo, lo + int(rng.integers(1, 16)))
        if op == 0:
            g.put(keys[sel], pages[sel])
        else:
            out, found = g.get(keys[sel])
            st["gets"] += sel.stop - sel.start
            st["hits"] += int(found.sum())
            good = pages[sel]
            st["wrong_bytes"] += int(
                (out[found] != good[found]).any(axis=1).sum())
        g.repair_tick()
    return st


STEPS = 220
SCHEDULE = ((40, "grow", None), (70, "grow", None), (120, "shrink", 0),
            (150, "shrink", 1), (180, "shrink", 2))


def test_elastic_chaos_scale_3_5_2_mid_soak(tmp_path):
    def drill(p):
        dump = tmp_path / p.conf.__name__
        p.tele.configure(p.conf.TelemetryConfig(
            enabled=True, dump_dir=str(dump), dump_min_interval_s=0.0))
        keys = _keys(224, seed=55)
        pages = _pages(keys)
        cl0 = _Cluster(p, 3)
        g0 = _group(p, [cl0.endpoint(i) for i in range(3)])
        try:
            g0.put(keys, pages)
            base = _storm(g0, keys, pages, STEPS, seed=55)
        finally:
            g0.close()
            cl0.close()
        assert base["wrong_bytes"] == 0
        base_rate = base["hits"] / max(1, base["gets"])
        cl = _Cluster(p, 3)
        g = _group(p, [cl.endpoint(i) for i in range(3)])
        owed = [0]

        def change(kind, slot):
            g.drain_migration(20)
            old = g.ring
            if kind == "grow":
                g.add_endpoint(cl.endpoint(cl.spawn()))
            else:
                g.remove_endpoint(slot)
            owed[0] += int(p.ring.moved_mask(old, g.ring, keys, 2).sum())

        plan = {s: (k, slot) for s, k, slot in SCHEDULE}

        def on_step(step):
            if step in plan:
                change(*plan[step])

        try:
            g.put(keys, pages)
            faulted = _storm(g, keys, pages, STEPS, seed=55, on_step=on_step)
            assert faulted["wrong_bytes"] == 0, "wrong bytes mid-scale"
            rate = faulted["hits"] / max(1, faulted["gets"])
            assert rate >= 0.8 * base_rate, (rate, base_rate)
            assert g.drain_migration(30)
            assert g.ring.members == (3, 4)
            for s in (0, 1, 2):
                cl.stop(s)
            out, found = g.get(keys)
            assert (out[found] == pages[found]).all()
            assert found.mean() >= 0.95, found.mean()
            mig = dict(g.migrator.scope)
            assert mig["moved_pages"] > 0 and mig["transitions"] == 5
            assert (mig["moved_join"] + mig["moved_leave"]
                    + mig["moved_replace"]) == mig["moved_pages"]
            assert mig["candidate_keys"] <= 2 * owed[0] + 1
            grp = g.stats()["group"]
            assert grp["misses"] == (grp["miss_replica_exhausted"]
                                     + grp["miss_digest"]
                                     + grp["miss_routed"]
                                     + grp["miss_remote"])
            members = g.ring.members
        finally:
            g.close()
            cl.close()
        dumps = sorted(glob.glob(str(dump / "flight_membership_*.json")))
        assert dumps, "no membership flight dump written"
        doc = json.load(open(dumps[-1]))
        assert doc["rung"].startswith("membership_")
        assert check_flight(doc) == [], check_flight(doc)
        return {"members": members, "transitions": mig["transitions"],
                "owed": owed[0]}
    twin(drill)
