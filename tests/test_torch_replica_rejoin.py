"""PyTorch port: `ReplicaGroup` rejoin drills over the port's
`NetServer`s, and one group across both packages' servers.

- Cold rejoin (the JAX drill's twin): a replica killed, writes go on, it
  comes back empty; once its breaker closes, bloom-guided repair refills
  exactly the keys the ring gives it, and the repaired key set is the
  one JAX's ring names.
- Warm rejoin: the replica's `KV` journals and cuts a full and a delta;
  it is dropped without a close, `journal.warm_restart` brings it back
  from the chain and the journal tail in its `recovering` state on a new
  port, the endpoint factory follows the port, invalidations issued while
  it was down are replayed by its `ReconnectingClient`, repair refills
  the outage's puts, and the group's drain calls `mark_recovered` over
  `MSG_RECOVERY` (`recoveries_completed == 1`).
- `MSG_RINGNOTE` and `MSG_HANDOFF` against the port's server, and the
  ring-off wire half (no elastic capability asked or acked).
- One group over a JAX `NetServer` and two port ones serves byte-exact:
  the wire is the same, byte for byte.
"""

from __future__ import annotations

import socket
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

import pmdfc_tpu.client.backends as jbe
import pmdfc_tpu.config as jconf
import pmdfc_tpu.kv as jkv
import pmdfc_tpu.runtime.net as jnet
from pmdfc_tpu.cluster.ring import HashRing as JHashRing
from pmdfc_tpu_torch.client.backends import DirectBackend
from pmdfc_tpu_torch.client.replica import ReplicaGroup
from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, JournalConfig,
                                    KVConfig, ReplicaConfig)
from pmdfc_tpu_torch.kv import KV, MISS_CAUSE_NAMES
from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
from pmdfc_tpu_torch.runtime.journal import Journal, warm_restart
from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

pytestmark = pytest.mark.torch

W = 16
CFG = KVConfig(index=IndexConfig(capacity=1 << 12),
               bloom=BloomConfig(num_bits=1 << 13), paged=True, page_words=W)
# every case on FAST_CFG asserts a tripped breaker reads "open": its
# cooldown (1 s, up to 1.25 s with jitter) outlasts what a loaded host
# takes between the verb that trips it and the read
FAST_CFG = ReplicaConfig(
    n_replicas=3, rf=2, hedge_ms=50.0, breaker_failures=3,
    breaker_cooldown_s=1.0, breaker_max_cooldown_s=4.0,
    repair_interval_s=0.0, repair_batch=64)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 1:2].astype(np.uint32) * 3 + 1) * np.arange(
        1, W + 1, dtype=np.uint32)


def _stop(srv):
    """Stop a server of either package without waiting out its accept
    loop's join timeout."""
    try:
        srv._lsock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.stop()


def _endpoint(ports, i, seed):
    def factory(i=i):
        return TcpBackend("127.0.0.1", ports[i], page_words=W,
                          keepalive_s=None, op_timeout_s=10.0)

    return ReconnectingClient(factory, page_words=W, retry_delay_s=0.005,
                              max_retry_delay_s=0.05, seed=seed * 31 + i)


def _serve(kv):
    return NetServer(lambda kv=kv: DirectBackend(kv)).start()


def _close_in(g, i, deadline_s=5.0, probe=None):
    """Drive GETs until endpoint i's half-open probe closes its breaker."""
    end = time.time() + deadline_s
    while g.breakers[i].state != "closed" and time.time() < end:
        g.get(probe)
        time.sleep(0.01)
    assert g.breakers[i].state == "closed", "rejoin never probed in"


def _drain_repair(g, deadline_s=10.0):
    end = time.time() + deadline_s
    while time.time() < end:
        g.repair_tick()
        if not g._repair_pending:
            return
        time.sleep(0.01)
    raise AssertionError("repair backlog never drained")


def test_rejoin_triggers_bloom_guided_repair():
    kvs = [KV(CFG, device="cpu") for _ in range(3)]
    srvs = [_serve(kv) for kv in kvs]
    ports = [s.port for s in srvs]
    g = ReplicaGroup([_endpoint(ports, i, 31) for i in range(3)],
                     page_words=W, cfg=FAST_CFG, seed=31)
    try:
        keys = _keys(192, seed=31)
        pages = _pages(keys)
        g.put(keys[:96], pages[:96])
        _stop(srvs[1])
        for _ in range(FAST_CFG.breaker_failures):
            g.put(keys[96:], pages[96:])
        assert g.breakers[1].state == "open"
        kvs[1] = KV(CFG, device="cpu")  # cold: a fresh KV, empty bloom
        srvs[1] = _serve(kvs[1])
        ports[1] = srvs[1].port
        _close_in(g, 1, probe=keys[:16])
        _drain_repair(g)
        assert g.counters["repair_pages"] > 0
        assert g.counters["repair_rounds"] >= 1
        owned = (g._members(keys) == 1).any(axis=1)
        # the placement is JAX's ring
        np.testing.assert_array_equal(
            g.ring.owners_np(keys, 2), JHashRing(range(3)).owners_np(keys, 2))
        out, found = kvs[1].get(keys[owned])
        assert found.all(), \
            f"{int((~found).sum())}/{int(owned.sum())} owned keys not repaired"
        assert (out == pages[owned]).all()
        # it holds its share and nothing else: repair wrote no other key
        assert not kvs[1].get(keys[~owned])[1].any()
    finally:
        g.close()
        for s in srvs:
            _stop(s)


def test_warm_rejoin_replays_recovers_and_is_marked_recovered(tmp_path):
    jcfg = JournalConfig(rpo_ops=1, rpo_ms=0.0)  # every record synced
    jdir = str(tmp_path / "wal1")
    kvs = [KV(CFG, device="cpu") for _ in range(3)]
    kvs[1].attach_journal(Journal(jdir, jcfg))
    srvs = [_serve(kv) for kv in kvs]
    ports = [s.port for s in srvs]
    g = ReplicaGroup([_endpoint(ports, i, 7) for i in range(3)],
                     page_words=W, cfg=FAST_CFG, seed=7)
    try:
        keys = _keys(640, seed=7)
        pages = _pages(keys)
        a, b, c, d = keys[:256], keys[256:384], keys[384:448], keys[448:512]
        g.put(a, _pages(a))
        full = str(tmp_path / "full.npz")
        kvs[1].snapshot(full)
        g.put(b, _pages(b))
        delta = str(tmp_path / "d1.npz")
        assert kvs[1].snapshot(delta, delta=True)["kind"] == "delta"
        g.put(c, _pages(c))            # the journal tail only
        gone_before = a[:32]
        g.invalidate(gone_before)
        # the crash: the server stops, the KV and its journal are dropped
        # without a close (every record was synced at rpo_ops=1)
        _stop(srvs[1])
        kvs[1] = None
        for _ in range(FAST_CFG.breaker_failures):
            g.get(a[32:64])
        assert g.breakers[1].state == "open"
        g.put(d, _pages(d))            # while down
        gone_during = b[:24]
        g.invalidate(gone_during)      # journaled by the ReconnectingClient
        out, found = g.get(keys[:512])
        live = np.ones(512, bool)
        live[:32] = False
        live[256:280] = False
        assert found[live].all() and not found[~live].any()
        assert (out[live] == pages[:512][live]).all()

        kv1, rep = warm_restart(CFG, [full, delta], jdir, journal_config=jcfg,
                                device="cpu")
        # the tail: node 1's share of the last put, and the invalidate
        assert rep["puts"] == 1 and rep["deletes"] == 1
        assert rep["pages"] == int((g._members(c) == 1).any(axis=1).sum())
        assert kv1.recovery_info()["recovering"] is True
        kvs[1] = kv1
        srvs[1] = _serve(kv1)
        ports[1] = srvs[1].port        # the factory follows the new port
        own1 = (g._members(keys[:512]) == 1).any(axis=1)
        # before the rejoin: what node 1 acknowledged before the crash
        # is back, byte for byte; the outage's puts are cold misses that
        # count as miss_recovering
        pre = own1 & live & (np.arange(512) < 448)
        o, f = kv1.get(keys[:512][pre])
        assert f.all() and (o == pages[:512][pre]).all()
        assert not kv1.get(gone_before)[1].any()
        s0 = kv1.stats()
        o, f = kv1.get(keys[448:512][own1[448:512]])
        assert not f.any()
        s1 = kv1.stats()
        assert s1["miss_recovering"] - s0["miss_recovering"] == len(f) > 0
        assert s1["miss_cold"] == s0["miss_cold"]
        assert s1["misses"] == sum(s1[k] for k in MISS_CAUSE_NAMES)

        _close_in(g, 1, probe=a[32:48])
        _drain_repair(g)
        assert g.counters["repair_pages"] > 0
        assert g.counters["recoveries_completed"] == 1
        assert kv1.recovery_info()["recovering"] is False
        # after the rejoin: every key node 1 owns, live, serves from it;
        # nothing invalidated is served by it or by the group
        want = own1 & live
        o, f = kv1.get(keys[:512][want])
        assert f.all() and (o == pages[:512][want]).all()
        assert not kv1.get(gone_during)[1].any()
        assert not g.get(np.concatenate([gone_before, gone_during]))[1].any()
    finally:
        g.close()
        for s in srvs:
            if s is not None:
                _stop(s)
        if kvs[1] is not None and kvs[1]._journal is not None:
            kvs[1]._journal.close()


def test_ring_note_bumps_directory_epoch_and_handoff_counts():
    kv = KV(CFG, device="cpu")
    srv = _serve(kv)
    try:
        be = TcpBackend("127.0.0.1", srv.port, page_words=W,
                        keepalive_s=None, directory=True)
        assert be.elastic
        keys = _keys(64, seed=43)
        pages = _pages(keys)
        be.put(keys, pages)
        assert be.dir_refresh()
        e0 = kv.dir_epoch
        assert be.ring_note(epoch=7, members=4) == e0 + 1
        assert not be.directory.ready()
        assert srv.stats["ring_notes"] == 1 and srv.stats["ring_epoch"] == 7
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
    finally:
        _stop(srv)


def test_ring_off_wire_half(monkeypatch):
    monkeypatch.setenv("PMDFC_RING", "off")
    kv = KV(CFG, device="cpu")
    srv = _serve(kv)
    try:
        be = TcpBackend("127.0.0.1", srv.port, page_words=W,
                        keepalive_s=None)
        assert not be.elastic
        assert be.ring_note(1, 3) is None
        keys = _keys(4, seed=3)
        be.handoff(keys, _pages(keys))  # degrades to a plain put
        out, found = be.get(keys)
        assert found.all() and (out == _pages(keys)).all()
        assert srv.stats["ring_notes"] == 0
        assert srv.stats["handoff_pages"] == 0
        be.close()
    finally:
        _stop(srv)


def test_group_over_a_jax_server_and_two_port_servers():
    """A port group across packages: one JAX `NetServer` over a JAX `KV`
    and two port ones. Every put lands on its owners in both packages,
    every GET is byte-exact, failover from the JAX server works, and an
    invalidate reaches every member."""
    jcfg = jkv.KVConfig(index=jconf.IndexConfig(capacity=1 << 12),
                        bloom=jconf.BloomConfig(num_bits=1 << 13),
                        paged=True, page_words=W)
    jk = jkv.KV(jcfg)
    kvs = [jk, KV(CFG, device="cpu"), KV(CFG, device="cpu")]
    srvs = [jnet.NetServer(lambda: jbe.DirectBackend(jk)).start(),
            _serve(kvs[1]), _serve(kvs[2])]
    ports = [s.port for s in srvs]
    g = ReplicaGroup([_endpoint(ports, i, 5) for i in range(3)],
                     page_words=W, cfg=FAST_CFG, seed=5)
    try:
        keys = _keys(160, seed=5)
        pages = _pages(keys)
        g.put(keys, pages)
        own = g.ring.owners_np(keys, 2)
        for i in range(3):
            mask = (own == i).any(axis=1)
            o, f = kvs[i].get(keys[mask])
            assert f.all() and (o == pages[mask]).all(), i
            assert not kvs[i].get(keys[~mask])[1].any(), i
        out, found = g.get(keys)
        assert found.all() and (out == pages).all()
        hit = g.invalidate(keys[:16])
        assert hit.all()
        for kv in kvs:
            assert not kv.get(keys[:16])[1].any()
        _stop(srvs[0])
        srvs[0] = None
        for _ in range(FAST_CFG.breaker_failures):
            g.get(keys[16:])
        assert g.breakers[0].state == "open"
        out, found = g.get(keys[16:])
        assert found.all() and (out == pages[16:]).all()
    finally:
        g.close()
        for s in srvs:
            if s is not None:
                _stop(s)
