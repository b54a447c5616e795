"""PyTorch port: `tests/test_containment.py`'s twins.

Deterministic drills run through both packages on one seed and must
agree exactly: the poison fingerprint (CRC32 of the key batch seeded
with the verb), the `FaultPlan` seam and `FaultyBackend`'s capability
mirror, `ShardQuarantine`'s lifecycle, and `ReplicaGroup`'s deadline
stop. The NetServer wire drills and the plane quarantine drills, which
the JAX suite marks `slow`, run here through the port at the JAX test's
size and are held to its invariants: only the culprit NACKed, within
`ceil(log2 b)` failures, no connection dropped, the resubmit refused;
`miss_deadline` and `miss_quarantined` attributed with
`misses == Σ miss_*` on every surface. Each of these eight runs the JAX
drill itself first, on the same seeds and sizes, so both packages are
held to its assertions, which pin exact values where the drill is
deterministic (the negotiated bits, `poison_ops`, `poison_refused`, the
quarantined shard's causes). Their full size runs on the card
(`chip_smoke.py`, phase 14).
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import pytest
import test_containment as jcont
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import (JAX, PKGS, PORT, cause_sum,  # noqa: F401
                        fresh_jax_registry, registries, stop)

pytestmark = pytest.mark.torch

W = 16


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 0] * 7 + keys[:, 1])[:, None] + np.arange(
        W, dtype=np.uint32)


def _faulty_server(p=PORT, **net_kw):
    plan = p.failure.FaultPlan()
    shared = p.failure.FaultyBackend(
        p.backends.LocalBackend(page_words=W, capacity=1 << 12), plan)
    kw = dict(flush_timeout_us=150_000, settle_us=40_000)
    kw.update(net_kw)
    srv = p.net.NetServer(lambda: shared,
                          net=p.config.NetConfig(**kw)).start()
    return srv, plan


def _tcp(srv, **kw):
    return PORT.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                               keepalive_s=None, **kw)


# -- negotiation ------------------------------------------------------


@pytest.mark.usefixtures("fresh_jax_registry")
def test_nack_negotiation_and_kill_switch(monkeypatch):
    jcont.test_nack_negotiation_and_kill_switch(monkeypatch)
    monkeypatch.undo()
    srv, _ = _faulty_server()
    try:
        with _tcp(srv) as be:
            assert be.nack, "containment not negotiated by default"
        monkeypatch.setenv("PMDFC_CONTAINMENT", "off")
        with _tcp(srv) as be:
            assert not be.nack, "client-side kill switch ignored"
        monkeypatch.delenv("PMDFC_CONTAINMENT")
    finally:
        stop(srv)
    monkeypatch.setenv("PMDFC_CONTAINMENT", "off")
    srv2, _ = _faulty_server()
    monkeypatch.delenv("PMDFC_CONTAINMENT")
    try:
        with _tcp(srv2) as be:
            assert not be.nack, "server-side kill switch ignored"
    finally:
        stop(srv2)


# -- bisection + fingerprint refusal ----------------------------------


@pytest.mark.usefixtures("fresh_jax_registry")
def test_poison_bisection_isolates_culprit():
    """b = 4 connections fuse one flush with one poisoned op: only the
    culprit is NACKed, within ceil(log2 b) failures; every healthy op is
    served and no connection drops; the resubmit is refused at staging
    without a second isolation."""
    jcont.test_poison_bisection_isolates_culprit()
    srv, plan = _faulty_server()
    bad = _keys(8, seed=101)
    plan.poison_keys(bad)
    b = 4
    try:
        bes = [_tcp(srv) for _ in range(b)]
        pools = [_keys(8, seed=50 + i) for i in range(b)]
        barrier = threading.Barrier(b)
        errs: list = []

        def worker(i):
            try:
                barrier.wait()
                ks = bad if i == 0 else pools[i]
                bes[i].put(ks, _pages(ks))
            except Exception as e:  # noqa: BLE001
                errs.append((i, repr(e)))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, f"an op raised through a NACK: {errs}"
        st = srv.stats.snapshot()
        assert st["poison_ops"] == 1, st
        assert st["nacks_sent"] >= 1
        assert st["bisect_failures"] <= math.ceil(math.log2(b)), st
        for i in range(1, b):
            out, found = bes[i].get(pools[i])
            assert found.all(), f"conn{i} lost its batch"
            assert (out == _pages(pools[i])).all()
        _, found = bes[0].get(pools[1])
        assert found.all(), "victim conn was dropped"
        bes[0].put(bad, _pages(bad))
        st = srv.stats.snapshot()
        assert st["poison_refused"] >= 1, st
        assert st["poison_ops"] == 1, "resubmit re-ran isolation"
        for be in bes:
            be.close()
    finally:
        stop(srv)


@pytest.mark.usefixtures("fresh_jax_registry")
def test_poison_fingerprint_is_verb_seeded():
    """The fingerprint is CRC32 of the key batch seeded with the verb, the
    same u32 in both packages; through the port's server a GET for a
    poisoned PUT's keys is its own op (isolated, all-miss), and the GET's
    resubmit is then refused."""
    jcont.test_poison_fingerprint_is_verb_seeded()
    keys = _keys(8, seed=7)
    digests = []
    for p in PKGS:
        ops = [p.net._StagedOp(None, mt, 0, len(keys), 0, keys=keys)
               for mt in (p.net.MSG_PUTPAGE, p.net.MSG_GETPAGE)]
        digests.append([p.net.NetServer._poison_digest(o) for o in ops])
    assert digests[0] == digests[1]
    assert digests[1][0] != digests[1][1]

    srv, plan = _faulty_server()
    plan.poison_keys(keys)
    try:
        with _tcp(srv) as be:
            be.put(keys, _pages(keys))
            refused0 = srv.stats.snapshot()["poison_refused"]
            _, found = be.get(keys)
            assert not found.any(), "poisoned GET must answer all-miss"
            st = srv.stats.snapshot()
            assert st["poison_refused"] == refused0, \
                "a GET was refused under a PUT's fingerprint"
            assert st["poison_ops"] == 2
            _, found = be.get(keys)
            assert not found.any()
            assert srv.stats.snapshot()["poison_refused"] > refused0
    finally:
        stop(srv)


@pytest.mark.usefixtures("fresh_jax_registry")
def test_unnegotiated_peer_keeps_conn_drop_semantics(monkeypatch):
    jcont.test_unnegotiated_peer_keeps_conn_drop_semantics(monkeypatch)
    monkeypatch.undo()
    srv, plan = _faulty_server()
    bad = _keys(8, seed=7)
    plan.poison_keys(bad)
    monkeypatch.setenv("PMDFC_CONTAINMENT", "off")
    try:
        be = _tcp(srv, op_timeout_s=5.0)
        assert not be.nack
        with pytest.raises((ConnectionError, OSError)):
            be.put(bad, _pages(bad))
            be.get(bad)
        be.close()
        monkeypatch.delenv("PMDFC_CONTAINMENT")
        with _tcp(srv) as be2:
            ks = _keys(8, seed=8)
            be2.put(ks, _pages(ks))
            _, found = be2.get(ks)
            assert found.all(), "server did not survive the conn drop"
    finally:
        stop(srv)


# -- deadlines --------------------------------------------------------


@pytest.mark.usefixtures("fresh_jax_registry")
def test_deadline_shed_lands_in_miss_deadline():
    jcont.test_deadline_shed_lands_in_miss_deadline()
    p = PORT
    c = p.config
    kv = p.KV(c.KVConfig(index=c.IndexConfig(capacity=1 << 12),
                         bloom=c.BloomConfig(num_bits=1 << 13),
                         paged=True, page_words=W))
    srv = p.net.NetServer(lambda: p.backends.DirectBackend(kv),
                          net=c.NetConfig(flush_timeout_us=200_000,
                                          settle_us=120_000)).start()
    try:
        with _tcp(srv, deadline_ms=1.0) as be:
            assert be.nack
            ks = _keys(32, seed=3)
            _, found = be.get(ks)
            assert not found.any(), "an expired GET reported hits"
            _, found = be.get(ks[:4])
            assert not found.any()
        st = srv.stats.snapshot()
        assert st["deadline_shed"] >= 1, st
        s = kv.stats()
        assert s["miss_deadline"] >= 32, s
        assert s["misses"] == cause_sum(p, s)
    finally:
        stop(srv)


@pytest.mark.usefixtures("fresh_jax_registry")
def test_deadline_zero_means_none():
    jcont.test_deadline_zero_means_none()
    srv, _ = _faulty_server(flush_timeout_us=100_000, settle_us=60_000)
    try:
        with _tcp(srv) as be:
            ks = _keys(8, seed=4)
            be.put(ks, _pages(ks))
            out, found = be.get(ks)
            assert found.all() and (out == _pages(ks)).all()
        assert srv.stats.snapshot()["deadline_shed"] == 0
    finally:
        stop(srv)


def test_replica_group_deadline_stops_failover():
    import pmdfc_tpu.client.replica as jrep
    import pmdfc_tpu_torch.client.replica as trep

    def script(p):
        c = p.config
        rep = jrep if p is JAX else trep
        out = []
        for deadline in (1e-6, None):
            kw = {} if deadline is None else {"deadline_ms": deadline}
            g = rep.ReplicaGroup(
                [p.backends.LocalBackend(page_words=W, capacity=1 << 10)
                 for _ in range(3)], page_words=W,
                cfg=c.ReplicaConfig(n_replicas=3, rf=2, hedge_ms=0.0,
                                    repair_interval_s=0.0, **kw))
            try:
                _, found = g.get(_keys(16, seed=5))
                out.append((np.asarray(found).tolist(),
                            g.counters["deadline_stops"],
                            g.counters["failover_gets"]))
            finally:
                g.close()
        return out

    a, b = (script(p) for p in PKGS)
    assert a == b
    (f1, stops1, fo1), (f2, stops2, fo2) = b
    assert not any(f1) and stops1 == 1 and fo1 == 0
    assert stops2 == 0 and fo2 > 0


# -- fault seam + quarantine units ------------------------------------


def test_faultplan_seam():
    def script(p):
        f = p.failure
        plan = f.FaultPlan()
        ks = _keys(4, seed=1)
        out = []

        def outcome(fn):
            try:
                fn()
                return "ok"
            except f.ShardFault as e:
                return f"shard {e.shard}"
            except RuntimeError:
                return "raised"

        plan.poison_keys(ks[:1])
        out.append(outcome(lambda: plan.check("put", keys=ks)))
        out.append(outcome(lambda: plan.check("put", keys=ks[1:])))
        plan.clear_poison()
        out.append(outcome(lambda: plan.check("put", keys=ks)))
        plan.fail_shard(2)
        out.append(outcome(lambda: plan.check("get",
                                              shards=np.array([0, 2]))))
        out.append(outcome(lambda: plan.check("get",
                                              shards=np.array([0, 1]))))
        plan.heal_shard(2)
        out.append(outcome(lambda: plan.check("get", shards=np.array([2]))))
        plan.raise_on_op(2)
        out += [outcome(lambda: plan.check("get")) for _ in range(3)]
        return out

    got = [script(p) for p in PKGS]
    assert got[0] == got[1] == ["raised", "ok", "ok", "shard 2", "ok", "ok",
                                "ok", "raised", "ok"]


def test_faulty_backend_capability_mirror():
    def script(p):
        plan = p.failure.FaultPlan()
        inner = p.backends.LocalBackend(page_words=W, capacity=1 << 10)
        fb = p.failure.FaultyBackend(inner, plan)
        caps = [fb.page_words, hasattr(fb, "get"),
                hasattr(fb, "insert_extent"),
                hasattr(fb, "get_fused") == hasattr(inner, "get_fused")]
        ks = _keys(4, seed=2)
        fb.put(ks, _pages(ks))
        out, found = fb.get(ks)
        plan.poison_keys(ks[:1])
        with pytest.raises(RuntimeError):
            fb.get(ks)
        return caps, np.asarray(out).tolist(), np.asarray(found).tolist()

    a, b = (script(p) for p in PKGS)
    assert a == b
    assert b[0] == [W, True, True, True] and all(b[2])


def test_shard_quarantine_unit():
    """The lifecycle through both packages on one seed: two strikes trip
    shard 2, its rows are masked, a half-open probe is granted after the
    jittered cooldown, success re-admits it and its journal drains."""
    def script(p):
        q = p.failure.ShardQuarantine(4, failures_to_open=2,
                                      cooldown_s=0.05, max_cooldown_s=0.2,
                                      backoff=2.0, seed=1)
        shards = np.array([0, 1, 2, 3, 2])
        out = []
        blocked, probing = q.gate(shards)
        out.append((np.asarray(blocked).tolist(), list(probing)))
        out.append((q.note_failure(2), q.note_failure(2), q.quarantined()))
        blocked, _ = q.gate(shards)
        out.append(np.asarray(blocked).tolist())
        q.journal_invalidations(2, _keys(8, seed=3))
        deadline = time.monotonic() + 5.0
        probed = []
        while not probed and time.monotonic() < deadline:
            time.sleep(0.02)
            _, probed = q.gate(shards)
        out.append(list(probed))
        out.append((q.note_success(2), q.quarantined()))
        ks, overflowed = q.drain_journal(2)
        out.append((np.asarray(ks).tolist(), bool(overflowed)))
        rep = q.report()["stats"]
        out.append({k: int(rep[k]) for k in
                    ("trips", "readmits", "journaled_invals")})
        return out

    a, b = (script(p) for p in PKGS)
    assert a == b
    assert b[0] == ([False] * 5, [])
    assert b[1] == (False, True, [2])
    assert b[2] == [False, False, True, False, True]
    assert b[3] == [2] and b[4] == (True, [])
    assert len(b[5][0]) == 8 and not b[5][1]
    assert b[6] == {"trips": 1, "readmits": 1, "journaled_invals": 8}


# -- shard quarantine through the serving plane -----------------------


def _plane(containment=True, capacity=1 << 10):
    from pmdfc_tpu_torch.parallel.plane import make_serving_backend
    from pmdfc_tpu_torch.parallel.shard import make_mesh

    c = PORT.config
    plan = PORT.failure.FaultPlan()
    cfg = c.KVConfig(index=c.IndexConfig(capacity=capacity),
                     bloom=c.BloomConfig(num_bits=1 << 12),
                     paged=True, page_words=W)
    kw = {}
    if containment:
        kw["containment"] = c.ContainmentConfig(
            quarantine_failures=2, quarantine_cooldown_s=0.05,
            quarantine_max_cooldown_s=0.2)
    be = make_serving_backend(cfg, mesh=make_mesh(["cpu"] * 4),
                              fault_plan=plan, **kw)
    return be, plan


def _assert_shards_reconciled(rep):
    names = PORT.kv_mod.MISS_CAUSE_NAMES
    for i in range(len(rep["misses"])):
        assert int(rep["misses"][i]) == sum(int(rep[k][i]) for k in names)


@pytest.mark.usefixtures("fresh_jax_registry")
def test_plane_shard_quarantine_and_readmission():
    """A 4-shard plane on the CPU: kill one shard via the fault seam; its
    breaker trips, its rows degrade to `miss_quarantined` while the
    healthy shards serve, `misses == Σ miss_*` on `stats()` and on every
    row of `shard_report()`, and healing re-admits it through the
    half-open probe with its keys intact."""
    jcont.test_plane_shard_quarantine_and_readmission()
    be, plan = _plane()
    skv = be.skv
    pool = _keys(128, seed=7)
    be.put(pool, _pages(pool))
    _, res = be.get(pool)
    pool = pool[np.asarray(res, bool)]
    node = skv.node_of(pool)
    k = int(np.bincount(node, minlength=4).argmax())
    on_k = pool[node == k]
    assert len(on_k) and (node != k).any()

    plan.fail_shard(k)
    for _ in range(8):
        try:
            be.get(pool[:32])
        except PORT.failure.ShardFault:
            pass
        if be.quarantine.quarantined():
            break
    assert be.quarantine.quarantined() == [k]
    out, found = be.get(pool)
    f = np.asarray(found, bool)
    assert not f[node == k].any(), "a quarantined row claimed a hit"
    assert f[node != k].all(), "a healthy shard lost rows"
    assert (np.asarray(out)[f] == _pages(pool)[f]).all()
    st = skv.stats()
    assert st["miss_quarantined"] >= int((node == k).sum()), st
    assert st["misses"] == cause_sum(PORT, st)
    rep = skv.shard_report()["stats"]
    _assert_shards_reconciled(rep)
    assert rep["miss_quarantined"][k] > 0

    plan.heal_shard(k)
    deadline = time.monotonic() + 10.0
    while be.quarantine.quarantined() and time.monotonic() < deadline:
        time.sleep(0.02)
        try:
            be.get(on_k[:16])
        except PORT.failure.ShardFault:
            pass
    assert not be.quarantine.quarantined(), "shard never re-admitted"
    out, found = be.get(on_k)
    assert np.asarray(found, bool).all(), \
        "resident keys lost across quarantine"
    assert (np.asarray(out) == _pages(on_k)).all()
    st = skv.stats()
    assert st["misses"] == cause_sum(PORT, st)
    assert be.quarantine.report()["stats"]["readmits"] >= 1


@pytest.mark.usefixtures("fresh_jax_registry")
def test_plane_containment_off_is_conformant(monkeypatch):
    jcont.test_plane_containment_off_is_conformant(monkeypatch)
    monkeypatch.undo()
    monkeypatch.setenv("PMDFC_CONTAINMENT", "off")
    be, plan = _plane(containment=False)
    assert be.quarantine is None
    pool = _keys(32, seed=9)
    be.put(pool, _pages(pool))
    _, found = be.get(pool)
    f = np.asarray(found, bool)
    out, _ = be.get(pool[f])
    assert (np.asarray(out) == _pages(pool[f])).all()
    plan.fail_shard(0)
    with pytest.raises(PORT.failure.ShardFault):
        for _ in range(4):
            be.get(pool)
    st = be.skv.stats()
    assert st["miss_quarantined"] == 0 and st["miss_deadline"] == 0

