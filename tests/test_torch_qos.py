"""PyTorch port: `tests/test_qos.py`'s twins.

Each test runs the JAX test's drill through both packages on the same
seed. Where the drill is deterministic (tags, the token bucket, DRR
shares and debt, the shed ladder, `account_shed` over `KV` and
`ShardedKV`, the `check_qos` pins over a lane snapshot, the autotune
knobs, config validation) the two packages' outputs must be equal: pages,
found masks, every stats counter and every lane counter. The NetServer
drills that the JAX suite marks `slow` (the wire shed drill and the
`PMDFC_QOS=off` conformance) run here through the port at the JAX test's
size and are held to the JAX test's invariants; their full size runs on
the card (`chip_smoke.py`, phase 14).
"""

from __future__ import annotations

import numbers
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import (JAX, PKGS, PORT, cause_sum, counters,  # noqa: F401
                        registries, stop)

from tools.check_teledump import _MISS_CAUSES, check, check_qos

pytestmark = pytest.mark.torch

W = 16


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 0] * 7 + keys[:, 1])[:, None] + np.arange(
        W, dtype=np.uint32)


def _op(tid=0, count=1, mt=5, shed_ok=True):
    return types.SimpleNamespace(tid=tid, count=count, mt=mt,
                                 shed_ok=shed_ok)


def _plane(p, **kw):
    c = p.config
    tenants = tuple(c.TenantConfig(**t) for t in kw.pop("tenants"))
    p.tele.configure(c.TelemetryConfig())
    return p.qos.QosPlane(c.QosConfig(tenants=tenants, **kw), "t")


def _both(script):
    a, b = (script(p) for p in PKGS)
    assert a == b, f"jax {a}\nport {b}"
    return b


# -- namespace tagging -------------------------------------------------


def test_tag_roundtrip_and_payload_preserved():
    oids = np.array([0, 1, 0x0FFF_FFFF, 12345], np.uint32)

    def script(p):
        out = []
        for tid in (0, 1, 7, 15):
            tagged = p.qos.tag_oids(oids, tid, 4)
            assert (np.asarray(p.qos.tenant_of(tagged, 4)) == tid).all()
            assert ((tagged & np.uint32(0x0FFF_FFFF)) == oids).all()
            out.append(np.asarray(tagged).tolist())
        with pytest.raises(ValueError):
            p.qos.tag_oids(oids, 16, 4)
        return out

    _both(script)


def test_client_tag_agrees_with_plane_tag():
    oids = _keys(64, seed=3)[:, 0] & np.uint32(0x0FFF_FFFF)

    def script(p):
        cc = p.cleancache.CleanCacheClient(
            p.backends.LocalBackend(page_words=W, capacity=1 << 10),
            tenant=5, tenant_bits=4)
        tag = np.asarray(cc._tag(oids))
        np.testing.assert_array_equal(tag, p.qos.tag_oids(oids, 5, 4))
        return tag.tolist()

    _both(script)


def test_untagged_and_unregistered_resolve_to_default():
    def script(p):
        plane = _plane(p, tenant_bits=4, tenants=(dict(tid=3),))
        untagged = np.array([[123, 4]], np.uint32)
        tagged = untagged.copy()
        tagged[:, 0] = p.qos.tag_oids(tagged[:, 0], 3, 4)
        stranger = untagged.copy()
        stranger[:, 0] = p.qos.tag_oids(stranger[:, 0], 9, 4)
        return [plane.resolve(x) for x in (
            None, np.zeros((0,), np.uint32), untagged, tagged, stranger)]

    assert _both(script) == [0, 0, 0, 3, 0]


# -- token bucket ------------------------------------------------------


def test_token_bucket_all_or_nothing_and_unlimited():
    def script(p):
        b = p.qos.TokenBucket(rate=1.0, burst=4)
        out = [b.take(4), b.take(1), b.take(8)]
        free = p.qos.TokenBucket(rate=0.0, burst=1)
        out.append(all(free.take(1 << 20) for _ in range(100)))
        out += [b.set_rate(25.0), b.rate(), b.set_rate(-5.0)]
        return out

    assert _both(script) == [True, False, False, True, 25.0, 25.0, 0.0]


# -- DRR drain ---------------------------------------------------------


def test_drr_composition_follows_weights():
    def script(p):
        plane = _plane(p, tenant_bits=4, quantum_ops=4, tenants=(
            dict(tid=1, weight=3), dict(tid=2, weight=1)))
        for _ in range(50):
            plane.stage(_op(tid=1))
            plane.stage(_op(tid=2))
        out = [o.tid for o in plane.drain(16)]
        depth = plane.depth()
        rest = [o.tid for o in plane.drain(1 << 20)]
        return out, depth, rest, plane.depth()

    out, depth, rest, left = _both(script)
    got = np.bincount(out, minlength=3)
    assert (got[1], got[2]) == (12, 4)
    assert depth == 84 and len(rest) == 84 and left == 0


def test_drr_serves_whole_ops_and_repays_debt():
    def script(p):
        plane = _plane(p, tenant_bits=4, quantum_ops=2, tenants=(
            dict(tid=1, weight=1),))
        plane.stage(_op(tid=1, count=64))
        plane.stage(_op(tid=1, count=1))
        first = [o.count for o in plane.drain(1)]
        second = [o.count for o in plane.drain(1)]
        return first, second, plane.depth()

    assert _both(script) == ([64], [1], 0)


# -- shed ladder -------------------------------------------------------


def test_shed_ladder_lowest_priority_newest_first():
    def script(p):
        plane = _plane(p, tenant_bits=4, shed_threshold=8, shed_batch=16,
                       tenants=(dict(tid=1, priority=2),
                                dict(tid=2, priority=1)))
        for i in range(6):
            plane.stage(_op(tid=1, count=1))
            plane.stage(_op(tid=2, count=10 + i))
        victims = plane.shed_overflow(lambda op: op.shed_ok)
        depth = plane.depth()
        survivors = plane.drain(1 << 20)
        return ([(v.tid, v.count) for v in victims], depth,
                [(o.tid, o.count) for o in survivors])

    victims, depth, survivors = _both(script)
    assert victims == [(2, c) for c in (15, 14, 13, 12, 11)]
    assert depth == 7
    assert sum(1 for t, _ in survivors if t == 1) == 6
    assert [c for t, c in survivors if t == 2] == [10]


def test_shed_ladder_spares_nonsheddable_ops():
    def script(p):
        plane = _plane(p, tenant_bits=4, shed_threshold=2, shed_batch=16,
                       tenants=(dict(tid=2, priority=1),))
        ops = [_op(tid=2, count=1, shed_ok=False)]
        ops += [_op(tid=2, count=1) for _ in range(4)]
        for op in ops:
            plane.stage(op)
        victims = plane.shed_overflow(lambda op: op.shed_ok)
        drained = plane.drain(1 << 20)
        return ([ops.index(v) for v in victims],
                [ops.index(o) for o in drained])

    victims, drained = _both(script)
    assert 0 not in victims and victims and 0 in drained


# -- miss_shed attribution --------------------------------------------


def test_kv_account_shed_keeps_causes_exact():
    def script(p):
        c = p.config
        kv = p.KV(c.KVConfig(index=c.IndexConfig(capacity=1 << 10),
                             bloom=c.BloomConfig(num_bits=1 << 13),
                             paged=True, page_words=W))
        keys = _keys(32)
        kv.insert(keys, _pages(keys))
        out, found = kv.get(_keys(16, seed=9))
        kv.account_shed(gets=5, puts=2)
        st = counters(kv.stats())
        return np.asarray(out).tolist(), np.asarray(found).tolist(), st

    _, _, st = _both(script)
    assert st["miss_shed"] == 5 and st["drops"] >= 2
    assert st["misses"] == cause_sum(PORT, st)


def test_sharded_account_shed_keeps_causes_exact():
    import jax

    from pmdfc_tpu.parallel.shard import ShardedKV as JSharded
    from pmdfc_tpu.parallel.shard import make_mesh as jmesh
    from pmdfc_tpu_torch.parallel.shard import ShardedKV as TSharded
    from pmdfc_tpu_torch.parallel.shard import make_mesh as tmesh

    def script(p):
        c = p.config
        cfg = c.KVConfig(index=c.IndexConfig(capacity=1 << 12),
                         bloom=c.BloomConfig(num_bits=1 << 15), paged=False)
        skv = (JSharded(cfg, mesh=jmesh(np.array(jax.devices()[:4])))
               if p is JAX else TSharded(cfg, mesh=tmesh(["cpu"] * 4)))
        skv.account_shed(gets=3, puts=1)
        st = counters(skv.stats())
        rep = {k: [int(x) for x in v]
               for k, v in skv.shard_report()["stats"].items()}
        return st, rep

    st, rep = _both(script)
    assert st["miss_shed"] == 3 and st["misses"] == cause_sum(PORT, st)
    assert sum(rep["miss_shed"]) == 3
    assert sum(rep["misses"]) == sum(
        sum(rep[k]) for k in PORT.kv_mod.MISS_CAUSE_NAMES)


def test_wire_shed_drill_end_to_end():
    """The JAX test's drill (`slow` there) through the port's NetServer
    and TcpBackend: a tenant whose verbs exceed its bucket's burst sheds
    deterministically at the edge, every shed lands in `miss_shed` on the
    KV and on the wire document, the untagged tenant is untouched, and
    the live teledump passes the checker."""
    p = PORT
    c = p.config
    kv = p.KV(c.KVConfig(index=c.IndexConfig(capacity=1 << 12),
                         bloom=c.BloomConfig(num_bits=1 << 13),
                         paged=True, page_words=W))
    qcfg = c.QosConfig(tenant_bits=4, tenants=(
        c.TenantConfig(tid=2, rate_ops_per_s=1.0, burst_ops=4),))
    srv = p.net.NetServer(lambda: p.backends.DirectBackend(kv),
                          net=c.NetConfig(), qos=qcfg).start()
    try:
        assert srv.qos_plane() is not None
        with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                              keepalive_s=None) as be:
            good = _keys(64, seed=1)
            be.put(good, _pages(good))
            out, found = be.get(good)
            assert found.all() and (out == _pages(good)).all()
            bad = _keys(24, seed=2)
            bad[:, 0] = p.qos.tag_oids(bad[:, 0], 2, 4)
            be.put(bad[:8], _pages(bad[:8]))
            for i in range(3):
                _, found = be.get(bad[i * 8:(i + 1) * 8])
                assert not found.any()
            doc = be.server_stats()
        st = kv.stats()
        assert st["miss_shed"] == 24 and st["drops"] >= 8
        assert st["misses"] == cause_sum(p, st)
        assert int(doc["miss_shed"]) == 24
        assert int(doc["misses"]) == cause_sum(p, doc)
        sc = dict(srv.qos_plane().scope(2))
        assert sc["ops"] == 4 and sc["shed_edge"] == 4
        assert sc["staged"] == 0 and sc["shed_ladder"] == 0
        assert sc["shed_gets"] == 3 and sc["shed_puts"] == 1
        assert dict(srv.qos_plane().scope(0))["shed_edge"] == 0
        assert check(doc) == []
    finally:
        stop(srv)


# -- check_qos pins over the port's lane snapshot ----------------------


def _lane_snapshot(p) -> dict:
    """A tenant lane's counters and gauges as each package's registry
    holds them after the serving edge's accounting on a live plane: ten
    verbs against a bucket of six (no refill to speak of), the six staged
    ones over the ladder's threshold of four."""
    c = p.config
    p.tele.configure(c.TelemetryConfig(enabled=True))
    plane = p.qos.QosPlane(c.QosConfig(
        tenant_bits=4, shed_threshold=4, shed_batch=8, tenants=(
            c.TenantConfig(tid=2, weight=3, priority=1,
                           rate_ops_per_s=1e-3, burst_ops=6),)),
        "net.server")
    for i in range(10):
        op = _op(tid=2, count=1, mt=i % 2)
        staged = plane.admit(2, op.count)
        plane.note_arrival(2, staged)
        if staged:
            plane.stage(op)
        else:
            plane.note_shed_verbs(2, gets=op.mt, puts=1 - op.mt)
    for op in plane.shed_overflow(lambda op: op.shed_ok):
        plane.note_shed_verbs(2, gets=op.mt, puts=1 - op.mt, ladder=True)
    plane.drain(1 << 20)
    snap = p.tele.snapshot()
    keep = ".qos.t2."
    return {"counters": {k: v for k, v in snap["counters"].items()
                         if keep in k},
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if keep in k}}


@pytest.fixture(scope="module")
def lane_snapshot():
    state = JAX.tele._STATE
    found = (state.registry, state.tracing)
    try:
        a, b = (_lane_snapshot(p) for p in PKGS)
    finally:
        state.registry, state.tracing = found
    assert a == b
    lanes = {k.rsplit(".", 1)[1]: v for k, v in b["counters"].items()}
    assert lanes == dict(ops=10, staged=6, shed_edge=4, shed_ladder=3,
                         shed_gets=4, shed_puts=3)
    return b


def _copy(snap):
    out = {"counters": dict(snap["counters"]),
           "gauges": dict(snap["gauges"])}
    pfx = next(iter(out["counters"])).rsplit(".", 1)[0] + "."
    return out, pfx


def test_check_qos_accepts_consistent_lanes(lane_snapshot):
    assert check_qos(lane_snapshot) == []
    assert check_qos({"counters": {}, "gauges": {}}) == []


@pytest.mark.parametrize("mutate, needle", [
    (lambda c, g, pfx: c.update({pfx + "ops": c[pfx + "ops"] + 1}),
     "conservation"),
    (lambda c, g, pfx: c.update({pfx + "shed_ladder":
                                 c[pfx + "staged"] + 1}), "shed"),
    (lambda c, g, pfx: c.update({pfx + "shed_gets":
                                 c[pfx + "shed_gets"] - 2}), "shed_gets"),
    (lambda c, g, pfx: g.update({pfx + "weight": 0}), "weight"),
    (lambda c, g, pfx: g.update({pfx + "rate": -1.0}), "rate"),
], ids=["ops", "shed_ladder", "shed_gets", "weight", "rate"])
def test_check_qos_rejects_drift(lane_snapshot, mutate, needle):
    snap, pfx = _copy(lane_snapshot)
    mutate(snap["counters"], snap["gauges"], pfx)
    errs = check_qos(snap)
    assert errs, f"drift {needle} not caught"
    assert any(needle in e or "drift" in e for e in errs)


def test_check_qos_rejects_straggler_lanes(lane_snapshot):
    snap, pfx = _copy(lane_snapshot)
    del snap["counters"][pfx + "shed_ladder"]
    assert any("travel together" in e for e in check_qos(snap))


def test_miss_shed_in_cause_taxonomy():
    assert "miss_shed" in _MISS_CAUSES
    assert "miss_shed" in PORT.kv_mod.MISS_CAUSE_NAMES
    assert PORT.kv_mod.MISS_CAUSE_NAMES == JAX.kv_mod.MISS_CAUSE_NAMES


# -- PMDFC_QOS=off conformance ----------------------------------------


def test_qos_off_is_single_tenant_fifo(monkeypatch):
    """The JAX test's drill (`slow` there) through the port: a server
    built with a QosConfig under `PMDFC_QOS=off` carries no plane and no
    tenant scope and serves the throttled tenant whole; the client edge
    stops tagging."""
    p = PORT
    c = p.config
    monkeypatch.setenv("PMDFC_QOS", "off")
    qcfg = c.QosConfig(tenant_bits=4, tenants=(
        c.TenantConfig(tid=2, rate_ops_per_s=1.0, burst_ops=1),))
    shared = p.backends.LocalBackend(page_words=W, capacity=1 << 12)
    srv = p.net.NetServer(lambda: shared, net=c.NetConfig(),
                          qos=qcfg).start()
    try:
        assert srv._qos is None
        with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                              keepalive_s=None) as be:
            keys = _keys(32, seed=4)
            keys[:, 0] = p.qos.tag_oids(keys[:, 0], 2, 4)
            be.put(keys, _pages(keys))
            out, found = be.get(keys)
            assert found.all() and (out == _pages(keys)).all()
            doc = be.server_stats()
        snap = doc.get("telemetry") or {}
        assert not any(".qos.t" in k for k in (snap.get("counters") or {}))
        assert not any(".qos.t" in k for k in (snap.get("gauges") or {}))
    finally:
        stop(srv)
    cc = p.cleancache.CleanCacheClient(
        p.backends.LocalBackend(page_words=W, capacity=1 << 10),
        tenant=5, tenant_bits=4)
    oids = np.array([1, 2, 3], np.uint32)
    np.testing.assert_array_equal(cc._tag(oids), oids)


# -- autotune knob registration ---------------------------------------


def test_autotune_registers_rate_limited_tenants_only():
    import pmdfc_tpu.runtime.autotune as jauto
    import pmdfc_tpu_torch.runtime.autotune as tauto

    def script(p):
        c = p.config
        auto = jauto if p is JAX else tauto
        p.tele.configure(c.TelemetryConfig(enabled=True))
        qcfg = c.QosConfig(tenant_bits=4, tenants=(
            c.TenantConfig(tid=1, weight=3),
            c.TenantConfig(tid=2, rate_ops_per_s=100.0),
            c.TenantConfig(tid=3, rate_ops_per_s=50.0,
                           rate_lo=10.0, rate_hi=1000.0)))
        shared = p.backends.LocalBackend(page_words=W, capacity=1 << 12)
        srv = p.net.NetServer(lambda: shared, net=c.NetConfig(),
                              qos=qcfg).start()
        try:
            ctl = auto.attach(server=srv, cfg=c.AutotuneConfig())
            kvals = ctl.knob_values()
            qos_knobs = {k: v for k, v in kvals.items()
                         if k.startswith("qos_rate_t")}
            env = {k: (ctl._knobs[k].lo, ctl._knobs[k].hi)
                   for k in qos_knobs}
            set_to = srv.set_qos_rate(2, 60.0)
            live = srv.qos_plane().rate(2)
            moved = kvals != ctl.knob_values()
        finally:
            stop(srv)
        return qos_knobs, env, set_to, live, moved

    knobs, env, set_to, live, moved = _both(script)
    assert knobs["qos_rate_t2"] == 100.0 and "qos_rate_t3" in knobs
    assert "qos_rate_t0" not in knobs and "qos_rate_t1" not in knobs
    assert env["qos_rate_t2"] == (25.0, 400.0)
    assert env["qos_rate_t3"] == (10.0, 1000.0)
    assert set_to == 60.0 and live == 60.0 and moved


# -- concurrency discipline -------------------------------------------


def test_lock_rank_and_module_coverage_pins():
    from pmdfc_tpu_torch.runtime.sanitizer import HIERARCHY
    from tools.analyze.lockorder import RANKED_MODULES

    assert "TokenBucket._lock" in HIERARCHY
    assert HIERARCHY["NetServer._flush_cv"] \
        < HIERARCHY["TokenBucket._lock"] \
        < HIERARCHY["TcpBackend._lock"]
    assert "runtime/qos.py" in RANKED_MODULES
    assert (PORT.qos.__file__.replace("\\", "/")
            .endswith("pmdfc_tpu_torch/runtime/qos.py"))


def test_config_validation():
    def script(p):
        c = p.config
        raised = []
        for make in (lambda: c.QosConfig(tenant_bits=0),
                     lambda: c.QosConfig(tenant_bits=2, tenants=(
                         c.TenantConfig(tid=4),)),
                     lambda: c.QosConfig(tenants=(c.TenantConfig(tid=1),
                                                  c.TenantConfig(tid=1))),
                     lambda: c.TenantConfig(tid=1, weight=0),
                     lambda: c.TenantConfig(tid=1, rate_lo=5.0,
                                            rate_hi=2.0)):
            try:
                make()
                raised.append(None)
            except ValueError as e:
                raised.append(str(e))
        assert isinstance(c.TenantConfig(tid=1).weight, numbers.Integral)
        return raised

    assert None not in _both(script)
