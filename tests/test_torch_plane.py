"""PyTorch port: the serving plane against the JAX plane.

- The plane verbs (`plane_insert`, `plane_get` read-only and counting,
  `plane_delete`, `plane_get_extent`) give the JAX plane's results, and
  a read-only GET leaves every shard's stats leaf as JAX leaves it: its
  delta lives in the host stats plane, which `stats()`, `shard_report()`
  and a saved snapshot fold in (the read-only stats pin).
- `PlaneBackend` with shard quarantine and the fault seam, `warm_plane`
  (stat-clean), `make_serving_backend` under `PMDFC_MESH=off`, the tiered
  plane's migration, `KVServer(mesh=)` serving engine verbs, and a
  seeded mixed workload through each package's `NetServer` on a 4-shard
  plane: the same transcript.
"""

from __future__ import annotations

import socket
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu.config import MeshConfig as JMeshConfig
from pmdfc_tpu.config import NetConfig as JNetConfig
from pmdfc_tpu.parallel import plane as jplane
from pmdfc_tpu.runtime import failure as jfailure
from pmdfc_tpu.runtime import net as jnet
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.config import ContainmentConfig, MeshConfig, NetConfig
from pmdfc_tpu_torch.parallel import plane as tplane
from pmdfc_tpu_torch.parallel import shard as tshard
from pmdfc_tpu_torch.runtime import failure as tfailure
from pmdfc_tpu_torch.runtime import net as tnet

from test_torch_shard import (cfg_pair, check_leaves, check_stats, jax_grid,
                              keys_of, pages_of, pair, port_grid, same,
                              same_result)

pytestmark = pytest.mark.torch

W = 16


def _stop(srv):
    try:
        srv._lsock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.stop()


def _snapshot_leaves(path):
    with np.load(path) as z:
        import json

        meta = json.loads(bytes(z["__meta__"]).decode())
        return ([d["name"] for d in meta["leaves"]],
                [z[f"leaf_{i}"] for i in range(len(meta["leaves"]))])


PLANE_CASES = {
    # read-only GETs only (no touch, flat pool)
    "linear-4": (dict(), 4),
    # every second GET batch takes the counting path (tier migration)
    "tiered-2": (dict(capacity=512, touch_sample_every=2, tier=dict(
        ghost_rows=32, promote_touches=1, max_promotes_per_batch=32)), 2),
    # hotring counts accesses on every GET (touch_sample_every=1)
    "hotring-2": (dict(kind="hotring", capacity=512), 2),
}


@pytest.mark.parametrize("case", list(PLANE_CASES))
def test_plane_verbs_and_read_only_stats_match_jax(case, tmp_path):
    kw, n = PLANE_CASES[case]
    jcfg, tcfg = cfg_pair(**kw)
    a, b = pair(jcfg, tcfg, n)
    rng = np.random.default_rng(n)
    keys = keys_of(300, seed=11)
    pages = pages_of(keys)
    same_result(a.plane_insert(keys, pages).fetch(),
                b.plane_insert(keys, pages).fetch(), "plane_insert")
    for step in range(4):
        probe = np.concatenate([keys[rng.integers(0, 300, 120)],
                                keys_of(30, seed=100 + step),
                                np.full((2, 2), 0xFFFFFFFF, np.uint32)])
        ha, hb = a.plane_get(probe), b.plane_get(probe)
        same(ha.counts, hb.counts, "routed counts")
        ga, gb = ha.fetch(), hb.fetch()
        same(ga.found, gb.found, f"get {step} found")
        same(ga.dense(), gb.dense(), f"get {step} dense")
        same(ga.hit_rows(20, 90), gb.hit_rows(20, 90), "hit_rows")
        if step == 0:
            # the read-only pin: the GET wrote no stats leaf on either
            # side (flat pool), yet stats() already counts it
            check_leaves(a, b, "after a GET")
            assert b.stats()["gets"] == len(probe) - 2
        if step == 1:
            gone = keys[:40]
            same(a.plane_delete(gone).fetch(), b.plane_delete(gone).fetch(),
                 "plane_delete")
    a.insert_extent([5, 0], [0, 8192], 16)
    b.insert_extent([5, 0], [0, 8192], 16)
    ep = np.array([[5, 3], [5, 15], [5, 16], [6, 0]], np.uint32)
    same_result(a.plane_get_extent(ep).fetch(),
                b.plane_get_extent(ep).fetch(), "plane_get_extent")
    check_leaves(a, b, case)
    check_stats(a, b, case)
    # a snapshot folds the host stats plane into the written stats leaf
    pa, pb = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    a.save(pa)
    b.save(pb)
    (na, la), (nb, lb) = _snapshot_leaves(pa), _snapshot_leaves(pb)
    assert na == nb
    for name, x, y in zip(na, la, lb):
        assert x.dtype == y.dtype, name
        same(x, y, f"snapshot leaf {name}")
    st = lb[nb.index("stats")].astype(np.int64).sum(axis=0)
    assert st[tkv.GETS] == b.stats()["gets"]


def test_plane_verbs_match_single_device_kv():
    """Routed phases reproduce the single-device `KV` (the plane's own
    ground truth), over 4 CPU shards."""
    _, tcfg = cfg_pair()
    skv = tshard.ShardedKV(tcfg, mesh=port_grid(4))
    ref = tkv.KV(tcfg, device="cpu")
    keys = keys_of(300, seed=11)
    pages = pages_of(keys)
    res = skv.plane_insert(keys, pages).fetch()
    same(res.dropped, ref.insert(keys, pages).dropped, "dropped")
    g = skv.plane_get(keys).fetch()
    rout, rfound = ref.get(keys)
    same(g.found, rfound, "found")
    same(g.dense()[g.found], rout[rfound], "pages")
    same(skv.plane_delete(keys[:64]).fetch(), ref.delete(keys[:64]), "del")
    s, r = skv.stats(), ref.stats()
    for k in ("puts", "gets", "hits", "misses", "deletes"):
        assert s[k] == r[k], (k, s, r)


def _containment():
    return dict(containment=ContainmentConfig(
        quarantine_failures=2, quarantine_cooldown_s=0.05,
        quarantine_max_cooldown_s=0.2))


def test_plane_backend_quarantine_and_fault_plan_match_jax():
    from pmdfc_tpu.config import ContainmentConfig as JContainment

    jcfg, tcfg = cfg_pair()
    jplan, tplan = jfailure.FaultPlan(), tfailure.FaultPlan()
    ja = jplane.PlaneBackend(
        jplane.build_plane_kv(jcfg, jax_grid(4)), fault_plan=jplan,
        containment=JContainment(quarantine_failures=2,
                                 quarantine_cooldown_s=60.0,
                                 quarantine_max_cooldown_s=60.0))
    tb = tplane.PlaneBackend(
        tshard.ShardedKV(tcfg, mesh=port_grid(4)), fault_plan=tplan,
        containment=ContainmentConfig(quarantine_failures=2,
                                      quarantine_cooldown_s=60.0,
                                      quarantine_max_cooldown_s=60.0))
    pool = keys_of(128, seed=7)
    for be in (ja, tb):
        be.put(pool, pages_of(pool))
    node = tb.skv.node_of(pool)
    k = int(np.bincount(node, minlength=4).argmax())
    for plan, be in ((jplan, ja), (tplan, tb)):
        plan.fail_shard(k)
        for _ in range(4):
            with pytest.raises((jfailure.ShardFault, tfailure.ShardFault)):
                be.get(pool[:32])
            if be.quarantine.quarantined():
                break
        assert be.quarantine.quarantined() == [k]
    (oa, fa), (ob, fb) = ja.get(pool), tb.get(pool)
    same(fa, fb, "quarantined found")
    same(oa, ob, "quarantined pages")
    assert not fb[node == k].any() and fb[node != k].all()
    # blocked invalidations journal for replay; blocked puts drop acked
    same(ja.invalidate(pool[:20]), tb.invalidate(pool[:20]), "invalidate")
    ja.put(pool[:8], pages_of(pool[:8]))
    tb.put(pool[:8], pages_of(pool[:8]))
    sa, sb = ja.stats(), tb.stats()
    for key in ("shard_report",):
        assert sa[key]["stats"] == sb[key]["stats"]
    for key in ("quarantined", "states", "journal_depths"):
        assert sa["quarantine"][key] == sb["quarantine"][key], key
    assert {x: sa[x] for x in tkv.STAT_NAMES} == \
        {x: sb[x] for x in tkv.STAT_NAMES}
    assert sb["miss_quarantined"] > 0
    assert sb["misses"] == sum(sb[c] for c in tkv.MISS_CAUSE_NAMES)


def test_plane_quarantine_readmission_replays_the_journal():
    _, tcfg = cfg_pair()
    plan = tfailure.FaultPlan()
    be = tplane.PlaneBackend(tshard.ShardedKV(tcfg, mesh=port_grid(4)),
                             fault_plan=plan, **_containment())
    pool = keys_of(128, seed=7)
    be.put(pool, pages_of(pool))
    node = be.skv.node_of(pool)
    k = int(np.bincount(node, minlength=4).argmax())
    on_k = pool[node == k]
    plan.fail_shard(k)
    for _ in range(8):
        try:
            be.get(pool[:32])
        except tfailure.ShardFault:
            pass
        if be.quarantine.quarantined():
            break
    assert be.quarantine.quarantined() == [k]
    # invalidate while quarantined: journaled, replayed at re-admission
    be.invalidate(on_k[:4])
    plan.heal_shard(k)
    deadline = time.monotonic() + 10.0
    while be.quarantine.quarantined() and time.monotonic() < deadline:
        time.sleep(0.02)
        be.get(on_k[4:12])
    assert not be.quarantine.quarantined(), "shard never re-admitted"
    _, found = be.get(on_k)
    assert not found[:4].any(), "a journaled invalidation was lost"
    assert found[4:].all(), "resident keys lost across quarantine"
    st = be.skv.stats()
    assert st["misses"] == sum(st[c] for c in tkv.MISS_CAUSE_NAMES)


def test_warm_plane_counts_nothing_like_jax():
    jcfg, tcfg = cfg_pair(kind="hotring", capacity=512)
    a, b = pair(jcfg, tcfg, 2)
    assert jplane.warm_plane(a, 32) == tplane.warm_plane(b, 32) > 0
    s = b.stats()
    assert s["gets"] == 0 and s["puts"] == 0, s
    check_stats(a, b, "warm")
    check_leaves(a, b, "warm")
    be = tplane.PlaneBackend(b)
    assert be.warmup(16) > 0
    assert b.stats()["gets"] == 0


def test_make_serving_backend_kill_switch(monkeypatch):
    from pmdfc_tpu_torch.client.backends import DirectBackend

    _, tcfg = cfg_pair()
    monkeypatch.setenv("PMDFC_MESH", "off")
    off = tplane.make_serving_backend(tcfg, MeshConfig(n_shards=4),
                                      device="cpu")
    assert isinstance(off, DirectBackend) and off.device.type == "cpu"
    assert tplane.build_plane_kv(tcfg, port_grid(2)) is None
    monkeypatch.delenv("PMDFC_MESH")
    on = tplane.make_serving_backend(tcfg, MeshConfig(pad_floor=16),
                                     mesh=port_grid(4))
    assert isinstance(on, tplane.PlaneBackend)
    assert on.skv.n_shards == 4 and on.skv._router.pad_floor == 16
    assert on.routes_per_shard and on.replica_lanes == 1
    # an int shard count takes distinct local GPUs: none here
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            tplane.make_serving_backend(tcfg, MeshConfig(n_shards=2))


def test_tiered_plane_counting_path_migrates_like_jax():
    jcfg, tcfg = cfg_pair(capacity=512, tier=dict(
        ghost_rows=32, promote_touches=1, max_promotes_per_batch=32))
    a, b = pair(jcfg, tcfg, 2)
    keys = keys_of(64, seed=13)
    a.plane_insert(keys, pages_of(keys)).fetch()
    b.plane_insert(keys, pages_of(keys)).fetch()
    for _ in range(4):
        ga, gb = a.plane_get(keys).fetch(), b.plane_get(keys).fetch()
        assert gb.found.all()
        same(ga.dense(), gb.dense(), "tiered pages")
    assert b.tier_stats() == a.tier_stats()
    assert b.tier_stats()["promotions"] > 0
    check_stats(a, b, "tiered")
    check_leaves(a, b, "tiered")


def test_kvserver_mesh_mode_serves_engine_verbs():
    from pmdfc_tpu_torch.client import EngineBackend
    from pmdfc_tpu_torch.runtime import Engine, KVServer

    _, tcfg = cfg_pair()
    keys = keys_of(128, seed=21)
    pages = pages_of(keys)
    srv = KVServer(tcfg, engine=Engine(page_bytes=W * 4), pad_floor=16,
                   mesh=port_grid(4))
    assert srv._plane is not None and srv.kv.n_shards == 4
    assert srv.kv._router.pad_floor == 16
    assert srv.warmup(256) > 0
    with srv.start():
        eb = EngineBackend(srv, timeout_us=60_000_000)
        eb.put(keys, pages)
        out, found = eb.get(keys)
        assert found.all()
        same(out, pages, "engine pages")
        assert eb.invalidate(keys[:16]).all()
        _, f2 = eb.get(keys[:16])
        assert not f2.any()
        assert eb.insert_extent(np.array([9, 0], np.uint32),
                                np.array([0, 4096], np.uint32), 8) == 0
        vals, fe = eb.get_extent(np.array([[9, 2]], np.uint32))
        assert fe[0] and int(vals[0, 1]) == 4096 + 2 * 4096
        h = srv.health()
        assert h["kv"]["hits"] >= 128 and h["serve_errors"] == 0
        eb.close()


def test_kvserver_mesh_respects_kill_switch(monkeypatch):
    from pmdfc_tpu_torch.runtime import KVServer

    _, tcfg = cfg_pair()
    monkeypatch.setenv("PMDFC_MESH", "off")
    srv = KVServer(tcfg, mesh=port_grid(2), device="cpu")
    assert srv._plane is None
    srv.engine.close()


def _serve_workload(net_mod, cfg_mod, backend):
    """Seeded mixed workload through one package's NetServer (the
    conformance unit of `tests/test_mesh.py`)."""
    srv = net_mod.NetServer(lambda: backend, net=cfg_mod(
        flush_timeout_us=5000, settle_us=200)).start()
    results = []
    try:
        with net_mod.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                keepalive_s=None, pipeline=True) as be:
            rng = np.random.default_rng(77)
            universe = keys_of(256, seed=77)
            for _ in range(60):
                op = int(rng.integers(5))
                lo = int(rng.integers(0, 240))
                n = int(rng.integers(1, 16))
                sel = universe[lo:lo + n]
                if op == 0:
                    be.put(sel, pages_of(sel))
                    results.append(("put", n))
                elif op in (1, 2):
                    out, found = be.get(sel)
                    results.append(("get", found.tolist(),
                                    out[found].tolist()))
                elif op == 3:
                    results.append(("inval", be.invalidate(sel).tolist()))
                else:
                    vals, ef = be.get_extent(sel)
                    results.append(("gext", ef.tolist(), vals[ef].tolist()))
            be.insert_extent(np.array([3, 0], np.uint32),
                             np.array([0, 4096], np.uint32), 32)
            vals, ef = be.get_extent(np.array([[3, 5], [3, 40]], np.uint32))
            results.append(("ext", ef.tolist(), vals.tolist()))
            results.append(("stats", {k: be.server_stats()[k]
                                      for k in tkv.STAT_NAMES}))
    finally:
        _stop(srv)
    return results


def test_net_transcript_on_a_4_shard_plane_matches_jax():
    jcfg, tcfg = cfg_pair()
    jbe = jplane.make_serving_backend(jcfg, JMeshConfig(n_shards=4))
    tbe = tplane.make_serving_backend(tcfg, mesh=port_grid(4))
    want = _serve_workload(jnet, JNetConfig, jbe)
    got = _serve_workload(tnet, NetConfig, tbe)
    assert got == want
    check_stats(jbe.skv, tbe.skv, "wire")
    check_leaves(jbe.skv, tbe.skv, "wire")


@pytest.mark.parametrize("tiered", [False, True])
def test_plane_fast_lane_validates_like_jax(tiered):
    """The plane's fast lane: the directory (shard, row, digest) of every
    live key equals JAX's; one locked `read` per batch validates each
    (shard, row) lane on its shard and gathers only the ok rows; a
    rewrite fails its old lane, a delete's epoch bump fails every lane —
    the ok masks equal the JAX view's `validate` at each step and the
    pages its `gather`."""
    kw = (dict(capacity=512, tier=dict(ghost_rows=32, promote_touches=1,
                                       max_promotes_per_batch=32))
          if tiered else dict())
    jcfg, tcfg = cfg_pair(**kw)
    a, b = pair(jcfg, tcfg, 4)
    keys = keys_of(300, seed=29)
    for skv in (a, b):
        skv.plane_insert(keys, pages_of(keys)).fetch()
        skv.plane_get(keys[:100]).fetch()
    da, db = a.directory_snapshot(), b.directory_snapshot()
    for k in ("keys", "shards", "rows", "digs"):
        same(da[k], db[k], f"directory {k}")
    # the plane never shares the JAX view's mirror, so the epochs are
    # each side's own; lanes are checked against each side's epoch
    lanes = (db["shards"], db["rows"], db["digs"])
    bad = np.array([7, 3], np.uint32)  # shard past the grid, row past a pool

    def both(step):
        fa, fb = a.fast_view(), b.fast_view()
        sh = np.concatenate([lanes[0], bad[:1], [0]]).astype(np.uint32)
        rw = np.concatenate([lanes[1], [0], bad[1:] << 20]).astype(np.uint32)
        dg = np.concatenate([lanes[2], [0, 0]]).astype(np.uint32)
        ok_a = fa.validate(fa.epoch, sh, rw, dg)
        ok_b, pages, ep = fb.read(fb.epoch, sh, rw, dg)
        same(ok_a, ok_b, f"{step} ok")
        same(fa.gather(sh[ok_a], rw[ok_a]), pages, f"{step} pages")
        assert ep == b.dir_epoch
        # a stale epoch fails every lane
        assert not fb.read(fb.epoch + 2, sh, rw, dg)[0].any()
        same(fb.validate(fb.epoch, sh, rw, dg), ok_b, f"{step} validate")
        return ok_b

    assert both("fresh")[:len(keys)].all()
    # rewrite 40 keys: their old lanes fail, the rest still serve
    new = pages_of(keys[:40]) ^ np.uint32(0x5A5A5A5A)
    a.plane_insert(keys[:40], new).fetch()
    b.plane_insert(keys[:40], new).fetch()
    ok = both("after rewrites")
    assert ok.sum() <= len(keys) - 40
    fb = b.fast_view()
    assert fb is b.fast_view()  # cached per mutation sequence
    b.plane_delete(keys[40:50]).fetch()
    assert b.fast_view() is not fb and b.fast_view().epoch != fb.epoch


def test_plane_concurrent_verbs_lose_no_update_and_serve_no_torn_page():
    """Stress: more threads than cores, a short switch interval. Reader
    threads GET through the plane and read the fast lane while writer
    threads rewrite half the keys: every fast-lane page served is the one
    its directory digest names (never a rewritten or torn page), every
    GET key is counted once in `stats()` (no lost update of the host stats
    plane), and every GET hit is one of its key's two pages."""
    import os
    import sys
    import threading

    _, tcfg = cfg_pair(capacity=1 << 11)
    skv = tshard.ShardedKV(tcfg, mesh=port_grid(4))
    keys = keys_of(512, seed=33)
    old = pages_of(keys)
    new = old ^ np.uint32(0x5A5A5A5A)
    skv.plane_insert(keys, old).fetch()
    d = skv.directory_snapshot()
    order = {(int(k[0]), int(k[1])): i for i, k in enumerate(keys)}
    want = old[[order[(int(k[0]), int(k[1]))] for k in d["keys"]]]
    n_threads = 2 * (os.cpu_count() or 2) + 2
    gets = [0] * n_threads
    errors: list = []

    def reader(t):
        rng = np.random.default_rng(t)
        for _ in range(20):
            sel = rng.integers(0, len(keys), 32)
            g = skv.plane_get(keys[sel]).fetch()
            gets[t] += len(sel)
            rows = g.dense()
            good = ((rows == old[sel]) | (rows == new[sel])).all(axis=1)
            if not good[g.found].all():
                errors.append("a GET hit served neither of its pages")
            fv = skv.fast_view()
            lanes = rng.integers(0, len(d["rows"]), 32)
            ok, pages, _ = fv.read(fv.epoch, d["shards"][lanes],
                                   d["rows"][lanes], d["digs"][lanes])
            if not np.array_equal(pages, want[lanes][ok]):
                errors.append("a fast read served a page its digest "
                              "does not name")

    def writer(t):
        rng = np.random.default_rng(100 + t)
        for _ in range(10):
            sel = rng.integers(0, len(keys) // 2, 32)
            skv.plane_insert(keys[sel], new[sel]).fetch()

    threads = ([threading.Thread(target=reader, args=(t,))
                for t in range(n_threads)]
               + [threading.Thread(target=writer, args=(t,))
                  for t in range(2)])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:3]
    assert skv.stats()["gets"] == sum(gets)
