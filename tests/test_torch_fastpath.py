"""PyTorch port: `tests/test_fastpath.py`'s structural-invalidation drills
on both packages.

Each drill runs once through the JAX package and once through the port
(`KV(device="cpu")`, each package's own `NetServer` and `TcpBackend` over
loopback) on the same numpy-seeded keys and pages, and the two
transcripts must be equal: `dir_epoch` steps, directory rows and digests,
`FastView.validate` masks, the directory client's counters, pages and
found masks, `fastpath_hits`/`fastpath_stale` on both sides of the wire,
the tier's promotions, the owners after a 4 -> 2 reshard. The ChaosProxy
soak depends on timing and is held on each package to the JAX test's
invariants: zero wrong bytes and `miss_gets == miss_bloom_negative +
miss_remote`. The drills the port's earlier suites already hold against
JAX are named in `tests/test_torch_twins.py`.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import (JAX, PKGS, PORT, fresh_jax_registry,  # noqa: F401
                        registries, same, stop, twin)

import pmdfc_tpu.client.replica as jreplica
import pmdfc_tpu.parallel.shard as jshard
import pmdfc_tpu_torch.client.replica as treplica
import pmdfc_tpu_torch.parallel.shard as tshard

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("fresh_jax_registry")]

W = 16  # tiny pages keep socket traffic fast, as the JAX drills


def _jax_mesh(n):
    import jax

    return jshard.make_mesh(jax.devices()[:n])


EXTRA = {
    id(JAX): types.SimpleNamespace(replica=jreplica, shard=jshard,
                                   mesh=_jax_mesh),
    id(PORT): types.SimpleNamespace(
        replica=treplica, shard=tshard,
        mesh=lambda n: tshard.make_mesh(["cpu"] * n)),
}


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 0] * 7 + keys[:, 1])[:, None] + np.arange(
        W, dtype=np.uint32)


def _cfg(pkg, capacity=1 << 10, tier=None, paged=True):
    c = pkg.config
    return c.KVConfig(index=c.IndexConfig(capacity=capacity),
                      bloom=c.BloomConfig(num_bits=1 << 13),
                      paged=paged, page_words=W, tier=tier)


def _server(pkg, kv=None, backend=None):
    kv = kv if kv is not None else pkg.KV(_cfg(pkg))
    shared = backend or pkg.backends.DirectBackend(kv)
    net = pkg.config.NetConfig(flush_timeout_us=500, settle_us=50)
    return pkg.net.NetServer(lambda: shared, net=net).start(), kv


def _dial(pkg, srv, **kw):
    kw.setdefault("keepalive_s", None)
    return pkg.net.TcpBackend("127.0.0.1", srv.port, page_words=W, **kw)


def _fp(srv):
    """(reads, hits, stale) of a server's fast lane: reads are derived."""
    s = srv.stats
    h, st = int(s["fastpath_hits"]), int(s["fastpath_stale"])
    return (h + st, h, st)


def _client_fp(be):
    c = be.directory.counters
    return (c["fastpath_gets"], c["fastpath_hits"], c["fastpath_stale"])


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# KV-level drills
# ---------------------------------------------------------------------------


def _epoch_drill(pkg):
    kv = pkg.KV(_cfg(pkg))
    keys = _keys(32, seed=4)
    kv.insert(keys, _pages(keys))
    e0 = kv.dir_epoch
    kv.insert(keys[:4], _pages(keys[:4]))   # puts never bump the epoch
    d_put = kv.dir_epoch - e0
    hit = _np(kv.delete(keys[:2]))          # invalidation does
    d_del = kv.dir_epoch - e0
    fv = kv.fast_view()
    z = np.zeros(1, np.uint32)
    stale_any = _np(fv.validate(e0, z, z, z))
    snap = kv.directory_snapshot()
    cur = _np(fv.validate(snap["epoch"], snap["shards"], snap["rows"],
                          snap["digs"]))
    old = _np(fv.validate(e0, snap["shards"], snap["rows"], snap["digs"]))
    return dict(d_put=d_put, d_del=d_del, hit=hit, stale_any=stale_any,
                cur=cur, old=old, snap_epoch=snap["epoch"] - e0,
                **{k: _np(snap[k]) for k in ("keys", "shards", "rows",
                                             "digs")})


def test_epoch_bumps_on_structural_invalidation():
    t = twin(_epoch_drill)
    assert (t["d_put"], t["d_del"]) == (0, 1)
    assert t["hit"].all() and not t["stale_any"].any()
    assert t["cur"].all() and not t["old"].any() and len(t["keys"]) == 30


def _promotion_drill(pkg):
    kv = pkg.KV(_cfg(pkg, capacity=256,
                     tier=pkg.config.TierConfig(ghost_rows=16)))
    keys = _keys(32, seed=30)
    pages = _pages(keys)
    kv.insert(keys, pages)
    snap = kv.directory_snapshot()
    for _ in range(6):   # inserts land cold; promote_touches is 2
        kv.get(keys)
    promotions = (kv.tier_stats() or {})["promotions"]
    kv.insert(keys, pages ^ np.uint32(0x5A5A))
    fv = kv.fast_view()
    ok = _np(fv.validate(snap["epoch"], snap["shards"], snap["rows"],
                         snap["digs"]))
    snap2 = kv.directory_snapshot()
    fv2 = kv.fast_view()
    ok2 = _np(fv2.validate(snap2["epoch"], snap2["shards"], snap2["rows"],
                           snap2["digs"]))
    got = _np(fv2.gather(snap2["shards"][ok2], snap2["rows"][ok2]))
    want, found = kv.get(snap2["keys"])
    return dict(n_snap=len(snap["keys"]), promotions=promotions, ok=ok,
                ok2=ok2, got=got, want=_np(want), found=_np(found),
                rows=_np(snap["rows"]), rows2=_np(snap2["rows"]),
                digs2=_np(snap2["digs"]))


def test_tier_promotion_vacates_directory_rows():
    t = twin(_promotion_drill)
    assert t["n_snap"] == 32 and t["promotions"] > 0
    assert not t["ok"].any()   # no old-snapshot lane validates
    assert t["ok2"].all() and t["found"].all()
    assert np.array_equal(t["got"], t["want"])


# ---------------------------------------------------------------------------
# wire drills
# ---------------------------------------------------------------------------


def _unpaged_drill(pkg):
    kv = pkg.KV(pkg.config.KVConfig(
        index=pkg.config.IndexConfig(capacity=256), paged=False,
        bloom=None, page_words=W))
    srv = pkg.net.NetServer(lambda: pkg.backends.DirectBackend(kv),
                            net=pkg.config.NetConfig(
                                flush_timeout_us=200)).start()
    try:
        be = _dial(pkg, srv, directory=True)
        out = (kv.fast_view() is None, kv.directory_snapshot() is None,
               be.fastpath, be.directory is None)
        be.close()
    finally:
        stop(srv)
    return out


def test_unpaged_server_acks_no_fast_lane():
    assert twin(_unpaged_drill) == (True, True, False, True)


def _teledump_drill(pkg):
    from tools.check_teledump import check, check_fastpath

    srv, _ = _server(pkg)
    try:
        keys = _keys(32, seed=8)
        fast = _dial(pkg, srv, directory=True)
        fast.put(keys, _pages(keys))
        fast.dir_refresh()
        out, found = fast.get(keys)
        doc = fast.server_stats()
        snap = doc["telemetry"]
        hits_names = [n for n in snap["counters"]
                      if n.endswith(".fastpath_hits")]
        scope = hits_names[0][: -len("fastpath_hits")]
        forged = {**snap, "counters": {
            **snap["counters"],
            scope + "fastpath_reads": snap["counters"][hits_names[0]] + 1}}
        broken = {**snap, "counters": dict(snap["counters"])}
        broken["counters"].pop(scope + "fastpath_stale")
        lanes = {n[len(scope):]: snap["counters"][n]
                 for n in snap["counters"] if n.startswith(scope)
                 and n.endswith(("fastpath_hits", "fastpath_stale",
                                 "dir_pulls"))}
        res = dict(
            errors=check(doc), n_scopes=len(hits_names), lanes=lanes,
            server=_fp(srv), client=_client_fp(fast),
            drift=any("fast-lane drift" in e for e in check_fastpath(forged)),
            lone=any("without its stale lane" in e
                     for e in check_fastpath(broken)),
            out=out, found=found)
        fast.close()
    finally:
        stop(srv)
    return res


def test_teledump_pins_fastpath_invariant():
    t = twin(_teledump_drill)
    assert t["errors"] == [] and t["n_scopes"] >= 1
    assert t["drift"] and t["lone"]
    assert t["server"] == t["client"] == (32, 32, 0)
    assert t["lanes"] == {"fastpath_hits": 32, "fastpath_stale": 0,
                          "dir_pulls": 1}
    assert t["found"].all()


def _delta_drill(pkg):
    srv, kv = _server(pkg)
    try:
        keys = _keys(48, seed=10)
        pages = _pages(keys)
        a = _dial(pkg, srv, directory=True)
        b = _dial(pkg, srv)
        a.put(keys, pages)
        a.dir_refresh()
        n0 = len(a.directory)
        e0 = kv.dir_epoch
        inv = _np(b.invalidate(keys[:4]))             # -> tombstones
        b.put(keys[4:6], pages[4:6] ^ np.uint32(1))   # -> new digests
        delta = a.dir_refresh()
        c = dict(a.directory.counters)
        mask = a.directory.lookup(keys[:4])[0]
        out, found = a.get(keys[4:6])
        res = dict(n0=n0, inv=inv, epoch=kv.dir_epoch - e0, delta=delta,
                   counters=c, n1=len(a.directory), mask=mask, out=out,
                   found=found, server=_fp(srv), client=_client_fp(a),
                   pulls=int(srv.stats["dir_pulls"]))
        a.close()
        b.close()
    finally:
        stop(srv)
    return res


def test_dir_delta_upserts_and_tombstones():
    t = twin(_delta_drill)
    assert t["n0"] == 48 and t["delta"] and t["n1"] == 44
    c = t["counters"]
    assert c["dir_refreshes"] == 2 and c["dir_upserts"] < 48 + 8
    assert c["dir_tombstones"] >= 4 and not t["mask"].any()
    assert t["found"].all()
    assert np.array_equal(t["out"], _pages(_keys(48, seed=10))[4:6]
                          ^ np.uint32(1))
    assert t["server"] == t["client"]


def _gets(be, keys, pages, step=16):
    """GETs of `keys` in `step`-key verbs -> (served, misses, wrong)."""
    served = misses = wrong = 0
    for lo in range(0, len(keys), step):
        out, found = be.get(keys[lo:lo + step])
        served += int(found.sum())
        misses += int((~found).sum())
        wrong += int((out[found] != pages[lo:lo + step][found])
                     .any(axis=1).sum())
        assert not out[~found].any(), "a miss returned nonzero bytes"
    return served, misses, wrong


def _balloon_drill(pkg):
    tier = pkg.config.TierConfig(balloon_step=32, ghost_rows=16,
                                 cold_init_rows=256)
    kv = pkg.KV(_cfg(pkg, capacity=256, tier=tier))
    srv, _ = _server(pkg, kv=kv)
    try:
        keys = _keys(128, seed=13)
        pages = _pages(keys)
        a = _dial(pkg, srv, directory=True)
        a.put(keys, pages)
        _, landed = a.get(keys)
        keys, pages = keys[landed], pages[landed]
        a.dir_refresh()
        first = a.get(keys[:16])[1]
        e0 = kv.dir_epoch
        shrunk = kv.balloon_shrink(64)
        bumped = kv.dir_epoch - e0
        served, misses, wrong = _gets(a, keys, pages)
        mid = (_fp(srv), _client_fp(a))
        refreshed = a.dir_refresh()
        out, found = a.get(keys[:16])
        res = dict(landed=landed, first=first, shrunk=shrunk, bumped=bumped,
                   served=served, misses=misses, wrong=wrong, mid=mid,
                   refreshed=refreshed, out=out, found=found,
                   wrong_after=int((out[found] != pages[:16][found])
                                   .any(axis=1).sum()),
                   end=(_fp(srv), _client_fp(a)))
        a.close()
    finally:
        stop(srv)
    return res


def test_balloon_shrink_drill_zero_wrong_bytes():
    """Equal but for one recorded difference after the refresh: JAX's
    fast lane reads a host mirror cached per `_mut_seq`, which a tiered
    counting GET's promotions and demotions do not bump, so the mirror
    taken before the mid-serve GETs still holds the rows they moved and
    every re-armed lane is stale; the port reads the live rows under the
    KV's lock (`FastView.read`) and every re-armed lane hits. Both serve
    the same bytes."""
    j, t = (_balloon_drill(pkg) for pkg in PKGS)
    j_end, t_end = j.pop("end"), t.pop("end")
    same(j, t, "_balloon_drill")
    assert t["first"].all() and t["shrunk"] and t["bumped"] > 0
    assert t["wrong"] == 0 == t["wrong_after"] and t["served"] > 0
    (srv_fp, cli_fp) = t["mid"]
    assert srv_fp == cli_fp and srv_fp[2] > 0   # stale, exact both sides
    assert t["refreshed"] and t["found"].all()
    r, h, s = srv_fp
    assert j_end == ((r + 16, h, s + 16),) * 2
    assert t_end == ((r + 16, h + 16, s),) * 2


def _reshard_drill(pkg, root):
    ex = EXTRA[id(pkg)]
    cfg = _cfg(pkg, capacity=256)
    skv4 = ex.shard.ShardedKV(cfg, mesh=ex.mesh(4))
    db = pkg.backends.DirectBackend(skv4)
    srv, _ = _server(pkg, kv=skv4, backend=db)
    try:
        keys = _keys(96, seed=14)
        pages = _pages(keys)
        a = _dial(pkg, srv, directory=True)
        a.put(keys, pages)
        _, landed = a.get(keys)
        keys, pages = keys[landed], pages[landed]
        a.dir_refresh()
        first = a.get(keys[:16])[1]
        owners4 = sorted({e[0] for e in a.directory._map.values()})
        path = str(root / f"skv4_{'port' if pkg is PORT else 'jax'}.ckpt")
        skv4.save(path)
        skv2 = ex.shard.ShardedKV(cfg, mesh=ex.mesh(2))
        skv2.restore(path)
        db.kv = skv2          # swapped in mid-serve
        served, misses, wrong = _gets(a, keys, pages)
        mid = (_fp(srv), _client_fp(a))
        refreshed = a.dir_refresh() and a.directory.ready()
        out, found = a.get(keys[:32])
        owners2 = sorted({e[0] for e in a.directory._map.values()})
        res = dict(landed=landed, first=first, owners4=owners4,
                   served=served, misses=misses, wrong=wrong, mid=mid,
                   refreshed=refreshed, out=out, found=found,
                   owners2=owners2, end=(_fp(srv), _client_fp(a)))
        a.close()
    finally:
        stop(srv)
    return res


def test_reshard_4_to_2_drill_zero_wrong_bytes(tmp_path):
    t = twin(_reshard_drill, tmp_path)
    n = int(t["landed"].sum())
    assert t["first"].all() and len(t["owners4"]) > 1
    assert t["wrong"] == 0 and t["served"] == n   # loss-free replay
    assert t["mid"][0] == t["mid"][1] and t["mid"][0][2] > 0
    assert t["refreshed"] and t["found"].all()
    assert np.array_equal(t["out"], _pages(_keys(96, seed=14)[
        t["landed"]])[:32])
    assert set(t["owners2"]) <= {0, 1}
    assert t["end"][0] == t["end"][1]


def _replica_drill(pkg):
    ex = EXTRA[id(pkg)]
    srv1, _ = _server(pkg)
    srv2, _ = _server(pkg)
    try:
        eps = [_dial(pkg, s, directory=True) for s in (srv1, srv2)]
        grp = ex.replica.ReplicaGroup(
            eps, page_words=W,
            cfg=pkg.config.ReplicaConfig(n_replicas=2, rf=2,
                                         hedge_ms=5000.0,
                                         repair_interval_s=0.0))
        keys = _keys(64, seed=21)
        pages = _pages(keys)
        grp.put(keys, pages)
        refreshed = grp.dir_refresh()
        out, found = grp.get(keys)
        res = dict(refreshed=refreshed, out=out, found=found,
                   fp=[_fp(s) for s in (srv1, srv2)],
                   hedges=grp.stats()["group"]["hedges_fired"],
                   same=np.array_equal(out, pages))
        grp.close()
    finally:
        stop(srv1)
        stop(srv2)
    return res


def test_replica_group_prefers_fastpath_over_hedging():
    t = twin(_replica_drill)
    assert t["refreshed"] == 2 and t["found"].all() and t["same"]
    assert sum(f[1] for f in t["fp"]) > 0   # primaries answered fast
    assert t["hedges"] == 0                 # nothing ever hedged


# ---------------------------------------------------------------------------
# lifecycle, and the seeded soak
# ---------------------------------------------------------------------------


def _close_drill(pkg):
    class SpyBackend(pkg.backends.LocalBackend):
        def __init__(self):
            super().__init__(page_words=W)
            self.dir_refreshes = 0

        def dir_refresh(self):
            self.dir_refreshes += 1
            return True

    be = SpyBackend()
    with pkg.cleancache.CleanCacheClient(be, bloom_refresh_s=0.01) as cc:
        t0 = time.monotonic()
        while be.dir_refreshes == 0 and time.monotonic() - t0 < 5:
            time.sleep(0.01)
        rode = be.dir_refreshes > 0            # the directory rides the loop
        refresher = cc._refresher
        alive = refresher is not None and refresher.is_alive()
    joined = not refresher.is_alive() and cc._refresher is None
    cc.close()                                 # idempotent
    with pkg.cleancache.CleanCacheClient(SpyBackend()) as cc2:
        pass
    return rode, alive, joined, cc2._refresher is None


def test_cleancache_close_joins_refresher_and_dir_refresh():
    assert twin(_close_drill) == (True, True, True, True)


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_chaos_fastpath_soak_no_wrong_bytes(pkg):
    """The JAX test's seeded soak on each package: ChaosProxy flips and
    truncations between a directory client and the coalescing server
    degrade connections, never bytes."""
    f = pkg.failure
    srv, _ = _server(pkg)
    try:
        with f.ChaosProxy("127.0.0.1", srv.port, seed=17,
                          rates={"flip": 0.02, "truncate": 0.01},
                          delay_s=0.01, reorder_wait_s=0.02) as px:
            def factory():
                be = pkg.net.TcpBackend("127.0.0.1", px.port, page_words=W,
                                        keepalive_s=None, op_timeout_s=1.0,
                                        directory=True)
                be.dir_refresh()
                return be

            rc = f.ReconnectingClient(factory, page_words=W,
                                      retry_delay_s=0.005,
                                      max_retry_delay_s=0.05)
            cc = pkg.cleancache.CleanCacheClient(rc)
            keys = _keys(192, seed=18)
            pages = _pages(keys)
            rng = np.random.default_rng(19)
            hits = 0
            for step in range(30):
                lo = (step * 8) % len(keys)
                cc.put_pages(keys[lo:lo + 8, 0], keys[lo:lo + 8, 1],
                             pages[lo:lo + 8])
                idx = rng.integers(0, len(keys), 16)
                out, found = cc.get_pages(keys[idx, 0], keys[idx, 1])
                assert (out[found] == pages[idx][found]).all(), \
                    f"step {step}: a found page is not the key's page"
                hits += int(found.sum())
                if step % 10 == 0:
                    rc.dir_refresh()
            c = cc.counters
            assert c["miss_gets"] == (c["miss_bloom_negative"]
                                      + c["miss_remote"])
            assert hits > 0
            cc.close()
            rc.close()
    finally:
        stop(srv)
