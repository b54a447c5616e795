"""PyTorch port: `tests/test_onesided.py`'s drills on both packages.

The one-sided mode's pool is passive (no index, no server logic) and the
client owns the key -> row map; clean-cache semantics throughout: a lost
client map turns every get into a legal miss, a finite pool refuses a
grant it cannot give. Each drill runs through the JAX package's
`PassivePool` and `OneSidedBackend` and the port's (`device="cpu"` for
the device pool), on both pool modes where the JAX drill takes its
`pool` fixture, and over each package's `PoolServer` and `RemotePool`
for the network drills: pages, found masks, the client maps and free
lists, drops, the pool's read and write counters and the server's op
counters must be equal across the packages. The drills the port's
earlier suites already hold are named in `tests/test_torch_twins.py`.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import (JAX, PKGS, PORT, fresh_jax_registry,  # noqa: F401
                        registries, stop, twin)

import pmdfc_tpu.onesided as jonesided
import pmdfc_tpu_torch.onesided as tonesided

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("fresh_jax_registry")]

W = 64
ONE = {id(JAX): types.SimpleNamespace(
           mod=jonesided,
           pool=lambda n, mode: jonesided.PassivePool(
               num_rows=n, page_words=W, mode=mode)),
       id(PORT): types.SimpleNamespace(
           mod=tonesided,
           pool=lambda n, mode: tonesided.PassivePool(
               num_rows=n, page_words=W, mode=mode, device="cpu"))}
MODES = ["hbm", "host"]


def _pages(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64).astype(
        np.uint32)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed + 1000)
    flat = rng.choice(1 << 24, size=n, replace=False)
    return np.stack([flat >> 12, flat & 0xFFF], -1).astype(np.uint32)


def _client(be):
    """What a OneSidedBackend holds: its map, free rows, grant, drops."""
    return dict(map=sorted(be._map.items()), free=list(be._free),
                grant=(be.grant_lo, be.grant_hi), drops=be.drops)


def _roundtrip_drill(pkg, mode):
    one = ONE[id(pkg)]
    pool = one.pool(256, mode)
    be = one.mod.OneSidedBackend(pool, slice_pages=128)
    keys, pages = _keys(100), _pages(100)
    be.put(keys, pages)
    out, found = be.get(keys)
    reads = pool.reads
    out2, found2 = be.get(_keys(10, seed=9))   # a pure local miss
    return dict(out=out, found=found, out2=out2, found2=found2,
                reads=(reads, pool.reads), client=_client(be))


@pytest.mark.parametrize("mode", MODES)
def test_roundtrip_content(mode):
    t = twin(_roundtrip_drill, mode)
    assert t["found"].all() and np.array_equal(t["out"], _pages(100))
    assert not t["found2"].any() and (t["out2"] == 0).all()
    assert t["reads"][0] == t["reads"][1]   # zero pool traffic


def _duplicates_drill(pkg, mode):
    one = ONE[id(pkg)]
    be = one.mod.OneSidedBackend(one.pool(256, mode), slice_pages=16)
    k = _keys(4)
    be.put(np.concatenate([k, k[:2]]), _pages(6, seed=3))
    out, found = be.get(k)
    return dict(out=out, found=found, client=_client(be))


@pytest.mark.parametrize("mode", MODES)
def test_duplicate_keys_in_batch_last_wins(mode):
    t = twin(_duplicates_drill, mode)
    pages = _pages(6, seed=3)
    assert t["found"].all()
    assert np.array_equal(t["out"], np.concatenate([pages[4:6],
                                                    pages[2:4]]))


def _map_loss_drill(pkg, mode):
    one = ONE[id(pkg)]
    pool = one.pool(256, mode)
    grant = pool.grant(64)
    be = one.mod.OneSidedBackend(pool, grant=grant)
    keys, pages = _keys(32), _pages(32)
    be.put(keys, pages)
    be2 = one.mod.OneSidedBackend(pool, grant=grant)   # restarted client
    out, found = be2.get(keys)
    be2.put(keys[:8], pages[:8])
    out2, found2 = be2.get(keys[:8])
    return dict(grant=grant, out=out, found=found, out2=out2,
                found2=found2, before=_client(be), after=_client(be2),
                io=(pool.reads, pool.writes))


@pytest.mark.parametrize("mode", MODES)
def test_client_map_loss_is_legal_miss(mode):
    t = twin(_map_loss_drill, mode)
    assert not t["found"].any() and (t["out"] == 0).all()
    assert t["found2"].all()
    assert np.array_equal(t["out2"], _pages(32)[:8])


def _isolation_drill(pkg, mode):
    one = ONE[id(pkg)]
    pool = one.pool(256, mode)
    a = one.mod.OneSidedBackend(pool, slice_pages=64)
    b = one.mod.OneSidedBackend(pool, slice_pages=64)
    ka, kb = _keys(40, seed=1), _keys(40, seed=2)
    a.put(ka, _pages(40, seed=1))
    b.put(kb, _pages(40, seed=2))
    out_a, f_a = a.get(ka)
    out_b, f_b = b.get(kb)
    with pytest.raises(ValueError, match="exhausted"):
        pool.grant(1 << 20)   # grants are finite: refused loudly
    return dict(a=_client(a), b=_client(b), out_a=out_a, f_a=f_a,
                out_b=out_b, f_b=f_b, granted=pool.granted_rows)


@pytest.mark.parametrize("mode", MODES)
def test_multi_client_isolation(mode):
    t = twin(_isolation_drill, mode)
    (alo, ahi), (blo, bhi) = t["a"]["grant"], t["b"]["grant"]
    assert ahi <= blo or bhi <= alo
    assert t["f_a"].all() and t["f_b"].all()
    assert np.array_equal(t["out_a"], _pages(40, seed=1))
    assert np.array_equal(t["out_b"], _pages(40, seed=2))


def _persistence_drill(pkg, mode, root):
    one = ONE[id(pkg)]
    pool = one.pool(256, mode)
    grant = pool.grant(64)
    be = one.mod.OneSidedBackend(pool, grant=grant)
    keys, pages = _keys(20), _pages(20)
    be.put(keys, pages)
    path = str(root / f"pool_{'port' if pkg is PORT else 'jax'}.npz")
    pool.save(path)
    pool2 = one.pool(256, mode)   # server restart: same region file
    pool2.load(path)
    be2 = one.mod.OneSidedBackend(pool2, grant=grant)
    be2._map = dict(be._map)      # the client kept its map
    be2._free = list(be._free)
    out, found = be2.get(keys)
    with pytest.raises(ValueError, match="shape"):
        one.pool(16, "hbm").load(path)   # a wrong-shape restore fails
    return dict(out=out, found=found, client=_client(be2))


@pytest.mark.parametrize("mode", MODES)
def test_pool_persistence_across_restart(mode, tmp_path):
    t = twin(_persistence_drill, mode, tmp_path)
    assert t["found"].all() and np.array_equal(t["out"], _pages(20))


def _cleancache_drill(pkg, mode):
    one = ONE[id(pkg)]
    pool = one.pool(256, mode)
    cc = pkg.cleancache.CleanCacheClient(
        one.mod.OneSidedBackend(pool, slice_pages=64))
    pages = _pages(30, seed=7)
    oids, idxs = np.full(30, 5), np.arange(30)
    cc.put_pages(oids, idxs, pages)
    out, found = cc.get_pages(oids, idxs)
    absent = cc.get_page(5, 1000)
    hit = cc.invalidate_pages(oids[:5], idxs[:5])
    out2, found2 = cc.get_pages(oids[:5], idxs[:5])
    return dict(out=out, found=found, absent=absent is None, hit=hit,
                out2=out2, found2=found2, counters=dict(cc.counters),
                io=(pool.reads, pool.writes))


@pytest.mark.parametrize("mode", MODES)
def test_cleancache_client_rides_onesided(mode):
    t = twin(_cleancache_drill, mode)
    assert t["found"].all() and np.array_equal(t["out"], _pages(30, seed=7))
    assert t["absent"] and t["hit"].all() and not t["found2"].any()


def _storm_drill(pkg):
    one = ONE[id(pkg)]
    pool = one.pool(1 << 12, "hbm")
    be = one.mod.OneSidedBackend(pool, slice_pages=1 << 12)
    rng = np.random.default_rng(11)
    n = 1 << 12
    keys = _keys(n, seed=12)
    pages = keys[:, 1:2].astype(np.uint32) * np.arange(1, W + 1,
                                                       dtype=np.uint32)
    for lo in range(0, n, 256):
        be.put(keys[lo:lo + 256], pages[lo:lo + 256])
    order = rng.permutation(n)
    wrong = hits = 0
    for lo in range(0, n, 512):
        sel = order[lo:lo + 512]
        out, found = be.get(keys[sel])
        hits += int(found.sum())
        wrong += int((out != pages[sel]).any(axis=1).sum())
    return dict(hits=hits, wrong=wrong, client=_client(be),
                io=(pool.reads, pool.writes))


def test_storm_content_verified():
    t = twin(_storm_drill)
    assert t["hits"] == 1 << 12 and t["wrong"] == 0


def _net_pool(pkg):
    one = ONE[id(pkg)]
    pool = one.pool(256, "host")
    srv = pkg.net.PoolServer(pool).start()
    proxy = pkg.net.RemotePool("127.0.0.1", srv.port, page_words=W,
                               keepalive_s=None)
    return srv, pool, proxy, one


def _client_stack_drill(pkg):
    srv, pool, proxy, one = _net_pool(pkg)
    try:
        be = one.mod.OneSidedBackend(proxy, slice_pages=64)
        cc = pkg.cleancache.CleanCacheClient(be)
        oids = np.full(48, 3, np.uint32)
        idxs = np.arange(48, dtype=np.uint32)
        pages = (idxs[:, None] * 7 + np.arange(W)).astype(np.uint32)
        cc.put_pages(oids, idxs, pages)
        out, found = cc.get_pages(oids, idxs)
        ops_before = int(srv.stats["ops"])
        absent = cc.get_page(3, 9999)
        ops_after = int(srv.stats["ops"])   # a pure miss: no wire traffic
        be2 = one.mod.OneSidedBackend(proxy, slice_pages=64)
        _, found2 = pkg.cleancache.CleanCacheClient(be2).get_pages(
            oids[:4], idxs[:4])
        res = dict(out=out, found=found, absent=absent is None,
                   ops=(ops_before, ops_after), found2=found2,
                   client=_client(be), client2=_client(be2),
                   io=(pool.reads, pool.writes))
        proxy.close()
    finally:
        stop(srv)
    return res


def test_onesided_client_stack_over_network():
    t = twin(_client_stack_drill)
    pages = (np.arange(48, dtype=np.uint32)[:, None] * 7
             + np.arange(W)).astype(np.uint32)
    assert t["found"].all() and np.array_equal(t["out"], pages)
    assert t["absent"] and t["ops"][0] == t["ops"][1]
    assert not t["found2"].any()


def _exhaustion_drill(pkg):
    srv, pool, proxy, _ = _net_pool(pkg)
    try:
        first = proxy.grant(200)
        with pytest.raises(RuntimeError):
            proxy.grant(200)
        after = proxy.grant(16)   # the connection still serves
        res = dict(first=first, after=after,
                   counters={k: int(srv.stats[k]) for k in
                             ("connects", "ops", "bad_rows", "bad_frames")},
                   granted=pool.granted_rows)
        proxy.close()
    finally:
        stop(srv)
    return res


def test_remote_pool_grant_exhaustion_refused():
    t = twin(_exhaustion_drill)
    assert t["after"][1] - t["after"][0] == 16 and t["granted"] == 216
