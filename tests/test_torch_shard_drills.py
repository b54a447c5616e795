"""PyTorch port: the drills of `tests/test_shard.py` that no other port
test runs on both packages, each at the JAX drill's own shape (8 shards:
the JAX plane on the 8 forced CPU devices of `tests/conftest.py`, the
port's on a grid naming the CPU eight times).

Paged shards without a bloom, FIFO evictions reported through the
combine, the clean-cache client over a `DirectBackend` of the plane,
`node_of` against where `find_anyway` finds each key and the per-shard
report, HotRing's sampled touches across shards, and the tier counters
that `KVServer.health`, `tier_stats()`, `stats()` and `shard_report()`
publish. Every result, `stats()`, `shard_report()` and every per-shard
state leaf (through `carry`) must be equal. Tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from test_torch_shard import (check_leaves, check_stats, cfg_pair, pair,
                              same, same_result)
from torch_twin import fresh_jax_registry, registries  # noqa: F401
from torch_twin import same as same_deep

from pmdfc_tpu import tier as jtier
from pmdfc_tpu.client.backends import DirectBackend as JDirect
from pmdfc_tpu.client.cleancache import CleanCacheClient as JClean
from pmdfc_tpu.kv import KV as JKV
from pmdfc_tpu.runtime.engine import Engine as JEngine
from pmdfc_tpu.runtime.server import KVServer as JServer
from pmdfc_tpu_torch import tier as ttier
from pmdfc_tpu_torch.client.backends import DirectBackend as TDirect
from pmdfc_tpu_torch.client.cleancache import CleanCacheClient as TClean
from pmdfc_tpu_torch.kv import KV as TKV
from pmdfc_tpu_torch.runtime.engine import Engine as TEngine
from pmdfc_tpu_torch.runtime.server import KVServer as TServer

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]


def _keys(n, seed=0):
    """`tests/test_shard.py`'s keys."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 20, size=n, replace=False).astype(np.uint32)
    return np.stack([flat >> 10, flat & 0x3FF], axis=-1).astype(np.uint32)


def test_paged_mode_sharded_matches_jax():
    jcfg, tcfg = cfg_pair(capacity=1 << 10, bloom_bits=0, page_words=64)
    a, b = pair(jcfg, tcfg, 8)
    keys = _keys(40, seed=5)
    pages = np.random.default_rng(6).integers(
        0, 1 << 32, size=(40, 64), dtype=np.uint64).astype(np.uint32)
    same_result(a.insert(keys, pages), b.insert(keys, pages), "insert")
    out, found = b.get(keys)
    assert found.all() and np.array_equal(out, pages)
    same_result(a.get(keys), (out, found), "get")
    assert a.packed_bloom() is None and b.packed_bloom() is None
    check_stats(a, b, "paged")
    check_leaves(a, b, "paged")


def test_eviction_propagates_like_jax():
    """16 slots a shard x 8 = 128 < 256 keys: the second batch FIFO-evicts
    the first's residents, and every evicted key is counted."""
    jcfg, tcfg = cfg_pair(capacity=16, cluster_slots=16, bloom_bits=1 << 10,
                          paged=False)
    a, b = pair(jcfg, tcfg, 8)
    keys = _keys(256, seed=7)
    vals = np.ones((256, 2), np.uint32)
    same_result(a.insert(keys[:128], vals[:128]),
                b.insert(keys[:128], vals[:128]), "first batch")
    ra, rb = a.insert(keys[128:], vals[128:]), b.insert(keys[128:],
                                                       vals[128:])
    same_result(ra, rb, "second batch")
    evicted = (np.asarray(rb.evicted) != 0xFFFFFFFF).any(axis=-1)
    assert evicted.sum() > 0
    assert b.stats()["evictions"] == int(evicted.sum())
    check_stats(a, b, "evictions")
    check_leaves(a, b, "evictions")


def test_cleancache_client_over_sharded_server_like_jax():
    """The clean-cache stack over `DirectBackend` of each package's plane:
    the same pages, the same short-circuits on the OR-combined filter,
    the same client counters."""
    jcfg, tcfg = cfg_pair(capacity=1 << 10, bloom_bits=1 << 13,
                          page_words=32)
    a, b = pair(jcfg, tcfg, 8)
    pages = np.random.default_rng(70).integers(
        0, 1 << 32, size=(60, 32), dtype=np.uint64).astype(np.uint32)
    runs = []
    for skv, direct, clean in ((a, JDirect, JClean), (b, TDirect, TClean)):
        cc = clean(direct(skv))
        cc.put_pages(np.full(60, 11), np.arange(60), pages)
        out = [cc.get_pages(np.full(60, 11), np.arange(60))]
        before = cc.counters["actual_gets"]
        out.append(cc.get_pages(np.full(30, 11), np.arange(500, 530)))
        assert cc.counters["bf_short_circuits"] >= 25
        assert cc.counters["actual_gets"] - before <= 5
        out.append(cc.invalidate_pages(np.full(10, 11), np.arange(10)))
        out.append(cc.get_pages(np.full(10, 11), np.arange(10)))
        out.append(dict(cc.counters))
        runs.append(out)
    same_deep(runs[0], runs[1], "cleancache")
    got, found = runs[1][0]
    assert found.all() and np.array_equal(got, pages)
    assert runs[1][2].all() and not runs[1][3][1].any()
    check_stats(a, b, "cleancache")


def test_node_of_and_shard_report_like_jax():
    jcfg, tcfg = cfg_pair(capacity=1 << 12, bloom_bits=1 << 15, paged=False)
    a, b = pair(jcfg, tcfg, 8)
    keys = _keys(256, seed=21)
    vals = np.stack([keys[:, 0] ^ 0xABCD, keys[:, 1] + 1], -1).astype(
        np.uint32)
    same_result(a.insert(keys, vals), b.insert(keys, vals), "insert")
    nodes = b.node_of(keys)
    same(a.node_of(keys), nodes, "node_of")
    fa, fb = a.find_anyway(keys), b.find_anyway(keys)
    for x, y, what in zip(fa, fb, ("vals", "found", "slot", "shard")):
        same(np.asarray(x), y, f"find_anyway {what}")
    assert fb[1].all() and np.array_equal(fb[3], nodes)
    rep = b.shard_report()
    assert rep["n_shards"] == 8 and sum(rep["occupancy"]) == 256
    assert all(o > 0 for o in rep["occupancy"]) and "crf" not in rep
    check_stats(a, b, "node_of")


def test_sampled_touch_sharded_like_jax():
    """HotRing's `touch_sample_every=4` across shards: the same results,
    and the counters bumped on batches 4 and 8 only, in both."""
    jcfg, tcfg = cfg_pair(kind="hotring", capacity=1 << 12, bloom_bits=0,
                          paged=False, touch_sample_every=4,
                          decay_every_gets=0)
    a, b = pair(jcfg, tcfg, 8)
    keys = _keys(256, seed=9)
    same_result(a.insert(keys, keys), b.insert(keys, keys), "insert")
    for i in range(8):
        out, found = b.get(keys)
        assert found.all() and np.array_equal(out, keys)
        same_result(a.get(keys), (out, found), f"get {i}")
    check_leaves(a, b, "sampled touch")
    total = int(np.asarray(a.state.index.counters).sum())
    assert total == 2 * 256, total


def _touch(store, w):
    keys = _keys(192, seed=41)
    store.insert(keys, np.repeat(keys[:, 1:2], w, axis=1).astype(np.uint32))
    for _ in range(3):  # cold hits -> promotions
        _, found = store.get(keys[:64])
        assert found.all()


def test_health_and_shard_report_tier_stats_agree_like_jax():
    """After the same promotions: `KVServer.health`'s kv block, the KV's
    `tier_stats()` and `tier.counters_dict` agree per counter on one
    device, and `shard_report()`'s per-shard tier block sums to
    `tier_stats()` and `stats()` on the plane, each equal to JAX's."""
    w = 16
    jcfg, tcfg = cfg_pair(capacity=1 << 10, bloom_bits=0, page_words=w,
                          tier=dict(promote_touches=1, ghost_rows=64))
    eng = dict(num_queues=2, queue_cap=1 << 8, batch=128, timeout_us=200,
               arena_pages=256, page_bytes=w * 4)
    surfaces = []
    for kv, server, engine, tier_mod in (
            (JKV(jcfg), JServer, JEngine, jtier),
            (TKV(tcfg, device="cpu"), TServer, TEngine, ttier)):
        _touch(kv, w)
        srv = server(kv.config, kv=kv, engine=engine(**eng))
        try:
            health = srv.health()
        finally:
            srv.engine.close()
        ts = kv.tier_stats()
        expect = tier_mod.counters_dict(np.asarray(kv.state.pool.tstats),
                                        w * 4)
        assert expect["promotions"] > 0
        names = list(tier_mod.TIER_STAT_NAMES) + ["migrated_bytes"]
        for name in names:
            assert health["kv"][name] == ts[name] == expect[name], name
        surfaces.append({n: int(ts[n]) for n in names})
    assert surfaces[0] == surfaces[1]
    a, b = pair(jcfg, tcfg, 8)
    for skv in (a, b):
        _touch(skv, w)
    rep, ts, merged = b.shard_report(), b.tier_stats(), b.stats()
    for name in ttier.TIER_STAT_NAMES:
        assert sum(rep["tier"][name]) == ts[name] == merged[name], name
    assert ts["migrated_bytes"] == merged["migrated_bytes"]
    assert a.tier_stats() == ts
    check_stats(a, b, "tiered plane")
