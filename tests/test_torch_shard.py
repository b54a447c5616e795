"""PyTorch port: `ShardedKV` against the JAX `ShardedKV`, verb by verb.

The JAX plane runs on its forced CPU devices (`tests/conftest.py`), the
port's on a grid that names the CPU once per shard. The same seeded mix of
inserts (updates, in-batch duplicates, padding, capacity evictions), gets,
deletes, extents across shards, `find_anyway`, `utilization`, `recovery`
and the packed bloom goes through both, over 2 and 4 shards in both
dispatch modes, for the linear index, CCEH, a composed family and the
tiered pool. Every result, `stats()`, every shard's stats row of
`shard_report()` and every per-shard state leaf (through `carry`) must
be identical. Tolerance 0.

The helpers here (`cfg_pair`, `jax_grid`, `port_grid`, `same`,
`check_leaves`, ...) are shared by the other plane test files.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu import config as jc
from pmdfc_tpu.parallel import shard as jshard
from pmdfc_tpu.utils.hashing import shard_of as jshard_of
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import config as tc
from pmdfc_tpu_torch.parallel import shard as tshard
from pmdfc_tpu_torch.parallel.partitioning import shard_of_np

pytestmark = pytest.mark.torch


def cfg_pair(kind="linear", capacity=1 << 10, bloom_bits=1 << 15,
             paged=True, page_words=16, tier=None, **ix):
    """The same KVConfig in both packages (`tier` a dict of TierConfig
    fields, with `admit` a dict of AdmitConfig fields)."""
    def make(m):
        t = None
        if tier is not None:
            kw = dict(tier)
            if kw.get("admit") is not None:
                kw["admit"] = m.AdmitConfig(**kw["admit"])
            t = m.TierConfig(**kw)
        return m.KVConfig(
            index=m.IndexConfig(kind=m.IndexKind(kind), capacity=capacity,
                                **ix),
            bloom=m.BloomConfig(num_bits=bloom_bits) if bloom_bits else None,
            paged=paged, page_words=page_words, tier=t,
            evicted_sketch_bits=1 << 10)
    return make(jc), make(tc)


def jax_grid(n, lanes=1):
    devs = jax.devices()[:n * lanes]
    return (jshard.make_mesh2d(n, lanes, np.array(devs)) if lanes > 1
            else jshard.make_mesh(np.array(devs)))


def port_grid(n, lanes=1):
    return (tshard.make_mesh2d(n, lanes, ["cpu"] * (n * lanes)) if lanes > 1
            else tshard.make_mesh(["cpu"] * n))


def keys_of(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 20, size=n, replace=False)
    return np.stack([flat >> 10, flat & 0x3FF], -1).astype(np.uint32)


def pages_of(keys, w=16):
    return ((keys[:, 0] * np.uint32(31) + keys[:, 1])[:, None]
            + np.arange(1, w + 1, dtype=np.uint32)[None, :])


def same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert np.array_equal(a, b), f"{what} differs"


def same_result(ra, rb, what):
    """InsertResult / tuple / array, field by field."""
    if hasattr(ra, "_fields"):
        for f in ra._fields:
            same(getattr(ra, f), getattr(rb, f), f"{what} {f}")
    elif isinstance(ra, tuple):
        for i, (x, y) in enumerate(zip(ra, rb)):
            same(x, y, f"{what}[{i}]")
    else:
        same(ra, rb, what)


def jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def jax_lane_leaves(state, n, lanes) -> dict:
    """Every leaf of a 2-D JAX plane lane by lane, `[n, R, ...]`, from
    the device buffers (each replica lane holds its own copy)."""
    mesh_devs = None
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    for path, v in flat:
        name = ".".join(k.name for k in path)
        if mesh_devs is None:
            mesh_devs = list(v.sharding.mesh.devices.reshape(-1))
        by_dev = {sh.device: np.asarray(sh.data) for sh in
                  v.addressable_shards}
        out[name] = np.stack([
            np.stack([by_dev[mesh_devs[s * lanes + r]][0]
                      for r in range(lanes)]) for s in range(n)])
    return out


def check_leaves(a, b, what=""):
    la, lb = jax_leaves(a.state), carry.sharded_to_numpy(b._st)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, f"{what} leaf {k} dtype"
        same(la[k], lb[k], f"{what} leaf {k}")


def check_stats(a, b, what=""):
    sa, sb = a.stats(), b.stats()
    assert sa == sb, f"{what} stats: {sa} vs {sb}"
    ra, rb = a.shard_report(), b.shard_report()
    assert ra == rb, f"{what} shard_report: {ra} vs {rb}"


def pair(jcfg, tcfg, n, dispatch="a2a", lanes=1, **kw):
    return (jshard.ShardedKV(jcfg, mesh=jax_grid(n, lanes),
                             dispatch=dispatch, **kw),
            tshard.ShardedKV(tcfg, mesh=port_grid(n, lanes),
                             dispatch=dispatch, **kw))


# ---------------------------------------------------------------------------

CASES = {
    # name: (cfg_pair kwargs, shards, dispatch)
    "linear-a2a-2": (dict(), 2, "a2a"),
    "linear-a2a-4": (dict(), 4, "a2a"),
    "linear-broadcast-4": (dict(), 4, "broadcast"),
    "cceh-a2a-4": (dict(kind="cceh", capacity=512, segment_slots=64,
                        probe_window=16), 4, "a2a"),
    "cceh-broadcast-2": (dict(kind="cceh", capacity=512, segment_slots=64,
                              probe_window=16), 2, "broadcast"),
    "cuckoo-a2a-4": (dict(kind="cuckoo", capacity=512), 4, "a2a"),
    "unpaged-a2a-4": (dict(paged=False, page_words=1024), 4, "a2a"),
    "tiered-a2a-2": (dict(capacity=512, tier=dict(
        ghost_rows=32, promote_touches=1, max_promotes_per_batch=32),
        touch_sample_every=2), 2, "a2a"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_verbs_match_jax(case):
    kw, n, dispatch = CASES[case]
    jcfg, tcfg = cfg_pair(**kw)
    a, b = pair(jcfg, tcfg, n, dispatch)
    assert a.capacity() == b.capacity()
    rng = np.random.default_rng(len(case))
    vw = tcfg.page_words if tcfg.paged else 2
    live = np.zeros((0, 2), np.uint32)
    for step, m in enumerate((300, 513, 700)):
        keys = rng.integers(0, 1 << 32, (m, 2), dtype=np.uint32)
        keys[: m // 8] = keys[m // 8: 2 * (m // 8)]       # in-batch dups
        if len(live):
            keys[m // 4: m // 4 + 64] = live[rng.integers(0, len(live), 64)]
        keys[rng.integers(0, m, 5)] = 0xFFFFFFFF           # padding keys
        vals = rng.integers(0, 1 << 32, (m, vw), dtype=np.uint32)
        same_result(a.insert(keys, vals), b.insert(keys, vals),
                    f"insert {step}")
        live = np.concatenate([live, keys])
        probe = np.concatenate([
            live[rng.integers(0, len(live), 150)],
            rng.integers(0, 1 << 32, (40, 2), dtype=np.uint32),
            np.full((3, 2), 0xFFFFFFFF, np.uint32)])
        same_result(a.get(probe), b.get(probe), f"get {step}")
        if step == 1:
            gone = np.concatenate([live[rng.integers(0, len(live), 80)],
                                   live[:6], live[:6]])
            same(a.delete(gone), b.delete(gone), f"delete {step}")
    # extents: covers of one record land on different shards
    for key, val, ln in (([7, 1000], [0, 1 << 20], 300),
                         ([1, 64], [0, 4096], 100), ([2, 0], [1, 0], 17)):
        ra, ua = a.insert_extent(key, val, ln)
        rb, ub = b.insert_extent(key, val, ln)
        same_result(ra, rb, f"insert_extent {key}")
        assert ua == ub
    off = np.arange(0, 310, 7, dtype=np.uint32)
    eprobe = np.concatenate([
        np.stack([np.full_like(off, 7), 1000 + off], -1),
        np.array([[1, 64], [1, 163], [1, 164], [2, 0], [2, 16], [2, 17],
                  [3, 5]], np.uint32)]).astype(np.uint32)
    same_result(a.get_extent(eprobe), b.get_extent(eprobe), "get_extent")
    fa = a.find_anyway(live[:40])
    fb = b.find_anyway(live[:40])
    for x, y, what in zip(fa, fb, ("vals", "found", "slot", "shard")):
        same(np.asarray(x), y, f"find_anyway {what}")
    assert a.utilization() == b.utilization()
    assert a.recovery() and b.recovery()
    same_result(a.get(live[:200]), b.get(live[:200]), "get after recovery")
    pa, pb = a.packed_bloom(), b.packed_bloom()
    assert (pa is None) == (pb is None)
    if pa is not None:
        same(pa, pb, "packed_bloom")
        same(a.packed_bloom_per_shard(), b.packed_bloom_per_shard(),
             "packed_bloom_per_shard")
    check_stats(a, b, case)
    check_leaves(a, b, case)
    s = b.stats()
    assert s["misses"] == sum(s[c] for c in ("miss_cold", "miss_evicted",
                                             "miss_parked", "miss_stale",
                                             "miss_digest", "miss_routed",
                                             "miss_recovering", "miss_shed",
                                             "miss_quarantined",
                                             "miss_deadline"))


def test_a2a_bucket_overflow_is_reported_like_jax():
    """Twin of `test_a2a_bucket_overflow_is_reported_not_silent`: every key
    of the batch owned by ONE shard; the rows past each pair's capacity
    come back as drops on insert and `miss_routed` misses on get, counted
    on the requesting shard, and deletes stay loss-free."""
    jcfg, tcfg = cfg_pair(capacity=1 << 12, paged=False, page_words=1024)
    a, b = pair(jcfg, tcfg, 4)
    pool = keys_of(4096, seed=60)
    owner = np.asarray(jshard_of(jnp.asarray(pool), 4))
    same(owner, shard_of_np(pool, 4), "owners")
    mine = pool[owner == 3][:256]
    assert len(mine) == 256
    vals = np.ones((256, 2), np.uint32)
    ra, rb = a.insert(mine, vals), b.insert(mine, vals)
    same_result(ra, rb, "overflow insert")
    # w = 256 over 4 shards: bl = 64, c_pair = 32 -> 32 dropped per source
    assert rb.dropped.sum() == 4 * 32
    same_result(a.get(mine), b.get(mine), "overflow get")
    s = b.stats()
    assert s["puts"] == 256 and s["drops"] == 128
    assert s["miss_routed"] == 128 and s["misses"] == 128 + 0
    same(a.delete(mine), b.delete(mine), "overflow delete")
    same(b.delete(mine), np.zeros(256, bool), "second delete")
    check_stats(a, b, "overflow")
    check_leaves(a, b, "overflow")


def test_dup_keys_last_wins_across_shards():
    jcfg, tcfg = cfg_pair(capacity=1 << 12, paged=False, page_words=1024)
    for dispatch in ("a2a", "broadcast"):
        a, b = pair(jcfg, tcfg, 4, dispatch)
        base = keys_of(60, seed=21)
        keys = np.concatenate([base, base[::2], base[::3]])
        vals = np.stack([np.arange(len(keys), dtype=np.uint32),
                         np.arange(len(keys), dtype=np.uint32) * 7], -1)
        same_result(a.insert(keys, vals), b.insert(keys, vals), dispatch)
        out, found = b.get(base)
        assert found.all()
        same_result(a.get(base), (out, found), dispatch)


def test_lrfu_plane_and_node_of_match_jax():
    jcfg, tcfg = cfg_pair()
    a, b = pair(jcfg, tcfg, 4, lrfu_stats=True)
    for seed in range(3):
        k = keys_of(100 + 50 * seed, seed=seed)
        a.insert(k, pages_of(k))
        b.insert(k, pages_of(k))
        a.get(k[:70])
        b.get(k[:70])
    same(a.node_of(k), b.node_of(k), "node_of")
    check_stats(a, b, "lrfu")
    rep = b.shard_report()
    assert sum(rep["freq"]) == sum(100 + 50 * s + 70 for s in range(3))
