"""PyTorch port: `tests/test_tier.py`'s drills, one by one, on both packages.

Each test carries the name of the JAX drill it twins (the three
`PMDFC_TIER` drills are twinned in `test_torch_env_switches.py`) and runs
that drill's script at its own sizes through the JAX `KV` and the port's
`KV(device="cpu")` over the tiered pool: the hot and cold pools, promotion,
demotion and the ghost ring, the balloon, the generation guard, the
compacted GET, the sampled touch, the stats surfaces, the sharded report,
the one-sided pool's tiered mode, `MSG_STATS` over each package's own
wire, and a tiered snapshot restored. Both sides are held to the JAX
drill's asserts and to its row-ownership invariants, and what each returns
must be equal: results, tier counters, stats and every state leaf
(tolerance 0).
"""

from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import (counters, fresh_jax_registry,  # noqa: F401
                        registries, same, stop)

from pmdfc_tpu import checkpoint as jckpt
from pmdfc_tpu import config as jconf
from pmdfc_tpu import kv as jkv
from pmdfc_tpu import onesided as jone
from pmdfc_tpu import tier as jtier
from pmdfc_tpu.client import backends as jbe
from pmdfc_tpu.models.base import get_index_ops as jops
from pmdfc_tpu.ops.pagepool import page_digest_np
from pmdfc_tpu.parallel import shard as jshard
from pmdfc_tpu.runtime import net as jnet
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import checkpoint as tckpt
from pmdfc_tpu_torch import config as tconf
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch import onesided as tone
from pmdfc_tpu_torch import tier as ttier
from pmdfc_tpu_torch.client import backends as tbe
from pmdfc_tpu_torch.models.base import get_index_ops as tops
from pmdfc_tpu_torch.parallel import shard as tshard
from pmdfc_tpu_torch.runtime import net as tnet
from pmdfc_tpu_torch.utils import u32

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures(
    "fresh_jax_registry")]

W = 64
INVALID_WORD = 0xFFFFFFFF


def _jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _jax_scan(kv):
    fk, fv = jops(kv.config.index.kind).scan(kv.state.index)
    return np.asarray(fk), np.asarray(fv)


def _port_scan(kv):
    fk, fv = tops(kv.config.index.kind).scan(kv.state.index)
    return u32.to_numpy(fk), u32.to_numpy(fv)


JAX = types.SimpleNamespace(
    conf=jconf, KV=jkv.KV, tier=jtier, scan=_jax_scan,
    leaves=_jax_leaves, stat=lambda kv, k: int(
        jtier.stats_arrays(kv.state.pool)[k]),
    sharded=lambda cfg: jshard.ShardedKV(
        cfg, mesh=jshard.make_mesh(jax.devices("cpu")[:2]),
        dispatch="broadcast"),
    pool=lambda *a, **kw: jone.PassivePool(*a, **kw),
    net=jnet, backends=jbe,
    load=lambda path, cfg: jkv.KV(cfg, state=jckpt.load(path, cfg)))
PORT = types.SimpleNamespace(
    conf=tconf, KV=lambda cfg: tkv.KV(cfg, device="cpu"), tier=ttier,
    scan=_port_scan, leaves=carry.state_to_numpy, stat=lambda kv, k: int(
        ttier.stats_arrays(kv.state.pool)[k]),
    sharded=lambda cfg: tshard.ShardedKV(
        cfg, mesh=tshard.make_mesh(["cpu"] * 2), dispatch="broadcast"),
    pool=lambda *a, **kw: tone.PassivePool(*a, device="cpu", **kw),
    net=tnet, backends=tbe,
    load=lambda path, cfg: tkv.KV(
        cfg, state=tckpt.load(path, cfg, device="cpu"), device="cpu"))


def twin(drill):
    """`drill(pkg)` on JAX, then on the port; equal observables."""
    a, b = drill(JAX), drill(PORT)
    same(a, b, drill.__name__)
    return b


def _cfg(p, capacity=1 << 10, tier=None, **tkw):
    c = p.conf
    t = tier if tier is not None else c.TierConfig(**tkw)
    return c.KVConfig(index=c.IndexConfig(capacity=capacity), bloom=None,
                      paged=True, page_words=W, tier=t)


def _keys(los):
    los = np.asarray(los, np.uint32)
    return np.stack([los >> 16, los], axis=-1).astype(np.uint32)


def _pages(keys):
    lo = np.asarray(keys, np.uint32)[:, 1]
    return (lo[:, None] * np.uint32(2654435761)
            + np.arange(W, dtype=np.uint32)[None, :])


def _check_invariants(p, kv) -> None:
    """`test_tier.py`'s row-uniqueness and hot-ownership coherence on
    either package's state."""
    lv = p.leaves(kv.state)
    h = lv["pool.hfree"].shape[0]
    fk, fv = p.scan(kv)
    valid = ~np.all(fk == INVALID_WORD, axis=-1)
    paged = valid & ((fv[:, 0] >> 30) == 0)
    cgen = lv["pool.cgen"]
    rws = fv[:, 1].astype(np.int64)
    is_cold = paged & (rws >= h)
    cur = paged & np.where(
        is_cold, fv[:, 0] == cgen[np.clip(rws - h, 0, len(cgen) - 1)],
        fv[:, 0] == 0)
    rows = fv[cur, 1].astype(np.int64)
    assert len(np.unique(rows)) == len(rows)
    hk = lv["pool.hot_keys"]
    occ = ~np.all(hk == INVALID_WORD, axis=-1)
    claimed_hot = rows[rows < h]
    keys_of_hot = fk[cur][rows < h]
    for r, k in zip(claimed_hot, keys_of_hot):
        assert occ[r], f"hot row {r} claimed by index but unowned"
        assert (hk[r] == k).all(), f"hot row {r} ownership mismatch"
    assert occ.sum() == len(claimed_hot)


def _end(p, kv, **obs) -> dict:
    obs.update(stats=counters(kv.stats()), tier=kv.tier_stats(),
               leaves=p.leaves(kv.state))
    return obs


def test_promotion_preserves_bytes_and_digests():
    def drill(p):
        kv = p.KV(_cfg(p, capacity=1 << 9, promote_touches=2))
        keys = _keys(np.arange(1, 129))
        pages = _pages(keys)
        kv.insert(keys, pages)
        hot_set = keys[:24]
        for _ in range(3):
            out, found = kv.get(hot_set)
            assert found.all() and (out == _pages(hot_set)).all()
        ts = kv.tier_stats()
        assert ts["promotions"] > 0 and ts["hot_hits"] > 0
        assert ts["migrated_bytes"] == ts["migrated_pages"] * W * 4
        lv = p.leaves(kv.state)
        hk = lv["pool.hot_keys"]
        occ = ~np.all(hk == INVALID_WORD, axis=-1)
        assert occ.any()
        nh = lv["pool.hfree"].shape[0]
        hp = lv["pool.pages"][:nh][occ]
        assert (page_digest_np(hp) == lv["pool.sums"][:nh][occ]).all()
        assert (hp == _pages(hk[occ])).all()
        _check_invariants(p, kv)
        out, found = kv.get(keys)
        assert found.all() and (out == pages).all()
        assert kv.stats()["corrupt_pages"] == 0
        _check_invariants(p, kv)
        return _end(p, kv, occ=occ)
    twin(drill)


def test_demotion_and_ghost_readmission():
    def drill(p):
        kv = p.KV(_cfg(p, capacity=1 << 8, tier=p.conf.TierConfig(
            hot_fraction=16, promote_touches=2, ghost_rows=64)))
        h = p.tier.num_hot_rows(1 << 8, kv.config.tier)
        keys = _keys(np.arange(1, 3 * h + 2))
        kv.insert(keys, _pages(keys))
        a = keys[:1]
        for _ in range(3):
            kv.get(a)
        assert kv.tier_stats()["promotions"] >= 1
        rest = keys[1:2 * h + 1]
        for _ in range(3):
            out, found = kv.get(rest)
            assert found.all() and (out == _pages(rest)).all()
        assert kv.tier_stats()["demotions"] >= 1
        _check_invariants(p, kv)
        before = kv.tier_stats()["ghost_readmits"]
        out, found = kv.get(a)
        assert found.all() and (out == _pages(a)).all()
        assert kv.stats()["corrupt_pages"] == 0
        _check_invariants(p, kv)
        assert kv.tier_stats()["ghost_readmits"] >= before
        return _end(p, kv, h=h)
    twin(drill)


def test_balloon_grow_covers_fill_burst():
    def drill(p):
        kv = p.KV(_cfg(p, capacity=1 << 10, tier=p.conf.TierConfig(
            cold_init_rows=64, balloon_step=64, grow_free_rows=16)))
        keys = _keys(np.arange(1, 400))
        pages = _pages(keys)
        for i in range(0, len(keys), 64):
            kv.insert(keys[i:i + 64], pages[i:i + 64])
        assert kv.tier_stats()["balloon_grows"] >= 1
        s = kv.stats()
        assert s["drops"] == 0
        out, found = kv.get(keys)
        assert (out[found] == pages[found]).all()
        assert found.sum() + s["evictions"] >= len(keys) - s["drops"]
        _check_invariants(p, kv)
        return _end(p, kv, found=found)
    twin(drill)


def test_balloon_shrink_under_load_degrades_to_misses():
    def drill(p):
        kv = p.KV(_cfg(p, capacity=1 << 9,
                       tier=p.conf.TierConfig(balloon_step=32)))
        keys = _keys(np.arange(1, 257))
        pages = _pages(keys)
        kv.insert(keys, pages)
        free_before = p.stat(kv, "cold_free")
        assert kv.balloon_shrink(free_before + 64)
        ts = kv.tier_stats()
        assert ts["balloon_shrinks"] >= 1 and ts["shrink_evictions"] >= 1
        out, found = kv.get(keys)
        assert not found.all()
        assert (out[found] == pages[found]).all()
        assert kv.stats()["corrupt_pages"] == 0
        assert kv.balloon_grow(64)
        more = _keys(np.arange(1000, 1032))
        kv.insert(more, _pages(more))
        out2, found2 = kv.get(more)
        assert (out2[found2] == _pages(more)[found2]).all()
        _check_invariants(p, kv)
        return _end(p, kv, found=found, found2=found2)
    twin(drill)


def test_stale_entries_never_alias_recirculated_rows():
    def drill(p):
        kv = p.KV(_cfg(p, capacity=1 << 8,
                       tier=p.conf.TierConfig(balloon_step=16)))
        keys = _keys(np.arange(1, 129))
        pages = _pages(keys)
        kv.insert(keys, pages)
        free0 = p.stat(kv, "cold_free")
        assert kv.balloon_shrink(free0 + 96)
        assert kv.balloon_grow(96)
        new = _keys(np.arange(1000, 1096))
        new_pages = _pages(new)
        kv.insert(new, new_pages)
        out, found = kv.get(keys)
        assert (out[found] == pages[found]).all()
        hit = kv.delete(keys)
        out2, found2 = kv.get(new)
        assert found2.all() and (out2 == new_pages).all()
        assert kv.stats()["corrupt_pages"] == 0
        _check_invariants(p, kv)
        return _end(p, kv, found=found, hit=hit)
    twin(drill)


def test_delete_frees_hot_row():
    def drill(p):
        kv = p.KV(_cfg(p, capacity=1 << 8, promote_touches=1))
        keys = _keys(np.arange(1, 33))
        kv.insert(keys, _pages(keys))
        kv.get(keys[:4])
        assert kv.tier_stats()["promotions"] >= 4
        occ0 = p.stat(kv, "hot_occupied")
        assert occ0 >= 4
        assert kv.delete(keys[:4]).all()
        assert p.stat(kv, "hot_occupied") <= occ0 - 4
        _, found = kv.get(keys[:4])
        assert not found.any()
        _check_invariants(p, kv)
        return _end(p, kv, occ0=occ0)
    twin(drill)


def test_get_compact_tiered_serves_hits_front():
    def drill(p):
        kv = p.KV(_cfg(p, capacity=1 << 8, promote_touches=1))
        keys = _keys(np.arange(1, 17))
        pages = _pages(keys)
        kv.insert(keys, pages)
        kv.get(keys)
        probe = np.concatenate([keys[:8], _keys(np.arange(500, 508))])
        out, order, found, nfound, b = kv.get_compact_async(probe)
        out, order, found = (np.asarray(u32.to_numpy(out) if p is PORT
                                        else out), np.asarray(order),
                             np.asarray(found))
        nf = int(nfound)
        assert nf == 8
        assert (out[:nf] == pages[order[:nf]]).all()
        return _end(p, kv, out=out[:nf], order=order, found=found, b=int(b))
    twin(drill)


def test_update_in_place_of_hot_resident_key():
    def drill(p):
        kv = p.KV(_cfg(p, capacity=1 << 8, promote_touches=1))
        keys = _keys(np.arange(1, 9))
        kv.insert(keys, _pages(keys))
        kv.get(keys)
        new_pages = _pages(keys) ^ np.uint32(0xABCD)
        kv.insert(keys, new_pages)
        out, found = kv.get(keys)
        assert found.all() and (out == new_pages).all()
        assert kv.stats()["corrupt_pages"] == 0
        _check_invariants(p, kv)
        return _end(p, kv)
    twin(drill)


def test_tier_sampled_touch_cadence():
    def drill(p):
        c = p.conf
        cfg = c.KVConfig(
            index=c.IndexConfig(capacity=1 << 8, touch_sample_every=4),
            bloom=None, paged=True, page_words=W,
            tier=c.TierConfig(promote_touches=1))
        kv = p.KV(cfg)
        keys = _keys(np.arange(1, 9))
        pages = _pages(keys)
        kv.insert(keys, pages)
        for _ in range(3):
            out, found = kv.get(keys)
            assert found.all() and (out == pages).all()
        ts = kv.tier_stats()
        assert ts["hot_hits"] + ts["cold_hits"] == 0
        assert ts["promotions"] == 0
        out, found = kv.get(keys)
        assert found.all() and (out == pages).all()
        ts = kv.tier_stats()
        assert ts["cold_hits"] == 8 and ts["promotions"] == 8
        return _end(p, kv)
    twin(drill)


def test_tier_stats_surface_in_print_stats():
    def drill(p):
        kv = p.KV(_cfg(p, capacity=1 << 8))
        line = kv.print_stats()
        assert "hot_hits=" in line and "promotions=" in line
        assert "balloon_grows" in line
        return [w for w in line.split() if not w.startswith("uptime")]
    twin(drill)


def test_sharded_tier_counters_in_shard_report():
    def drill(p):
        kv = p.sharded(_cfg(p, capacity=1 << 8, promote_touches=1))
        keys = _keys(np.arange(1, 49))
        pages = _pages(keys)
        kv.insert(keys, pages)
        for _ in range(2):
            out, found = kv.get(keys)
            assert found.all() and (out == pages).all()
        rep = kv.shard_report()
        assert "tier" in rep
        t = rep["tier"]
        assert len(t["hot_hits"]) == 2
        total = kv.tier_stats()
        assert total["promotions"] == sum(t["promotions"]) > 0
        assert len(rep["hot_heat"]) == 2
        for heat, occ in zip(rep["hot_heat"], t["hot_occupied"]):
            assert 0.0 <= heat <= occ + 1e-6
        return {"tier": {k: [int(x) for x in v] for k, v in t.items()},
                "total": total, "stats": counters(kv.stats())}
    twin(drill)


def test_passive_pool_tiered_mode():
    def drill(p):
        pool = p.pool(128, page_words=32, mode="tiered", hot_rows=8,
                      promote_touches=2)
        rows = np.arange(16, dtype=np.int32)
        pages = (np.arange(16, dtype=np.uint32)[:, None] * 977
                 + np.arange(32, dtype=np.uint32)[None, :])
        pool.write_rows(rows, pages)
        for _ in range(3):
            assert (pool.read_rows(rows) == pages).all()
        s = pool.stats()
        assert s["promotions"] > 0 and s["hot_hits"] > 0
        assert s["demotions"] > 0 and s["hot_mirrored"] <= 8
        pages2 = pages ^ np.uint32(7)
        pool.write_rows(rows, pages2)
        out = pool.read_rows(rows)
        assert (out == pages2).all()
        return {"stats": s, "after": pool.stats(), "out": out}
    twin(drill)


def test_tier_stats_over_the_wire():
    def drill(p):
        kv = p.KV(_cfg(p, capacity=1 << 8, promote_touches=1))
        srv = p.net.NetServer(lambda: p.backends.DirectBackend(kv)).start()
        try:
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None) as be:
                keys = _keys(np.arange(1, 9))
                be.put(keys, _pages(keys))
                out, found = be.get(keys)
                assert found.all()
                s = be.server_stats()
                assert s["puts"] == 8
                assert "promotions" in s and "balloon_grows" in s
                assert s["promotions"] >= 1
        finally:
            stop(srv)
        return {"out": out, "tier": {k: s[k] for k in kv.tier_stats()},
                "puts": s["puts"], "hits": s["hits"]}
    twin(drill)


def test_checkpoint_roundtrip_tiered(tmp_path):
    def drill(p):
        cfg = _cfg(p, capacity=1 << 8, promote_touches=1)
        kv = p.KV(cfg)
        keys = _keys(np.arange(1, 33))
        pages = _pages(keys)
        kv.insert(keys, pages)
        kv.get(keys)
        assert kv.tier_stats()["promotions"] > 0
        path = str(tmp_path / f"tier-{id(p)}.ckpt")
        kv.snapshot(path)
        kv2 = p.load(path, cfg)
        same(p.leaves(kv2.state), p.leaves(kv.state), "restored leaves")
        out, found = kv2.get(keys)
        assert found.all() and (out == pages).all()
        return _end(p, kv2)
    twin(drill)
