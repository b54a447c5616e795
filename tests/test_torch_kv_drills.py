"""PyTorch port: `tests/test_kv.py`'s drills, one by one, on both packages.

Each test carries the name of the JAX drill it twins and runs that drill's
script through `pmdfc_tpu.kv.KV` and `pmdfc_tpu_torch.kv.KV(device="cpu")`
on the same seeded inputs. Both sides are held to the JAX drill's own
asserts, and what each returns must be equal: every verb's result, the
counters of `stats()` (all but the clock), and where the drill ends on a
state, every state leaf (tolerance 0: integer arithmetic). The poisoned
pool rows of the integrity drills are written in place on each package's
own state.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import (counters, fresh_jax_registry,  # noqa: F401
                        registries, same)
from torch_twin import walk_in_reverse

from pmdfc_tpu import config as jconf
from pmdfc_tpu import kv as jkv
from pmdfc_tpu.bench import fill_sweep as jfill
from pmdfc_tpu.client import backends as jbe
from pmdfc_tpu.ops import bloom as jbloom
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import config as tconf
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.bench import fill_sweep as tfill
from pmdfc_tpu_torch.client import backends as tbe
from pmdfc_tpu_torch.ops import bloom as tbloom
from pmdfc_tpu_torch.utils import u32

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures(
    "fresh_jax_registry")]
# the drills replay `test_kv.py`'s own JAX programs: compiled as the suite
# compiles them, each file finds the other's in the persistent cache
KEEP_XLA_DEFAULTS = True


def _jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _jax_xor_pool(kv, word) -> None:
    pool = kv.state.pool
    kv.state = dataclasses.replace(kv.state, pool=dataclasses.replace(
        pool, pages=pool.pages ^ jnp.uint32(word)))


def _jax_bump_word(kv, row, col) -> None:
    pool = kv.state.pool
    kv.state = dataclasses.replace(kv.state, pool=dataclasses.replace(
        pool, pages=pool.pages.at[row, col].add(jnp.uint32(1))))


def _port_bump_word(kv, row, col) -> None:
    kv.state.pool.pages[row, col] += 1


def _port_compact(state, cfg, keys):
    st, out, order, found, nfound = tkv.get_compact(
        state, cfg, u32.from_numpy(keys, "cpu"))
    return st, (u32.to_numpy(out), order.numpy(), found.numpy(),
                int(nfound))


def _jax_compact(state, cfg, keys):
    st, out, order, found, nfound = jkv.get_compact(state, cfg,
                                                    jnp.asarray(keys))
    return st, (np.asarray(out), np.asarray(order), np.asarray(found),
                int(nfound))


JAX = types.SimpleNamespace(
    conf=jconf, KV=jkv.KV, leaves=lambda kv: _jax_leaves(kv.state),
    bloom_query=lambda st, ks: np.asarray(
        jbloom.query_batch(st, jnp.asarray(ks), num_hashes=4)),
    utilization=lambda kv: float(jkv.utilization(kv.state, kv.config)),
    top=lambda kv: int(kv.state.pool.top),
    xor_pool=_jax_xor_pool, bump_word=_jax_bump_word, compact=_jax_compact,
    run_point=jfill.run_point, backends=jbe)
PORT = types.SimpleNamespace(
    conf=tconf, KV=lambda cfg: tkv.KV(cfg, device="cpu"),
    leaves=lambda kv: carry.state_to_numpy(kv.state),
    bloom_query=lambda st, ks: tbloom.query_batch(
        st, u32.from_numpy(ks, "cpu"), num_hashes=4).numpy(),
    utilization=lambda kv: float(tkv.utilization(kv.state, kv.config)),
    top=lambda kv: int(kv.state.pool.top),
    xor_pool=lambda kv, word: kv.state.pool.pages.bitwise_xor_(word),
    bump_word=_port_bump_word, compact=_port_compact,
    run_point=lambda *a, **kw: tfill.run_point(*a, device="cpu", **kw),
    backends=tbe)


def twin(drill):
    """`drill(pkg)` on JAX, then on the port; equal observables."""
    a, b = drill(JAX), drill(PORT)
    same(a, b, drill.__name__)
    return b


def small_cfg(p, paged=False, capacity=1 << 12, **kw):
    return p.conf.KVConfig(index=p.conf.IndexConfig(capacity=capacity),
                           bloom=p.conf.BloomConfig(num_bits=1 << 14),
                           paged=paged, page_words=16, **kw)


def u64vals(lo):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.zeros_like(lo), lo], axis=-1)


def keys_of(lo, hi=1):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.full_like(lo, hi), lo], axis=-1)


def _result(res) -> dict:
    """An `InsertResult` of either package as numpy fields."""
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


def _end(p, kv, **obs) -> dict:
    obs.update(stats=counters(kv.stats()), leaves=p.leaves(kv))
    return obs


def test_insert_then_get_roundtrip():
    def drill(p):
        kv = p.KV(small_cfg(p))
        ks = keys_of(np.arange(500))
        res = kv.insert(ks, u64vals(np.arange(500) * 3))
        out, found = kv.get(ks)
        assert found.all()
        np.testing.assert_array_equal(out[:, 1], np.arange(500) * 3)
        return _end(p, kv, res=_result(res), out=out, found=found)
    twin(drill)


def test_miss_is_legal():
    def drill(p):
        kv = p.KV(small_cfg(p))
        out, found = kv.get(keys_of([42]))
        assert not found.any()
        s = kv.stats()
        assert s["misses"] == 1 and s["gets"] >= 1
        return _end(p, kv, out=out, found=found)
    twin(drill)


def test_paged_roundtrip():
    def drill(p):
        cfg = small_cfg(p, paged=True)
        kv = p.KV(cfg)
        rng = np.random.default_rng(0)
        ks = keys_of(np.arange(64))
        pages = rng.integers(0, 2**32, size=(64, cfg.page_words),
                             dtype=np.uint32)
        kv.insert(ks, pages)
        out, found = kv.get(ks)
        assert found.all()
        np.testing.assert_array_equal(out, pages)
        return _end(p, kv, out=out)
    twin(drill)


def test_update_in_place():
    def drill(p):
        kv = p.KV(small_cfg(p))
        ks = keys_of([9])
        kv.insert(ks, u64vals([1]))
        kv.insert(ks, u64vals([2]))
        out, found = kv.get(ks)
        assert found.all() and out[0, 1] == 2
        return _end(p, kv, out=out)
    twin(drill)


def test_eviction_propagates_to_bloom():
    def drill(p):
        c = p.conf
        cfg = c.KVConfig(index=c.IndexConfig(capacity=16, cluster_slots=16),
                         bloom=c.BloomConfig(num_bits=1 << 14), paged=False)
        kv = p.KV(cfg)
        evicted = []
        for start in range(0, 32, 8):
            ks = keys_of(np.arange(start, start + 8))
            res = kv.insert(ks, u64vals(np.arange(start, start + 8)))
            evicted.append(np.asarray(res.evicted))
        assert kv.stats()["evictions"] == 16
        q = p.bloom_query(kv.state.bloom, keys_of(np.arange(16, 32)))
        assert q.all()
        out, found = kv.get(keys_of(np.arange(16)))
        assert not found.any()
        return _end(p, kv, evicted=evicted, query=q, found=found)
    twin(drill)


def test_delete():
    def drill(p):
        kv = p.KV(small_cfg(p))
        ks = keys_of(np.arange(10))
        kv.insert(ks, u64vals(np.arange(10)))
        hit = kv.delete(keys_of([3, 4, 99]))
        assert list(hit) == [True, True, False]
        _, found = kv.get(ks)
        assert found.sum() == 8
        return _end(p, kv, hit=hit, found=found)
    twin(drill)


def test_extent_roundtrip():
    def drill(p):
        kv = p.KV(small_cfg(p))
        base, length = 100, 13
        res, unc = kv.insert_extent(keys_of([base])[0],
                                    np.array([0, 5000], np.uint32), length)
        probe = keys_of(np.arange(base, base + length))
        out, found = kv.get_extent(probe)
        assert found.all()
        np.testing.assert_array_equal(
            out[:, 1], 5000 + np.arange(length, dtype=np.uint32) * 4096)
        out2, found2 = kv.get_extent(keys_of([base + length, base - 1]))
        assert not found2.any()
        return _end(p, kv, res=_result(res), uncovered=int(unc), out=out,
                    out2=out2, found2=found2)
    twin(drill)


def test_extent_cover_count_is_logarithmic():
    def drill(p):
        kv = p.KV(small_cfg(p))
        kv.insert_extent(keys_of([0])[0], np.array([0, 0], np.uint32), 1024)
        assert kv.stats()["extent_puts"] == 1
        u = kv.utilization()
        assert u * kv.capacity() <= 2
        return _end(p, kv, utilization=u)
    twin(drill)


def test_key_with_all_ones_hi_word_survives_padding():
    def drill(p):
        kv = p.KV(small_cfg(p))
        ks = keys_of(np.arange(30), hi=0xFFFFFFFF)
        res = kv.insert(ks, u64vals(np.arange(30)))
        r = _result(res)
        assert (r["slots"] >= 0).all() and not r["dropped"].any()
        out, found = kv.get(ks)
        assert found.all()
        np.testing.assert_array_equal(out[:, 1], np.arange(30))
        return _end(p, kv, res=r, out=out)
    twin(drill)


def test_large_extent_reachable():
    def drill(p):
        kv = p.KV(small_cfg(p))
        _, uncovered = kv.insert_extent(
            keys_of([0])[0], np.array([0, 0], np.uint32), 1 << 16)
        assert uncovered == 0
        out, found = kv.get_extent(keys_of([40000, (1 << 16) - 1, 1 << 16]))
        assert list(found) == [True, True, False]
        return _end(p, kv, out=out, found=found)
    twin(drill)


def test_extent_truncation_reported():
    def drill(p):
        kv = p.KV(small_cfg(p, extent_max_covers=4))
        _, uncovered = kv.insert_extent(
            keys_of([1])[0], np.array([0, 0], np.uint32), 1000)
        assert uncovered > 0
        return _end(p, kv, uncovered=int(uncovered))
    twin(drill)


def test_find_anyway_and_utilization():
    def drill(p):
        kv = p.KV(small_cfg(p))
        kv.insert(keys_of(np.arange(100)), u64vals(np.arange(100)))
        vals, found, slots = kv.find_anyway(keys_of([50, 7777]))
        assert list(found) == [True, False]
        assert vals[0, 1] == 50
        u = kv.utilization()
        assert 0 < u < 1
        assert kv.capacity() >= 4096
        assert kv.recovery()
        return _end(p, kv, vals=vals, found=found, slots=slots, u=u,
                    capacity=kv.capacity())
    twin(drill)


def test_stats_counts():
    def drill(p):
        kv = p.KV(small_cfg(p))
        ks = keys_of(np.arange(20))
        kv.insert(ks, u64vals(np.arange(20)))
        kv.get(ks)
        kv.get(keys_of([999]))
        s = kv.stats()
        assert s["puts"] == 20 and s["hits"] == 20 and s["misses"] == 1
        line = kv.print_stats()
        assert "puts=" in line
        return _end(p, kv, line=line.split("uptime")[0])
    twin(drill)


def test_paged_pool_rows_recycled_under_eviction():
    def drill(p):
        c = p.conf
        cfg = c.KVConfig(index=c.IndexConfig(capacity=1 << 8), bloom=None,
                         paged=True, page_words=8)
        kv = p.KV(cfg)
        rng = np.random.default_rng(1)
        n = 2048
        ks = keys_of(np.arange(n))
        pages = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
        for i in range(0, n, 128):
            kv.insert(ks[i:i + 128], pages[i:i + 128])
        out, found = kv.get(ks)
        assert found.sum() > 0 and (~found).sum() > 0
        np.testing.assert_array_equal(out[found], pages[found])
        live = p.utilization(kv) * kv.capacity()
        top = p.top(kv)
        assert top == kv.capacity() - round(live)
        return _end(p, kv, found=found, top=top)
    twin(drill)


def test_paged_delete_frees_rows():
    def drill(p):
        c = p.conf
        cfg = c.KVConfig(index=c.IndexConfig(capacity=1 << 8), bloom=None,
                         paged=True, page_words=8)
        kv = p.KV(cfg)
        ks = keys_of(np.arange(32))
        pages = np.arange(32 * 8, dtype=np.uint32).reshape(32, 8)
        kv.insert(ks, pages)
        top0 = p.top(kv)
        assert kv.delete(ks[:10]).all()
        assert p.top(kv) == top0 + 10
        kv.insert(ks[:10], pages[:10] + 7)
        out, found = kv.get(ks[:10])
        assert found.all()
        np.testing.assert_array_equal(out, pages[:10] + 7)
        return _end(p, kv, top0=top0)
    twin(drill)


def test_fill_sweep_point_conformance():
    def drill(p):
        r = p.run_point("cuckoo", capacity=1 << 12, fill=1.0, batch=1 << 10)
        assert r["conformance_ok"]
        assert r["misses"] <= r["evictions"] + r["drops"]
        r2 = p.run_point("linear", capacity=1 << 12, fill=1.2,
                         batch=1 << 10)
        assert r2["conformance_ok"] and r2["miss_rate"] > 0
        return [r, r2]
    twin(drill)


def test_corrupt_page_degrades_to_miss_never_wrong_bytes():
    def drill(p):
        kv = p.KV(small_cfg(p, paged=True))
        ks = keys_of(np.arange(64))
        pages = (np.arange(64, dtype=np.uint32)[:, None]
                 + np.arange(16, dtype=np.uint32) * 3)
        kv.insert(ks, pages)
        out, found = kv.get(ks)
        assert found.all() and np.array_equal(out, pages)
        p.xor_pool(kv, 1 << 7)
        out, found = kv.get(ks)
        assert not found.any(), "corrupt pages served as hits"
        assert (out == 0).all(), "corrupt bytes leaked to the caller"
        assert kv.stats()["corrupt_pages"] == 64
        assert kv.stats()["misses"] >= 64
        return _end(p, kv, found=found)
    twin(drill)


def test_corrupt_page_miss_on_compact_path():
    def drill(p):
        cfg = small_cfg(p, paged=True)
        kv = p.KV(cfg)
        ks = keys_of(np.arange(32))
        pages = (np.arange(32, dtype=np.uint32)[:, None]
                 + np.arange(16, dtype=np.uint32))
        kv.insert(ks, pages)
        vals, found, _ = kv.find_anyway(ks[:1])
        assert found[0]
        row = int(vals[0][1])
        p.bump_word(kv, row, 3)
        st, (out, order, fmask, nfound) = p.compact(
            kv.state, cfg, np.vstack([ks, ks[:4]])[:32])
        # the port's module-level verbs update the state they are given in
        # place (JAX's hand back a new one): the KV sees the GET's counts
        # before it takes the returned state (ROADMAP Queue 3)
        assert kv.stats()["gets"] == (32 if p is PORT else 0)
        kv.state = st
        assert not fmask[0], "poisoned row survived the compact path"
        assert fmask[1:32].all()
        assert nfound == 31
        order = order[:nfound]
        np.testing.assert_array_equal(out[:nfound], pages[order])
        return _end(p, kv, row=row, out=out, order=order, fmask=fmask)
    twin(drill)


def test_update_refreshes_digest_and_delete_clears_row():
    def drill(p):
        kv = p.KV(small_cfg(p, paged=True))
        ks = keys_of(np.arange(8))
        a = np.full((8, 16), 5, np.uint32)
        b = np.full((8, 16), 9, np.uint32)
        kv.insert(ks, a)
        kv.insert(ks, b)
        out, found = kv.get(ks)
        assert found.all() and np.array_equal(out, b)
        kv.delete(ks[:4])
        kv.insert(ks[:4], a[:4])
        out, found = kv.get(ks)
        assert found.all()
        np.testing.assert_array_equal(out[:4], a[:4])
        np.testing.assert_array_equal(out[4:], b[4:])
        assert kv.stats()["corrupt_pages"] == 0
        return _end(p, kv)
    twin(drill)


def test_integrity_backend_stale_overwrite_degrades_to_miss():
    def drill(p):
        kv = p.KV(small_cfg(p, paged=True))
        be = p.backends.IntegrityBackend(p.backends.DirectBackend(kv))
        ks = keys_of(np.arange(8))
        v1 = np.full((8, 16), 3, np.uint32)
        v2 = np.full((8, 16), 4, np.uint32)
        be.put(ks, v1)
        kv.insert(ks, v2)
        out, found = be.get(ks)
        assert not found.any()
        assert (out == 0).all()
        assert be.counters["corrupt_pages"] == 8
        be.put(ks, v2)
        out, found = be.get(ks)
        assert found.all() and np.array_equal(out, v2)
        return _end(p, kv, corrupt=int(be.counters["corrupt_pages"]))
    twin(drill)


def test_reput_after_deletes_in_a_full_index_evicts_like_jax():
    """Not a JAX drill: the hazard phase 18 (a) met in its rehearsal. In a
    linear index churned past its slots, a fresh insert lands at its
    cluster's FIFO cursor and evicts what sits there, never in the hole a
    delete left, so a batch that re-puts deleted keys and updates older
    ones can evict keys of its own batch. A key the
    insert reported evicted is a legal miss; every other key of the batch
    serves its new bytes. Both packages evict the same keys."""
    def drill(p):
        cfg = small_cfg(p, paged=True)
        kv = p.KV(cfg)
        n = 4 * kv.capacity()
        ks = keys_of(np.arange(n), hi=5)
        for i in range(0, n, 512):
            kv.insert(ks[i:i + 512], np.repeat(ks[i:i + 512, 1:2], 16, 1))
        _, found = kv.get(ks[-kv.capacity():])
        held = ks[-kv.capacity():][found]
        rng = np.random.default_rng(3)
        pick = held[rng.permutation(len(held))[:512]]
        assert kv.delete(pick[:256]).all()
        res = kv.insert(pick, np.repeat(pick[:, 1:2], 16, 1) ^ np.uint32(7))
        ev = np.asarray(res.evicted)
        ev = ev[~(ev == 0xFFFFFFFF).all(axis=1)]
        gone = (pick[:, None, :] == ev[None, :, :]).all(axis=2).any(axis=1)
        out, found = kv.get(pick)
        assert gone.any(), "the batch evicted none of its own keys"
        np.testing.assert_array_equal(found, ~gone)
        np.testing.assert_array_equal(
            out[found], np.repeat(pick[found, 1:2], 16, 1) ^ np.uint32(7))
        return _end(p, kv, res=_result(res), found=found)
    twin(drill)


walk_in_reverse(globals())
