"""PyTorch port: `tests/test_cceh.py`'s drills, one by one, on both packages.

Each test carries the name of the JAX drill it twins and runs the drill's
script through `pmdfc_tpu.models.cceh` (or `pmdfc_tpu.kv.KV`) and the
port's (`device="cpu"`) on the same seeded batches. Both sides are held
to the drill's own asserts, the directory invariants among them (every
stored entry reachable through the directory, replication blocks
agreeing), and what each returns must be equal: every verb's result and
the index leaves (`table`, `ld`, `dirr`, `gdepth`, `nseg`), or for the
`KV` drills the pages, found masks, stats and state leaves (tolerance 0:
integer arithmetic).
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
from torch_twin import bits, counters, same

from pmdfc_tpu import config as jconf
from pmdfc_tpu import kv as jkv
from pmdfc_tpu.models import cceh as jcceh
from pmdfc_tpu.models.base import get_index_ops as jops
from pmdfc_tpu.utils import hashing as jhash
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import config as tconf
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.models import cceh as tcceh
from pmdfc_tpu_torch.models.base import get_index_ops as tops
from pmdfc_tpu_torch.utils import hashing as thash
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

INV = 0xFFFFFFFF
LEAVES = ("table", "ld", "dirr", "gdepth", "nseg")


def _res(r) -> dict:
    return {f: bits(getattr(r, f)) for f in r._fields}


def _jax_hash(hi, lo, seed=0):
    return np.asarray(jhash.hash_u64(jnp.asarray(hi), jnp.asarray(lo),
                                     seed=seed))


def _port_hash(hi, lo, seed=0):
    return thash.hash_u64(u32.from_numpy(hi, "cpu"),
                          u32.from_numpy(lo, "cpu"),
                          seed=seed).numpy().astype(np.uint32)


def _t(a):
    return u32.from_numpy(np.asarray(a, np.uint32), "cpu")


JAX = types.SimpleNamespace(
    conf=jconf, ops=jops(jconf.IndexKind.CCEH), mod=jcceh, hash=_jax_hash,
    arr=jnp.asarray, KV=jkv.KV, utilization=jkv.utilization,
    with_dirr=lambda st, d: dataclasses.replace(st, dirr=jnp.asarray(d)),
    init=lambda c: jops(c.kind).init(c),
    kv_leaves=lambda kv: {".".join(k.name for k in p): np.asarray(v)
                          for p, v in jax.tree_util.tree_flatten_with_path(
                              kv.state)[0]})
PORT = types.SimpleNamespace(
    conf=tconf, ops=tops(tconf.IndexKind.CCEH), mod=tcceh, hash=_port_hash,
    arr=_t, KV=lambda cfg: tkv.KV(cfg, device="cpu"),
    utilization=tkv.utilization,
    with_dirr=lambda st, d: dataclasses.replace(
        st, dirr=u32.from_numpy(np.asarray(d, np.uint32), "cpu")),
    init=lambda c: tops(c.kind).init(c, device="cpu"),
    kv_leaves=lambda kv: carry.state_to_numpy(kv.state))


def twin(drill):
    """`drill(pkg)` on JAX, then on the port; equal observables."""
    a, b = drill(JAX), drill(PORT)
    same(a, b, drill.__name__)
    return b


def cfg(p, capacity=1 << 9, segment_slots=128, headroom=2):
    return p.conf.IndexConfig(kind=p.conf.IndexKind.CCEH, capacity=capacity,
                              segment_slots=segment_slots,
                              split_headroom=headroom)


def _keys(lo, hi=1):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.full_like(lo, hi), lo], axis=-1)


def _vals(lo):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.zeros_like(lo), lo], axis=-1)


def _leaves(st) -> dict:
    return {f: bits(getattr(st, f)) for f in LEAVES}


def _insert(p, st, keys, vals):
    st, res = p.ops.insert_batch(st, p.arr(keys), p.arr(vals))
    return st, _res(res)


def _get(p, st, keys):
    return _res(p.ops.get_batch(st, p.arr(keys)))


def _check_directory_invariants(p, st):
    """The drill's invariants on a state of package `p`: every valid
    entry is reachable via the directory; replication blocks agree."""
    g = p.mod._geom(st)
    keys = bits(p.ops.scan(st)[0]).astype(np.uint32)
    dirr, ld = bits(st.dirr), bits(st.ld)
    valid = ~((keys[:, 0] == INV) & (keys[:, 1] == INV))
    slots = np.nonzero(valid)[0]
    h = p.hash(keys[slots, 0], keys[slots, 1]).astype(np.int64)
    hw = p.hash(keys[slots, 0], keys[slots, 1],
                seed=p.mod.WINDOW_SEED).astype(np.int64) & (g.W - 1)
    seg_expect = dirr[h >> (32 - g.Gmax)]
    np.testing.assert_array_equal(slots // g.P, seg_expect * g.W + hw)
    for i in range(g.Smax):
        s = dirr[i]
        block = 1 << (g.Gmax - ld[s])
        assert dirr[i & ~(block - 1)] == s, f"dir[{i}]={s}: block disagrees"


def test_roundtrip_no_split():
    def drill(p):
        st = p.init(cfg(p))
        ks = _keys(np.arange(64))
        st, res = _insert(p, st, ks, _vals(np.arange(64) * 2))
        assert not res["dropped"].any()
        got = _get(p, st, ks)
        assert got["found"].all()
        np.testing.assert_array_equal(got["values"][:, 1], np.arange(64) * 2)
        _check_directory_invariants(p, st)
        return res, got, _leaves(st)
    twin(drill)


def test_split_grows_segments_and_keeps_entries():
    def drill(p):
        st = p.init(cfg(p))
        nseg0 = int(bits(st.nseg))
        rng = np.random.default_rng(3)
        lo = rng.choice(1 << 20, size=900, replace=False)
        ks = _keys(lo)
        evicted = dropped = 0
        results = []
        for i in range(0, 900, 128):
            st, res = _insert(p, st, ks[i:i + 128], _vals(lo[i:i + 128]))
            evicted += int((res["evicted"] != INV).all(-1).sum())
            dropped += int(res["dropped"].sum())
            results.append(res)
        assert int(bits(st.nseg)) > nseg0, "no split happened"
        got = _get(p, st, ks)
        misses = int((~got["found"]).sum())
        assert misses <= evicted + dropped
        assert misses < 50
        ok = got["found"]
        np.testing.assert_array_equal(got["values"][ok, 1], lo[ok])
        _check_directory_invariants(p, st)
        return results, got, _leaves(st)
    twin(drill)


def test_eviction_fallback_when_headroom_exhausted():
    def drill(p):
        c = cfg(p, capacity=1 << 8, segment_slots=64, headroom=1)
        st = p.init(c)
        n = p.ops.num_slots(c) * 3
        rng = np.random.default_rng(5)
        lo = rng.choice(1 << 22, size=n, replace=False)
        ks = _keys(lo)
        ev = drop = 0
        results = []
        for i in range(0, n, 256):
            st, res = _insert(p, st, ks[i:i + 256], _vals(lo[i:i + 256]))
            ev += int((res["evicted"] != INV).all(-1).sum())
            drop += int(res["dropped"].sum())
            results.append(res)
        assert ev > 0, "expected eviction fallback to kick in"
        got = _get(p, st, ks)
        assert int((~got["found"]).sum()) == ev + drop
        _check_directory_invariants(p, st)
        return results, got, _leaves(st)
    twin(drill)


def test_update_in_place_and_delete():
    def drill(p):
        st = p.init(cfg(p))
        ks = _keys([7, 8])
        st, r1 = _insert(p, st, ks, _vals([1, 2]))
        st, r2 = _insert(p, st, ks[:1], _vals([9]))
        assert not r2["fresh"][0]
        got = _get(p, st, ks)
        np.testing.assert_array_equal(got["values"][:, 1], [9, 2])
        st, hit, old = p.ops.delete_batch(st, p.arr(ks[:1]))
        hit, old = bits(hit), bits(old)
        assert hit[0] and int(old[0, 1]) == 9
        got2 = _get(p, st, ks)
        np.testing.assert_array_equal(got2["found"], [False, True])
        return r1, r2, got, hit, old, got2, _leaves(st)
    twin(drill)


def test_duplicate_keys_in_batch_last_wins():
    def drill(p):
        st = p.init(cfg(p))
        ks = _keys([5, 5, 5])
        st, res = _insert(p, st, ks, _vals([1, 2, 3]))
        got = _get(p, st, ks[:1])
        assert int(got["values"][0, 1]) == 3
        assert int((res["slots"] != INV).sum()) == 1  # one placement
        return res, got, _leaves(st)
    twin(drill)


def test_recovery_repairs_corrupt_directory():
    def drill(p):
        st = p.init(cfg(p))
        rng = np.random.default_rng(11)
        lo = rng.choice(1 << 20, size=600, replace=False)
        ks = _keys(lo)
        st, res = _insert(p, st, ks, _vals(lo))
        good = _leaves(st)
        g = p.mod._geom(st)
        dirr, ld = good["dirr"].copy(), good["ld"]
        corrupted = None
        for i in range(g.Smax):  # a NON-canonical replicated entry
            s = dirr[i]
            if i & ((1 << (g.Gmax - ld[s])) - 1):
                dirr[i] = (s + 1) % g.Smax
                corrupted = i
                break
        assert corrupted is not None
        fixed = p.ops.recovery(p.with_dirr(st, dirr))
        np.testing.assert_array_equal(bits(fixed.dirr), good["dirr"])
        got = _get(p, fixed, ks)
        assert got["found"].all()
        return res, corrupted, got, _leaves(fixed)
    twin(drill)


def test_paged_kv_pages_survive_splits():
    def drill(p):
        kvcfg = p.conf.KVConfig(index=cfg(p), bloom=None, paged=True,
                                page_words=8)
        kv = p.KV(kvcfg)
        rng = np.random.default_rng(7)
        n = 1200
        lo = rng.choice(1 << 20, size=n, replace=False)
        ks = _keys(lo)
        pages = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
        results = [_res(kv.insert(ks[i:i + 128], pages[i:i + 128]))
                   for i in range(0, n, 128)]
        out, found = kv.get(ks)
        s = kv.stats()
        assert (~found).sum() <= s["evictions"] + s["drops"]
        np.testing.assert_array_equal(out[found], pages[found])
        live = float(p.utilization(kv.state, kvcfg)) * kv.capacity()
        assert int(kv.state.pool.top) == kv.capacity() - round(live)
        return (results, np.asarray(out), np.asarray(found), counters(s),
                p.kv_leaves(kv))
    twin(drill)


def test_kv_facade_end_to_end_with_cceh():
    def drill(p):
        kvcfg = p.conf.KVConfig(index=cfg(p), bloom=None, paged=False)
        kv = p.KV(kvcfg)
        lo = np.arange(400)
        ks = _keys(lo)
        vals = np.stack([np.zeros(400, np.uint32),
                         lo.astype(np.uint32) * 5], axis=-1)
        res = _res(kv.insert(ks, vals))
        out, found = kv.get(ks)
        assert found.all()
        np.testing.assert_array_equal(out[:, 1], lo * 5)
        vals2, found2, slots2 = kv.find_anyway(ks[:4])
        assert found2.all()
        return (res, np.asarray(out), np.asarray(found), np.asarray(vals2),
                np.asarray(found2), np.asarray(slots2), counters(kv.stats()),
                p.kv_leaves(kv))
    twin(drill)
