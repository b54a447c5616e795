"""PyTorch port: the IHash conformance suite over all nine index families.

The contract of `tests/test_index_conformance.py` (ref `server/IHash.h:10-24`
plus the clean-cache semantics `server/KV.cpp:100-127` relies on), run on
`pmdfc_tpu_torch` on the CPU, one case per `IndexKind`:

- every inserted key is gettable with its value unless reported
  evicted or dropped (`misses <= evictions + drops`);
- an insert of an existing key updates in place (`fresh=False`);
- duplicate keys within one batch resolve to the LAST occurrence;
- a delete removes the key and reports its old value;
- evicted keys are reported WITH their values;
- padding (INVALID) keys are no-ops everywhere;
- the lean GET agrees with `get_batch` (values zeroed on a miss);
- paged `KV`: pages ride along index mutations losslessly, and the pool's
  free rows are conserved.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.config import IndexConfig, IndexKind, KVConfig
from pmdfc_tpu_torch.models.base import get_index_ops
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

ALL_KINDS = list(IndexKind)


def make_cfg(kind: IndexKind, capacity: int = 1 << 12) -> IndexConfig:
    kw = {}
    if kind in (IndexKind.CCEH, IndexKind.EXTENDIBLE):
        kw = dict(segment_slots=128, split_headroom=2)
    return IndexConfig(kind=kind, capacity=capacity, **kw)


def keys_of(lo, hi=1):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.full_like(lo, hi), lo], axis=-1)


def vals_of(lo):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.zeros_like(lo), lo], axis=-1)


def _t(a):
    return u32.from_numpy(np.asarray(a, np.uint32), "cpu")


def _n(t):
    return u32.to_numpy(t)


def _init(kind, capacity=1 << 12):
    ops = get_index_ops(kind)
    return ops, ops.init(make_cfg(kind, capacity), device="cpu")


@pytest.fixture(params=ALL_KINDS, ids=[k.value for k in ALL_KINDS])
def kind(request):
    return request.param


def test_roundtrip_and_update(kind):
    ops, st = _init(kind)
    ks = _t(keys_of(np.arange(100)))
    st, res = ops.insert_batch(st, ks, _t(vals_of(np.arange(100) * 2)))
    assert not res.dropped.any()
    got = ops.get_batch(st, ks)
    assert got.found.all()
    assert np.array_equal(_n(got.values)[:, 1], np.arange(100) * 2)
    st, res2 = ops.insert_batch(st, ks[:10],
                                _t(vals_of(np.arange(10) + 500)))
    assert not res2.fresh.any()
    got2 = ops.get_batch(st, ks[:10])
    assert np.array_equal(_n(got2.values)[:, 1], np.arange(10) + 500)


def test_delete_returns_old_value(kind):
    ops, st = _init(kind)
    ks = _t(keys_of([11, 22, 33]))
    st, _ = ops.insert_batch(st, ks, _t(vals_of([1, 2, 3])))
    st, hit, old = ops.delete_batch(st, ks[:2])
    assert hit.tolist() == [True, True]
    assert _n(old)[:, 1].tolist() == [1, 2]
    assert ops.get_batch(st, ks).found.tolist() == [False, False, True]
    st, hit2, _ = ops.delete_batch(st, _t(keys_of([99])))
    assert not hit2.any()


def test_duplicates_last_wins(kind):
    ops, st = _init(kind)
    ks = _t(keys_of([5, 5, 5]))
    st, res = ops.insert_batch(st, ks, _t(vals_of([1, 2, 3])))
    assert int(_n(ops.get_batch(st, ks[:1]).values)[0, 1]) == 3
    assert int((res.slots >= 0).sum()) == 1


def test_clean_cache_accounting_under_pressure(kind):
    """Three times capacity: every miss is a reported eviction or drop, and
    evicted entries carry their values."""
    ops = get_index_ops(kind)
    cfg = make_cfg(kind, capacity=1 << 8)
    st = ops.init(cfg, device="cpu")
    n = ops.num_slots(cfg) * 3
    lo = np.random.default_rng(17).choice(1 << 24, size=n, replace=False)
    ks = keys_of(lo)
    ev = drop = 0
    for i in range(0, n, 256):
        st, res = ops.insert_batch(st, _t(ks[i:i + 256]),
                                   _t(vals_of(lo[i:i + 256])))
        evm = ~(_n(res.evicted) == 0xFFFFFFFF).all(-1)
        ev += int(evm.sum())
        drop += int(res.dropped.sum())
        assert (_n(res.evicted_vals)[evm] != 0xFFFFFFFF).all()
    got = ops.get_batch(st, _t(ks))
    found = got.found.numpy()
    assert int((~found).sum()) <= ev + drop, ((~found).sum(), ev, drop)
    assert np.array_equal(_n(got.values)[found, 1], lo[found])


def test_padding_keys_are_noops(kind):
    ops, st = _init(kind)
    pad = _t(np.full((8, 2), 0xFFFFFFFF, np.uint32))
    st, res = ops.insert_batch(st, pad, _t(np.zeros((8, 2), np.uint32)))
    assert (res.slots == -1).all()
    assert not ops.get_batch(st, pad).found.any()
    st, hit, _ = ops.delete_batch(st, pad)
    assert not hit.any()


def test_scan_powers_find_anyway(kind):
    ops, st = _init(kind)
    ks = keys_of([7])
    st, res = ops.insert_batch(st, _t(ks), _t(vals_of([42])))
    flat_keys, flat_vals = (_n(x) for x in ops.scan(st))
    where = (flat_keys[:, 0] == ks[0, 0]) & (flat_keys[:, 1] == ks[0, 1])
    assert where.sum() == 1 and int(flat_vals[where][0, 1]) == 42
    assert np.nonzero(where)[0][0] == int(res.slots[0])  # scan pos == slot


def test_paged_kv_integration(kind):
    cfg = KVConfig(index=make_cfg(kind, capacity=1 << 9), bloom=None,
                   paged=True, page_words=8)
    kv = tkv.KV(cfg, device="cpu")
    rng = np.random.default_rng(23)
    n = 1024
    lo = rng.choice(1 << 20, size=n, replace=False)
    ks = keys_of(lo)
    pages = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    for i in range(0, n, 128):
        kv.insert(ks[i:i + 128], pages[i:i + 128])
    out, found = kv.get(ks)
    s = kv.stats()
    assert (~found).sum() <= s["evictions"] + s["drops"]
    assert np.array_equal(out[found], pages[found])
    live = kv.utilization() * kv.capacity()
    assert int(kv.state.pool.top) == kv.capacity() - round(live)


def test_get_values_matches_get_batch(kind):
    """The lean GET agrees with `get_batch` on a table driven toward full
    (cuckoo kicks, CCP relocation, level's bottom tier run), misses read
    zero, and padding is a no-op."""
    ops, st = _init(kind)
    cfg = make_cfg(kind)
    ks = _t(keys_of(np.arange(64)))
    st, _ = ops.insert_batch(st, ks, _t(vals_of(np.arange(64) + 9)))
    cap = ops.num_slots(cfg)
    rng = np.random.default_rng(5)
    fill = keys_of(rng.choice(1 << 20, size=min(2 * cap, 1 << 13),
                              replace=False) + 1000)
    for lo in range(0, len(fill), 1 << 11):
        st, _ = ops.insert_batch(st, _t(fill[lo:lo + (1 << 11)]),
                                 _t(vals_of(fill[lo:lo + (1 << 11), 1])))
    probe = _t(keys_of(np.arange(0, 128, 2)))
    ref = ops.get_batch(st, probe)
    vals, found = ops.get_values(st, probe)
    assert torch.equal(found, ref.found)
    assert torch.equal(vals[ref.found], ref.values[ref.found])
    assert not vals[~ref.found].any(), "miss rows must be zero"
    pad = _t(np.full((4, 2), 0xFFFFFFFF, np.uint32))
    vals2, found2 = ops.get_values(st, pad)
    assert not found2.any() and not vals2.any()


def _hot_kv(**ix):
    cfg = KVConfig(index=IndexConfig(kind=IndexKind.HOTRING, **ix),
                   bloom=None, paged=False)
    return tkv.KV(cfg, device="cpu")


def test_hotring_prefers_evicting_cold_entries():
    """Touched keys survive overflow at a higher rate than the cold ones."""
    kv = _hot_kv(capacity=1 << 6, cluster_slots=32)
    lo = np.arange(256)
    ks = keys_of(lo)
    kv.insert(ks[:64], vals_of(lo[:64]))
    for _ in range(5):
        kv.get(ks[:16])
    for i in range(64, 256, 16):
        kv.insert(ks[i:i + 16], vals_of(lo[i:i + 16]))
    _, found_hot = kv.get(ks[:16])
    _, found_all = kv.get(ks[:64])
    assert found_hot.mean() >= found_all[16:].mean()
    assert found_hot.mean() > 0.5


def test_hotring_decay_halves_counters():
    kv = _hot_kv(capacity=1 << 6, decay_every_gets=32)
    ks = keys_of([1, 2, 3])
    kv.insert(ks, vals_of([1, 2, 3]))
    for _ in range(4):
        kv.get(ks)
    assert int(u32.widen(kv.state.index.counters).max()) >= 4
    for _ in range(20):
        kv.get(ks)  # crosses decay_every_gets repeatedly
    assert int(u32.widen(kv.state.index.counters).max()) < 24
    assert get_index_ops(IndexKind.HOTRING).decay is not None
