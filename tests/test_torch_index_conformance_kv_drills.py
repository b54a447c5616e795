"""PyTorch port: the last four of `tests/test_index_conformance.py`'s
drills, one by one, on both packages: the paged `KV` over every index
family, the two HotRing `KV` drills and the lean GET against
`get_batch`.

`tests/test_torch_index_conformance_drills.py` holds the first six and
the namespaces, helpers and comparisons both files share: each drill
runs on `pmdfc_tpu` and on the port (`device="cpu"`), is held to its own
asserts on each, and what the two return must be equal (tolerance 0).
The drills sit in two files so that no one worker carries all ten: both
files walk their tests in reverse, against the JAX suite's order, and
each finds the JAX programs the other compiled in the persistent cache.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from test_torch_index_conformance_drills import (INV, _get, _insert, _res,
                                                 keys_of, make_cfg, twin,
                                                 vals_of)
from test_torch_index_conformance_drills import kind  # noqa: F401 (fixture)
from torch_twin import bits, counters, walk_in_reverse

pytestmark = pytest.mark.torch
# the drills replay `test_index_conformance.py`'s own JAX programs: compiled
# as the suite compiles them, each file finds the other's in the persistent
# cache
KEEP_XLA_DEFAULTS = True


def test_paged_kv_integration(kind):
    def drill(p, kind):
        cfg = p.conf.KVConfig(index=make_cfg(p, kind, capacity=1 << 9),
                              bloom=None, paged=True, page_words=8)
        kv = p.KV(cfg)
        rng = np.random.default_rng(23)
        n = 1024
        lo = rng.choice(1 << 20, size=n, replace=False)
        ks = keys_of(lo)
        pages = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
        results = [_res(kv.insert(ks[i:i + 128], pages[i:i + 128]))
                   for i in range(0, n, 128)]
        out, found = kv.get(ks)
        s = kv.stats()
        assert (~found).sum() <= s["evictions"] + s["drops"]
        np.testing.assert_array_equal(out[found], pages[found])
        live = float(p.utilization(kv.state, cfg)) * kv.capacity()
        top = int(kv.state.pool.top)
        assert top == kv.capacity() - round(live)
        return (results, np.asarray(out), np.asarray(found), counters(s),
                top, p.kv_leaves(kv))
    twin(drill, kind)


def test_hotring_prefers_evicting_cold_entries():
    def drill(p):
        c = p.conf
        kv = p.KV(c.KVConfig(
            index=c.IndexConfig(kind=c.IndexKind.HOTRING, capacity=1 << 6,
                                cluster_slots=32),
            bloom=None, paged=False))
        lo = np.arange(256)
        ks = keys_of(lo)
        results = [_res(kv.insert(ks[:64], vals_of(lo[:64])))]
        hot = ks[:16]
        for _ in range(5):
            kv.get(hot)
        for i in range(64, 256, 16):
            results.append(_res(kv.insert(ks[i:i + 16],
                                          vals_of(lo[i:i + 16]))))
        _, found_hot = kv.get(hot)
        _, found_all = kv.get(ks[:64])
        hot_rate = found_hot.mean()
        cold_rate = found_all[16:].mean()
        assert hot_rate >= cold_rate
        assert hot_rate > 0.5
        return (results, np.asarray(found_hot), np.asarray(found_all),
                counters(kv.stats()), p.kv_leaves(kv))
    twin(drill)


def test_hotring_decay_halves_counters():
    def drill(p):
        c = p.conf
        ops = p.ops("hotring")
        kv = p.KV(c.KVConfig(
            index=c.IndexConfig(kind=c.IndexKind.HOTRING, capacity=1 << 6,
                                decay_every_gets=32),
            bloom=None, paged=False))
        ks = keys_of([1, 2, 3])
        kv.insert(ks, vals_of([1, 2, 3]))
        for _ in range(4):
            kv.get(ks)
        peak = int(bits(kv.state.index.counters).max())
        assert peak >= 4
        for _ in range(20):
            kv.get(ks)
        after = int(bits(kv.state.index.counters).max())
        assert after < 24
        assert ops.decay is not None
        return peak, after, counters(kv.stats()), p.kv_leaves(kv)
    twin(drill)


def test_get_values_matches_get_batch(kind):
    """The lean GET agrees with `get_batch` in each package (same found
    mask, same values on hits, zero values on misses, padding a no-op),
    and the two packages agree; a family without a lean GET has none in
    either package."""
    def drill(p, kind):
        ops = p.ops(kind)
        if ops.get_values is None:
            return None
        st = p.init(ops, make_cfg(p, kind))
        ks = keys_of(np.arange(64))
        st, _ = _insert(p, ops, st, ks, vals_of(np.arange(64) + 9))
        cap = ops.num_slots(make_cfg(p, kind))
        rng = np.random.default_rng(5)
        fill = keys_of(rng.choice(1 << 20, size=min(2 * cap, 1 << 13),
                                  replace=False) + 1000)
        for lo in range(0, len(fill), 1 << 11):
            st, _ = _insert(p, ops, st, fill[lo:lo + (1 << 11)],
                            vals_of(fill[lo:lo + (1 << 11), 1]))
        probe = keys_of(np.arange(0, 128, 2))
        ref = _get(p, ops, st, probe)
        vals, found = (bits(a) for a in ops.get_values(st, p.arr(probe)))
        np.testing.assert_array_equal(found, ref["found"])
        f = ref["found"]
        np.testing.assert_array_equal(vals[f], ref["values"][f])
        assert (vals[~f] == 0).all(), "miss rows must be zero"
        pad = np.full((4, 2), INV, np.uint32)
        vals2, found2 = (bits(a) for a in ops.get_values(st, p.arr(pad)))
        assert not found2.any() and (vals2 == 0).all()
        return ref, vals, found, vals2, found2, p.index_leaves(st)
    twin(drill, kind)


walk_in_reverse(globals())
