"""PyTorch port: `KV` over the six index families added last, against the
JAX `KV`.

The same seeded verb sequence — inserts past capacity (updates, in-batch
duplicates, padding, evictions or drops), get, get_async,
get_compact_async, delete (with duplicates) — goes through
`pmdfc_tpu.kv.KV` and `pmdfc_tpu_torch.kv.KV(device="cpu")` for each
family over the flat paged pool, HotRing also unpaged, and HotRing and
cuckoo over the tiered pool. Every result, the 19-lane stats vector,
the packed bloom, utilization and every state leaf must be identical.

HotRing runs with `touch_sample_every=2` and a `decay_every_gets` small
enough that the decay fires several times inside the sequence, through
each of `get`, `get_async` and `get_compact_async`: the counters, the
hot mirror and the sampling cadence stay bit for bit with JAX.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

from pmdfc_tpu import kv as jkv
from pmdfc_tpu.config import BloomConfig as JBloomConfig
from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu.config import TierConfig as JTier
from pmdfc_tpu.models import hotring as jhr
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.config import BloomConfig as TBloomConfig
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.config import KVConfig as TKVConfig
from pmdfc_tpu_torch.config import TierConfig as TTier
from pmdfc_tpu_torch.models import hotring as thr
from pmdfc_tpu_torch.ops import fused as tfused
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

TIER = dict(hot_fraction=16, ghost_rows=32, balloon_step=32,
            max_promotes_per_batch=16, cold_init_rows=512, grow_free_rows=32)
HOT = dict(touch_sample_every=2, decay_every_gets=700)

CASES = {
    # name: (index kind, paged, tiered)
    "cuckoo": ("cuckoo", True, False),
    "ccp": ("ccp", True, False),
    "level": ("level", True, False),
    "path": ("path", True, False),
    "static": ("static", True, False),
    "hotring": ("hotring", True, False),
    "hotring-unpaged": ("hotring", False, False),
    "hotring-tiered": ("hotring", True, True),
    "cuckoo-tiered": ("cuckoo", True, True),
}


def _configs(kind, paged, tiered):
    ix = dict(capacity=1024, **(HOT if kind == "hotring" else {}))

    def make(K, I, B, T, Kind):
        return K(index=I(kind=Kind(kind), **ix), page_words=64, paged=paged,
                 bloom=B(num_bits=1 << 12), evicted_sketch_bits=1 << 10,
                 tier=T(**TIER) if tiered else None)
    return (make(JKVConfig, JIndexConfig, JBloomConfig, JTier, JKind),
            make(TKVConfig, TIndexConfig, TBloomConfig, TTier, TKind))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert np.array_equal(a, b), f"{what} differs"


def _jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in p): np.asarray(v) for p, v in flat}


def _same_leaves(a, b, what):
    la, lb = _jax_leaves(a.state), carry.state_to_numpy(b.state)
    assert sorted(la) == sorted(lb), f"{what}: {set(la) ^ set(lb)}"
    for k in la:
        _same(la[k], lb[k], f"{what}: leaf {k}")


def _host(y, like):
    """A port output as numpy in the dtype of the JAX output `like` (u32
    words come back as int32 bits)."""
    if isinstance(y, torch.Tensor):
        dt = np.asarray(like).dtype
        return u32.to_numpy(y) if dt == np.uint32 else y.numpy().astype(dt)
    return y


def _counting_decays(kv):
    """Count the port KV's decays (its ops vtable is swapped for one whose
    `decay` counts, then decays)."""
    n = [0]
    real = kv._ops.decay

    def decay(index):
        n[0] += 1
        return real(index)
    kv._ops = dataclasses.replace(kv._ops, decay=decay)
    return n


@pytest.mark.parametrize("case", list(CASES))
def test_kv_over_family_matches_jax(case):
    kind, paged, tiered = CASES[case]
    jcfg, tcfg = _configs(kind, paged, tiered)
    assert not tfused.supports(tcfg)  # these families take the composed GET
    a, b = jkv.KV(jcfg), tkv.KV(tcfg, device="cpu")
    assert a.capacity() == b.capacity()
    decays = _counting_decays(b) if kind == "hotring" else None
    rng = np.random.default_rng(len(case))
    vw = 64 if paged else 2
    live = np.zeros((0, 2), np.uint32)
    for step in range(4):
        n = 500
        keys = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint32)
        keys[:40] = keys[40:80]                            # in-batch duplicates
        if len(live):
            keys[100:140] = live[rng.integers(0, len(live), 40)]  # updates
        keys[rng.integers(0, n, 5)] = 0xFFFFFFFF           # padding keys
        keys[rng.integers(0, n, 20), 0] |= 0x80000000      # hi >= 2^31
        vals = rng.integers(0, 1 << 32, (n, vw), dtype=np.uint32)
        ra, rb = a.insert(keys, vals), b.insert(keys, vals)
        for f in ra._fields:
            _same(getattr(ra, f), getattr(rb, f), f"insert {step} {f}")
        live = np.concatenate([live, keys])
        hot = live[:60]  # a hot set that skews every GET
        for r in range(3):
            probe = np.concatenate([
                hot[rng.integers(0, 60, 200)],
                live[rng.integers(0, len(live), 200)],
                rng.integers(0, 1 << 32, (90, 2), dtype=np.uint32),
                np.full((10, 2), 0xFFFFFFFF, np.uint32)])
            verb = ("get", "get_async", "get_compact_async")[r]
            ra, rb = getattr(a, verb)(probe), getattr(b, verb)(probe)
            for i, (x, y) in enumerate(zip(ra, rb)):
                _same(x, _host(y, x), f"{verb} {step} output {i}")
            _same_leaves(a, b, f"{verb} {step}")
        if step in (1, 3):
            gone = np.concatenate([live[rng.integers(0, len(live), 120)],
                                   live[:6], live[:6]])
            _same(a.delete(gone), b.delete(gone), f"delete {step}")

    sa, sb = a.stats(), b.stats()
    for k in tkv.STAT_NAMES:
        assert sa[k] == sb[k], f"stat {k}: {sa[k]} vs {sb[k]}"
    assert sb["misses"] == sum(sb[c] for c in tkv.MISS_CAUSE_NAMES)
    assert sb["evictions"] + sb["drops"] > 0 and sb["hits"] > 0
    assert a.utilization() == b.utilization()
    assert a.packed_bloom().tobytes() == b.packed_bloom().tobytes()
    _same_leaves(a, b, "end")
    if decays is not None:
        # 4 x 3 GETs of 500 keys, a decay every 700: one in about three
        # GETs, so each of the three verbs fired one
        assert decays[0] >= 6
        assert u32.to_numpy(b.state.index.hot_lane).max() >= 0


def test_touch_sample_every_counts_one_batch_in_n():
    """touch_sample_every=N: every batch returns the same answers, but only
    each Nth batch bumps the counters — in both packages, as
    `tests/test_hotring.py` pins for JAX."""
    def build(K, I, Kind, n, **kw):
        return K(index=I(kind=Kind.HOTRING, capacity=1 << 10,
                         touch_sample_every=n, decay_every_gets=0),
                 bloom=None, paged=False)

    keys = np.stack([np.arange(64, dtype=np.uint32)] * 2, -1)
    for n, want in ((1, 8 * 64), (4, 2 * 64)):
        a = jkv.KV(build(JKVConfig, JIndexConfig, JKind, n))
        b = tkv.KV(build(TKVConfig, TIndexConfig, TKind, n), device="cpu")
        a.insert(keys, keys)
        b.insert(keys, keys)
        for _ in range(8):
            (oa, fa), (ob, fb) = a.get(keys), b.get(keys)
            assert fb.all()
            _same(oa, ob, "get")
        _same_leaves(a, b, f"every {n}")
        assert int(u32.widen(b.state.index.counters).sum()) == want


def test_facade_skew_workload_serves_hot_keys_from_the_mirror():
    """Through the port's `KV`: zipf GETs drive touch and decay; after the
    drain interval the mirror serves the popular keys (the twin of
    `test_hotring.py::test_facade_skew_workload_end_to_end`), and the
    state matches JAX's."""
    def cfg(K, I, B, Kind):
        return K(index=I(kind=Kind.HOTRING, capacity=1 << 10,
                         cluster_slots=16, hot_lanes=4,
                         decay_every_gets=2048),
                 bloom=B(num_bits=1 << 14), paged=False)

    a = jkv.KV(cfg(JKVConfig, JIndexConfig, JBloomConfig, JKind))
    b = tkv.KV(cfg(TKVConfig, TIndexConfig, TBloomConfig, TKind),
               device="cpu")
    rng = np.random.default_rng(5)
    flat = rng.choice(1 << 20, size=256, replace=False).astype(np.uint32)
    keys = np.stack([flat >> 10, flat & 0x3FF], -1).astype(np.uint32)
    vals = np.stack([keys[:, 1], keys[:, 0]], -1)
    a.insert(keys, vals)
    b.insert(keys, vals)
    hot = keys[:16]
    for _ in range(20):
        sel = hot[rng.integers(0, 16, size=128)]
        (oa, fa), (ob, fb) = a.get(sel), b.get(sel)
        assert fb.all()
        _same(oa, ob, "get")
    assert thr.probe_hot(b.state.index, u32.from_numpy(hot, "cpu")).all()
    assert np.array_equal(
        np.asarray(jhr.probe_hot(a.state.index, hot)),
        thr.probe_hot(b.state.index, u32.from_numpy(hot, "cpu")).numpy())
    _same_leaves(a, b, "end")


@pytest.mark.parametrize("kind", ["cuckoo", "ccp", "level", "path", "static",
                                  "hotring"])
def test_family_state_carries_across_and_back(kind):
    """`state_to_numpy(state_from_numpy(x)) == x` for each family's JAX
    state, dtypes and the static knobs (cuckoo's `max_kicks`, level's
    `top_rows`, path's `top`) included."""
    jcfg, tcfg = _configs(kind, True, False)
    a = jkv.KV(jcfg)
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 1 << 32, (300, 2), dtype=np.uint32)
    a.insert(keys, rng.integers(0, 1 << 32, (300, 64), dtype=np.uint32))
    leaves = _jax_leaves(a.state)
    st = carry.state_from_numpy(leaves, tcfg, "cpu")
    for f in dataclasses.fields(a.state.index):
        if f.metadata.get("static"):
            assert getattr(st.index, f.name) == getattr(a.state.index, f.name)
    back = carry.state_to_numpy(st)
    assert sorted(back) == sorted(leaves)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
