"""PyTorch port: `KV` verb by verb against the JAX `KV` over the tiered
pool, with and without the admission gate: balloon shrinks and grows,
extents and lean sampled GETs mixed in; every result, `tier_stats`,
`balloon_state`, `stats()` and every state leaf after each step must be
identical. The flat pool's sequences are in `test_torch_kv.py`, whose
configs and helpers this file shares.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import timeless

from pmdfc_tpu import kv as jkv
from pmdfc_tpu.config import BloomConfig as JBloomConfig
from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.config import AdmitConfig as JAdmit
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu.config import TierConfig as JTier
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.config import BloomConfig as TBloomConfig
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.config import AdmitConfig as TAdmit
from pmdfc_tpu_torch.config import KVConfig as TKVConfig
from pmdfc_tpu_torch.config import TierConfig as TTier
from pmdfc_tpu_torch.utils import u32
from test_torch_kv import _same, jax_leaves

pytestmark = pytest.mark.torch


TIER = dict(hot_fraction=16, ghost_rows=32, balloon_step=32,
            max_promotes_per_batch=16, cold_init_rows=512, grow_free_rows=32)
GATE = dict(sketch_width=1 << 10, door_bits=1 << 11, reset_ops=512,
            threshold=2)


def _tiered_configs(kind, admit, every=1):
    ix = dict(capacity=2048, cluster_slots=32) if kind == "linear" else \
        dict(capacity=1024, probe_window=16, segment_slots=256)
    ix["touch_sample_every"] = every

    def make(K, I, T, A, B, Kind):
        return K(index=I(kind=Kind(kind), **ix), page_words=64,
                 bloom=B(num_bits=1 << 12), evicted_sketch_bits=1 << 10,
                 tier=T(admit=A(**GATE) if admit else None, **TIER))
    return (make(JKVConfig, JIndexConfig, JTier, JAdmit, JBloomConfig, JKind),
            make(TKVConfig, TIndexConfig, TTier, TAdmit, TBloomConfig, TKind))


def _same_leaves(a, b, what):
    la, lb = jax_leaves(a.state), carry.state_to_numpy(b.state)
    assert sorted(la) == sorted(lb), f"{what}: {set(la) ^ set(lb)}"
    for k in la:
        _same(la[k], lb[k], f"{what}: leaf {k}")


TIERED = [("linear", False, 1), ("linear", True, 2), ("cceh", True, 1),
          ("cceh", False, 2), ("extendible", True, 1)]


@pytest.mark.parametrize("kind,admit,every", TIERED,
                         ids=[f"{k}-{'gate' if a else 'nogate'}-every{e}"
                              for k, a, e in TIERED])
def test_tiered_kv_verb_sequence_matches_jax(kind, admit, every):
    """The `KV` surface over a tiered pool, verb by verb: inserts growing
    the balloon from 512 circulating rows, counting and lean GETs driving
    promotions, get_compact, deletes, an extent, a forced shrink past the
    free rows (stale misses), a grow and re-puts, the gate's state and
    live threshold — results, `tier_stats`, `balloon_state`, `stats()`
    and every leaf after each step."""
    jcfg, tcfg = _tiered_configs(kind, admit, every)
    a, b = jkv.KV(jcfg), tkv.KV(tcfg, device="cpu")
    rng = np.random.default_rng(17)
    keys = rng.integers(0, 1 << 32, (2600, 2), dtype=np.uint32)
    keys[rng.integers(0, 2600, 20), 0] |= 0x80000000

    def both(verb, *args):
        ra, rb = getattr(a, verb)(*args), getattr(b, verb)(*args)
        if hasattr(ra, "_fields"):
            for f in ra._fields:
                _same(getattr(ra, f), getattr(rb, f), f"{verb} {f}")
        elif isinstance(ra, tuple):
            for x, y in zip(ra, rb):
                _same(x, y, verb)
        elif isinstance(ra, np.ndarray):
            _same(ra, rb, verb)
        else:
            assert ra == rb, f"{verb}: {ra} vs {rb}"
        _same_leaves(a, b, verb)
        return rb

    for i in range(0, 2600, 520):
        both("insert", keys[i:i + 520],
             rng.integers(0, 1 << 32, (520, 64), dtype=np.uint32))
    assert b.tier_stats()["balloon_grows"] > 0
    hot = keys[:200]
    for r in range(6):
        probe = np.concatenate([hot[(r % 2) * 100:(r % 2) * 100 + 120],
                                keys[rng.integers(0, 2600, 40)],
                                np.full((3, 2), 0xFFFFFFFF, np.uint32)])
        both("get", probe)
        ca, cb = a.get_compact_async(probe), b.get_compact_async(probe)
        for x, y, what in zip(ca[:4], cb[:4], ("out", "order", "found",
                                                "nfound")):
            y = u32.to_numpy(y) if what == "out" else y.numpy()
            _same(x, y, f"get_compact {r} {what}")
        _same_leaves(a, b, "get_compact")
    both("delete", np.concatenate([hot[:10], hot[:10], keys[2000:2050]]))
    ra, rb = a.insert_extent(np.array([9, 4000], np.uint32),
                             np.array([1, 0xFFFFF000], np.uint32), 77), \
        b.insert_extent(np.array([9, 4000], np.uint32),
                        np.array([1, 0xFFFFF000], np.uint32), 77)
    assert ra[1] == rb[1]
    _same_leaves(a, b, "insert_extent")
    both("get_extent", np.array([[9, 4000], [9, 4050], [9, 5000]], np.uint32))
    free = both("balloon_state")["free"]
    assert both("balloon_shrink", free + 100)
    both("get", keys[:400])
    assert both("balloon_grow", 100)
    both("insert", keys[400:600],
         rng.integers(0, 1 << 32, (200, 64), dtype=np.uint32))
    both("get", keys[:600])
    both("tier_stats")
    both("admit_state")
    assert both("set_admit_threshold", 0) == admit
    both("get", hot)
    sa, sb = timeless(a.stats()), timeless(b.stats())
    assert sa == sb
    for k in ("promotions", "hot_hits", "shrink_evictions", "migrated_bytes",
              "hot_occupied", "cold_free"):
        assert k in sb
    assert sb["promotions"] > 0 and sb["miss_stale"] > 0
    assert sb["misses"] == sum(sb[c] for c in tkv.MISS_CAUSE_NAMES)
    assert ("admit_denied" in sb) == admit
    assert a.utilization() == b.utilization()


@pytest.mark.parametrize("admit", [False, True], ids=["nogate", "gate"])
def test_tiered_state_carries_across_and_back(admit):
    """`state_to_numpy(state_from_numpy(x)) == x` for a tiered JAX state,
    dtypes included; the admission leaves exist on both sides iff the
    gate does."""
    jcfg, tcfg = _tiered_configs("cceh", admit)
    a = jkv.KV(jcfg)
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 32, (600, 2), dtype=np.uint32)
    a.insert(keys, rng.integers(0, 1 << 32, (600, 64), dtype=np.uint32))
    for _ in range(3):
        a.get(keys[:64])
    leaves = jax_leaves(a.state)
    assert ("pool.admit_cm" in leaves) == admit
    back = carry.state_to_numpy(carry.state_from_numpy(leaves, tcfg, "cpu"))
    assert sorted(back) == sorted(leaves)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
