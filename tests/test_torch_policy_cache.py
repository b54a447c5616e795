"""PyTorch port: the policy cache (`ops/policy_cache.py`) against the JAX
package.

The LRU, LFU, FIFO and update cases of `tests/test_aux.py` run through
`pmdfc_tpu.ops.policy_cache.PolicyCache` and its port on the CPU, side by
side: every eviction callback, every get and the state's table, metric
and tick after each call must be identical, and each case keeps its
behavioural check (recently used or frequent entries survive, FIFO
evicts the first generation, an update is not an eviction).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu.ops import policy_cache as jpc
from pmdfc_tpu_torch.ops import policy_cache as tpc
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch


def k2(lo):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.ones_like(lo), lo], axis=-1)


class Pair:
    """One JAX and one port cache fed the same calls, compared after each."""

    def __init__(self, capacity, policy):
        self.ev_j, self.ev_t = [], []
        self.j = jpc.PolicyCache(capacity, policy,
                                 on_evict=lambda k, v: self.ev_j.append(
                                     (k, v)))
        self.t = tpc.PolicyCache(capacity, policy,
                                 on_evict=lambda k, v: self.ev_t.append(
                                     (k, v)), device="cpu")

    def check(self):
        assert [tuple(map(int, k)) for k, _ in self.ev_j] == \
            [tuple(map(int, k)) for k, _ in self.ev_t]
        assert [tuple(map(int, v)) for _, v in self.ev_j] == \
            [tuple(map(int, v)) for _, v in self.ev_t]
        for f in ("table", "metric", "tick"):
            assert np.array_equal(np.asarray(getattr(self.j.state, f)),
                                  u32.to_numpy(getattr(self.t.state, f))), f
        assert self.j.state.policy == self.t.state.policy

    def put(self, keys, vals):
        self.j.put(keys, vals)
        self.t.put(keys, vals)
        self.check()

    def get(self, keys):
        (vj, fj), (vt, ft) = self.j.get(keys), self.t.get(keys)
        assert np.array_equal(vj, vt) and np.array_equal(fj, ft)
        self.check()
        return vt, ft

    def fill(self, lo_range, batch=8):
        lo = np.arange(*lo_range)
        for i in range(0, len(lo), batch):
            self.put(k2(lo[i:i + batch]), k2(lo[i:i + batch]))


def test_policy_cache_lru():
    c = Pair(128, "lru")
    c.fill((0, 64))
    c.get(k2(np.arange(16)))  # the first 16 become most recently used
    c.fill((100, 228))
    assert len(c.ev_t) > 0
    _, found_hot = c.get(k2(np.arange(16)))
    _, found_cold = c.get(k2(np.arange(16, 64)))
    assert found_hot.mean() > found_cold.mean()


def test_policy_cache_lfu():
    c = Pair(128, "lfu")
    c.fill((0, 64))
    for _ in range(3):
        c.get(k2(np.concatenate([np.arange(8), np.arange(4)])))  # repeats
    c.fill((200, 328))
    _, found_freq = c.get(k2(np.arange(8)))
    _, found_rest = c.get(k2(np.arange(8, 64)))
    assert found_freq.all() and found_freq.mean() > found_rest.mean()


def test_policy_cache_fifo():
    c = Pair(128, "fifo")
    c.fill((0, 64))
    c.get(k2(np.arange(32)))  # FIFO ignores accesses
    c.fill((300, 428))
    assert len(c.ev_t) > 0 and c.ev_t[0][0][1] < 64


def test_policy_cache_update_not_evict():
    c = Pair(64, "lru")
    c.put(k2([1]), k2([10]))
    c.put(k2([1]), k2([20]))
    vals, found = c.get(k2([1]))
    assert found.all() and vals[0, 1] == 20 and not c.ev_t


def test_policy_cache_full_batch_with_ties_matches_jax():
    """One batch over a full cache with tied metrics, duplicates and
    padding: the eviction ranks and the stable victim order agree."""
    for policy in ("lru", "lfu", "fifo"):
        c = Pair(64, policy)
        c.fill((0, 64), batch=64)
        keys = k2(np.concatenate([np.arange(1000, 1100), np.arange(1000, 1010),
                                  np.arange(5)]))
        keys[[3, 50]] = 0xFFFFFFFF
        c.put(keys, keys)
        assert len(c.ev_t) > 0
