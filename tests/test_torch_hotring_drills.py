"""PyTorch port: `tests/test_hotring.py`'s `KV`-level drills on both packages.

The index-level drills (the hot-point shift, the mirror never serving a
stale value, decay running the shift, the tag-half rehash) have their
twins in `tests/test_torch_hotring.py`. The two here drive HotRing
through the `KV` façade, each named after its JAX drill: the same seeded
keys go through `pmdfc_tpu.kv.KV` and `pmdfc_tpu_torch.kv.KV(device=
"cpu")`, both are held to the drill's own asserts, and the GETs' values
and found masks, the stats, the hot mirror's answers and every state
leaf must be equal (tolerance 0: integer arithmetic).
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import counters, same

from pmdfc_tpu import config as jconf
from pmdfc_tpu import kv as jkv
from pmdfc_tpu.models import hotring as jhr
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import config as tconf
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.models import hotring as thr
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

JAX = types.SimpleNamespace(
    conf=jconf, KV=jkv.KV,
    probe_hot=lambda st, k: np.asarray(jhr.probe_hot(st, jnp.asarray(k))),
    counters=lambda kv: np.asarray(kv.state.index.counters).astype(np.int64),
    leaves=lambda kv: {".".join(k.name for k in p): np.asarray(v)
                       for p, v in jax.tree_util.tree_flatten_with_path(
                           kv.state)[0]})
PORT = types.SimpleNamespace(
    conf=tconf, KV=lambda cfg: tkv.KV(cfg, device="cpu"),
    probe_hot=lambda st, k: thr.probe_hot(
        st, u32.from_numpy(k, "cpu")).numpy(),
    counters=lambda kv: u32.to_numpy(kv.state.index.counters).astype(
        np.int64),
    leaves=lambda kv: carry.state_to_numpy(kv.state))


def twin(drill):
    a, b = drill(JAX), drill(PORT)
    same(a, b, drill.__name__)
    return b


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 20, size=n, replace=False).astype(np.uint32)
    return np.stack([flat >> 10, flat & 0x3FF], axis=-1).astype(np.uint32)


def _vals(keys):
    return np.stack([keys[:, 1], keys[:, 0]], -1).astype(np.uint32)


def test_facade_skew_workload_end_to_end():
    """Zipf GETs through the façade drive touch and decay; after the
    drain interval the hot mirror serves the popular keys."""
    def drill(p):
        c = p.conf
        cfg = c.KVConfig(
            index=c.IndexConfig(kind=c.IndexKind.HOTRING, capacity=1 << 10,
                                cluster_slots=16, hot_lanes=4,
                                decay_every_gets=2048),
            bloom=c.BloomConfig(num_bits=1 << 14), paged=False)
        kv = p.KV(cfg)
        keys = _keys(256, seed=5)
        kv.insert(keys, _vals(keys))
        rng = np.random.default_rng(6)
        hot = keys[:16]
        gets = []
        for _ in range(20):
            sel = rng.integers(0, 16, size=128)
            out, found = kv.get(hot[sel])
            assert found.all()
            gets.append(np.asarray(out))
        hot_hit = p.probe_hot(kv.state.index, hot)
        assert hot_hit.all()
        s = kv.stats()
        assert s["hits"] == s["gets"]
        return gets, hot_hit, counters(s), p.leaves(kv)
    twin(drill)


def test_sampled_touch_counts_one_in_n():
    """`touch_sample_every=N`: lean batches return identical results but
    only every Nth batch bumps the access counters."""
    def drill(p):
        c = p.conf

        def build(n):
            return p.KV(c.KVConfig(
                index=c.IndexConfig(kind=c.IndexKind.HOTRING,
                                    capacity=1 << 10, touch_sample_every=n,
                                    decay_every_gets=0),
                bloom=None, paged=False))

        keys = np.stack([np.arange(64, dtype=np.uint32)] * 2, -1)
        ref, sampled = build(1), build(4)
        ref.insert(keys, keys)
        sampled.insert(keys, keys)
        outs = []
        for _ in range(8):
            o1, f1 = ref.get(keys)
            o2, f2 = sampled.get(keys)
            assert f1.all() and f2.all()
            np.testing.assert_array_equal(o1, o2)
            outs.append(np.asarray(o1))
        c_ref, c_smp = p.counters(ref), p.counters(sampled)
        assert int(c_ref.sum()) == 8 * 64
        assert int(c_smp.sum()) == 2 * 64, int(c_smp.sum())
        return (outs, c_ref, c_smp, counters(ref.stats()),
                counters(sampled.stats()), p.leaves(sampled))
    twin(drill)
