"""PyTorch port: `tests/test_bloom.py`'s drills, one by one, on both packages.

Each test carries the name of the JAX drill it twins and runs its script
through `pmdfc_tpu.ops.bloom` and `pmdfc_tpu_torch.ops.bloom` (on the CPU)
on the same keys: the counting filter's inserts, deletes and duplicate
counts, the false-positive bound, the packed bit image and the dirty
blocks of a delta push. Both sides are held to the JAX drill's asserts,
and every query, counter array, packed image and dirty mask must be equal
(tolerance 0).
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
import torch
from torch_twin import same

from pmdfc_tpu import config as jconf
from pmdfc_tpu.ops import bloom as jbloom
from pmdfc_tpu_torch import config as tconf
from pmdfc_tpu_torch.ops import bloom as tbloom
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

H = 4


def _port(keys):
    return u32.from_numpy(keys, "cpu")


def _np(x):
    return u32.to_numpy(x) if x.dtype == torch.int32 else x.numpy()


JAX = types.SimpleNamespace(
    cfg=jconf.BloomConfig(num_bits=1 << 14, num_hashes=H),
    init=jbloom.init, ones=lambda n: jnp.ones(n, bool), keys=jnp.asarray,
    insert=lambda st, ks, m: jbloom.insert_batch(st, ks, m, num_hashes=H),
    delete=lambda st, ks, m: jbloom.delete_batch(st, ks, m, num_hashes=H),
    query=lambda st, ks: np.asarray(jbloom.query_batch(st, ks,
                                                       num_hashes=H)),
    packed=lambda st: np.asarray(jbloom.to_packed_bits(st)),
    query_packed=lambda pk, ks: np.asarray(jbloom.query_packed(
        jnp.asarray(pk), ks, num_hashes=H)),
    counters=lambda st: np.asarray(st.counters),
    dirty=lambda a, b: np.asarray(jbloom.dirty_blocks(a, b,
                                                      block_bytes=64)))
PORT = types.SimpleNamespace(
    cfg=tconf.BloomConfig(num_bits=1 << 14, num_hashes=H),
    init=lambda cfg: tbloom.init(cfg, device="cpu"),
    ones=lambda n: torch.ones(n, dtype=torch.bool), keys=_port,
    insert=lambda st, ks, m: tbloom.insert_batch(st, ks, m, num_hashes=H),
    delete=lambda st, ks, m: tbloom.delete_batch(st, ks, m, num_hashes=H),
    query=lambda st, ks: tbloom.query_batch(st, ks, num_hashes=H).numpy(),
    packed=lambda st: _np(tbloom.to_packed_bits(st)),
    query_packed=lambda pk, ks: tbloom.query_packed(
        _port(pk), ks, num_hashes=H).numpy(),
    counters=lambda st: st.counters.numpy(),
    dirty=lambda a, b: np.asarray(tbloom.dirty_blocks(a, b,
                                                      block_bytes=64)))


def keys_of(lo):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.full_like(lo, 7), lo], axis=-1)


def twin(drill):
    """`drill(pkg)` on JAX, then on the port; equal observables."""
    a, b = drill(JAX), drill(PORT)
    same(a, b, drill.__name__)
    return b


def test_insert_query_no_false_negatives():
    def drill(p):
        st = p.init(p.cfg)
        ks = p.keys(keys_of(np.arange(256)))
        st = p.insert(st, ks, p.ones(256))
        q = p.query(st, ks)
        assert q.all()
        return [q, p.counters(st)]
    twin(drill)


def test_absent_mostly_rejected():
    def drill(p):
        st = p.init(p.cfg)
        st = p.insert(st, p.keys(keys_of(np.arange(256))), p.ones(256))
        q = p.query(st, p.keys(keys_of(np.arange(100_000, 100_256))))
        assert q.mean() < 0.1
        return q
    twin(drill)


def test_delete_removes():
    def drill(p):
        st = p.init(p.cfg)
        ks = p.keys(keys_of(np.arange(64)))
        st = p.insert(st, ks, p.ones(64))
        st = p.delete(st, ks, p.ones(64))
        c = p.counters(st)
        assert int(c.sum()) == 0
        q = p.query(st, ks)
        assert not q.any()
        return [c, q]
    twin(drill)


def test_duplicate_inserts_accumulate():
    def drill(p):
        st = p.init(p.cfg)
        st = p.insert(st, p.keys(keys_of([5, 5, 5, 9])), p.ones(4))
        st = p.delete(st, p.keys(keys_of([5])), p.ones(1))
        q = p.query(st, p.keys(keys_of([5])))
        assert q.all()
        return [q, p.counters(st)]
    twin(drill)


def test_packed_matches_counters():
    def drill(p):
        st = p.init(p.cfg)
        st = p.insert(st, p.keys(keys_of(np.arange(128))), p.ones(128))
        packed = p.packed(st)
        probe = p.keys(keys_of(np.arange(0, 4096)))
        a, b = p.query(st, probe), p.query_packed(packed, probe)
        np.testing.assert_array_equal(a, b)
        return [packed, a]
    twin(drill)


def test_dirty_blocks():
    def drill(p):
        st = p.init(p.cfg)
        p0 = p.packed(st)
        st = p.insert(st, p.keys(keys_of([3])), p.ones(1))
        p1 = p.packed(st)
        dirty = p.dirty(p0, p1)
        assert dirty.any() and not dirty.all()
        return [p0, p1, dirty]
    twin(drill)
