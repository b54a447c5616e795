"""PyTorch port: `tests/test_hashing.py`'s drills, one by one, on both
packages.

Each test carries the name of the JAX drill it twins, runs the drill's
inputs through `pmdfc_tpu.utils` and `pmdfc_tpu_torch.utils`, holds both
to the drill's own asserts (determinism and seed sensitivity, spread of
sequential keys, independence of the multi-hash rows, the key round
trip) and compares the two packages' words exactly (tolerance 0).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)

from pmdfc_tpu.utils import hashing as jhash
from pmdfc_tpu.utils import keys as jkeys
from pmdfc_tpu_torch.utils import hashing as thash
from pmdfc_tpu_torch.utils import keys as tkeys
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch


def _jax_h(hi, lo, **kw):
    return np.asarray(jhash.hash_u64(jnp.asarray(hi), jnp.asarray(lo), **kw))


def _port_h(hi, lo, **kw):
    return thash.hash_u64(u32.from_numpy(hi, "cpu"), u32.from_numpy(lo, "cpu"),
                          **kw).numpy().astype(np.uint32)


def _both(fn_j, fn_t, *args, **kw):
    a, b = fn_j(*args, **kw), fn_t(*args, **kw)
    assert a.dtype == b.dtype and np.array_equal(a, b), "packages differ"
    return a


def test_hash_deterministic_and_seed_sensitive():
    hi = np.arange(1000, dtype=np.uint32)
    lo = np.arange(1000, dtype=np.uint32) * np.uint32(7)
    h0 = _both(_jax_h, _port_h, hi, lo, seed=0)
    h0b = _both(_jax_h, _port_h, hi, lo, seed=0)
    h1 = _both(_jax_h, _port_h, hi, lo, seed=1)
    np.testing.assert_array_equal(h0, h0b)
    assert np.mean(h0 != h1) > 0.99


def test_hash_distribution_uniform():
    hi = np.zeros(1 << 14, dtype=np.uint32)
    lo = np.arange(1 << 14, dtype=np.uint32)  # sequential page indexes
    buckets = _both(_jax_h, _port_h, hi, lo) % 256
    counts = np.bincount(buckets, minlength=256)
    assert counts.max() < 3 * counts.mean()
    assert counts.min() > 0


def test_hash_multi_independent():
    hi = np.arange(4096, dtype=np.uint32)
    lo = np.arange(4096, dtype=np.uint32)
    hs = np.asarray(jhash.hash_u64_multi(jnp.asarray(hi), jnp.asarray(lo),
                                         num_hashes=4))
    ths = thash.hash_u64_multi(u32.from_numpy(hi, "cpu"),
                               u32.from_numpy(lo, "cpu"), num_hashes=4)
    assert np.array_equal(ths.numpy().astype(np.uint32), hs)
    assert hs.shape == (4, 4096)
    for i in range(4):
        for j in range(i + 1, 4):
            assert np.mean(hs[i] == hs[j]) < 0.01


def test_key_pack_roundtrip_and_invalid():
    """JAX packs through `make_longkey` and splits through
    `split_longkey`; the port packs straight from the words (it keeps no
    longkey helpers: a key is its two columns) and the columns split it."""
    hi, lo = jkeys.make_longkey([1, 2, 3], [10, 20, 30])
    keys = np.asarray(jkeys.pack_key(hi, lo))
    tk = tkeys.pack_key([1, 2, 3], [10, 20, 30], device="cpu")
    assert keys.shape == (3, 2) and tk.shape == (3, 2)
    assert np.array_equal(u32.to_numpy(tk), keys)
    rhi, rlo = jkeys.split_longkey(keys)
    np.testing.assert_array_equal(np.asarray(rhi), [1, 2, 3])
    np.testing.assert_array_equal(np.asarray(rlo), [10, 20, 30])
    np.testing.assert_array_equal(u32.to_numpy(tk[:, 0]), [1, 2, 3])
    np.testing.assert_array_equal(u32.to_numpy(tk[:, 1]), [10, 20, 30])
    assert not bool(jkeys.is_invalid(keys).any())
    assert not bool(tkeys.is_invalid(tk).any())
    inv = jkeys.pack_key([jkeys.INVALID_WORD], [jkeys.INVALID_WORD])
    tinv = tkeys.pack_key([tkeys.INVALID_WORD], [tkeys.INVALID_WORD],
                          device="cpu")
    assert np.array_equal(u32.to_numpy(tinv), np.asarray(inv))
    assert bool(jkeys.is_invalid(inv).all())
    assert bool(tkeys.is_invalid(tinv).all())
