"""PyTorch port: u32 words, keys and murmur3 hashing against the JAX package.

Same inputs (numpy, seeded) through `pmdfc_tpu.utils` and
`pmdfc_tpu_torch.utils`; every comparison is exact (integer arithmetic).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

from pmdfc_tpu.utils import hashing as jhash
from pmdfc_tpu.utils import keys as jkeys
from pmdfc_tpu_torch.utils import hashing as thash
from pmdfc_tpu_torch.utils import keys as tkeys
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                 0xFFFFFFFF], np.uint32)


def _words(seed, n=4096):
    rng = np.random.default_rng(seed)
    hi = np.concatenate([rng.integers(0, 1 << 32, n, dtype=np.uint32),
                         np.repeat(EDGE, len(EDGE))])
    lo = np.concatenate([rng.integers(0, 1 << 32, n, dtype=np.uint32),
                         np.tile(EDGE, len(EDGE))])
    return hi, lo


def test_u32_representation_edge_words():
    """int32 storage, int64 arithmetic: round trips and wrapping products
    are exact on the edge words (uint32 arithmetic itself is not usable
    in torch on every backend)."""
    t = u32.from_numpy(EDGE, "cpu")
    assert t.dtype == torch.int32
    assert np.array_equal(u32.to_numpy(t), EDGE)
    w = u32.widen(t)
    assert w.dtype == torch.int64 and int(w.min()) >= 0
    assert np.array_equal(w.numpy(), EDGE.astype(np.int64))
    assert torch.equal(u32.narrow(w), t)
    for c in (0x9E3779B9, 0xCC9E2D51, 0xFFFFFFFF, 1, 0):
        with np.errstate(over="ignore"):
            want = EDGE * np.uint32(c)
        assert np.array_equal(u32.mul(w, c).numpy(), want.astype(np.int64))
    with np.errstate(over="ignore"):
        rot = (EDGE << np.uint32(13)) | (EDGE >> np.uint32(19))
    assert np.array_equal(u32.rotl(w, 13).numpy(), rot.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 0x0E51C7ED, 0x0E51C7ED ^ 0x9E3779B9,
                                  0xFFFFFFFF])
def test_hash_u64_matches_jax(seed):
    hi, lo = _words(seed & 0xFFFF)
    want = np.asarray(jhash.hash_u64(jnp.asarray(hi), jnp.asarray(lo),
                                     seed=seed))
    got = thash.hash_u64(u32.from_numpy(hi, "cpu"), u32.from_numpy(lo, "cpu"),
                         seed=seed)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("num_hashes,seed_base", [(4, 0), (7, 0x12345)])
def test_hash_u64_multi_matches_jax(num_hashes, seed_base):
    hi, lo = _words(num_hashes)
    want = np.asarray(jhash.hash_u64_multi(jnp.asarray(hi), jnp.asarray(lo),
                                           num_hashes, seed_base))
    got = thash.hash_u64_multi(u32.from_numpy(hi, "cpu"),
                               u32.from_numpy(lo, "cpu"), num_hashes,
                               seed_base)
    assert got.shape == (num_hashes, len(hi))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_pack_key_and_is_invalid_match_jax():
    hi = [0, 5, 0xFFFFFFFF, 0xFFFFFFFF, 0x80000000]
    lo = [7, 0xFFFFFFFF, 0xFFFFFFFF, 3, 0x80000000]
    jk = np.asarray(jkeys.pack_key(hi, lo))
    tk = tkeys.pack_key(hi, lo, device="cpu")
    assert tk.dtype == torch.int32 and tk.shape == (5, 2)
    assert np.array_equal(u32.to_numpy(tk), jk)
    assert np.array_equal(tkeys.is_invalid(tk).numpy(),
                          np.asarray(jkeys.is_invalid(jnp.asarray(jk))))
    assert tkeys.INVALID_WORD == jkeys.INVALID_WORD


@pytest.mark.parametrize("family", ["murmur3", "std", "murmur2", "jenkins",
                                    "xxhash"])
def test_hash_families_match_jax(family):
    """The reference's `h()` dispatcher: each family on torch and in numpy
    (`hashing_np.h_np`) bit for bit against the JAX package's, over
    random and edge words and three seeds."""
    from pmdfc_tpu.utils import hashing_np as jhnp
    from pmdfc_tpu_torch.utils import hashing_np as thnp

    assert sorted(thash.FAMILIES) == sorted(jhash.FAMILIES)
    assert sorted(thnp.FAMILIES_NP) == sorted(jhnp.FAMILIES_NP)
    hi, lo = _words(len(family))
    for seed in (0, 11, 0xFFFFFFFF):
        want = np.asarray(jhash.h(jnp.asarray(hi), jnp.asarray(lo),
                                  seed=seed, family=family))
        got = thash.h(u32.from_numpy(hi, "cpu"), u32.from_numpy(lo, "cpu"),
                      seed=seed, family=family)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want.astype(np.int64)), seed
        assert np.array_equal(thnp.h_np(hi, lo, seed, family), want), seed
    with pytest.raises(ValueError, match="unknown hash family"):
        thash.h(u32.from_numpy(hi, "cpu"), u32.from_numpy(lo, "cpu"),
                family="nope")
    with pytest.raises(ValueError, match="unknown hash family"):
        thnp.h_np(hi, lo, family="nope")
