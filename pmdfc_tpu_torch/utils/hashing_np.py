"""Pure-numpy murmur3-32 and the packed bloom mirror (twin of
`pmdfc_tpu/utils/hashing_np.py`, the part the client needs).

The client-side bloom check (`client/bloom_filter.c:61-116` in the reference)
must run host-side with zero device involvement — that is its entire purpose
(short-circuit misses without an RTT). `hash_u64_np` is bit-exact with
`utils/hashing.hash_u64`, and the packed positions with `ops/bloom`'s, so a
mirror built from `KV.packed_bloom()` answers as the server's filter does
(`tests/test_torch_client.py`). Only murmur3 is kept: it is the one family
the bloom filter hashes with.
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def hash_u64_np(hi: np.ndarray, lo: np.ndarray, seed: int = 0) -> np.ndarray:
    """murmur3-32 of the 8-byte key (hi<<32|lo), as uint32."""
    with np.errstate(over="ignore"):
        h1 = np.uint32(seed) * np.ones_like(np.asarray(hi, np.uint32))
        for word in (np.asarray(lo, np.uint32), np.asarray(hi, np.uint32)):
            k = word * _C1
            k = _rotl32(k, 15)
            k = k * _C2
            h1 = h1 ^ k
            h1 = _rotl32(h1, 13)
            h1 = h1 * np.uint32(5) + np.uint32(0xE6546B64)
        h1 = h1 ^ np.uint32(8)
        return _fmix32(h1)


def bloom_positions_np(keys: np.ndarray, num_bits: int,
                       num_hashes: int) -> np.ndarray:
    """[k, B] bit positions — mirrors `ops/bloom._positions`."""
    hs = []
    for i in range(num_hashes):
        seed = (0x9E3779B9 * (i + 1)) & 0xFFFFFFFF
        hs.append(hash_u64_np(keys[..., 0], keys[..., 1], seed=seed))
    h = np.stack(hs)
    if num_bits & (num_bits - 1) == 0:
        return h & np.uint32(num_bits - 1)
    return h % np.uint32(num_bits)


def query_packed_np(packed: np.ndarray, keys: np.ndarray,
                    num_hashes: int) -> np.ndarray:
    """Host-side membership test against the packed mirror (MSB-first)."""
    num_bits = packed.shape[0] * 32
    pos = bloom_positions_np(keys, num_bits, num_hashes)
    word = packed[pos >> 5]
    bit = (word >> (np.uint32(31) - (pos & np.uint32(31)))) & np.uint32(1)
    return (bit > 0).all(axis=0)


def add_packed_np(packed: np.ndarray, keys: np.ndarray,
                  num_hashes: int) -> None:
    """Set the k bits of each key in the local mirror, in place — the
    client-side `bloom_filter_add` on every put (`client/rdpma.c:295-305`)."""
    num_bits = packed.shape[0] * 32
    pos = bloom_positions_np(keys, num_bits, num_hashes).reshape(-1)
    np.bitwise_or.at(
        packed, pos >> 5, np.uint32(1) << (np.uint32(31) - (pos & np.uint32(31)))
    )
