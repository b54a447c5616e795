"""Pure-numpy murmur3-32 and the packed bloom mirror (twin of
`pmdfc_tpu/utils/hashing_np.py`, the part the client needs).

The client-side bloom check (`client/bloom_filter.c:61-116` in the reference)
must run host-side with zero device involvement — that is its entire purpose
(short-circuit misses without an RTT). `hash_u64_np` is bit-exact with
`utils/hashing.hash_u64`, and the packed positions with `ops/bloom`'s, so a
mirror built from `KV.packed_bloom()` answers as the server's filter does
(`tests/test_torch_client.py`). The reference's four other families and
the `h_np` dispatcher are numpy twins of `utils/hashing.py`'s.
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


def _bytes_fold(word: np.ndarray):
    for shift in (0, 8, 16, 24):
        yield (word >> np.uint32(shift)) & np.uint32(0xFF)


def hash_std_np(hi, lo, seed: int = 0) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (np.uint32(0x811C9DC5) ^ np.uint32(seed)) * np.ones_like(
            np.asarray(hi, np.uint32))
        prime = np.uint32(0x01000193)
        for word in (np.asarray(lo, np.uint32), np.asarray(hi, np.uint32)):
            for b in _bytes_fold(word):
                h = (h ^ b) * prime
        return h


def hash_murmur2_np(hi, lo, seed: int = 0) -> np.ndarray:
    with np.errstate(over="ignore"):
        m = np.uint32(0x5BD1E995)
        h = (np.uint32(seed) ^ np.uint32(8)) * np.ones_like(
            np.asarray(hi, np.uint32))
        for word in (np.asarray(lo, np.uint32), np.asarray(hi, np.uint32)):
            k = word * m
            k = k ^ (k >> np.uint32(24))
            k = k * m
            h = (h * m) ^ k
        h = h ^ (h >> np.uint32(13))
        h = h * m
        h = h ^ (h >> np.uint32(15))
        return h


def hash_jenkins_np(hi, lo, seed: int = 0) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = np.uint32(seed) * np.ones_like(np.asarray(hi, np.uint32))
        for word in (np.asarray(lo, np.uint32), np.asarray(hi, np.uint32)):
            for b in _bytes_fold(word):
                h = h + b
                h = h + (h << np.uint32(10))
                h = h ^ (h >> np.uint32(6))
        h = h + (h << np.uint32(3))
        h = h ^ (h >> np.uint32(11))
        h = h + (h << np.uint32(15))
        return h


def hash_xxh32_np(hi, lo, seed: int = 0) -> np.ndarray:
    with np.errstate(over="ignore"):
        p2, p3 = np.uint32(0x85EBCA77), np.uint32(0xC2B2AE3D)
        p4, p5 = np.uint32(0x27D4EB2F), np.uint32(0x165667B1)
        h = (np.uint32(seed) + p5 + np.uint32(8)) * np.ones_like(
            np.asarray(hi, np.uint32))
        for word in (np.asarray(lo, np.uint32), np.asarray(hi, np.uint32)):
            h = h + word * p3
            h = _rotl32(h, 17) * p4
        h = h ^ (h >> np.uint32(15))
        h = h * p2
        h = h ^ (h >> np.uint32(13))
        h = h * p3
        h = h ^ (h >> np.uint32(16))
        return h


FAMILIES_NP = {
    "murmur3": hash_u64_np,
    "std": hash_std_np,
    "murmur2": hash_murmur2_np,
    "jenkins": hash_jenkins_np,
    "xxhash": hash_xxh32_np,
}


def h_np(hi, lo, seed: int = 0, family: str = "murmur3") -> np.ndarray:
    try:
        return FAMILIES_NP[family](hi, lo, seed)
    except KeyError:
        raise ValueError(
            f"unknown hash family {family!r}; have {sorted(FAMILIES_NP)}"
        ) from None


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
