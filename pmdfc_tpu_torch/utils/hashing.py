"""Hashes over 64-bit keys (twin of `pmdfc_tpu/utils/hashing.py`).

Keys are (hi, lo) u32 pairs; the default hash is murmur3-32 over the two
words, and the reference's `h()` dispatcher adds four more families.
Inputs are int32 tensors of u32 bits (or any integer tensor holding u32
values); results are int64 tensors holding the u32 hash in [0, 2^32)
(see `utils/u32.py`), ready for `& (n - 1)`.
"""

from __future__ import annotations

import torch

from pmdfc_tpu_torch.utils.u32 import M32, mul, rotl, widen

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_u64(hi: torch.Tensor, lo: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3-32 of the 8-byte key (hi<<32|lo), as int64 in [0, 2^32)."""
    h1 = torch.full_like(hi, seed & M32, dtype=torch.int64)
    for word in (widen(lo), widen(hi)):
        k = mul(word, _C1)
        k = rotl(k, 15)
        k = mul(k, _C2)
        h1 = rotl(h1 ^ k, 13)
        h1 = (h1 * 5 + 0xE6546B64) & M32
    return _fmix32(h1 ^ 8)  # total length in bytes


def hash_u64_multi(hi: torch.Tensor, lo: torch.Tensor, num_hashes: int,
                   seed_base: int = 0) -> torch.Tensor:
    """Stack of `num_hashes` independent hashes, shape (num_hashes, *key_shape)."""
    return torch.stack([
        hash_u64(hi, lo, seed=(seed_base + 0x9E3779B9 * (i + 1)) & M32)
        for i in range(num_hashes)
    ])


# ---------------------------------------------------------------------------
# The reference's four-family dispatcher `h()` (`server/util/hash.h:240-252`:
# std, murmur2, jenkins, xxhash over the 8-byte key), each on (hi, lo) u32
# lanes with wraparound arithmetic. murmur3 (above) is the default; the
# others exist for parity and for consumers that want another family.
# ---------------------------------------------------------------------------

def _key_bytes(hi: torch.Tensor, lo: torch.Tensor):
    """The 8 key bytes, lo word first, least significant byte first."""
    for word in (widen(lo), widen(hi)):
        for shift in (0, 8, 16, 24):
            yield (word >> shift) & 0xFF


def hash_std(hi: torch.Tensor, lo: torch.Tensor, seed: int = 0
             ) -> torch.Tensor:
    """FNV-1a over the 8 key bytes (the `std::hash` stand-in)."""
    h = torch.full_like(hi, (0x811C9DC5 ^ seed) & M32, dtype=torch.int64)
    for b in _key_bytes(hi, lo):
        h = mul(h ^ b, 0x01000193)
    return h


def hash_murmur2(hi: torch.Tensor, lo: torch.Tensor, seed: int = 0
                 ) -> torch.Tensor:
    """MurmurHash2 (32-bit) over the two key words — the family the
    reference's counting bloom filter salts (`counting_bloom_filter.h:249`)."""
    m = 0x5BD1E995
    h = torch.full_like(hi, (seed ^ 8) & M32, dtype=torch.int64)
    for word in (widen(lo), widen(hi)):
        k = mul(word, m)
        k = k ^ (k >> 24)
        k = mul(k, m)
        h = mul(h, m) ^ k
    h = h ^ (h >> 13)
    h = mul(h, m)
    return h ^ (h >> 15)


def hash_jenkins(hi: torch.Tensor, lo: torch.Tensor, seed: int = 0
                 ) -> torch.Tensor:
    """Jenkins one-at-a-time over the 8 key bytes."""
    h = torch.full_like(hi, seed & M32, dtype=torch.int64)
    for b in _key_bytes(hi, lo):
        h = (h + b) & M32
        h = (h + (h << 10)) & M32
        h = h ^ (h >> 6)
    h = (h + (h << 3)) & M32
    h = h ^ (h >> 11)
    return (h + (h << 15)) & M32


def hash_xxh32(hi: torch.Tensor, lo: torch.Tensor, seed: int = 0
               ) -> torch.Tensor:
    """xxHash32 of the 8-byte key (small-input path: no stripe loop)."""
    p2, p3, p4, p5 = 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1
    h = torch.full_like(hi, (seed + p5 + 8) & M32, dtype=torch.int64)
    for word in (widen(lo), widen(hi)):
        h = (h + mul(word, p3)) & M32
        h = mul(rotl(h, 17), p4)
    h = h ^ (h >> 15)
    h = mul(h, p2)
    h = h ^ (h >> 13)
    h = mul(h, p3)
    return h ^ (h >> 16)


FAMILIES = {
    "murmur3": hash_u64,
    "std": hash_std,
    "murmur2": hash_murmur2,
    "jenkins": hash_jenkins,
    "xxhash": hash_xxh32,
}


def h(hi: torch.Tensor, lo: torch.Tensor, seed: int = 0,
      family: str = "murmur3") -> torch.Tensor:
    """The reference's `h()` dispatcher (`server/util/hash.h:240-252`)."""
    try:
        return FAMILIES[family](hi, lo, seed)
    except KeyError:
        raise ValueError(
            f"unknown hash family {family!r}; have {sorted(FAMILIES)}"
        ) from None


SHARD_SEED = 0x5EED5EED


def shard_of(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Key -> owning shard, the `GetNodeID(key)` analog
    (`server/NuMA_KV.cpp:141`): int64 in [0, n_shards) per [..., 2] key
    (u32 bits as int32). One murmur3 family member is reserved for
    routing, so the shard choice is independent of every index's bucket
    choice."""
    h = hash_u64(keys[..., 0], keys[..., 1], seed=SHARD_SEED)
    return h % n_shards
