"""murmur3-32 over 64-bit keys (twin of `pmdfc_tpu/utils/hashing.py`).

Keys are (hi, lo) u32 pairs; the hash is murmur3-32 over the two words.
Inputs are int32 tensors of u32 bits; results are int64 tensors holding
the u32 hash in [0, 2^32) (see `utils/u32.py`), ready for `& (n - 1)`.
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


SHARD_SEED = 0x5EED5EED


def shard_of(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Key -> owning shard, the `GetNodeID(key)` analog
    (`server/NuMA_KV.cpp:141`): int64 in [0, n_shards) per [..., 2] key
    (u32 bits as int32). One murmur3 family member is reserved for
    routing, so the shard choice is independent of every index's bucket
    choice."""
    h = hash_u64(keys[..., 0], keys[..., 1], seed=SHARD_SEED)
    return h % n_shards
