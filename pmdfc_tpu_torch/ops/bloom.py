"""Counting bloom filter (twin of `pmdfc_tpu/ops/bloom.py`).

Reference: `server/util/counting_bloom_filter.h`: counters, Insert/Delete/
Query, and `ToOrdinaryBloomFilter()`, the packed MSB-first bit form pushed
to clients (`client/bloom_filter.c:61-116`).

Counters are int32; a batch insert or delete is one accumulating scatter
over the `k × B` hashed positions, written IN PLACE into
`state.counters`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pmdfc_tpu_torch.config import BloomConfig
from pmdfc_tpu_torch.utils.hashing import hash_u64_multi
from pmdfc_tpu_torch.utils.keys import is_invalid
from pmdfc_tpu_torch.utils.u32 import narrow, widen


@dataclasses.dataclass
class BloomState:
    counters: torch.Tensor  # int32[num_bits]


def init(config: BloomConfig, device="cuda") -> BloomState:
    return BloomState(counters=torch.zeros(config.num_bits, dtype=torch.int32,
                                           device=device))


def _positions(keys: torch.Tensor, num_bits: int, num_hashes: int) -> torch.Tensor:
    """int64[k, B] bit positions for each key (one murmur3 seed per hash)."""
    h = hash_u64_multi(keys[..., 0], keys[..., 1], num_hashes)
    if num_bits & (num_bits - 1) == 0:
        return h & (num_bits - 1)
    return h % num_bits


def _bump(state: BloomState, keys, mask, delta: int, num_hashes: int):
    pos = _positions(keys, state.counters.shape[0], num_hashes)
    live = mask & ~is_invalid(keys)
    w = torch.where(live, delta, 0).to(torch.int32).expand(pos.shape)
    state.counters.index_put_((pos.reshape(-1),), w.reshape(-1),
                              accumulate=True)
    return state


def insert_batch(state: BloomState, keys: torch.Tensor, mask: torch.Tensor,
                 *, num_hashes: int) -> BloomState:
    """+1 at the k hashed positions of every masked key (in place)."""
    return _bump(state, keys, mask, +1, num_hashes)


def delete_batch(state: BloomState, keys: torch.Tensor, mask: torch.Tensor,
                 *, num_hashes: int) -> BloomState:
    """-1 at the k hashed positions of every masked key (in place); the
    caller guarantees the keys were inserted before."""
    return _bump(state, keys, mask, -1, num_hashes)


def query_batch(state: BloomState, keys: torch.Tensor, *,
                num_hashes: int) -> torch.Tensor:
    """bool[B]: True if possibly present (all k counters non-zero)."""
    pos = _positions(keys, state.counters.shape[0], num_hashes)
    return (state.counters[pos] > 0).all(dim=0)


def to_packed_bits(state: BloomState) -> torch.Tensor:
    """Counters -> packed u32 words (int32 bits), MSB-first per word."""
    bits = (state.counters > 0).reshape(-1, 32).to(torch.int64)
    weights = 1 << (31 - torch.arange(32, device=bits.device))
    return narrow((bits * weights[None, :]).sum(dim=1))


def query_packed(packed: torch.Tensor, keys: torch.Tensor, *,
                 num_hashes: int) -> torch.Tensor:
    """Membership against the packed client-side mirror (u32 words as
    int32 bits, MSB-first per word): bool[B]."""
    pos = _positions(keys, packed.shape[0] * 32, num_hashes)
    bit = (widen(packed[pos >> 5]) >> (31 - (pos & 31))) & 1
    return (bit > 0).all(dim=0)


def dirty_blocks(old_packed: np.ndarray, new_packed: np.ndarray,
                 *, block_bytes: int = 8192) -> np.ndarray:
    """bool[num_blocks]: which fixed-size blocks of the packed form changed.

    Mirrors `GetUpdatedBlocks` (`counting_bloom_filter.h:101-107`, 8 KB
    blocks) — the delta-sync unit for pushing filter updates to clients.
    Host numpy in and out: the server diffs two `KV.packed_bloom()`
    snapshots, which are already on the host.
    """
    words_per_block = block_bytes // 4
    diff = (old_packed ^ new_packed).reshape(-1, words_per_block)
    return (diff != 0).any(axis=1)
