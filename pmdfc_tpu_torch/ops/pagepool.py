"""Device page pool: pages behind a free-row stack (twin of
`pmdfc_tpu/ops/pagepool.py`).

The index value of a paged entry is its pool row id; rows are allocated
by one fused push(evicted rows)-then-pop(rows for fresh entries) over a
device-resident free stack. Every row carries a 32-bit digest (`sums`)
computed at write time; a GET recomputes it from the gathered bytes and
refuses a page that no longer matches (clean-cache: lose anything, serve
nothing wrong).

In place. `write_batch`, `write_sums` and `recycle_and_alloc` update the
pool's tensors in place: the full-size pool is 8 GiB and is never copied.
Writes with row -1 are masked out (the JAX versions' `mode="drop"`), and
gathers clamp their rows to the pool, as JAX gathers do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pmdfc_tpu_torch.utils.u32 import M32, mul, narrow, widen

_LANE_SALT = 0x9E3779B9   # golden-ratio odd constant: position-mixes lanes
_FNV_PRIME = 0x01000193
_FINAL_MIX = 0x85EBCA6B   # murmur3 finalizer constant


def xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last axis by halving (torch has no XOR reduction;
    XOR is associative and commutative, so any order gives the same)."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        y = x[..., :h] ^ x[..., h:2 * h]
        if n % 2:
            y[..., 0] ^= x[..., n - 1]
        x = y
    return x[..., 0]


def page_digest(pages: torch.Tensor) -> torch.Tensor:
    """int32[..., W] pages (u32 bits) -> int32[...] per-page digest bits.

    Each word is mixed with its lane index, multiplied by the FNV prime,
    avalanche-shifted, XOR-folded across lanes, then finalized.
    """
    w = pages.shape[-1]
    lanes = (torch.arange(w, device=pages.device) * _LANE_SALT) & M32
    mixed = ((widen(pages) ^ lanes) * _FNV_PRIME) & M32  # < 2^57: exact
    mixed = mixed ^ (mixed >> 15)
    h = mul(xor_fold(mixed), _FINAL_MIX)
    return narrow(h ^ (h >> 13))


def page_digest_np(pages: np.ndarray) -> np.ndarray:
    """Host (numpy) mirror of `page_digest` — bit-identical, so a client
    can digest at put time and verify server-returned pages end to end
    (`client.backends.IntegrityBackend`). uint32 pages -> uint32 digests."""
    pages = np.ascontiguousarray(pages, np.uint32)
    lanes = np.arange(pages.shape[-1], dtype=np.uint32)
    with np.errstate(over="ignore"):
        mixed = (pages ^ (lanes * np.uint32(_LANE_SALT))) \
            * np.uint32(_FNV_PRIME)
        mixed ^= mixed >> np.uint32(15)
        h = np.bitwise_xor.reduce(mixed, axis=-1) * np.uint32(_FINAL_MIX)
    return h ^ (h >> np.uint32(13))


@dataclasses.dataclass
class PoolState:
    pages: torch.Tensor  # int32[num_rows, page_words] u32 bits
    sums: torch.Tensor   # int32[num_rows] per-row page digest bits
    free: torch.Tensor   # int32[num_rows] stack of free row ids
    top: torch.Tensor    # int32[] number of free rows


def init(num_rows: int, page_words: int = 1024, device="cuda") -> PoolState:
    return PoolState(
        pages=torch.zeros((num_rows, page_words), dtype=torch.int32,
                          device=device),
        sums=torch.zeros(num_rows, dtype=torch.int32, device=device),
        free=torch.arange(num_rows - 1, -1, -1, dtype=torch.int32,
                          device=device),
        top=torch.tensor(num_rows, dtype=torch.int32, device=device),
    )


def write_batch(pages: torch.Tensor, rows: torch.Tensor,
                batch: torch.Tensor) -> torch.Tensor:
    """pages[rows] = batch in place; row -1 ⇒ no write."""
    ok = rows >= 0
    pages[rows[ok].to(torch.int64)] = batch[ok]
    return pages


def write_sums(sums: torch.Tensor, rows: torch.Tensor,
               digests: torch.Tensor) -> torch.Tensor:
    """sums[rows] = digests in place; row -1 ⇒ no write."""
    ok = rows >= 0
    sums[rows[ok].to(torch.int64)] = digests[ok]
    return sums


def read_batch(pages: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Gather pool rows for rows[B]; row -1 ⇒ zero page."""
    safe = rows.to(torch.int64).clamp(0, pages.shape[0] - 1)
    return torch.where((rows >= 0)[:, None], pages[safe], 0)


def verify_batch(pool: PoolState, rows: torch.Tensor,
                 pages_out: torch.Tensor) -> torch.Tensor:
    """ok[B]: the gathered row's bytes still match its stored digest;
    rows < 0 (misses) report False."""
    safe = rows.to(torch.int64).clamp(0, pool.sums.shape[0] - 1)
    stored = torch.where(rows >= 0, pool.sums[safe], 0)
    return (rows >= 0) & (page_digest(pages_out) == stored)


def recycle_and_alloc(pool: PoolState, freed_mask: torch.Tensor,
                      freed_rows: torch.Tensor, want_mask: torch.Tensor):
    """One push-then-pop over the free stack, in place.

    `freed_rows[B]` (masked by `freed_mask`) return to the stack; then one
    row is popped for every True in `want_mask[B]`. Returns (pool, rows[B])
    with rows == -1 where `want_mask` is False. Freed rows sit on top, so
    an evicting insert reuses its victim's row.
    """
    n = pool.free.shape[0]
    top = pool.top.to(torch.int64)

    # push: freed rows land at [top, top+F)
    push_pos = top + torch.cumsum(freed_mask.to(torch.int64), 0) - 1
    ok_push = freed_mask & (push_pos < n)
    pool.free[push_pos[ok_push]] = freed_rows[ok_push].to(torch.int32)
    top = top + freed_mask.sum()

    # pop: want i takes free[top-1-rank_i]
    pop_pos = top - torch.cumsum(want_mask.to(torch.int64), 0)
    ok = want_mask & (pop_pos >= 0)  # defensive: unreachable when slots conserve
    rows = torch.where(ok, pool.free[pop_pos.clamp(0, n - 1)], -1)
    pool.top.copy_(top - ok.sum())
    return pool, rows
