"""Fused-row primitives (twin of `pmdfc_tpu/models/rowops.py`).

A row is one probe window stored as `int32[4*S]` of u32 bits: four S-lane
groups `[khi | klo | vhi | vlo]`.
"""

from __future__ import annotations

import torch

from pmdfc_tpu_torch.utils.keys import INVALID_I32, is_invalid
from pmdfc_tpu_torch.utils.u32 import M32, narrow, widen


def match_mask(rows: torch.Tensor, keys: torch.Tensor, s: int) -> torch.Tensor:
    """eq[B, S]: key-equality one-hot with INVALID queries masked off."""
    eq = (rows[:, 0:s] == keys[:, None, 0]) & (
        rows[:, s:2 * s] == keys[:, None, 1])
    return eq & ~is_invalid(keys)[:, None]


def match_rows(rows: torch.Tensor, keys: torch.Tensor, s: int):
    """rows[B, 4S] vs keys[B, 2] -> (eq[B, S], slot[B] int32, -1 on miss);
    the slot is the first matching lane."""
    eq = match_mask(rows, keys, s)
    slot = first_lane(eq).to(torch.int32)
    return eq, torch.where(eq.any(dim=1), slot, -1)


def lane_pick(rows: torch.Tensor, onehot: torch.Tensor, lo: int,
              s: int) -> torch.Tensor:
    """Masked u32 sum of the lanes of group `lo` selected by `onehot`
    (one lane per row in use) -> int32 bits [B]."""
    grp = widen(rows[:, lo:lo + s])
    return narrow(torch.where(onehot, grp, 0).sum(dim=1) & M32)


def pick_kv(rows: torch.Tensor, onehot: torch.Tensor, s: int):
    """(keys[B, 2], vals[B, 2]) at the hot lane of each row."""
    k = torch.stack([lane_pick(rows, onehot, 0, s),
                     lane_pick(rows, onehot, s, s)], dim=-1)
    v = torch.stack([lane_pick(rows, onehot, 2 * s, s),
                     lane_pick(rows, onehot, 3 * s, s)], dim=-1)
    return k, v


def free_lanes(rows: torch.Tensor, s: int) -> torch.Tensor:
    """bool[B, S]: lanes whose key is INVALID (empty slots)."""
    return (rows[:, 0:s] == INVALID_I32) & (rows[:, s:2 * s] == INVALID_I32)


def nth_lane(mask: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """One-hot[B, S] of the rank-th True lane per row (all False when rank
    is past the row's count)."""
    pos = torch.cumsum(mask, dim=1) - 1
    return mask & (pos == rank[:, None])


def first_lane(onehot: torch.Tensor) -> torch.Tensor:
    """int64[B]: index of the first True lane (0 when none), as
    `jnp.argmax` of a bool row gives it."""
    return torch.argmax(onehot.to(torch.uint8), dim=1)


def scatter_entry(table: torch.Tensor, rows: torch.Tensor, lanes: torch.Tensor,
                  keys: torch.Tensor, values: torch.Tensor, s: int,
                  mask: torch.Tensor) -> None:
    """Write (key, value) at (row, lane) where mask, in place; the masked
    (row, lane) pairs must be unique."""
    r, lane = rows[mask], lanes[mask]
    table[r, lane] = keys[mask, 0]
    table[r, s + lane] = keys[mask, 1]
    table[r, 2 * s + lane] = values[mask, 0]
    table[r, 3 * s + lane] = values[mask, 1]


def empty_table(c: int, s: int, device) -> torch.Tensor:
    """int32[c, 4*s] of empty fused rows: keys INVALID, values 0."""
    table = torch.zeros((c, 4 * s), dtype=torch.int32, device=device)
    table[:, :2 * s] = INVALID_I32
    return table


def write_values(table: torch.Tensor, rows: torch.Tensor, lanes: torch.Tensor,
                 values: torch.Tensor, s: int, mask: torch.Tensor) -> None:
    """Overwrite the value lanes at (row, lane) where mask, in place."""
    r, ln = rows[mask], lanes[mask]
    table[r, 2 * s + ln] = values[mask, 0]
    table[r, 3 * s + ln] = values[mask, 1]


def clear_keys(table: torch.Tensor, rows: torch.Tensor, lanes: torch.Tensor,
               s: int, mask: torch.Tensor) -> None:
    """Empty the key lanes at (row, lane) where mask, in place (the values
    stay, as the JAX deletes leave them)."""
    r, ln = rows[mask], lanes[mask]
    table[r, ln] = INVALID_I32
    table[r, s + ln] = INVALID_I32


def no_evict_stub(b: int, device):
    """The no-eviction payload of an insert tail: (evicted keys, evicted
    values) all INVALID, nothing dropped, lane 0 — what a tail with
    nothing left to place returns."""
    inv2 = torch.full((b, 2), INVALID_I32, dtype=torch.int32, device=device)
    return (inv2, inv2.clone(), torch.zeros(b, dtype=torch.bool, device=device),
            torch.zeros(b, dtype=torch.int32, device=device))


def place_free_phase(table: torch.Tensor, prot: torch.Tensor, r: torch.Tensor,
                     keys: torch.Tensor, vals: torch.Tensor,
                     active: torch.Tensor, s: int,
                     rank: torch.Tensor | None = None):
    """Place active keys into free lanes of row r, rank-deconflicted, in
    place -> (placed[B], slot[B] int32 or -1).

    `prot` is an int64 per-row lane bitmask of same-batch placements (so
    later displacement phases never touch them): the placed lanes' bits
    are added to it, and since they were free, adding is OR-ing (int64, so
    lane 31's bit is no sign bit). `rank` lets a caller that has an insert
    plan pass per-row ranks of `active` instead of paying this helper's
    sort."""
    from pmdfc_tpu_torch.models.base import batch_rank_by_segment

    rows = table[r]
    if rank is None:
        rank = batch_rank_by_segment(r, active)
    free = free_lanes(rows, s)
    can = active & (rank < free.sum(dim=1))
    lane = first_lane(nth_lane(free, rank))
    scatter_entry(table, r, lane, keys, vals, s, can)
    add_lane_bits(prot, r, lane, can)
    return can, torch.where(can, r * s + lane, -1).to(torch.int32)


def add_lane_bits(bits: torch.Tensor, rows: torch.Tensor, lanes: torch.Tensor,
                  mask: torch.Tensor) -> None:
    """bits[row] += 1 << lane where mask, accumulating repeated rows, in
    place (int64 bits; the masked (row, lane) pairs must be unique and
    their bits clear, so the sum is an OR)."""
    bits.index_add_(0, torch.where(mask, rows, 0),
                    torch.where(mask, 1 << lanes.to(torch.int64), 0))


def lane_bit(bits: torch.Tensor, lanes) -> torch.Tensor:
    """bool: bit `lanes` of each int64 lane mask (broadcasting)."""
    return ((bits >> lanes) & 1).bool()


def lean_miss_tail(missed: torch.Tensor, base_values: torch.Tensor,
                   base_found: torch.Tensor, tail_values: torch.Tensor,
                   tail_found: torch.Tensor):
    """Lean-GET miss tail shared by level's bottom tier and path's bank 1
    -> merged `(values[B, 2], found[B])`: the `missed` lanes take what the
    tail probe of the whole batch found for them.

    The JAX program probes only the missed lanes, compacted to a narrow
    width, unless they overflow it (`lax.cond` on the miss count). A probe
    is per key, so both give this merge: here the whole batch is probed
    and no host read of the count picks a width."""
    m = missed & tail_found
    return torch.where(m[:, None], tail_values, base_values), base_found | m


def lean_two_window(table: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor,
                    keys: torch.Tensor, s: int):
    """Lean GET over two hashed windows -> (values[B, 2] zero on miss,
    found[B]). A key occupies one lane across both windows; when the two
    hashes name the same row, window 2 is masked out (a raw sum would
    double the value)."""
    rows1, rows2 = table[r1], table[r2]
    eq1 = match_mask(rows1, keys, s)
    eq2 = match_mask(rows2, keys, s) & (r1 != r2)[:, None]
    values = torch.stack([
        narrow(widen(lane_pick(rows1, eq1, 2 * s, s))
               + widen(lane_pick(rows2, eq2, 2 * s, s))),
        narrow(widen(lane_pick(rows1, eq1, 3 * s, s))
               + widen(lane_pick(rows2, eq2, 3 * s, s)))], dim=-1)
    return values, eq1.any(dim=1) | eq2.any(dim=1)
