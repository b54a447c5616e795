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


def no_evict_stub(b: int, device):
    """The no-eviction payload of an insert tail: (evicted keys, evicted
    values) all INVALID, nothing dropped, lane 0 — what a tail with
    nothing left to place returns."""
    inv2 = torch.full((b, 2), INVALID_I32, dtype=torch.int32, device=device)
    return (inv2, inv2.clone(), torch.zeros(b, dtype=torch.bool, device=device),
            torch.zeros(b, dtype=torch.int32, device=device))
