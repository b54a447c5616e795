"""Fused-row primitives (twin of `pmdfc_tpu/models/rowops.py`).

A row is one probe window stored as `int32[4*S]` of u32 bits: four S-lane
groups `[khi | klo | vhi | vlo]`.
"""

from __future__ import annotations

import torch

from pmdfc_tpu_torch.utils.keys import is_invalid
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
    slot = torch.argmax(eq.to(torch.uint8), dim=1).to(torch.int32)
    return eq, torch.where(eq.any(dim=1), slot, -1)


def lane_pick(rows: torch.Tensor, onehot: torch.Tensor, lo: int,
              s: int) -> torch.Tensor:
    """Masked u32 sum of the lanes of group `lo` selected by `onehot`
    (one lane per row in use) -> int32 bits [B]."""
    grp = widen(rows[:, lo:lo + s])
    return narrow(torch.where(onehot, grp, 0).sum(dim=1) & M32)
