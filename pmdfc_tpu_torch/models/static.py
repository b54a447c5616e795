"""Static hash — one fixed table, no splits, no eviction (twin of
`pmdfc_tpu/models/static.py`).

Reference: `server/src/static_hash.{h,cpp}`, one fixed `Pair*` array
whose full region fails an insert. Here: the fused-row layout probed at
one hashed S-lane window; a full window DROPS the insert (reported, legal
under clean-cache) where the linear index would FIFO-evict.

In place, as the linear index: inserts, deletes and `set_values` write
`state.table` and return the same state.
"""

from __future__ import annotations

import dataclasses

import torch

from pmdfc_tpu_torch.config import IndexConfig, IndexKind
from pmdfc_tpu_torch.models import linear
from pmdfc_tpu_torch.models.base import (
    GetResult,
    IndexOps,
    InsertResult,
    dedupe_last_wins,
    register_index,
)
from pmdfc_tpu_torch.models.rowops import (
    clear_keys,
    empty_table,
    match_mask,
    match_rows,
    pick_kv,
    place_free_phase,
    write_values,
)
from pmdfc_tpu_torch.utils.keys import INVALID_I32, is_invalid


@dataclasses.dataclass
class StaticState:
    table: torch.Tensor  # int32[C, 4*S] u32 bits, fused rows


def _num_rows(config: IndexConfig) -> int:
    return linear._num_clusters(config)


def num_slots(config: IndexConfig) -> int:
    return _num_rows(config) * config.cluster_slots


def init(config: IndexConfig, device="cuda") -> StaticState:
    return StaticState(table=empty_table(_num_rows(config),
                                         config.cluster_slots, device))


def _row_of(state: StaticState, keys: torch.Tensor) -> torch.Tensor:
    return linear.cluster_of(keys, state.table.shape[0])


def get_batch(state: StaticState, keys: torch.Tensor) -> GetResult:
    s = state.table.shape[1] // 4
    row = _row_of(state, keys)
    rows = state.table[row]
    eq, lane = match_rows(rows, keys, s)
    found = lane >= 0
    _, values = pick_kv(rows, eq, s)
    gslot = torch.where(found, row * s + lane.clamp(min=0), -1)
    return GetResult(values=values, found=found, slots=gslot.to(torch.int32))


def get_values(state: StaticState, keys: torch.Tensor):
    """Lean GET: (values[B, 2] zero on miss, found[B])."""
    s = state.table.shape[1] // 4
    rows = state.table[_row_of(state, keys)]
    eq = match_mask(rows, keys, s)
    return pick_kv(rows, eq, s)[1], eq.any(dim=1)


def insert_batch(state: StaticState, keys: torch.Tensor, values: torch.Tensor):
    """In place -> (state, InsertResult): in-place updates, then free lanes
    of the one window; no free lane drops the key."""
    c = state.table.shape[0]
    s = state.table.shape[1] // 4
    b = keys.shape[0]
    winner = dedupe_last_wins(keys, ~is_invalid(keys))
    row = _row_of(state, keys)
    rows = state.table[row]
    mk = torch.where(winner[:, None], keys, INVALID_I32)
    _, lane = match_rows(rows, mk, s)
    upd = winner & (lane >= 0)
    l_u = lane.clamp(min=0).to(torch.int64)
    write_values(state.table, row, l_u, values, s, upd)

    new = winner & (lane < 0)
    prot = torch.zeros(c, dtype=torch.int64, device=keys.device)
    can, free_slots = place_free_phase(state.table, prot, row, keys, values,
                                       new, s)
    slots = torch.where(upd, (row * s + l_u).to(torch.int32),
                        torch.where(can, free_slots, -1))
    inv2 = torch.full((b, 2), INVALID_I32, dtype=torch.int32,
                      device=keys.device)
    return state, InsertResult(slots=slots, evicted=inv2,
                               dropped=new & ~can, fresh=can,
                               evicted_vals=inv2.clone())


def delete_batch(state: StaticState, keys: torch.Tensor):
    """In place -> (state, hit[B], old_vals[B, 2] (INVALID where no hit))."""
    s = state.table.shape[1] // 4
    row = _row_of(state, keys)
    rows = state.table[row]
    eq, lane = match_rows(rows, keys, s)
    hit = lane >= 0
    old_vals = torch.where(hit[:, None], pick_kv(rows, eq, s)[1], INVALID_I32)
    clear_keys(state.table, row, lane.clamp(min=0).to(torch.int64), s, hit)
    return state, hit, old_vals


register_index(
    IndexKind.STATIC,
    IndexOps(
        init=init,
        get_batch=get_batch,
        insert_batch=insert_batch,
        delete_batch=delete_batch,
        num_slots=num_slots,
        set_values=linear.set_values,
        scan=linear.scan,
        get_values=get_values,
    ),
)
