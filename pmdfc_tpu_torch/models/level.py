"""Level hashing — two-level buckets, four candidate rows per key (twin of
`pmdfc_tpu/models/level.py`).

Reference: `server/src/Level_hashing.{h,cpp}`: a top level of N buckets
over a bottom level of N/2, two hash functions. As in the JAX package
the buckets are S-lane fused rows in ONE table (top rows [0, Ct), bottom
rows [Ct, Ct + Ct/2)), a key's candidates are top[h1], top[h2],
bottom[h1>>1], bottom[h2>>1], an insert runs four rank-deconflicted
free-lane phases in that order, and when all four are full it evicts an
unprotected occupant of bottom[h1>>1] (clean-cache, no resize).

The lean GET probes the two top windows; a top miss takes what the
bottom windows hold (`rowops.lean_miss_tail`). In place.
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
    batch_rank_by_segment,
    dedupe_last_wins,
    register_index,
)
from pmdfc_tpu_torch.models.rowops import (
    add_lane_bits,
    clear_keys,
    empty_table,
    first_lane,
    free_lanes,
    lane_bit,
    lean_miss_tail,
    lean_two_window,
    match_rows,
    nth_lane,
    pick_kv,
    place_free_phase,
    scatter_entry,
    write_values,
)
from pmdfc_tpu_torch.utils.hashing import hash_u64
from pmdfc_tpu_torch.utils.keys import INVALID_I32, is_invalid

ALT_SEED = 0x1E7E11E7


@dataclasses.dataclass
class LevelState:
    # one table: rows [0, Ct) are the top level, [Ct, Ct + Ct//2) the bottom
    table: torch.Tensor  # int32[Ct + Ct//2, 4*S] u32 bits
    top_rows: int = 2    # static: Ct


def _top_rows(config: IndexConfig) -> int:
    # capacity = (Ct + Ct/2) * S  =>  Ct = 2/3 * capacity / S, pow2 >= 2
    c = max(2, (2 * config.capacity) // (3 * config.cluster_slots))
    return 1 << (c - 1).bit_length() if c & (c - 1) else c


def num_slots(config: IndexConfig) -> int:
    ct = _top_rows(config)
    return (ct + ct // 2) * config.cluster_slots


def init(config: IndexConfig, device="cuda") -> LevelState:
    ct = _top_rows(config)
    return LevelState(table=empty_table(ct + ct // 2, config.cluster_slots,
                                        device), top_rows=ct)


def _candidates(state: LevelState, keys: torch.Tensor):
    """The four candidate rows (global row ids, int64) in probe order."""
    ct = state.top_rows
    t1 = hash_u64(keys[..., 0], keys[..., 1]) & (ct - 1)
    t2 = hash_u64(keys[..., 0], keys[..., 1], seed=ALT_SEED) & (ct - 1)
    return t1, t2, ct + (t1 >> 1), ct + (t2 >> 1)


def _match4(state: LevelState, keys: torch.Tensor):
    """Probe all four candidates; the first hit wins -> (row, lane int32
    or -1, hit, rows_at_hit, eq_at_hit)."""
    s = state.table.shape[1] // 4
    b = keys.shape[0]
    dev = keys.device
    row = torch.full((b,), -1, dtype=torch.int64, device=dev)
    lane = torch.full((b,), -1, dtype=torch.int32, device=dev)
    hit = torch.zeros(b, dtype=torch.bool, device=dev)
    rows_sel = torch.zeros((b, 4 * s), dtype=torch.int32, device=dev)
    eq_sel = torch.zeros((b, s), dtype=torch.bool, device=dev)
    for r in _candidates(state, keys):
        rows = state.table[r]
        eq, ln = match_rows(rows, keys, s)
        here = ~hit & (ln >= 0)
        row = torch.where(here, r, row)
        lane = torch.where(here, ln, lane)
        rows_sel = torch.where(here[:, None], rows, rows_sel)
        eq_sel = torch.where(here[:, None], eq, eq_sel)
        hit = hit | here
    return row, lane, hit, rows_sel, eq_sel


def get_batch(state: LevelState, keys: torch.Tensor) -> GetResult:
    s = state.table.shape[1] // 4
    row, lane, found, rows, eq = _match4(state, keys)
    gslot = torch.where(found, row * s + lane.clamp(min=0), -1)
    return GetResult(values=pick_kv(rows, eq, s)[1], found=found,
                     slots=gslot.to(torch.int32))


def get_values(state: LevelState, keys: torch.Tensor):
    """Lean GET: the two top windows; a top miss takes what the bottom
    windows hold (candidate windows can collide: `lean_two_window` masks
    the second when they do)."""
    s = state.table.shape[1] // 4
    t1, t2, b1, b2 = _candidates(state, keys)
    values, found = lean_two_window(state.table, t1, t2, keys, s)

    tail = lean_two_window(state.table, b1, b2, keys, s)
    return lean_miss_tail(~found & ~is_invalid(keys), values, found, *tail)


def insert_batch(state: LevelState, keys: torch.Tensor, values: torch.Tensor):
    """In place -> (state, InsertResult)."""
    table = state.table
    n, s = table.shape[0], table.shape[1] // 4
    b = keys.shape[0]
    dev = keys.device
    winner = dedupe_last_wins(keys, ~is_invalid(keys))

    # update in place
    mk = torch.where(winner[:, None], keys, INVALID_I32)
    u_row, u_lane, u_hit, _, _ = _match4(state, mk)
    upd = winner & u_hit
    u_lane = u_lane.clamp(min=0).to(torch.int64)
    write_values(table, u_row, u_lane, values, s, upd)
    prot = torch.zeros(n, dtype=torch.int64, device=dev)
    add_lane_bits(prot, u_row, u_lane, upd)

    # four free-lane phases in probe order
    active = winner & ~upd
    slots = torch.where(upd, (u_row * s + u_lane).to(torch.int32), -1)
    fresh = torch.zeros(b, dtype=torch.bool, device=dev)
    cands = _candidates(state, keys)
    for r in cands:
        placed, sl = place_free_phase(table, prot, r, keys, values, active, s)
        slots = torch.where(placed, sl, slots)
        fresh = fresh | placed
        active = active & ~placed

    # all four full: displace an unprotected occupant of bottom[h1>>1]
    # (the JAX program skips this block under `lax.cond` when no key is
    # left; so does the host read here)
    b1 = cands[2]
    inv2 = torch.full((b, 2), INVALID_I32, dtype=torch.int32, device=dev)
    evicted, evicted_vals = inv2, inv2.clone()
    place = torch.zeros_like(active)
    if bool(active.any()):
        rows_b = table[b1]
        lanes = torch.arange(s, device=dev)
        cand = ~free_lanes(rows_b, s) & ~lane_bit(prot[b1][:, None], lanes)
        erank = batch_rank_by_segment(b1, active)
        place = active & (erank < cand.sum(dim=1))
        hot = nth_lane(cand, erank) & place[:, None]
        lane_e = first_lane(hot)
        ek, ev = pick_kv(rows_b, hot, s)
        scatter_entry(table, b1, lane_e, keys, values, s, place)
        evicted = torch.where(place[:, None], ek, inv2)
        evicted_vals = torch.where(place[:, None], ev, inv2)
        slots = torch.where(place, (b1 * s + lane_e).to(torch.int32), slots)
    return state, InsertResult(slots=slots, evicted=evicted,
                               dropped=active & ~place, fresh=fresh | place,
                               evicted_vals=evicted_vals)


def delete_batch(state: LevelState, keys: torch.Tensor):
    """In place -> (state, hit[B], old_vals[B, 2] (INVALID where no hit))."""
    s = state.table.shape[1] // 4
    row, lane, hit, rows, eq = _match4(state, keys)
    old_vals = torch.where(hit[:, None], pick_kv(rows, eq, s)[1], INVALID_I32)
    clear_keys(state.table, row, lane.clamp(min=0).to(torch.int64), s, hit)
    return state, hit, old_vals


register_index(
    IndexKind.LEVEL,
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
