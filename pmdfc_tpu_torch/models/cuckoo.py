"""Cuckoo hash — two-choice buckets with batched kick rounds (twin of
`pmdfc_tpu/models/cuckoo.py`).

Reference: `server/src/cuckoo_hash.{h,cpp}`, 2-hash cuckoo with path
search and resize. As in the JAX package: each hash picks one S-lane
fused row; unplaced keys displace one victim per bucket-2 row per round
(at most `max_kicks` rounds in all), the victim carried in the batch lane
and retried against both its buckets; a protection bitmask keeps a kick
off every entry this batch placed; after the last round a carried victim
is EVICTED and an unplaced original DROPPED (clean-cache, no resize).

Round 1 runs at full width; its survivors compact to a W-lane buffer
(W = max(1024, B/8)) for the kick rounds, or stay at full width when
they overflow it. The JAX program decides that and each further round
under `lax.cond`/`lax.while_loop`; here one host read per decision
decides it the same way. Both widths give the same results, but kick
rounds at the full width of a 2^16-key insert cost an H100 about 15 ms
more device time (PERF.md §6), so the narrow width stays. In place: the
table is written where it lies.
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
    compact_mask,
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

ALT_SEED = 0xC0C0C0C0  # second hash family


@dataclasses.dataclass
class CuckooState:
    table: torch.Tensor  # int32[C, 4*S] u32 bits, fused rows
    max_kicks: int = 8   # static: the placement rounds' total budget


def _num_rows(config: IndexConfig) -> int:
    c = max(2, config.capacity // config.cluster_slots)
    return 1 << (c - 1).bit_length() if c & (c - 1) else c


def num_slots(config: IndexConfig) -> int:
    return _num_rows(config) * config.cluster_slots


def init(config: IndexConfig, device="cuda") -> CuckooState:
    return CuckooState(table=empty_table(_num_rows(config),
                                         config.cluster_slots, device),
                       max_kicks=config.max_cuckoo_kicks)


def rows_of(c: int, keys: torch.Tensor, alt_seed: int = ALT_SEED):
    """(r1, r2) int64: the key's two candidate rows."""
    r1 = hash_u64(keys[..., 0], keys[..., 1]) & (c - 1)
    r2 = hash_u64(keys[..., 0], keys[..., 1], seed=alt_seed) & (c - 1)
    return r1, r2


def match2(table: torch.Tensor, keys: torch.Tensor, alt_seed: int = ALT_SEED):
    """Probe both rows, row 1 first -> (row, lane int32 or -1, hit,
    rows_at_hit[B, 4S], eq_at_hit[B, S])."""
    s = table.shape[1] // 4
    r1, r2 = rows_of(table.shape[0], keys, alt_seed)
    rows1, rows2 = table[r1], table[r2]
    eq1, l1 = match_rows(rows1, keys, s)
    eq2, l2 = match_rows(rows2, keys, s)
    in1 = l1 >= 0
    return (torch.where(in1, r1, r2), torch.where(in1, l1, l2),
            in1 | (l2 >= 0), torch.where(in1[:, None], rows1, rows2),
            torch.where(in1[:, None], eq1, eq2))


def get_batch(state: CuckooState, keys: torch.Tensor) -> GetResult:
    s = state.table.shape[1] // 4
    row, lane, found, rows, eq = match2(state.table, keys)
    gslot = torch.where(found, row * s + lane.clamp(min=0), -1)
    return GetResult(values=pick_kv(rows, eq, s)[1], found=found,
                     slots=gslot.to(torch.int32))


def get_values(state: CuckooState, keys: torch.Tensor):
    """Lean GET: a key lives in exactly one of its two windows."""
    s = state.table.shape[1] // 4
    r1, r2 = rows_of(state.table.shape[0], keys)
    return lean_two_window(state.table, r1, r2, keys, s)


def _kick(table, prot, cr2, ckeys, cvals, active, is_orig, slots, fresh, s):
    """One kick phase: the rank-0 active key of each bucket-2 row
    displaces the row's first unprotected occupant, in place, and carries
    it on -> (ckeys, cvals, is_orig, slots, fresh)."""
    w = ckeys.shape[0]
    rows2k = table[cr2]
    lanes = torch.arange(s, device=cr2.device)
    cand = ~free_lanes(rows2k, s) & ~lane_bit(prot[cr2][:, None], lanes)
    krank = batch_rank_by_segment(cr2, active)
    kick = active & (krank == 0) & cand.any(dim=1)
    hot = nth_lane(cand, torch.zeros(w, dtype=torch.int64,
                                     device=cr2.device)) & kick[:, None]
    klane = first_lane(hot)
    vk, vv = pick_kv(rows2k, hot, s)
    scatter_entry(table, cr2, klane, ckeys, cvals, s, kick)
    add_lane_bits(prot, cr2, klane, kick)
    slots = torch.where(kick & is_orig, (cr2 * s + klane).to(torch.int32),
                        slots)
    fresh = fresh | (kick & is_orig)
    # the victim becomes the carried key at this position
    return (torch.where(kick[:, None], vk, ckeys),
            torch.where(kick[:, None], vv, cvals), is_orig & ~kick, slots,
            fresh)


def _run_rounds(table, prot, ckeys, cvals, active, slots, rnd, max_kicks):
    """Placement rounds at the width of `ckeys` while anything is active
    and `rnd < max_kicks` -> (slots, fresh, evicted, evicted_vals,
    dropped). Each round: a free-lane phase in each bucket, then (if
    anything is left) a kick."""
    c, s = table.shape[0], table.shape[1] // 4
    w = ckeys.shape[0]
    is_orig = torch.ones(w, dtype=torch.bool, device=ckeys.device)
    fresh = torch.zeros_like(is_orig)
    while rnd < max_kicks and bool(active.any()):
        cr1, cr2 = rows_of(c, ckeys)
        pl1, sl1 = place_free_phase(table, prot, cr1, ckeys, cvals, active, s)
        active = active & ~pl1
        pl2, sl2 = place_free_phase(table, prot, cr2, ckeys, cvals, active, s)
        active = active & ~pl2
        placed = (pl1 | pl2) & is_orig
        slots = torch.where(placed, torch.where(pl1, sl1, sl2), slots)
        fresh = fresh | placed
        if bool(active.any()):  # kicked positions stay active
            ckeys, cvals, is_orig, slots, fresh = _kick(
                table, prot, cr2, ckeys, cvals, active, is_orig, slots,
                fresh, s)
        rnd += 1
    # budget exhausted: carried victims are evicted; originals dropped
    lost_victim = (active & ~is_orig)[:, None]
    evicted = torch.where(lost_victim, ckeys, INVALID_I32)
    evicted_vals = torch.where(lost_victim, cvals, INVALID_I32)
    return slots, fresh, evicted, evicted_vals, active & is_orig


def _scatter_back(idx, mask, vals, fill, b):
    """[b, ...] buffer of `fill` with `vals[i]` at `idx[i]` where mask
    (the JAX `.at[where(mask, idx, b)].set(vals, mode="drop")`)."""
    out = torch.full((b + 1, *vals.shape[1:]), fill, dtype=vals.dtype,
                     device=vals.device)
    out[torch.where(mask, idx, b)] = vals
    return out[:b]


def insert_batch(state: CuckooState, keys: torch.Tensor, values: torch.Tensor):
    """In place -> (state, InsertResult)."""
    table = state.table
    c, s = table.shape[0], table.shape[1] // 4
    b = keys.shape[0]
    winner = dedupe_last_wins(keys, ~is_invalid(keys))

    # update-in-place resolves before any displacement
    mk = torch.where(winner[:, None], keys, INVALID_I32)
    u_row, u_lane, u_hit, _, _ = match2(table, mk)
    upd = winner & u_hit
    u_lane = u_lane.clamp(min=0).to(torch.int64)
    write_values(table, u_row, u_lane, values, s, upd)
    slots = torch.where(upd, (u_row * s + u_lane).to(torch.int32), -1)
    # protect updated entries from same-batch kicks
    prot = torch.zeros(c, dtype=torch.int64, device=keys.device)
    add_lane_bits(prot, u_row, u_lane, upd)

    # round 1 at full width: one free-lane phase per bucket
    start = winner & ~upd
    cr1, cr2 = rows_of(c, keys)
    pl1, sl1 = place_free_phase(table, prot, cr1, keys, values, start, s)
    act = start & ~pl1
    pl2, sl2 = place_free_phase(table, prot, cr2, keys, values, act, s)
    act = act & ~pl2
    fresh1 = (pl1 | pl2) & start
    slots = torch.where(fresh1, torch.where(pl1, sl1, sl2), slots)

    # the kick rounds, on the survivors compacted to W lanes unless they
    # overflow it; the hoisted round 1 counts against the budget (rnd=1)
    w = min(b, max(1024, b // 8))
    idx, in_w, safe, overflow = compact_mask(act, w)
    if w < b and not bool(overflow.any()):
        ckeys = torch.where(in_w[:, None], keys[safe], INVALID_I32)
        cvals = torch.where(in_w[:, None], values[safe], 0)
        slots_w, fresh_w, ev_w, evv_w, drop_w = _run_rounds(
            table, prot, ckeys, cvals, in_w,
            torch.full((w,), -1, dtype=torch.int32, device=keys.device), 1,
            state.max_kicks)
        e_w = ~is_invalid(ev_w)
        slots2 = _scatter_back(idx, fresh_w, slots_w, -1, b)
        fresh2 = _scatter_back(idx, fresh_w, fresh_w, False, b)
        evicted = _scatter_back(idx, e_w, ev_w, INVALID_I32, b)
        evicted_vals = _scatter_back(idx, e_w, evv_w, INVALID_I32, b)
        dropped = _scatter_back(idx, drop_w, drop_w, False, b)
    else:
        slots2, fresh2, evicted, evicted_vals, dropped = _run_rounds(
            table, prot, keys, values, act,
            torch.full((b,), -1, dtype=torch.int32, device=keys.device), 1,
            state.max_kicks)
    return state, InsertResult(
        slots=torch.where(fresh2, slots2, slots), evicted=evicted,
        dropped=dropped, fresh=fresh1 | fresh2, evicted_vals=evicted_vals)


def delete_batch(state: CuckooState, keys: torch.Tensor):
    """In place -> (state, hit[B], old_vals[B, 2] (INVALID where no hit))."""
    s = state.table.shape[1] // 4
    row, lane, hit, rows, eq = match2(state.table, keys)
    old_vals = torch.where(hit[:, None], pick_kv(rows, eq, s)[1], INVALID_I32)
    clear_keys(state.table, row, lane.clamp(min=0).to(torch.int64), s, hit)
    return state, hit, old_vals


register_index(
    IndexKind.CUCKOO,
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
