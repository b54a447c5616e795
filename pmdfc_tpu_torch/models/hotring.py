"""HotRing — the hotspot-aware index (twin of `pmdfc_tpu/models/hotring.py`).

Reference: `server/hotring/` (FAST'20): per-bucket rings whose head moves
to the hottest item (`hotring.c:560-600`), split in two by tag halves on
rehash (`:493+`). As in the JAX package the three mechanisms are:

1. access counters `counters[C, S]`, bumped by the KV's counting GET
   through `touch` (repeated slots in one batch all count);
2. the hot-point shift `hotspot_shift`: a per-bucket HOT MIRROR
   `hot[C, 4*HS]` of the bucket's HS hottest occupants, heat-ordered;
   GET probes it first and falls through to the bucket row on a miss.
   `decay` halves the counters and shifts; every mutation of a bucket
   invalidates its mirror row, so a stale mirror never answers;
3. the tag-half `rehash`, doubling the bucket array (standalone growth).

A full bucket evicts its COLDEST unprotected occupant. Counters are u32
words stored as int32 bits: the sorts compare them widened (unsigned),
and `decay` shifts the widened word (a counter at or above 2^31 shifts in
no sign bit). In place, but for `rehash`, which returns a new state.
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
    plan_insert,
    plan_rank,
    register_index,
)
from pmdfc_tpu_torch.models.rowops import (
    add_lane_bits,
    clear_keys,
    empty_table,
    free_lanes,
    lane_bit,
    match_rows,
    pick_kv,
    place_free_phase,
    scatter_entry,
    write_values,
)
from pmdfc_tpu_torch.utils.hashing import hash_u64
from pmdfc_tpu_torch.utils.keys import INVALID_I32, is_invalid
from pmdfc_tpu_torch.utils.u32 import M32, narrow, widen


@dataclasses.dataclass
class HotRingState:
    table: torch.Tensor     # int32[C, 4*S] u32 bits: authoritative rows
    counters: torch.Tensor  # int32[C, S] u32 bits: per-lane access counts
    hot: torch.Tensor       # int32[C, 4*HS] u32 bits: heat-ordered mirror
    hot_lane: torch.Tensor  # int32[C, HS] main-table lane of each hot entry


def _num_rows(config: IndexConfig) -> int:
    return linear._num_clusters(config)


def num_slots(config: IndexConfig) -> int:
    return _num_rows(config) * config.cluster_slots


def _empty_hot(c: int, hs: int, device):
    return (empty_table(c, hs, device),
            torch.full((c, hs), -1, dtype=torch.int32, device=device))


def init(config: IndexConfig, device="cuda") -> HotRingState:
    c, s = _num_rows(config), config.cluster_slots
    hot, hot_lane = _empty_hot(c, min(config.hot_lanes, s), device)
    return HotRingState(
        table=empty_table(c, s, device),
        counters=torch.zeros((c, s), dtype=torch.int32, device=device),
        hot=hot, hot_lane=hot_lane)


def _row_of(state: HotRingState, keys: torch.Tensor) -> torch.Tensor:
    return linear.cluster_of(keys, state.table.shape[0])


def _clear_hot_rows(state: HotRingState, rows: torch.Tensor,
                    mask: torch.Tensor) -> None:
    """Invalidate the hot mirror of every mutated bucket, in place
    (row-granular; the next shift repopulates)."""
    hs = state.hot_lane.shape[1]
    r = rows[mask]
    state.hot[r, :2 * hs] = INVALID_I32
    state.hot[r, 2 * hs:] = 0
    state.hot_lane[r] = -1


def _two_phase_probe(state: HotRingState, keys: torch.Tensor):
    """Hot mirror first, the bucket row on a mirror miss (a mirror hit
    gathers dump row 0 instead) -> (row, hit_h, j_h, lane_f, found,
    values)."""
    s = state.table.shape[1] // 4
    hs = state.hot.shape[1] // 4
    row = _row_of(state, keys)
    hrows = state.hot[row]
    eq_h, j_h = match_rows(hrows, keys, hs)
    hit_h = j_h >= 0
    rows = state.table[torch.where(hit_h, 0, row)]
    mk = torch.where(hit_h[:, None], INVALID_I32, keys)
    eq_f, lane_f = match_rows(rows, mk, s)
    found = hit_h | (lane_f >= 0)
    values = torch.where(hit_h[:, None], pick_kv(hrows, eq_h, hs)[1],
                         pick_kv(rows, eq_f, s)[1])
    return row, hit_h, j_h, lane_f, found, values


def get_batch(state: HotRingState, keys: torch.Tensor) -> GetResult:
    """Two-phase probe with slot bookkeeping (the counting path)."""
    s = state.table.shape[1] // 4
    row, hit_h, j_h, lane_f, found, values = _two_phase_probe(state, keys)
    j = j_h.clamp(min=0).to(torch.int64)
    main_lane = torch.where(hit_h, state.hot_lane[row, j], lane_f)
    gslot = torch.where(found, row * s + main_lane.clamp(min=0), -1)
    return GetResult(values=values, found=found, slots=gslot.to(torch.int32))


def get_values(state: HotRingState, keys: torch.Tensor):
    """Lean GET: (values[B, 2] zero on miss, found[B]); no slot math, no
    counter bump (the sampled path, `IndexConfig.touch_sample_every`)."""
    _, _, _, _, found, values = _two_phase_probe(state, keys)
    return values, found


def probe_hot(state: HotRingState, keys: torch.Tensor) -> torch.Tensor:
    """bool[B]: the key resolves from the hot mirror alone."""
    hs = state.hot.shape[1] // 4
    _, j = match_rows(state.hot[_row_of(state, keys)], keys, hs)
    return j >= 0


def touch(state: HotRingState, slots: torch.Tensor) -> HotRingState:
    """Bump the access counters of hit slots (slot -1 ⇒ none), in place;
    a slot repeated in the batch counts each time (`index_add_`, integer
    adds wrapping mod 2^32 as u32 words do)."""
    ok = slots >= 0
    flat = state.counters.view(-1)
    flat.index_add_(0, torch.where(ok, slots, 0).to(torch.int64),
                    ok.to(torch.int32))
    return state


def _u32_argsort(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of int64 u32 values along the last axis (the
    JAX `jnp.argsort`, stable by default)."""
    return torch.argsort(key, dim=-1, stable=True)


def hotspot_shift(state: HotRingState) -> HotRingState:
    """Rebuild the hot mirror, in place: per bucket, the HS hottest
    occupants in heat order (an untouched occupant still outranks a free
    lane: its key is capped at 0xFFFFFFFE)."""
    s = state.table.shape[1] // 4
    hs = state.hot_lane.shape[1]
    t = state.table
    occ = ~free_lanes(t, s)
    sort_key = torch.where(occ, (widen(state.counters) ^ M32).clamp(
        max=0xFFFFFFFE), M32)
    top = _u32_argsort(sort_key)[:, :hs]
    picked = torch.gather(occ, 1, top)

    def grab(lo, fill):
        return torch.where(picked, torch.gather(t[:, lo:lo + s], 1, top), fill)

    state.hot.copy_(torch.cat([grab(0, INVALID_I32), grab(s, INVALID_I32),
                               grab(2 * s, 0), grab(3 * s, 0)], dim=1))
    state.hot_lane.copy_(torch.where(picked, top.to(torch.int32), -1))
    return state


def decay(state: HotRingState) -> HotRingState:
    """Periodic maintenance, in place: halve the counters (as u32 words)
    and run the hot-point shift."""
    state.counters.copy_(narrow(widen(state.counters) >> 1))
    return hotspot_shift(state)


def rehash(state: HotRingState) -> HotRingState:
    """Tag-half split -> a NEW state with twice the buckets: every entry
    moves to `h & (2C-1)`, each old ring splitting by the next hash bit
    (standalone growth, as in the JAX package: a KV's pool stays sized
    for its config)."""
    c = state.table.shape[0]
    s = state.table.shape[1] // 4
    hs = state.hot_lane.shape[1]
    t = state.table
    khi, klo = t[:, 0:s], t[:, s:2 * s]
    occ = ~free_lanes(t, s)
    goes_high = occ & ((hash_u64(khi, klo) & c) != 0)  # the new (tag) bit
    low_keep = occ & ~goes_high

    def half(keep):
        return torch.cat([torch.where(keep, khi, INVALID_I32),
                          torch.where(keep, klo, INVALID_I32),
                          torch.where(keep, t[:, 2 * s:3 * s], 0),
                          torch.where(keep, t[:, 3 * s:], 0)], dim=1)

    hot, hot_lane = _empty_hot(2 * c, hs, t.device)
    return hotspot_shift(HotRingState(
        table=torch.cat([half(low_keep), half(goes_high)]),
        counters=torch.cat([torch.where(low_keep, state.counters, 0),
                            torch.where(goes_high, state.counters, 0)]),
        hot=hot, hot_lane=hot_lane))


def insert_batch(state: HotRingState, keys: torch.Tensor,
                 values: torch.Tensor):
    """In place -> (state, InsertResult): in-place updates, free lanes,
    then the erank-th coldest unprotected occupant of a full bucket."""
    table = state.table
    c, s = table.shape[0], table.shape[1] // 4
    b = keys.shape[0]
    dev = keys.device
    row = _row_of(state, keys)
    plan = plan_insert(keys, row, ~is_invalid(keys), num_segments=c)
    winner = plan.winner
    rows = table[row]
    mk = torch.where(winner[:, None], keys, INVALID_I32)
    _, lane = match_rows(rows, mk, s)
    upd = winner & (lane >= 0)
    l_u = lane.clamp(min=0).to(torch.int64)
    write_values(table, row, l_u, values, s, upd)
    prot = torch.zeros(c, dtype=torch.int64, device=dev)
    add_lane_bits(prot, row, l_u, upd)

    # fresh: a free lane first
    new = winner & ~upd
    can, free_slots = place_free_phase(table, prot, row, keys, values, new, s,
                                       rank=plan_rank(plan, new))
    lane_t = free_slots.clamp(min=0).to(torch.int64) % s

    # overflow: evict the erank-th coldest unprotected occupant (the JAX
    # program skips this block under `lax.cond` when no key is left)
    still = new & ~can
    inv2 = torch.full((b, 2), INVALID_I32, dtype=torch.int32, device=dev)
    evicted, evicted_vals = inv2, inv2.clone()
    place = torch.zeros_like(still)
    lane_e = torch.zeros(b, dtype=torch.int64, device=dev)
    if bool(still.any()):
        rows2 = table[row]
        lanes = torch.arange(s, device=dev)
        cand = ~free_lanes(rows2, s) & ~lane_bit(prot[row][:, None], lanes)
        coldness = torch.where(cand, widen(state.counters[row]), M32)
        order = _u32_argsort(coldness)  # coldest first
        erank = plan_rank(plan, still)
        place = still & (erank < cand.sum(dim=1))
        lane_e = torch.gather(order, 1, erank.clamp(max=s - 1).to(
            torch.int64)[:, None])[:, 0]
        ehot = (lanes[None, :] == lane_e[:, None]) & place[:, None]
        ek, ev = pick_kv(rows2, ehot, s)
        evicted = torch.where(place[:, None], ek, inv2)
        evicted_vals = torch.where(place[:, None], ev, inv2)
        scatter_entry(table, row, lane_e, keys, values, s, place)

    # new entries start cold; evicted heat is discarded
    zero = can | place
    zl = torch.where(can, lane_t, lane_e)
    state.counters[row[zero], zl[zero]] = 0

    slots = torch.where(
        upd, row * s + l_u,
        torch.where(can, row * s + lane_t,
                    torch.where(place, row * s + lane_e, -1)))
    # only ACTUALLY mutated buckets lose their mirror rows
    _clear_hot_rows(state, row, upd | can | place)
    return state, InsertResult(slots=slots.to(torch.int32), evicted=evicted,
                               dropped=still & ~place, fresh=can | place,
                               evicted_vals=evicted_vals)


def delete_batch(state: HotRingState, keys: torch.Tensor):
    """In place -> (state, hit[B], old_vals[B, 2] (INVALID where no hit))."""
    s = state.table.shape[1] // 4
    row = _row_of(state, keys)
    rows = state.table[row]
    eq, lane = match_rows(rows, keys, s)
    hit = lane >= 0
    _clear_hot_rows(state, row, hit)
    old_vals = torch.where(hit[:, None], pick_kv(rows, eq, s)[1], INVALID_I32)
    ln = lane.clamp(min=0).to(torch.int64)
    clear_keys(state.table, row, ln, s, hit)
    state.counters[row[hit], ln[hit]] = 0
    return state, hit, old_vals


def set_values(state: HotRingState, slots: torch.Tensor, values: torch.Tensor):
    """Overwrite value lanes at global slots (slot -1 ⇒ no-op), in place;
    the touched buckets' mirror rows are invalidated."""
    s = state.table.shape[1] // 4
    _clear_hot_rows(state, slots.clamp(min=0).to(torch.int64) // s,
                    slots >= 0)
    return linear.set_values(state, slots, values)


register_index(
    IndexKind.HOTRING,
    IndexOps(
        init=init,
        get_batch=get_batch,
        insert_batch=insert_batch,
        delete_batch=delete_batch,
        num_slots=num_slots,
        set_values=set_values,
        scan=linear.scan,
        get_values=get_values,
        touch=touch,
        decay=decay,
    ),
)
