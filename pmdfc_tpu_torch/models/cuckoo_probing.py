"""Cuckoo-probing (CCP) — linear-probing clusters with a second-chance
cuckoo hop (twin of `pmdfc_tpu/models/cuckoo_probing.py`).

Reference: `server/src/cuckoo_probing.{h,cpp}`: a cluster's FIFO victim
is re-homed once to its second hash cluster and tagged; a victim that is
already tagged is evicted for real. As in the JAX package the tag is a
per-cluster u32 lane bitmask `cuckooed[C]` (value words stay full width),
fresh keys take linear's FIFO lanes, and one relocation phase re-homes
the untagged victims into free lanes of their second cluster. GET and
DELETE probe both clusters.

In place: table, FIFO cursor and tag plane are written where they lie.
The tag words are int32 bits; their lane masks are built in int64 (lane
31's bit is the int32 sign bit) and narrowed back.
"""

from __future__ import annotations

import dataclasses

import torch

from pmdfc_tpu_torch.config import IndexConfig, IndexKind
from pmdfc_tpu_torch.models import cuckoo, linear
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
    lean_two_window,
    nth_lane,
    pick_kv,
    scatter_entry,
    write_values,
)
from pmdfc_tpu_torch.utils.keys import INVALID_I32, is_invalid
from pmdfc_tpu_torch.utils.u32 import narrow, widen

ALT_SEED = 0xCC9CC9CC


@dataclasses.dataclass
class CCPState:
    table: torch.Tensor     # int32[C, 4*S] u32 bits
    head: torch.Tensor      # int32[C] u32 bits: FIFO cursor (cluster 1)
    cuckooed: torch.Tensor  # int32[C] u32 bits: lane lives in its 2nd cluster


num_slots = cuckoo.num_slots


def init(config: IndexConfig, device="cuda") -> CCPState:
    c = cuckoo._num_rows(config)
    zeros = torch.zeros(c, dtype=torch.int32, device=device)
    return CCPState(table=empty_table(c, config.cluster_slots, device),
                    head=zeros, cuckooed=zeros.clone())


def _match2(state: CCPState, keys: torch.Tensor):
    return cuckoo.match2(state.table, keys, ALT_SEED)


def get_batch(state: CCPState, keys: torch.Tensor) -> GetResult:
    s = state.table.shape[1] // 4
    row, lane, found, rows, eq = _match2(state, keys)
    gslot = torch.where(found, row * s + lane.clamp(min=0), -1)
    return GetResult(values=pick_kv(rows, eq, s)[1], found=found,
                     slots=gslot.to(torch.int32))


def get_values(state: CCPState, keys: torch.Tensor):
    """Lean GET over both clusters (a key occupies one lane across them)."""
    s = state.table.shape[1] // 4
    r1, r2 = cuckoo.rows_of(state.table.shape[0], keys, ALT_SEED)
    return lean_two_window(state.table, r1, r2, keys, s)


def _clear_tags(state: CCPState, rows, lanes, mask) -> None:
    """Clear the tag bits of (row, lane) where mask, in place."""
    acc = torch.zeros(state.cuckooed.shape[0], dtype=torch.int64,
                      device=rows.device)
    add_lane_bits(acc, rows, lanes, mask)
    state.cuckooed.copy_(narrow(widen(state.cuckooed) & ~acc))


def insert_batch(state: CCPState, keys: torch.Tensor, values: torch.Tensor):
    """In place -> (state, InsertResult)."""
    table = state.table
    c, s = table.shape[0], table.shape[1] // 4
    b = keys.shape[0]
    winner = dedupe_last_wins(keys, ~is_invalid(keys))
    r1, _ = cuckoo.rows_of(c, keys, ALT_SEED)

    # update in place (either cluster)
    mk = torch.where(winner[:, None], keys, INVALID_I32)
    u_row, u_lane, u_hit, _, _ = _match2(state, mk)
    upd = winner & u_hit
    u_lane = u_lane.clamp(min=0).to(torch.int64)
    write_values(table, u_row, u_lane, values, s, upd)

    # fresh: FIFO lane in cluster 1 (linear's scheme)
    new = winner & ~upd
    rank = batch_rank_by_segment(r1, new)
    drop = new & (rank >= s)
    ins = new & ~drop
    rows1 = table[r1]
    pos = (widen(state.head[r1]) + rank.to(torch.int64)) & (s - 1)
    pos_hot = (torch.arange(s, device=keys.device)[None, :] == pos[:, None]) \
        & ins[:, None]
    vk, vv = pick_kv(rows1, pos_hot, s)
    victim = ins & ~is_invalid(vk)
    # the victim's tag: was it already living its second life?
    victim_tagged = victim & lane_bit(widen(state.cuckooed[r1]), pos)

    scatter_entry(table, r1, pos, keys, values, s, ins)
    head = widen(state.head)
    head.index_add_(0, torch.where(ins, r1, 0), ins.to(torch.int64))
    state.head.copy_(narrow(head))
    _clear_tags(state, r1, pos, ins)  # fresh cluster-1 entries are untagged

    # second chance: untagged victims move to a free lane of THEIR second
    # cluster (the JAX program skips this under `lax.cond` when none does)
    reloc = victim & ~victim_tagged
    vcan = torch.zeros_like(reloc)
    if bool(reloc.any()):
        _, vr2 = cuckoo.rows_of(c, torch.where(reloc[:, None], vk, 0),
                                ALT_SEED)
        rows_v = table[vr2]  # re-gathered: sees this batch's placements
        vrank = batch_rank_by_segment(vr2, reloc)
        freev = free_lanes(rows_v, s)
        vcan = reloc & (vrank < freev.sum(dim=1))
        vlane = first_lane(nth_lane(freev, vrank))
        scatter_entry(table, vr2, vlane, vk, vv, s, vcan)
        acc = torch.zeros(c, dtype=torch.int64, device=keys.device)
        add_lane_bits(acc, vr2, vlane, vcan)
        state.cuckooed.copy_(narrow(widen(state.cuckooed) | acc))

    # true evictions: tagged victims, and victims whose 2nd cluster is full
    ev = (victim_tagged | (reloc & ~vcan))[:, None]
    slots = torch.where(upd, u_row * s + u_lane,
                        torch.where(ins, r1 * s + pos, -1)).to(torch.int32)
    return state, InsertResult(
        slots=slots, evicted=torch.where(ev, vk, INVALID_I32), dropped=drop,
        fresh=ins, evicted_vals=torch.where(ev, vv, INVALID_I32))


def delete_batch(state: CCPState, keys: torch.Tensor):
    """In place -> (state, hit[B], old_vals[B, 2] (INVALID where no hit))."""
    s = state.table.shape[1] // 4
    row, lane, hit, rows, eq = _match2(state, keys)
    lane = lane.clamp(min=0).to(torch.int64)
    old_vals = torch.where(hit[:, None], pick_kv(rows, eq, s)[1], INVALID_I32)
    clear_keys(state.table, row, lane, s, hit)
    # a repeated key clears its tag bit once, not additively
    _clear_tags(state, row, lane, hit & dedupe_last_wins(keys, hit))
    return state, hit, old_vals


register_index(
    IndexKind.CUCKOO_PROBING,
    IndexOps(
        init=init,
        get_batch=get_batch,
        insert_batch=insert_batch,
        delete_batch=delete_batch,
        num_slots=num_slots,
        set_values=linear.set_values,
        scan=linear.scan,
        get_values=get_values,
        rows_per_get=2,  # home + second-chance window
    ),
)
