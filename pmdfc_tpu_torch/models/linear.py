"""Linear-probing index with FIFO cluster eviction — the default index
(twin of `pmdfc_tpu/models/linear.py`).

Reference: `server/src/linear_probing.{h,cpp}`: when a cluster is full
the oldest entry is FIFO-evicted and returned (clean-cache semantics).

Layout as in the JAX package: one cluster is ONE `int32[4*S]` row of u32
bits `[khi | klo | vhi | vlo]`; a per-cluster monotone cursor `head[C]`
places fresh inserts at `(head + rank) % S`, with same-cluster conflicts
inside a batch ranked by one sort (`plan_insert`/`plan_rank`).

In place. `insert_batch_element`, `delete_batch` and `set_values` write
`state.table`/`state.head` in place and return the same state object
(a full-size table is 32 MiB and is never copied per batch). The JAX
versions' `mode="drop"` scatters (an out-of-range index meaning "no
write") become writes masked to the rows that do write; `head.at[].add`
with repeated clusters becomes `index_put_(accumulate=True)`.
"""

from __future__ import annotations

import dataclasses

import torch

from pmdfc_tpu_torch.config import IndexConfig, IndexKind
from pmdfc_tpu_torch.models.base import (
    GetResult,
    IndexOps,
    InsertResult,
    plan_insert,
    plan_rank,
    register_index,
)
from pmdfc_tpu_torch.models.rowops import lane_pick, match_mask, match_rows
from pmdfc_tpu_torch.utils.hashing import hash_u64
from pmdfc_tpu_torch.utils.keys import INVALID_I32, is_invalid
from pmdfc_tpu_torch.utils.u32 import narrow, widen


@dataclasses.dataclass
class LinearState:
    table: torch.Tensor  # int32[C, 4*S] u32 bits: lane groups [khi | klo | vhi | vlo]
    head: torch.Tensor   # int32[C] u32 bits: monotone FIFO cursor


def _num_clusters(config: IndexConfig) -> int:
    c = max(1, config.capacity // config.cluster_slots)
    # power of two so bucket selection is a mask, not a modulo
    return 1 << (c - 1).bit_length() if c & (c - 1) else c


def num_slots(config: IndexConfig) -> int:
    return _num_clusters(config) * config.cluster_slots


def init(config: IndexConfig, device="cuda") -> LinearState:
    c, s = _num_clusters(config), config.cluster_slots
    table = torch.zeros((c, 4 * s), dtype=torch.int32, device=device)
    table[:, :2 * s] = INVALID_I32  # khi | klo empty; vhi | vlo zero
    return LinearState(table=table,
                       head=torch.zeros(c, dtype=torch.int32, device=device))


def cluster_of(keys: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """int64[B] cluster of each key: murmur3 hash masked to the cluster count."""
    return hash_u64(keys[..., 0], keys[..., 1]) & (num_clusters - 1)


def _values(rows, eq, s):
    return torch.stack([lane_pick(rows, eq, 2 * s, s),
                        lane_pick(rows, eq, 3 * s, s)], dim=-1)


def get_batch(state: LinearState, keys: torch.Tensor) -> GetResult:
    s = state.table.shape[1] // 4
    c = cluster_of(keys, state.table.shape[0])
    rows = state.table[c]  # [B, 4S] — the one gather
    eq, slot = match_rows(rows, keys, s)
    found = slot >= 0
    gslot = torch.where(found, (c * s + slot.clamp(min=0)).to(torch.int32), -1)
    return GetResult(values=_values(rows, eq, s), found=found, slots=gslot)


def get_values(state: LinearState, keys: torch.Tensor):
    """Lean GET: (values[B, 2] zero on miss, found[B]), no slot math."""
    s = state.table.shape[1] // 4
    rows = state.table[cluster_of(keys, state.table.shape[0])]
    eq = match_mask(rows, keys, s)
    return _values(rows, eq, s), eq.any(dim=1)


def _insert_plan(state: LinearState, keys: torch.Tensor):
    """Insert prologue: batch plan, update-vs-fresh split, FIFO target
    lanes, drops, and the evicted pair read from the ORIGINAL row.

    Returns (c, s, plan, upd, ins, drop, mslot, pos, evicted, evicted_vals).
    """
    c_count = state.table.shape[0]
    s = state.table.shape[1] // 4
    valid = ~is_invalid(keys)
    c = cluster_of(keys, c_count)
    plan = plan_insert(keys, c, valid, num_segments=c_count)  # one sort
    rows = state.table[c]
    _, mslot = match_rows(rows, keys, s)
    upd = plan.winner & (mslot >= 0)
    new = plan.winner & (mslot < 0)

    # fresh inserts: unique (cluster, rank) targets via segment ranking
    rank = plan_rank(plan, new)
    drop = new & (rank >= s)
    ins = new & ~drop
    pos = (widen(state.head[c]) + rank.to(torch.int64)) & (s - 1)
    pos_hot = (torch.arange(s, device=keys.device)[None, :] == pos[:, None]) \
        & ins[:, None]
    old = torch.stack([lane_pick(rows, pos_hot, 0, s),
                       lane_pick(rows, pos_hot, s, s)], dim=-1)
    old_v = _values(rows, pos_hot, s)
    evicted_mask = (ins & ~is_invalid(old))[:, None]
    evicted = torch.where(evicted_mask, old, INVALID_I32)
    evicted_vals = torch.where(evicted_mask, old_v, INVALID_I32)
    return c, s, plan, upd, ins, drop, mslot, pos, evicted, evicted_vals


def insert_batch_element(state: LinearState, keys: torch.Tensor,
                         values: torch.Tensor):
    """Batched insert by lane scatters, in place; -> (state, InsertResult).
    Updates land first so a same-slot (update, evicting-insert) pair
    resolves in the insert's favor."""
    (c, s, plan, upd, ins, drop, mslot, pos, evicted,
     evicted_vals) = _insert_plan(state, keys)
    table = state.table
    su = mslot.clamp(min=0).to(torch.int64)
    vhi, vlo = values[:, 0], values[:, 1]

    cu, lu = c[upd], su[upd]
    table[cu, 2 * s + lu] = vhi[upd]
    table[cu, 3 * s + lu] = vlo[upd]
    ci, li = c[ins], pos[ins]
    table[ci, li] = keys[ins, 0]
    table[ci, s + li] = keys[ins, 1]
    table[ci, 2 * s + li] = vhi[ins]
    table[ci, 3 * s + li] = vlo[ins]
    head = widen(state.head)
    head.index_put_((ci,), torch.ones_like(ci), accumulate=True)
    state.head.copy_(narrow(head))

    gslot = torch.where(upd, c * s + su,
                        torch.where(ins, c * s + pos, -1)).to(torch.int32)
    return state, InsertResult(slots=gslot, evicted=evicted, dropped=drop,
                               fresh=ins, evicted_vals=evicted_vals)


insert_batch = insert_batch_element


def delete_batch(state: LinearState, keys: torch.Tensor):
    """In place; -> (state, hit[B], old_vals[B, 2] (INVALID where no hit))."""
    s = state.table.shape[1] // 4
    c = cluster_of(keys, state.table.shape[0])
    rows = state.table[c]
    eq, slot = match_rows(rows, keys, s)
    hit = slot >= 0
    old_vals = torch.where(hit[:, None], _values(rows, eq, s), INVALID_I32)
    cd, sd = c[hit], slot[hit].to(torch.int64)
    state.table[cd, sd] = INVALID_I32
    state.table[cd, s + sd] = INVALID_I32
    return state, hit, old_vals


def set_values(state: LinearState, slots: torch.Tensor, values: torch.Tensor):
    """Overwrite value lanes at global slots (slot -1 ⇒ no-op), in place."""
    s = state.table.shape[1] // 4
    ok = slots >= 0
    sl = slots[ok].to(torch.int64)
    c, lane = sl // s, sl % s
    state.table[c, 2 * s + lane] = values[ok, 0]
    state.table[c, 3 * s + lane] = values[ok, 1]
    return state


def scan(state: LinearState):
    """(flat_keys[N, 2], flat_vals[N, 2]) view of every slot."""
    s = state.table.shape[1] // 4
    t = state.table
    keys = torch.stack([t[:, 0:s].reshape(-1), t[:, s:2 * s].reshape(-1)], -1)
    vals = torch.stack([t[:, 2 * s:3 * s].reshape(-1),
                        t[:, 3 * s:4 * s].reshape(-1)], -1)
    return keys, vals


register_index(
    IndexKind.LINEAR,
    IndexOps(
        init=init,
        get_batch=get_batch,
        insert_batch=insert_batch,
        delete_batch=delete_batch,
        num_slots=num_slots,
        set_values=set_values,
        scan=scan,
        get_values=get_values,
    ),
)
