"""Fixed-size cache with LRU / LFU / FIFO replacement (twin of
`pmdfc_tpu/ops/policy_cache.py`).

Reference: `server/cache-replacement/`, `caches::fixed_sized_cache<K, V,
Policy>` with an eviction callback (`cache.hpp:20-67`). As in the JAX
package: S-lane fused rows with a per-lane u32 policy metric — FIFO the
insertion tick, LRU the last-access tick (a get bumps it), LFU an access
count (a get adds one) — and a full row evicts its min-metric unprotected
lane, reported as (key, value). Standalone: it shares the index rows'
machinery (`models/rowops.py`), not the KV.

In place: `get_batch` and `put_batch` update the state's tensors and
return the same state. The metric and the tick are u32 words as int32
bits; the victim sort compares them widened (unsigned) and stable.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from pmdfc_tpu_torch.kv import resolve_device
from pmdfc_tpu_torch.models.base import batch_rank_by_segment, dedupe_last_wins
from pmdfc_tpu_torch.models.linear import cluster_of
from pmdfc_tpu_torch.models.rowops import (
    add_lane_bits,
    empty_table,
    first_lane,
    free_lanes,
    lane_bit,
    match_rows,
    nth_lane,
    pick_kv,
    scatter_entry,
    write_values,
)
from pmdfc_tpu_torch.utils import u32
from pmdfc_tpu_torch.utils.keys import INVALID_I32, is_invalid


class Policy(str, enum.Enum):
    FIFO = "fifo"
    LRU = "lru"
    LFU = "lfu"


@dataclasses.dataclass
class CacheState:
    table: torch.Tensor   # int32[C, 4*S] u32 bits
    metric: torch.Tensor  # int32[C, S] u32 bits: the policy metric
    tick: torch.Tensor    # int32[] u32 bits: the logical clock
    policy: str = "lru"


def init(capacity: int, policy: Policy | str = Policy.LRU, lanes: int = 32,
         device="cuda") -> CacheState:
    c = max(1, capacity // lanes)
    c = 1 << (c - 1).bit_length() if c & (c - 1) else c
    return CacheState(
        table=empty_table(c, lanes, device),
        metric=torch.zeros((c, lanes), dtype=torch.int32, device=device),
        tick=torch.zeros((), dtype=torch.int32, device=device),
        policy=Policy(policy).value)


def _set_metric(state: CacheState, rows, lanes, mask, value) -> None:
    s = state.metric.shape[1]
    flat = (rows * s + lanes)[mask]
    state.metric.view(-1)[flat] = value


def _next_tick(state: CacheState) -> torch.Tensor:
    return u32.narrow(u32.widen(state.tick) + 1)


def get_batch(state: CacheState, keys: torch.Tensor):
    """In place -> (state, values[B, 2], found[B]); bumps LRU/LFU metrics."""
    s = state.table.shape[1] // 4
    row = cluster_of(keys, state.table.shape[0])
    rows = state.table[row]
    eq, lane = match_rows(rows, keys, s)
    found = lane >= 0
    lane = lane.clamp(min=0).to(torch.int64)
    if state.policy == Policy.LRU.value:
        tick = _next_tick(state)
        _set_metric(state, row, lane, found, tick)
        state.tick.copy_(tick)
    elif state.policy == Policy.LFU.value:
        # a key repeated in the batch counts each time
        state.metric.view(-1).index_add_(
            0, torch.where(found, row * s + lane, 0), found.to(torch.int32))
    return state, pick_kv(rows, eq, s)[1], found


def put_batch(state: CacheState, keys: torch.Tensor, values: torch.Tensor):
    """In place -> (state, evicted_keys[B, 2], evicted_vals[B, 2]) — the
    eviction callback as data (INVALID where nothing was evicted)."""
    table = state.table
    c, s = table.shape[0], table.shape[1] // 4
    b = keys.shape[0]
    dev = keys.device
    winner = dedupe_last_wins(keys, ~is_invalid(keys))
    row = cluster_of(keys, c)
    rows = table[row]
    mk = torch.where(winner[:, None], keys, INVALID_I32)
    _, lane = match_rows(rows, mk, s)
    upd = winner & (lane >= 0)
    tick = _next_tick(state)
    # FIFO/LRU: the insertion/access tick; LFU: a count starting at 1
    fresh = 1 if state.policy == Policy.LFU.value else tick
    l_u = lane.clamp(min=0).to(torch.int64)
    write_values(table, row, l_u, values, s, upd)
    _set_metric(state, row, l_u, upd, fresh)
    prot = torch.zeros(c, dtype=torch.int64, device=dev)
    add_lane_bits(prot, row, l_u, upd)

    # free lanes first
    new = winner & ~upd
    rank = batch_rank_by_segment(row, new)
    free = free_lanes(rows, s)
    can = new & (rank < free.sum(dim=1))
    lane_f = first_lane(nth_lane(free, rank))
    scatter_entry(table, row, lane_f, keys, values, s, can)
    _set_metric(state, row, lane_f, can, fresh)
    add_lane_bits(prot, row, lane_f, can)

    # then the min-metric unprotected lane (stable over u32 metrics)
    still = new & ~can
    rows2 = table[row]
    lanes = torch.arange(s, device=dev)
    cand = ~free_lanes(rows2, s) & ~lane_bit(prot[row][:, None], lanes)
    score = torch.where(cand, u32.widen(state.metric[row]), u32.M32)
    order = torch.argsort(score, dim=1, stable=True)
    erank = batch_rank_by_segment(row, still)
    place = still & (erank < cand.sum(dim=1))
    lane_e = torch.gather(order, 1, erank.clamp(max=s - 1).to(
        torch.int64)[:, None])[:, 0]
    ehot = (lanes[None, :] == lane_e[:, None]) & place[:, None]
    ek, ev = pick_kv(rows2, ehot, s)
    evicted = torch.where(place[:, None], ek, INVALID_I32)
    evicted_vals = torch.where(place[:, None], ev, INVALID_I32)
    scatter_entry(table, row, lane_e, keys, values, s, place)
    _set_metric(state, row, lane_e, place, fresh)
    state.tick.copy_(tick)
    return state, evicted, evicted_vals


class PolicyCache:
    """Host-facing fixed-size cache (the `caches::fixed_sized_cache`
    shape): numpy uint32 words in and out. `device` defaults to `cuda`
    and raises without a GPU; pass `device="cpu"` to run on the CPU."""

    def __init__(self, capacity: int, policy: Policy | str = Policy.LRU,
                 on_evict=None, device="cuda"):
        self.device = resolve_device(device)
        self.state = init(capacity, policy, device=self.device)
        self.on_evict = on_evict

    def _words(self, x) -> torch.Tensor:
        return u32.from_numpy(np.asarray(x, np.uint32).reshape(-1, 2),
                              self.device)

    def put(self, keys, values) -> None:
        self.state, ek, ev = put_batch(self.state, self._words(keys),
                                       self._words(values))
        if self.on_evict is not None:
            live = ~is_invalid(ek)
            for k, v in zip(u32.to_numpy(ek[live]), u32.to_numpy(ev[live])):
                self.on_evict(tuple(k), tuple(v))

    def get(self, keys):
        self.state, vals, found = get_batch(self.state, self._words(keys))
        return u32.to_numpy(vals), found.cpu().numpy()
