"""KV façade — one index + bloom filter + page pool (twin of
`pmdfc_tpu/kv.py`, this slice's part).

Reference: `server/KV.{h,cpp}`: `Insert` updates the counting bloom filter
and turns index evictions into bloom deletes (`KV.cpp:100-127`); `Get`,
`Delete`, `Utilization`, `Capacity`, `PrintStats`.

Batched ops take and return a `KVState`; the stats vector is an int32
device tensor bumped inside the op (`misses == Σ miss_*` on every batch).

In place. Unlike the JAX programs, which return new arrays, `insert`,
`insert_extent` and `delete` update the state's tensors in place and
return the same state: the full-size page pool is 8 GiB and must never be
copied per batch. A GET (`get_core`, `get_compact`, `get_extent`) writes
nothing but `state.stats`.

Extents (ref `KV::InsertExtent`/`GetExtent`, `CCEH::Insert_extent`
`CCEH_hybrid.cpp:90-105`): one record in a ring plus one tagged index
entry per aligned power-of-two cover of the page run. The cover
decomposition is a scalar recursion over one run, so it is computed on
the host in Python integers (u32 arithmetic masked to 32 bits).

Tiered pool (`config.tier`, `tier.py`): page entries are [generation,
row] values over one hot/cold backing array; `entry_current` guards every
site that keeps, frees or overwrites a row, a placement the balloon cannot
serve is stamped NOPAGE (a legal miss, counted as a drop), and a counting
GET runs the migration epilogue `tier.on_get` after the lookup. A `lean`
GET (`IndexConfig.touch_sample_every`) skips the epilogue and writes
nothing but `state.stats`.

The async verbs (`KV.insert_async`, `get_async`, `get_compact_async`,
`get_extent_async`, `delete_async`) return device tensors for the serving
driver (`runtime/server.py`); the blocking verbs are them plus a host
copy.

The one-sided fast path (`FastView`, `directory_entries`). The JAX
package mirrors the pool on the host per mutation sequence and its
server validates and then gathers from that immutable mirror. Here the
pool is updated in place and lives on the card, so a view is a handle on
the live state and serves one locked call, `FastView.read`, that checks
the epoch, compares each lane's stored digest (and, tiered, the row's
liveness) on the device, gathers only the validated rows and copies them
to the host, all under `KV._lock`: no put can land between the check and
the gather. The directory scan likewise digests the live pages on the
device; only keys, rows and digests cross to the host.

Durability (`snapshot`, `attach_journal`, `resume_chain`; the file
format and the chain live in `checkpoint.py`, the write-ahead journal in
`runtime/journal.py`). With a journal attached, `insert_async` (and so
`insert`), `delete_async` (and so `delete`) and `insert_extent` append
their record under the lock BEFORE the device dispatch, so the journal
covers everything the device acknowledges: a numpy caller's rows as they
are, a tensor caller's with one device-to-host copy. `snapshot` runs
under the lock on the KV's device after a synchronize, so every leaf it
copies holds every update queued before it.

The sharded plane (`parallel/shard.py`) runs these same ops once per
shard on each shard's own `KVState`; `insert_extent(shard=...)` and
`_get_extent_impl(bump_causes=False)` are its two hooks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from pmdfc_tpu_torch import tier as tier_mod
from pmdfc_tpu_torch.config import AdmitConfig, KVConfig, TierConfig
from pmdfc_tpu_torch.models.base import dedupe_last_wins, get_index_ops
from pmdfc_tpu_torch.models.rowops import first_lane
from pmdfc_tpu_torch.ops import bloom as bloom_ops
from pmdfc_tpu_torch.ops import fused as fused_ops
from pmdfc_tpu_torch.ops import pagepool
from pmdfc_tpu_torch.utils import u32
from pmdfc_tpu_torch.utils.hashing import hash_u64, shard_of
from pmdfc_tpu_torch.utils.keys import INVALID_I32, INVALID_WORD, is_invalid

# stats vector layout (same lanes as the JAX package); the trailing miss_*
# lanes are the miss-cause taxonomy: every recorded miss carries exactly
# one cause
(PUTS, GETS, HITS, MISSES, EVICTIONS, DROPS, EXTENT_PUTS, DELETES,
 CORRUPT_PAGES, MISS_COLD, MISS_EVICTED, MISS_PARKED, MISS_STALE,
 MISS_DIGEST, MISS_ROUTED, MISS_RECOVERING, MISS_SHED,
 MISS_QUARANTINED, MISS_DEADLINE) = range(19)
STAT_NAMES = [
    "puts", "gets", "hits", "misses", "evictions", "drops",
    "extent_puts", "deletes", "corrupt_pages",
    "miss_cold", "miss_evicted", "miss_parked", "miss_stale",
    "miss_digest", "miss_routed", "miss_recovering", "miss_shed",
    "miss_quarantined", "miss_deadline",
]
NSTATS = len(STAT_NAMES)
MISS_CAUSE_NAMES = tuple(STAT_NAMES[MISS_COLD:MISS_DEADLINE + 1])

EXTENT_REC_WORDS = 6  # khi, klo, vhi, vlo, len, valid
# tiered pool: hi word of an entry placed with no row allocated (balloon
# exhaustion; the entry [NOPAGE_TAG, 0] is a legal miss)
NOPAGE_TAG = 0xC0000000
_SKETCH_SEEDS = fused_ops.SKETCH_SEEDS


@dataclasses.dataclass
class ExtentState:
    recs: torch.Tensor    # int32[N, 6] u32 bits: the extent-record ring
    cursor: torch.Tensor  # int32[] u32 bits: ring cursor


@dataclasses.dataclass
class KVState:
    index: Any
    bloom: bloom_ops.BloomState | None
    # flat PoolState, or TierState when `config.tier` is set (after
    # `PMDFC_TIER`/`PMDFC_ADMIT`, `_tier_cfg_at_init`)
    pool: pagepool.PoolState | tier_mod.TierState | None
    extents: ExtentState
    stats: torch.Tensor           # int32[NSTATS]
    # evicted-key sketch: a plain bloom of keys the index capacity-evicted;
    # a GET miss that hits it is `miss_evicted`, else `miss_cold`
    evicted_filter: torch.Tensor  # bool[KVConfig.evicted_sketch_bits]


def resolve_device(device) -> torch.device:
    """The port's device rule: `cuda` unless the caller asks for the CPU;
    asking for cuda without a GPU raises (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pmdfc_tpu_torch: CUDA was asked for (the default) but no GPU "
            "is available; pass device='cpu' to run on the CPU")
    return dev


def _admit_cfg_at_init(tcfg: TierConfig) -> TierConfig:
    """Apply the `PMDFC_ADMIT` escape hatch to an effective tier config
    (init-time only, the `PMDFC_TIER` discipline: after init the STATE's
    admission leaves, present or not, carry the decision, so a
    mid-process env flip never mixes programs). `off` strips the gate
    (the TierState never grows the sketch leaves and the serving path is
    bit-identical to an admission-less config); `on` installs
    `AdmitConfig()` defaults on a tiered config that carries none."""
    env = os.environ.get("PMDFC_ADMIT", "")
    if env not in ("", "on", "off"):
        # a typo'd flag must not silently run the other promotion policy
        raise ValueError(
            f"PMDFC_ADMIT={env!r}: expected 'on', 'off', or unset")
    if env == "off" and tcfg.admit is not None:
        return dataclasses.replace(tcfg, admit=None)
    if env == "on" and tcfg.admit is None:
        return dataclasses.replace(tcfg, admit=AdmitConfig())
    return tcfg


def _tier_cfg_at_init(config: KVConfig) -> TierConfig | None:
    """Effective tier config, env escape hatches applied (init-time only:
    after init the pool's TYPE carries the decision, so a mid-process env
    flip never mixes programs). `PMDFC_ADMIT` rides the same resolution
    (see `_admit_cfg_at_init`)."""
    if not config.paged:
        return None
    env = os.environ.get("PMDFC_TIER", "")
    if env not in ("", "on", "off"):
        # a typo'd flag must not silently run the other pool layout
        raise ValueError(
            f"PMDFC_TIER={env!r}: expected 'on', 'off', or unset")
    if env == "off":
        return None
    if config.tier is not None:
        return _admit_cfg_at_init(config.tier)
    return _admit_cfg_at_init(TierConfig()) if env == "on" else None


def _tcfg(config: KVConfig) -> TierConfig:
    """Tier knobs for an already-tiered state (config.tier, or the
    defaults when the tier came from PMDFC_TIER=on). Whether the gate
    runs is the state's: `tier.admit_cfg` reads its admission leaves."""
    return config.tier if config.tier is not None else TierConfig()


def _tiered(state: KVState) -> bool:
    return isinstance(state.pool, tier_mod.TierState)


def init(config: KVConfig, device="cuda") -> KVState:
    dev = resolve_device(device)
    ops = get_index_ops(config.index.kind)
    n = ops.num_slots(config.index)
    pool = None
    tcfg = _tier_cfg_at_init(config)
    if tcfg is not None:
        pool = tier_mod.init(n, config.page_words, tcfg, device=dev)
    elif config.paged:
        pool = pagepool.init(n, config.page_words, device=dev)
    return KVState(
        index=ops.init(config.index, device=dev),
        bloom=bloom_ops.init(config.bloom, device=dev) if config.bloom else None,
        pool=pool,
        extents=ExtentState(
            recs=torch.zeros((config.extent_capacity, EXTENT_REC_WORDS),
                             dtype=torch.int32, device=dev),
            cursor=torch.zeros((), dtype=torch.int32, device=dev)),
        stats=torch.zeros(NSTATS, dtype=torch.int32, device=dev),
        evicted_filter=torch.zeros(config.evicted_sketch_bits,
                                   dtype=torch.bool, device=dev),
    )


# ---------------------------------------------------------------------------
# core batched ops
# ---------------------------------------------------------------------------

def _sketch_slots(config: KVConfig, keys: torch.Tensor) -> torch.Tensor:
    """int64[len(_SKETCH_SEEDS), B] sketch bit positions per key."""
    nb = config.evicted_sketch_bits
    return torch.stack([hash_u64(keys[..., 0], keys[..., 1], seed=s) % nb
                        for s in _SKETCH_SEEDS])


def _sketch_query(state: KVState, config: KVConfig, keys) -> torch.Tensor:
    """bool[B]: every sketch bit of the key is set (it was evicted once)."""
    return state.evicted_filter[_sketch_slots(config, keys)].all(dim=0)


def _index_miss_causes(bumps, state, config, keys, idx_miss):
    """Split index-level misses into `miss_evicted` (sketch hit) vs
    `miss_cold`."""
    ev = idx_miss & _sketch_query(state, config, keys)
    bumps[MISS_EVICTED] += ev.sum(dtype=torch.int32)
    bumps[MISS_COLD] += (idx_miss & ~ev).sum(dtype=torch.int32)


def _track_index(state: KVState, config: KVConfig, keys, placed, res):
    """After an index insert: bloom-insert the placed keys, bloom-delete
    the keys it evicted and mark them in the evicted-key sketch (so a
    later GET's miss can name its cause). -> the evicted mask."""
    evicted_mask = ~is_invalid(res.evicted)
    if state.bloom is not None:
        nh = config.bloom.num_hashes
        bloom_ops.insert_batch(state.bloom, keys, placed, num_hashes=nh)
        bloom_ops.delete_batch(state.bloom, res.evicted, evicted_mask,
                               num_hashes=nh)
    idx = _sketch_slots(config, res.evicted)
    state.evicted_filter[idx[:, evicted_mask].reshape(-1)] = True
    return evicted_mask


def _is_special(vals: torch.Tensor) -> torch.Tensor:
    """Paged mode: a set top-2-bit hi word is NOT a page-row value."""
    return (u32.widen(vals[..., 0]) >> 30) != 0


def _reclaim_evicted(res):
    """(freed mask, rows): pool rows released by index evictions (an
    extent-cover entry carries no row and frees nothing)."""
    freed = ~is_invalid(res.evicted) & ~_is_special(res.evicted_vals)
    return freed, torch.where(freed, res.evicted_vals[:, 1], -1)


def insert(state: KVState, config: KVConfig, keys: torch.Tensor,
           values: torch.Tensor):
    """Batched Insert (ref `KV::Insert` `server/KV.cpp:100-127`), in place.

    `values` is pages[B, page_words] when paged else u64 values[B, 2]
    (int32 bits). Index insert, bloom insert of landed keys, bloom delete
    and sketch mark of evicted keys, pool-row recycle/alloc, page and
    digest scatter. -> (state, InsertResult).

    The JAX program skips some masked passes with `lax.cond` when their
    mask is empty; here they always run (a masked pass over an empty mask
    changes nothing), so no host sync is needed.

    On a tiered pool a stale entry does not keep "its" row (the row may
    belong to another key now), freed rows are generation-guarded, fresh
    rows come from the cold tier (growing the balloon under pressure), a
    placement that got no row is stamped NOPAGE and counted as a drop, and
    a put is a touch for the admission gate.
    """
    ops = get_index_ops(config.index.kind)
    valid = ~is_invalid(keys)
    paged = state.pool is not None
    tiered = _tiered(state)
    shortfall = None

    if paged:
        # existing entries keep their row; fresh ones get a 0 placeholder
        # patched after allocation
        pre = ops.get_batch(state.index, keys)
        keep = pre.found & ~_is_special(pre.values)
        if tiered:
            keep = keep & tier_mod.entry_current(state.pool, pre.values)
        index_vals = torch.where(keep[:, None], pre.values, 0)
    else:
        index_vals = values

    _, res = ops.insert_batch(state.index, keys, index_vals)

    evicted_mask = _track_index(state, config, keys, valid & ~res.dropped,
                                res)

    if paged:
        pool = state.pool
        wrote = res.slots >= 0
        # a plain put over an extent-cover, NOPAGE or stale entry converts
        # it to a page entry with a fresh row
        conv = wrote & ~res.fresh & pre.found & ~keep
        want = res.fresh | conv
        freed, freed_rows = _reclaim_evicted(res)
        if tiered:
            # never free a row off a stale evicted value
            freed = freed & tier_mod.entry_current(pool, res.evicted_vals)
            _, new_rows = tier_mod.recycle_and_alloc(
                pool, _tcfg(config), freed, freed_rows, want)
            row_vals = tier_mod.row_values(pool, new_rows)
        else:
            _, new_rows = pagepool.recycle_and_alloc(pool, freed, freed_rows,
                                                     want)
            row_vals = torch.stack([torch.zeros_like(new_rows),
                                    new_rows.clamp(min=0)], dim=-1)
        # an entry placed mid-batch can lose its slot to a later same-batch
        # eviction; only an eviction can take a placement away
        probe = torch.where(want[:, None], keys, INVALID_I32)
        lost = want & ~ops.get_batch(state.index, probe).found \
            & evicted_mask.any()
        # a ballooned-down cold pool can run out of rows
        good = want & ~lost & (new_rows >= 0)
        if tiered:
            # a placed entry that got no row is stamped NOPAGE: it must not
            # keep its placeholder (that would alias global row 0)
            shortfall = want & ~lost & (new_rows < 0)
            nopage = u32.narrow(torch.tensor([NOPAGE_TAG, 0],
                                             device=keys.device))
            ops.set_values(state.index,
                           torch.where(good | shortfall, res.slots, -1),
                           torch.where(good[:, None], row_vals, nopage))
            tier_mod.recycle_and_alloc(pool, _tcfg(config), lost, new_rows,
                                       torch.zeros_like(lost), balloon=False)
        else:
            ops.set_values(state.index, torch.where(good, res.slots, -1),
                           row_vals)
            pagepool.recycle_and_alloc(pool, lost, new_rows,
                                       torch.zeros_like(lost))
        # ordered page scatters: in-place updates first, new rows second;
        # the digest sidecar rides the same two scatters
        upd_rows = torch.where(wrote & ~want & keep, pre.values[:, 1], -1)
        alloc_rows = torch.where(good, new_rows, -1)
        digs = pagepool.page_digest(values)
        for rows in (upd_rows, alloc_rows):
            if tiered:
                tier_mod.write_rows(pool, rows, values, digs)
            else:
                pagepool.write_batch(pool.pages, rows, values)
                pagepool.write_sums(pool.sums, rows, digs)
        acfg = tier_mod.admit_cfg(pool, _tcfg(config)) if tiered else None
        if acfg is not None:
            # a put is a touch: re-written keys accrue admission evidence
            tier_mod.admit_observe(pool, acfg, keys,
                                   dedupe_last_wins(keys, valid))

    bumps = torch.zeros(NSTATS, dtype=torch.int32, device=keys.device)
    bumps[PUTS] = valid.sum(dtype=torch.int32)
    bumps[EVICTIONS] = evicted_mask.sum(dtype=torch.int32)
    bumps[DROPS] = (valid & res.dropped).sum(dtype=torch.int32)
    if shortfall is not None:
        bumps[DROPS] += shortfall.sum(dtype=torch.int32)
    state.stats += bumps
    return state, res


def _reattribute_recovering(bumps: torch.Tensor) -> None:
    """Recovering serving state, in place on one batch's bumps: a would-be
    `miss_cold` cannot be told from a key that has not caught up yet, so
    the batch's whole cold lane moves to `miss_recovering`. Every other
    cause keeps its label, and `misses == Σ causes` stays exact."""
    cold = bumps[MISS_COLD].clone()
    bumps[MISS_RECOVERING] += cold
    bumps[MISS_COLD] -= cold


def _get_core(state: KVState, config: KVConfig, keys: torch.Tensor,
              lean: bool = False, recovering: bool = False):
    """Composed GET (ref `KV::Get` `KV.cpp:148`) -> (state, out, found).

    Serves the configs the fused GET does not (`fused.supports`): the lean
    probe for unpaged indexes, the composed page path for paged ones (the
    families other than linear and CCEH). Writes nothing but `state.stats`,
    except that a counting (`lean=False`) GET bumps an index's access
    counters (`ops.touch`: hotring) and, on a tiered pool, then runs the
    migration epilogue `tier.on_get`.
    """
    ops = get_index_ops(config.index.kind)
    valid = ~is_invalid(keys)
    bumps = torch.zeros(NSTATS, dtype=torch.int32, device=keys.device)
    corrupt = torch.zeros_like(valid)
    parked = stale = ext_m = torch.zeros_like(valid)
    # an index that counts accesses takes the slot-tracking probe on a
    # counting GET even without a pool
    lean_probe = state.pool is None and (ops.touch is None or lean)
    if not lean_probe:
        res = ops.get_batch(state.index, keys)
        found = res.found & valid
        idx_miss = valid & ~res.found
        if ops.touch is not None and not lean:
            # hotness bookkeeping (hotring's access counters)
            ops.touch(state.index, res.slots)
    if lean_probe:
        # lean probe: values pre-zeroed on miss
        out, found = ops.get_values(state.index, keys)
        found = found & valid
        idx_miss = valid & ~found
    elif state.pool is None:
        out = torch.where(found[:, None], res.values, 0)
    elif _tiered(state):
        pool = state.pool
        # tag 0 = page entry, 2 = extent, 3 = NOPAGE; every special tag but
        # NOPAGE is "not a page", so cold for a page GET
        tag = u32.widen(res.values[:, 0]) >> 30
        nopage = found & (tag == 3)
        ext_m = found & (tag != 0) & ~nopage
        found = found & (tag == 0)
        # a stale entry (generation mismatch) is a legal miss, never a
        # read of the row's new owner
        cur = tier_mod.entry_current(pool, res.values)
        stale = found & ~cur
        found = found & cur
        rows = torch.where(found, res.values[:, 1], -1)
        out = tier_mod.read_batch(pool, rows)
        live = tier_mod.row_live(pool, rows)
        sums_ok = pagepool.page_digest(out) == tier_mod.stored_sums(pool, rows)
        # a ballooned-out row is a legal miss, not corruption
        parked = nopage | (found & ~live)
        corrupt = found & live & ~sums_ok
        found = found & live & sums_ok
        out = torch.where(found[:, None], out, 0)
        if not lean:
            tier_mod.on_get(ops, state.index, pool, _tcfg(config), keys,
                            res.slots, rows, out, found)
    else:
        # extent-cover entries are not pages: misses for a page GET
        ext_m = found & (res.values[:, 0] == fused_ops.EXTENT_TAG_I32)
        found = found & ~ext_m
        rows = torch.where(found, res.values[:, 1], -1)
        out = pagepool.read_batch(state.pool.pages, rows)
        # integrity gate: a page whose bytes fail their digest is never
        # returned; it is a miss and bumps `corrupt_pages`
        ok = pagepool.verify_batch(state.pool, rows, out)
        corrupt = found & ~ok
        found = found & ok
        out = torch.where(found[:, None], out, 0)
    bumps[GETS] = valid.sum(dtype=torch.int32)
    bumps[HITS] = found.sum(dtype=torch.int32)
    bumps[MISSES] = (valid & ~found).sum(dtype=torch.int32)
    bumps[CORRUPT_PAGES] = corrupt.sum(dtype=torch.int32)
    _index_miss_causes(bumps, state, config, keys, idx_miss)
    bumps[MISS_COLD] += ext_m.sum(dtype=torch.int32)
    bumps[MISS_PARKED] = parked.sum(dtype=torch.int32)
    bumps[MISS_STALE] = stale.sum(dtype=torch.int32)
    bumps[MISS_DIGEST] = corrupt.sum(dtype=torch.int32)
    if recovering:
        _reattribute_recovering(bumps)
    state.stats += bumps
    return state, out, found


def get(state: KVState, config: KVConfig, keys: torch.Tensor,
        lean: bool = False, recovering: bool = False):
    """Batched Get -> (state, values_or_pages, found). Configs the fused
    GET supports always run it (the CUDA kernel on the card). `lean` skips
    the tiered pool's hotness bookkeeping and migration (the sampled
    path); it changes nothing on a flat pool. `recovering` is the
    warm-restart serving state: cold misses count as `miss_recovering`."""
    if fused_ops.supports(config):
        return fused_ops.get_core(state, config, keys, lean=lean,
                                  recovering=recovering)
    return _get_core(state, config, keys, lean=lean, recovering=recovering)


def get_compact(state: KVState, config: KVConfig, keys: torch.Tensor,
                lean: bool = False, recovering: bool = False):
    """Get with hit rows compacted to the front -> (state, out_sorted,
    order, found, nfound): a stable sort on `~found` keeps request order
    among hits, so the host fetches just `nfound` rows."""
    state, out, found = get(state, config, keys, lean=lean,
                            recovering=recovering)
    order = torch.argsort((~found).to(torch.uint8), stable=True)
    return (state, out[order], order.to(torch.int32), found,
            found.sum(dtype=torch.int32))


def delete(state: KVState, config: KVConfig, keys: torch.Tensor):
    """Batched Delete, in place: removes from index and bloom, frees the
    pool row (ref `KV::Delete`). -> (state, hit)."""
    ops = get_index_ops(config.index.kind)
    _, hit, old_vals = ops.delete_batch(state.index, keys)
    if state.bloom is not None:
        bloom_ops.delete_batch(state.bloom, keys, hit,
                               num_hashes=config.bloom.num_hashes)
    if state.pool is not None:
        # the same key twice in one batch hits twice but frees its row once
        freed = hit & ~_is_special(old_vals) & dedupe_last_wins(keys, hit)
        if _tiered(state):
            # a stale entry's delete must not free the recirculated row
            freed = freed & tier_mod.entry_current(state.pool, old_vals)
            rows = torch.where(freed, old_vals[:, 1], -1)
            tier_mod.recycle_and_alloc(state.pool, _tcfg(config), freed, rows,
                                       torch.zeros_like(freed), balloon=False)
        else:
            rows = torch.where(freed, old_vals[:, 1], -1)
            pagepool.recycle_and_alloc(state.pool, freed, rows,
                                       torch.zeros_like(freed))
    state.stats[DELETES] += hit.sum(dtype=torch.int32)
    return state, hit


# ---------------------------------------------------------------------------
# extents
# ---------------------------------------------------------------------------

def _covers(lo: int, length: int, max_covers: int, max_height: int):
    """Aligned power-of-two cover decomposition of [lo, lo + length), the
    recursion of `CCEH::Insert_extent` (`CCEH_hybrid.cpp:90-105`): each
    cover starts at the current head, sized by the largest power of two
    that divides the head, capped at 2**(max_height-1) and shrunk to fit
    the remainder. u32 words in Python ints: the head wraps past 2**32 as
    the JAX package's uint32 does.

    -> (bases: `max_covers` u32 cover bases, INVALID-padded; remaining:
    pages left uncovered when the run needs more than `max_covers`).
    """
    cap = (1 << (max_height - 1)) & u32.M32
    head, remaining = lo & u32.M32, length & u32.M32
    bases = []
    for _ in range(max_covers):
        low_bit = head & ((~head + 1) & u32.M32)  # 2**ffs; 0 for head 0
        size = min(cap if head == 0 else low_bit, cap)
        while size > remaining:
            size >>= 1
        bases.append(head if remaining else INVALID_WORD)
        head = (head + size) & u32.M32
        remaining -= size
    return bases, remaining


def _words(x) -> list[int]:
    """u32 words of a key or value given as ints, numpy or int32 bits."""
    return [int(v) & u32.M32 for v in x]


def insert_extent(state: KVState, config: KVConfig, key, value, length: int,
                  shard: tuple | None = None):
    """InsertExtent(key[2], value[2], len) (ref `KV::InsertExtent`), in
    place: one record in the extent ring, and one index entry per cover,
    valued `[EXTENT_TAG, record id]`. A cover over a page entry releases
    its pool row. -> (state, InsertResult over the covers, uncovered).

    `shard=(n_shards, me)` is the sharded plane's form (ref NUMA analog,
    `server/NuMA_KV.cpp:136-151`): every shard appends the identical
    record at the identical ring cursor (the ring is replicated), but
    indexes only the covers whose cover key it owns (a cover's owner
    differs from the base key's), and only shard 0 counts the put."""
    dev = state.stats.device
    (khi, klo), (vhi, vlo) = _words(key), _words(value)
    length = int(length) & u32.M32
    ext = state.extents
    rid = u32.widen(ext.cursor) % ext.recs.shape[0]
    ext.recs[rid] = u32.narrow(torch.tensor(
        [khi, klo, vhi, vlo, length, 1], device=dev))
    ext.cursor.copy_(u32.narrow(u32.widen(ext.cursor) + 1))

    bases, uncovered = _covers(klo, length, config.extent_max_covers,
                               config.extent_max_height)
    cover_keys = u32.narrow(torch.tensor(
        [[khi, b] if b != INVALID_WORD else [INVALID_WORD] * 2
         for b in bases], dtype=torch.int64, device=dev))
    if shard is not None:
        n_shards, me = shard
        mine = shard_of(cover_keys, n_shards) == me
        cover_keys = torch.where(mine[:, None], cover_keys, INVALID_I32)
    tagged = torch.stack([torch.full_like(cover_keys[:, 0], fused_ops
                                          .EXTENT_TAG_I32),
                          u32.narrow(rid).expand(len(bases))], dim=-1)
    ops = get_index_ops(config.index.kind)
    if state.pool is not None:
        # a cover overwriting a page entry releases its pool row
        pre = ops.get_batch(state.index, cover_keys)
        conv = pre.found & ~_is_special(pre.values)
        if _tiered(state):
            conv = conv & tier_mod.entry_current(state.pool, pre.values)
    _, res = ops.insert_batch(state.index, cover_keys, tagged)
    _track_index(state, config, cover_keys,
                 ~is_invalid(cover_keys) & ~res.dropped, res)
    if state.pool is not None:
        freed_e, rows_e = _reclaim_evicted(res)
        freed_c = conv & (res.slots >= 0) & ~res.fresh
        rows_c = torch.where(freed_c, pre.values[:, 1], -1)
        # a converted cover can also be reported evicted (its slot taken
        # by another cover of this batch, whose evicted values were read
        # before the batch): free its row once, on the conversion side
        dup = ((res.evicted[:, None, 0] == cover_keys[None, :, 0])
               & (res.evicted[:, None, 1] == cover_keys[None, :, 1])
               & freed_e[:, None] & freed_c[None, :])
        freed_e = freed_e & ~dup.any(dim=1)
        nothing = torch.zeros_like(freed_e)
        if _tiered(state):
            freed_e = freed_e & tier_mod.entry_current(state.pool,
                                                       res.evicted_vals)
            for f, r in ((freed_e, rows_e), (freed_c, rows_c)):
                tier_mod.recycle_and_alloc(state.pool, _tcfg(config), f, r,
                                           nothing, balloon=False)
        else:
            pagepool.recycle_and_alloc(state.pool, freed_e, rows_e, nothing)
            pagepool.recycle_and_alloc(state.pool, freed_c, rows_c, nothing)
    if shard is None or shard[1] == 0:
        state.stats[EXTENT_PUTS] += 1
    return state, res, uncovered


def _build_extent_probe(keys: torch.Tensor, hmax: int) -> torch.Tensor:
    """[B*H, 2] height-masked cover probe keys (INVALID rows stay INVALID)."""
    b = keys.shape[0]
    hs = torch.arange(hmax, device=keys.device)
    masks = u32.narrow(~((1 << hs) - 1))                       # [H]
    lo_t = keys[:, None, 1] & masks[None, :]                   # [B, H]
    hi_t = keys[:, None, 0].expand(b, hmax)
    probe = torch.stack([hi_t, lo_t], dim=-1).reshape(b * hmax, 2)
    inv = is_invalid(keys).repeat_interleave(hmax)
    return torch.where(inv[:, None], INVALID_I32, probe)


def _resolve_covers(recs: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                    hit: torch.Tensor, hmax: int):
    """Pick the winning cover per key from [B, H] probe results: the
    lowest height whose entry is an extent ref whose record spans the
    key. -> (out[B, 2] = record value + 4096 * (key - base) as a u64 on
    u32 words, found[B], height[B] (H where none))."""
    b = keys.shape[0]
    w = u32.widen
    is_ext = hit & (vals[..., 0] == fused_ops.EXTENT_TAG_I32)
    rid = torch.where(is_ext, w(vals[..., 1]), 0).clamp(max=recs.shape[0] - 1)
    recs_g = recs[rid]                                          # [B, H, 6]
    klo = w(keys[:, None, 1])
    spans = (is_ext & (recs_g[..., 5] != 0)
             & (recs_g[..., 0] == keys[:, None, 0])
             & (klo >= w(recs_g[..., 1]))
             & (((klo - w(recs_g[..., 1])) & u32.M32) < w(recs_g[..., 4])))
    first = first_lane(spans)
    found = spans.any(dim=1)
    rec = recs_g[torch.arange(b, device=keys.device), first]    # [B, 6]
    diff = ((w(keys[:, 1]) - w(rec[:, 1])) * 4096) & u32.M32
    lo = (w(rec[:, 3]) + diff) & u32.M32
    carry = (lo < w(rec[:, 3])).to(torch.int64)  # unsigned compare
    hi = w(rec[:, 2]) + carry
    out = torch.where(found[:, None], u32.narrow(torch.stack([hi, lo], -1)), 0)
    height = torch.where(found, first, hmax).to(torch.int32)
    return out, found, height


def _get_extent_impl(state: KVState, config: KVConfig, keys: torch.Tensor,
                     bump_causes: bool = True):
    """Batched GetExtent -> (state, values[B, 2], found[B], height[B],
    evicted[B]). `height` (the winning probe height, H on a miss) and
    `evicted` (the evicted-key sketch flag of a missed key) are for the
    sharded plane: covers of one key at different heights can live on
    different shards, and the plane arbitrates by the lowest height and
    classifies the global misses itself (`bump_causes=False`: every shard
    probes the whole batch, so per-shard cause bumps would count each
    miss once per shard). Writes only stats."""
    b, hmax = keys.shape[0], config.extent_max_height
    res = get_index_ops(config.index.kind).get_batch(
        state.index, _build_extent_probe(keys, hmax))
    out, found, height = _resolve_covers(state.extents.recs, keys,
                                         res.values.reshape(b, hmax, 2),
                                         res.found.reshape(b, hmax), hmax)
    valid = ~is_invalid(keys)
    bumps = torch.zeros(NSTATS, dtype=torch.int32, device=keys.device)
    bumps[GETS] = valid.sum(dtype=torch.int32)
    bumps[HITS] = found.sum(dtype=torch.int32)
    bumps[MISSES] = (valid & ~found).sum(dtype=torch.int32)
    ev = valid & ~found & _sketch_query(state, config, keys)
    if bump_causes:
        bumps[MISS_EVICTED] += ev.sum(dtype=torch.int32)
        bumps[MISS_COLD] += (valid & ~found & ~ev).sum(dtype=torch.int32)
    state.stats += bumps
    return state, out, found, height, ev


def get_extent(state: KVState, config: KVConfig, keys: torch.Tensor):
    """Batched GetExtent (ref `KV::GetExtent`, address arithmetic
    `KV.cpp:170-173`) -> (state, values[B, 2], found[B]). All B x H
    height-masked probes go through one index get. Writes only stats."""
    state, out, found, _, _ = _get_extent_impl(state, config, keys)
    return state, out, found


def find_anyway(state: KVState, config: KVConfig, keys: torch.Tensor):
    """Full-table scan for keys the hashed probe lost (ref `FindAnyway`,
    `server/IKV.h:18`) -> (values[B, 2], found[B], slot[B] or -1). Builds
    a [B, slots] mask: keep B small at full size."""
    flat_keys, flat_vals = get_index_ops(config.index.kind).scan(state.index)
    eq = ((flat_keys[None, :, 0] == keys[:, None, 0])
          & (flat_keys[None, :, 1] == keys[:, None, 1])
          & ~is_invalid(keys)[:, None])
    found = eq.any(dim=1)
    slot = first_lane(eq)
    return (flat_vals[slot], found,
            torch.where(found, slot, -1).to(torch.int32))


def utilization(state: KVState, config: KVConfig) -> torch.Tensor:
    """Fraction of occupied slots (ref `Utilization`, `server/IKV.h:19`)."""
    flat_keys, _ = get_index_ops(config.index.kind).scan(state.index)
    occ = (~is_invalid(flat_keys)).sum(dtype=torch.float32)
    # XLA divides by the constant slot count as a product with its float32
    # reciprocal, one ulp off a true division when the count is not a
    # power of two (level's 3 x 2^k slots, path's base-15 ones)
    one = torch.ones((), dtype=torch.float32, device=occ.device)
    return occ * (one / flat_keys.shape[0])


# ---------------------------------------------------------------------------
# directory scans and the one-sided fast path
# ---------------------------------------------------------------------------

# live rows digested per device step of a directory scan (bounds the
# gather to 2^16 pages, 256 MiB at 4 KiB pages)
_SCAN_CHUNK = 1 << 16


def _scan_live(state: KVState, config: KVConfig):
    """(flat_keys, flat_vals, live) over every slot, on the device; None
    when the index kind has no scan."""
    ops = get_index_ops(config.index.kind)
    if ops.scan is None:
        return None
    flat_keys, flat_vals = ops.scan(state.index)
    return flat_keys, flat_vals, ~is_invalid(flat_keys)


def _live_rows(state: KVState, flat_vals, live):
    """Paged-mode live filter on the device -> (mask, rows int64): the
    entries whose bytes currently verify. Extent-cover and NOPAGE entries
    drop out by their tag, stale-generation and parked tiered entries by
    the tier's rules, and a page that fails its at-rest digest drops out
    too (replaying or directing a client to it would serve corrupt bytes
    as good). The digest runs over the live rows only, `_SCAN_CHUNK` at a
    time."""
    pool = state.pool
    live = live & (u32.widen(flat_vals[:, 0]) >> 30 == 0)
    tiered = _tiered(state)
    if tiered:
        live = live & tier_mod.entry_current(pool, flat_vals)
    rows = torch.where(live, flat_vals[:, 1].to(torch.int64), -1)
    if tiered:
        # ballooned-out (parked) rows are legal misses, not servable rows
        live = live & tier_mod.row_live(pool, rows)
    idx = torch.nonzero(live).squeeze(1)
    ok = torch.zeros_like(live)
    for i in range(0, idx.numel(), _SCAN_CHUNK):
        j = idx[i:i + _SCAN_CHUNK]
        r = rows[j]
        ok[j] = pagepool.page_digest(pool.pages[r]) == pool.sums[r]
    return ok, rows


def _live_paged(state: KVState, scanned):
    """Shared paged-mode tail of `live_entries` and `directory_entries`:
    (keys[L, 2], rows[L]) device tensors, in scan order, of the entries
    whose bytes currently verify. The callers gather what they need from
    the rows (the pages, or only their digests)."""
    flat_keys, flat_vals, live = scanned
    ok, rows = _live_rows(state, flat_vals, live)
    idx = torch.nonzero(ok).squeeze(1)
    return flat_keys[idx], rows[idx]


def live_entries(state: KVState, config: KVConfig):
    """Host-side scan of one state: the live (key, payload) set a
    reshard/migration replay must re-insert -> numpy `(keys[L, 2],
    payload)`, payload the page rows `[L, page_words]` in paged mode, else
    the stored u64 value words `[L, 2]`. Extent-cover refs re-register
    from the extent ring and ride out; NOPAGE, stale, parked and
    digest-failing entries are legal misses and ride out too."""
    scanned = _scan_live(state, config)
    if scanned is None:
        raise ValueError(
            f"index kind {config.index.kind} has no scan op; "
            "reshard replay needs one")
    flat_keys, flat_vals, live = scanned
    if not config.paged:
        # extent-cover refs are tagged by the EXACT hi-word sentinel in
        # unpaged mode (arbitrary user hi-words are legal)
        live = live & (flat_vals[:, 0] != fused_ops.EXTENT_TAG_I32)
        return u32.to_numpy(flat_keys[live]), u32.to_numpy(flat_vals[live])
    keys, rows = _live_paged(state, scanned)
    return u32.to_numpy(keys), u32.to_numpy(state.pool.pages[rows])


def directory_entries(state: KVState, config: KVConfig):
    """Scan for the fast-path directory: the live, currently verifying
    (key -> row) set with each row's at-rest digest, numpy `(keys[L, 2],
    rows[L], digs[L])` (uint32). The digest is the validation token of a
    one-sided read: the server serves the row only while its stored
    digest still equals the client's. The scan, the masks and the digest
    check run on the device; no page crosses to the host. None for
    unpaged configs or an index kind without a scan."""
    scanned = _scan_live(state, config) if config.paged else None
    if scanned is None:
        return None
    keys, rows = _live_paged(state, scanned)
    return (u32.to_numpy(keys), rows.to(torch.int32).cpu().numpy()
            .astype(np.uint32), u32.to_numpy(state.pool.sums[rows]))


class FastView:
    """The server half of the one-sided fast path: a handle on one `KV`'s
    live pool, taken at directory epoch `epoch` and mutation sequence
    `seq` (the keys of `NetServer`'s packed-directory cache).

    The pool is updated in place, so the view holds no copy of it. A read
    is one call under `KV._lock` (`read`): check the epoch, compare each
    lane's stored digest with the client's (tiered: and the row's
    liveness; a free-row promotion vacates a cold row without scrubbing
    its bytes), gather only the validated rows, copy them to the host.
    Checking and gathering in two unlocked steps would let a put land
    between them and hand out new bytes under an old digest.

    `validate` and `gather` are the two halves, each locked on its own,
    kept for callers that compare with the JAX package's view; a server
    must call `read`."""

    __slots__ = ("epoch", "seq", "_kv")

    def __init__(self, kv: "KV", epoch: int, seq: int):
        self._kv = kv
        self.epoch = epoch
        self.seq = seq

    def _lanes(self, epoch: int, shards, rows, digs):
        """Caller holds the KV lock -> device (ok mask, rows int64)."""
        kv = self._kv
        pool = kv.state.pool
        dev = kv.device
        rows = np.asarray(rows, np.uint32)
        n = len(rows)
        if epoch != kv.dir_epoch:
            return torch.zeros(n, dtype=torch.bool, device=dev), None
        nr = pool.pages.shape[0]
        ok_h = (np.asarray(shards, np.uint32) == 0) & (rows < nr)
        r = torch.from_numpy(np.where(ok_h, rows, 0).astype(np.int64)).to(dev)
        d = torch.from_numpy(np.array(digs, np.uint32).view(np.int32)
                             ).to(dev)
        ok = torch.from_numpy(ok_h).to(dev) & (pool.sums[r] == d)
        if _tiered(kv.state):
            ok = ok & tier_mod.row_live(pool, r)
        return ok, r

    def read(self, epoch: int, shards, rows, digs):
        """One validated read -> (ok[N] bool, pages[nok, W] uint32 of the
        ok lanes in lane order, the KV's current epoch), atomic against
        every mutating verb."""
        kv = self._kv
        with kv._lock:
            ok, r = self._lanes(epoch, shards, rows, digs)
            cur = kv.dir_epoch
            if r is None:
                return (ok.cpu().numpy(),
                        np.zeros((0, kv.config.page_words), np.uint32), cur)
            hit = kv.state.pool.pages[r[ok]]
            return ok.cpu().numpy(), u32.to_numpy(hit), cur

    def validate(self, epoch: int, shards, rows, digs) -> np.ndarray:
        """ok[N]: the row is in range, live, and its stored digest still
        equals the client's; a stale epoch fails every lane."""
        with self._kv._lock:
            return self._lanes(epoch, shards, rows, digs)[0].cpu().numpy()

    def gather(self, shards, rows) -> np.ndarray:
        """The pages of the given rows (single shard), numpy uint32."""
        kv = self._kv
        with kv._lock:
            r = torch.from_numpy(np.asarray(rows, np.uint32)
                                 .astype(np.int64)).to(kv.device)
            return u32.to_numpy(kv.state.pool.pages[r])


def _host_words(x) -> np.ndarray:
    """A caller's rows as numpy uint32 words, for the journal: a uint32
    array as it is, another numpy or python input converted (its low 32
    bits), a tensor of int32 bits with one device-to-host copy."""
    if isinstance(x, torch.Tensor):
        return u32.to_numpy(x)
    a = np.asarray(x)
    return a if a.dtype == np.uint32 else a.astype(np.uint64).astype(np.uint32)


def _pad_pow2(n: int, lo: int = 16) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


class KV:
    """Host wrapper over one `KVState`: fixed-shape padded device batches.

    Keys are `[B, 2]` u32 words, values `[B, page_words]` pages (paged)
    or `[B, 2]` u64 words. Numpy in ⇒ numpy out (uint32 words, as the
    JAX package's `KV`); an int32 tensor in (u32 bits, any device) ⇒
    tensors out on the KV's device, with no host copy of pages.

    `device` defaults to `cuda` and raises when no GPU is present; pass
    `device="cpu"` to run on the CPU. Every method serializes on an
    instance lock (ops update the state in place).

    Besides the device stats vector, the KV keeps a host overlay
    (`account_shed`, `account_quarantined`, `account_deadline`: ops
    answered without a device op) folded into every `stats()`, the
    recovering serving state (`begin_recovering` .. `mark_recovered`),
    and the fast path's `dir_epoch` (structural generation, random odd
    start) and `_mut_seq` (one per mutating verb).
    """

    def __init__(self, config: KVConfig | None = None,
                 state: KVState | None = None, device="cuda", journal=None):
        self.config = config or KVConfig()
        self.device = resolve_device(device)
        self.state = state if state is not None else init(self.config,
                                                          self.device)
        self._ops = get_index_ops(self.config.index.kind)
        self._t0 = time.monotonic()
        # function-local import: runtime/__init__ imports server -> kv
        from pmdfc_tpu_torch.runtime import profiler
        from pmdfc_tpu_torch.runtime import sanitizer as san

        self._prof = profiler
        # the CUDA event pair of this thread's last async verb, for the
        # caller that fetches it (`take_launch`); per thread, so two
        # threads launching on one KV never swap pairs
        self._launch_tl = threading.local()

        # guarded-by: state, _gets_since_decay, _batches_since_touch,
        # guarded-by: dir_epoch, _mut_seq, _fastview, _host_stats,
        # guarded-by: _recovering, _recover_t0, _fused
        self._lock = san.rlock("KV._lock")
        # bounded-RPO durability (`runtime/journal.py`, duck-typed): when
        # attached, every mutation appends its record before the device
        # dispatch. `_chain` is the snapshot-chain cursor (id/seq/prev_crc
        # and the host digest basis the next delta diffs against).
        # guarded-by: _journal, _chain
        self._journal = journal
        self._chain: dict | None = None
        self._batches_since_touch = 0
        self._gets_since_decay = 0
        # the fused/composed GET decision (`ops/fused.py resolve`), made
        # at the first GET and published as the `serving.fused_get` gauge
        self._fused: bool | None = None
        # warm-restart serving state: GET misses that would read
        # `miss_cold` land in `miss_recovering` until `mark_recovered()`
        self._recovering = False
        self._recover_t0 = 0.0
        # host-side stats overlay: lanes the device never bumps (shed,
        # quarantined and deadline-expired ops), folded into every stats()
        self._host_stats = np.zeros(NSTATS, np.int64)
        # `dir_epoch` names a structural generation of the key -> row
        # mapping (delete, balloon, recovery, ring notes bump it); a
        # random odd start keeps a swapped instance from matching a
        # client's cached epoch. `_mut_seq` counts every mutating verb.
        self.dir_epoch = int.from_bytes(os.urandom(4), "little") | 1
        self._mut_seq = 0
        self._fastview: FastView | None = None
        # per-instance telemetry scope stats() publishes into (lazy)
        self._tele_scope = None

    # -- helpers --
    def _padded(self, x, w: int, fill: int) -> torch.Tensor:
        """Rows x[b, d] (u32 words as numpy or python ints, or an int32
        tensor) padded with `fill` rows to [w, d]: a FRESH int32 tensor on
        the device. Never a view of the caller's buffer — an engine arena
        row is reused by its client as soon as its request completes. Only
        the b rows cross from the host; the padding is filled on the
        device."""
        if not isinstance(x, torch.Tensor):
            a = np.ascontiguousarray(x)
            if a.dtype not in (np.uint32, np.int32):
                a = a.astype(np.uint64).astype(np.uint32)
            if not a.flags.writeable:  # torch.from_numpy wants writeable
                a = a.copy()
            x = torch.from_numpy(a.view(np.int32))  # a view: copied below
        out = torch.full((w, x.shape[-1]), fill, dtype=torch.int32,
                         device=self.device)
        out[:x.shape[0]].copy_(x)  # casts and crosses in one copy
        return out

    def _keys(self, keys, w: int) -> torch.Tensor:
        """Keys padded with INVALID to width w, as int32 on the device."""
        return self._padded(keys, w, INVALID_I32)

    def _on_device(self):
        """Enter the KV's device for this thread (a CUDA context is per
        thread: a server or control thread must not use the main one's)."""
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    @staticmethod
    def _out(x: torch.Tensor, host: bool, words: bool = True):
        """A result back to the caller: the tensor for tensor callers,
        numpy for numpy callers (u32 `words` as uint32, others as is)."""
        if not host:
            return x
        return u32.to_numpy(x) if words else x.cpu().numpy()

    def _launch_begin(self):
        """Start event of one async verb (caller holds the lock): None
        unless a profiler is attached and the KV is on CUDA."""
        self._launch_tl.events = None
        return self._prof.launch_begin(self.device)

    def _launch_end(self, ev) -> None:
        self._launch_tl.events = self._prof.launch_end(ev, self.device)

    def take_launch(self):
        """The CUDA event pair (`profiler.LaunchEvents`) this thread's
        last async verb recorded, or None; cleared by the read. The
        caller that fetches the verb's results hands it to
        `profiler.fetch(..., events=)`."""
        ev = getattr(self._launch_tl, "events", None)
        self._launch_tl.events = None
        return ev

    def insert(self, keys, values):
        """keys[B, 2]; values = pages[B, page_words] or u64 vals[B, 2]
        -> InsertResult of the B rows. The host copy is the profiler's
        timed fetch (`runtime/profiler.py`)."""
        host = not isinstance(keys, torch.Tensor)
        res, b = self.insert_async(keys, values)
        return self._prof.fetch(
            "kv.insert", "put", lambda: type(res)(**{
                f: self._out(x[:b], host, words=f.startswith("evicted"))
                for f, x in res._asdict().items()}),
            n_ops=b, ring=True, events=self.take_launch())

    # caller-holds: _lock
    def _touch_due(self) -> bool:
        """Sampled hotness accounting: one GET batch in
        `touch_sample_every` pays the counting path (an index's access
        counters, a tiered pool's migration epilogue); the rest are lean
        pure reads. Callers hold the lock."""
        every = self.config.index.touch_sample_every
        if self._ops.touch is None and not _tiered(self.state):
            return False  # lean changes nothing then
        if every <= 1:
            return True
        self._batches_since_touch += 1
        if self._batches_since_touch >= every:
            self._batches_since_touch = 0
            return True
        return False

    # caller-holds: _lock
    def _maybe_decay(self, gets: int) -> None:
        """Periodic heat drain of an index that counts accesses (hotring):
        `ops.decay` once every `decay_every_gets` keys asked for (each
        GET batch's length before padding, as the JAX `KV` counts them).
        Callers hold the lock."""
        every = self.config.index.decay_every_gets
        if self._ops.decay is not None and every:
            self._gets_since_decay += gets
            if self._gets_since_decay >= every:
                self._gets_since_decay = 0
                self._ops.decay(self.state.index)

    def get(self, keys):
        """-> (pages_or_values[B, ...], found[B])."""
        host = not isinstance(keys, torch.Tensor)
        out, found, b = self.get_async(keys)
        return self._prof.fetch(
            "kv.get", "get", lambda: (self._out(out[:b], host),
                                      self._out(found[:b], host,
                                                words=False)),
            n_ops=b, ring=True, events=self.take_launch())

    def delete(self, keys):
        """-> hit[B]."""
        host = not isinstance(keys, torch.Tensor)
        hit, b = self.delete_async(keys)
        return self._prof.fetch(
            "kv.delete", "del",
            lambda: self._out(hit[:b], host, words=False),
            n_ops=b, ring=True, events=self.take_launch())

    # caller-holds: _lock
    def _fused_on(self) -> bool:
        """Whether this instance's GETs take the fused route, resolved
        once (`fused_ops.resolve`, which publishes it)."""
        if self._fused is None:
            self._fused = fused_ops.resolve(self.config)
        return self._fused

    # caller-holds: _lock
    def _cost_get(self, program: str, w: int) -> None:
        """The profiler's cost gauges at the first (GET program, width):
        the fused kernel's bytes with every key a hit; the composed GET
        has no byte count and sets none."""
        if self._fused_on():
            self._prof.cost_probe(
                program, w, lambda: fused_ops.hit_bytes(self.state, w))

    # -- async verbs (the serving path, `runtime/server.py`) --
    # Each pads its batch to `_pad_pow2(b, lo=pad_floor)` rows, as the JAX
    # package's do (so a flush has the same padded width in both), and
    # returns tensors on the KV's device with no host copy: CUDA work runs
    # on until the caller reads a result, and the driver launches flush
    # N+1 before it reads flush N. The state is updated IN PLACE, so no
    # returned tensor may alias it: every result is a fresh tensor the op
    # computed (a gather, the kernel's own output buffer), never a view of
    # a state leaf, and stream order puts a later insert's writes after
    # this GET's reads (`tests/test_torch_server.py` pins both).

    def insert_async(self, keys, values, pad_floor: int = 16):
        """Like `insert` -> (InsertResult of device tensors, b)."""
        with self._lock:
            if self._journal is not None:
                # WAL before dispatch: the record must be durable-bound
                # before the device can acknowledge these pages
                self._journal.append_put(_host_words(keys),
                                         _host_words(values))
            b = len(keys)
            w = _pad_pow2(b, lo=pad_floor)
            ev = self._launch_begin()
            self.state, res = insert(self.state, self.config,
                                     self._keys(keys, w),
                                     self._padded(values, w, 0))
            self._launch_end(ev)
            self._mut_seq += 1
            return res, b

    def get_async(self, keys, pad_floor: int = 16):
        """Like `get` -> (device out, device found, b)."""
        with self._lock:
            b = len(keys)
            w = _pad_pow2(b, lo=pad_floor)
            self._cost_get("kv.get", w)
            ev = self._launch_begin()
            self.state, out, found = get(
                self.state, self.config, self._keys(keys, w),
                lean=not self._touch_due(), recovering=self._recovering)
            self._maybe_decay(b)
            self._launch_end(ev)
            return out, found, b

    def get_compact_async(self, keys, pad_floor: int = 16):
        """Hit-compacted get -> (device out_sorted, order, found, nfound, b).

        `out_sorted[:nfound]` are the hit rows in request order and
        `order[:nfound]` their request indices (the found-compressed page
        return, `server/rdma_svr.cpp:706-719`).
        """
        with self._lock:
            b = len(keys)
            w = _pad_pow2(b, lo=pad_floor)
            self._cost_get("kv.get_compact", w)
            ev = self._launch_begin()
            self.state, out, order, found, nfound = get_compact(
                self.state, self.config, self._keys(keys, w),
                lean=not self._touch_due(), recovering=self._recovering)
            self._maybe_decay(b)
            self._launch_end(ev)
            return out, order, found, nfound, b

    def get_extent_async(self, keys, pad_floor: int = 16):
        """Like `get_extent` -> (device vals, device found, b)."""
        with self._lock:
            b = len(keys)
            ev = self._launch_begin()
            self.state, out, found = get_extent(
                self.state, self.config,
                self._keys(keys, _pad_pow2(b, lo=pad_floor)))
            self._launch_end(ev)
            return out, found, b

    def delete_async(self, keys, pad_floor: int = 16):
        """Like `delete` -> (device hit mask, b)."""
        with self._lock:
            if self._journal is not None:
                self._journal.append_delete(_host_words(keys))
            b = len(keys)
            ev = self._launch_begin()
            self.state, hit = delete(
                self.state, self.config,
                self._keys(keys, _pad_pow2(b, lo=pad_floor)))
            self._launch_end(ev)
            self._mut_seq += 1
            self.dir_epoch += 1
            return hit, b

    def insert_extent(self, key, value, length: int):
        """key[2], value[2] u32 words, length in pages -> (InsertResult
        over the covers, uncovered tail pages). `uncovered > 0` means the
        run needed more than `config.extent_max_covers` covers and its
        tail was not indexed."""
        host = not isinstance(key, torch.Tensor)
        with self._lock:
            if self._journal is not None:
                self._journal.append_extent(_host_words(key),
                                            _host_words(value), length)
            self.state, res, uncovered = insert_extent(
                self.state, self.config, key, value, length)
            self._mut_seq += 1
            return type(res)(**{
                f: self._out(x, host, words=f.startswith("evicted"))
                for f, x in res._asdict().items()}), uncovered

    def get_extent(self, keys):
        """-> (values[B, 2] u64 words of each key's address, found[B])."""
        host = not isinstance(keys, torch.Tensor)
        out, found, b = self.get_extent_async(keys)
        return self._prof.fetch(
            "kv.get_extent", "get_ext",
            lambda: (self._out(out[:b], host),
                     self._out(found[:b], host, words=False)),
            n_ops=b, ring=True, events=self.take_launch())

    def find_anyway(self, keys):
        """-> (values[B, 2], found[B], slot[B] or -1), by a full scan."""
        host = not isinstance(keys, torch.Tensor)
        with self._lock:
            b = len(keys)
            vals, found, slot = find_anyway(
                self.state, self.config, self._keys(keys, _pad_pow2(b)))
            return (self._out(vals[:b], host),
                    self._out(found[:b], host, words=False),
                    self._out(slot[:b], host, words=False))

    def recovery(self) -> bool:
        """Post-restart repair hook (ref `KV::Recovery`): the index's
        directory repair, in place, where it has one."""
        with self._lock:
            if self._ops.recovery is not None:
                self._ops.recovery(self.state.index)
                self._mut_seq += 1
                self.dir_epoch += 1
            return True

    def snapshot(self, path: str, delta: bool = False) -> dict:
        """Crash-safe checkpoint of the live state (temp + fsync + atomic
        rename + integrity digest, see `checkpoint.save`).

        `delta=True` writes an INCREMENTAL chain member: only the pool
        rows whose digest sidecar (or tier liveness) changed since the
        previous member of this instance's chain (`checkpoint.save_delta`)
        — restore goes through `checkpoint.load_chain`. Falls back to a
        FULL (which starts a new chain) when there is no chain yet, the
        config is unpaged, or the row space drifted. When a journal is
        attached the save also appends a durable MARK record, so
        `journal.replay(after_mark=True)` replays exactly the tail past
        this snapshot.

        A consistent cut: under the instance lock, on the KV's device,
        after a synchronize of it. Returns a report (`kind`, `chain_id`,
        `seq`, `crc`, `dirty_rows`, ...)."""
        from pmdfc_tpu_torch import checkpoint as _ckpt  # imports kv

        with self._lock, self._on_device():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            sums, live = self._dirty_basis()
            report, self._chain = _ckpt.chain_step(
                self.state, path, self._chain, sums, live, delta)
            if self._journal is not None:
                self._journal.mark({"chain_id": report["chain_id"],
                                    "seq": report["seq"],
                                    "crc": report["crc"], "path": path,
                                    "kind": report["kind"]})
            return report

    # caller-holds: _lock
    def _dirty_basis(self):
        """Host copies of `(sums, live)` — the delta-dirty basis. The
        digest sidecar is maintained by exactly the mutation paths
        (insert / delete-recycle / balloon rewrite), so a sidecar diff
        IS the dirty-row set; tier liveness rides along to catch rows
        vacated WITHOUT a rewrite. None for unpaged configs."""
        pool = self.state.pool
        if pool is None:
            return None, None
        # a copy: on the CPU `to_numpy` would be a view of the live leaf
        sums = np.array(u32.to_numpy(pool.sums)).reshape(-1)
        live = tier_mod.live_mask(pool) if _tiered(self.state) else None
        return sums, live

    def attach_journal(self, journal) -> None:
        """Arm the write-ahead journal (`runtime/journal.py`): from now on
        every mutation appends its record before the device dispatch
        (None disarms it)."""
        with self._lock:
            self._journal = journal

    def resume_chain(self, chain: dict) -> None:
        """Re-arm the snapshot-chain cursor after a restore (`chain` is
        `materialize_chain`'s resume card): the next `snapshot(delta=
        True)` extends the restored chain, with the dirty basis
        re-anchored at the restored state."""
        with self._lock:
            sums, live = self._dirty_basis()
            self._chain = {"id": chain["id"], "seq": int(chain["seq"]),
                           "prev_crc": int(chain["crc"]),
                           "base_sums": sums, "base_live": live}

    def begin_recovering(self) -> None:
        """Enter the warm-restart serving state: GETs answer from the rows
        held; misses that would read `miss_cold` count as
        `miss_recovering` until `mark_recovered()`."""
        from pmdfc_tpu_torch.runtime import telemetry as tele

        with self._lock:
            if not self._recovering:
                self._recovering = True
                self._recover_t0 = time.monotonic()
                sc = tele.scope("recovery", {"warm_restarts": 0,
                                             "completed": 0}, unique=False)
                sc.inc("warm_restarts")
                sc.set("recovering", 1)

    def mark_recovered(self) -> bool:
        """Leave the recovering state (idempotent). -> whether it was
        set."""
        from pmdfc_tpu_torch.runtime import telemetry as tele

        with self._lock:
            was = self._recovering
            self._recovering = False
            if was:
                sc = tele.scope("recovery", unique=False)
                sc.inc("completed")
                sc.set("recovering", 0)
                sc.set("last_recovery_s",
                       round(time.monotonic() - self._recover_t0, 3))
            return was

    def recovery_info(self) -> dict:
        """Warm-restart status for health surfaces and the MSG_RECOVERY
        wire verb."""
        with self._lock:
            info: dict = {"recovering": self._recovering}
            if self._recovering:
                info["recovering_s"] = round(
                    time.monotonic() - self._recover_t0, 3)
            if self._chain is not None:
                info["chain"] = {"id": self._chain["id"],
                                 "seq": self._chain["seq"]}
            return info

    def capacity(self) -> int:
        return self._ops.num_slots(self.config.index)

    def utilization(self) -> float:
        with self._lock:
            return float(utilization(self.state, self.config))

    def packed_bloom(self) -> np.ndarray | None:
        """Packed MSB-first bit form for the client mirror (ref `send_bf`,
        `server/rdma_svr.cpp:157-251`), numpy uint32."""
        with self._lock:
            if self.state.bloom is None:
                return None
            return u32.to_numpy(bloom_ops.to_packed_bits(self.state.bloom))

    # -- one-sided fast-path surface (`runtime/net.py` MSG_DIRPULL /
    # MSG_FASTREAD) --

    def fast_view(self) -> FastView | None:
        """The fast lane's handle on the live pool at the current (epoch,
        seq), cached per mutation sequence. None for unpaged configs (no
        rows to read)."""
        if not self.config.paged:
            return None
        with self._lock:
            fv = self._fastview
            if fv is None or fv.seq != self._mut_seq \
                    or fv.epoch != self.dir_epoch:
                fv = self._fastview = FastView(self, self.dir_epoch,
                                               self._mut_seq)
            return fv

    def directory_snapshot(self, max_entries: int = 1 << 20) -> dict | None:
        """Compact key -> (shard, row, digest) directory for the client
        mirror: `{"epoch", "keys"[L, 2], "shards"[L], "rows"[L],
        "digs"[L]}` (shard column all zero on one device), the first
        `max_entries` in scan order. None when the config is unpaged or
        the index kind has no scan."""
        with self._lock:
            ents = directory_entries(self.state, self.config)
            if ents is None:
                return None
            keys, rows, digs = (x[:max_entries] for x in ents)
            return {"epoch": self.dir_epoch, "keys": keys,
                    "shards": np.zeros(len(rows), np.uint32),
                    "rows": rows, "digs": digs}

    def bump_dir_epoch(self) -> int:
        """Structural invalidation from above the KV (a membership
        change): every outstanding directory entry stops validating at
        once. -> the new epoch."""
        with self._lock:
            self._mut_seq += 1
            self.dir_epoch += 1
            return self.dir_epoch

    # -- tier surface (no-ops on a flat pool) --
    # Each verb runs under the lock AND on the KV's device: the
    # controller (`runtime/autotune.py`) calls them from its own thread,
    # whose current CUDA device is not the KV's.

    def tier_stats(self) -> dict | None:
        """Per-tier counters (`hot_hits`, `promotions`, `demotions`,
        `balloon_*`, `migrated_bytes`, occupancy, the admission lanes) —
        None when flat."""
        with self._lock, self._on_device():
            if not _tiered(self.state):
                return None
            return tier_mod.stats_dict(self.state.pool,
                                       self.config.page_words * 4)

    def _balloon_rows(self, rows: int) -> int:
        """A balloon request rounded UP to whole extents and clamped to the
        cold pool."""
        step = _tcfg(self.config).balloon_step
        c = self.state.pool.cfree.shape[0]
        return min(-(-int(rows) // step) * step, c)

    def balloon_state(self) -> dict | None:
        """Cold-pool circulation snapshot (circulating, parked and free
        rows, the extent step); None on a flat pool."""
        with self._lock, self._on_device():
            if not _tiered(self.state):
                return None
            return tier_mod.balloon_state(self.state.pool,
                                          _tcfg(self.config).balloon_step)

    def balloon_grow(self, rows: int) -> bool:
        """Ensure at least `rows` free cold rows circulate (parked capacity
        returns first; rounded up to whole extents). False on a flat
        pool."""
        with self._lock, self._on_device():
            if not _tiered(self.state):
                return False
            tier_mod.grow(self.state.pool, self._balloon_rows(rows))
            self._mut_seq += 1
            self.dir_epoch += 1
            return True

    def balloon_shrink(self, rows: int) -> bool:
        """Balloon the cold pool down by up to `rows` rows now (rounded up
        to whole extents). Free rows park first; then the coldest live
        rows are evicted, their pages degrading to legal misses. False on
        a flat pool."""
        with self._lock, self._on_device():
            if not _tiered(self.state):
                return False
            tier_mod.shrink(self.state.pool, self._balloon_rows(rows))
            self._mut_seq += 1
            self.dir_epoch += 1
            return True

    def admit_state(self) -> dict | None:
        """The admission gate's snapshot (threshold, epoch progress,
        counter lanes); None when the pool is flat or has no gate."""
        with self._lock, self._on_device():
            pool = self.state.pool
            if not _tiered(self.state) or pool.admit_cm is None:
                return None
            return tier_mod.admit_state(
                pool, tier_mod.admit_cfg(pool, _tcfg(self.config)))

    def set_admit_threshold(self, value: int) -> bool:
        """Live admission-threshold write (clamped to >= 0). False when no
        gate is installed."""
        with self._lock, self._on_device():
            pool = self.state.pool
            if not _tiered(self.state) or pool.admit_cm is None:
                return False
            tier_mod.set_admit_threshold(pool, value)
            return True

    def _account(self, cause: int, gets: int, puts: int) -> None:
        """Host overlay: `gets` served all-miss with `cause`, `puts`
        acked and dropped, with no device op."""
        with self._lock:
            if gets:
                self._host_stats[GETS] += int(gets)
                self._host_stats[MISSES] += int(gets)
                self._host_stats[cause] += int(gets)
            if puts:
                self._host_stats[PUTS] += int(puts)
                self._host_stats[DROPS] += int(puts)

    def account_shed(self, gets: int, puts: int = 0) -> None:
        """QoS-shed ops (`runtime/qos.py`): a shed GET is a served all-miss
        with cause `miss_shed`, a shed PUT an acked drop."""
        self._account(MISS_SHED, gets, puts)

    def account_quarantined(self, gets: int, puts: int = 0) -> None:
        """Shard-quarantine degradations (`failure.ShardQuarantine`):
        cause `miss_quarantined`."""
        self._account(MISS_QUARANTINED, gets, puts)

    def account_deadline(self, gets: int, puts: int = 0) -> None:
        """Deadline-expired staged ops (`runtime/net.py` flush shed):
        cause `miss_deadline`."""
        self._account(MISS_DEADLINE, gets, puts)

    def stats(self) -> dict:
        from pmdfc_tpu_torch.runtime import telemetry as tele

        with self._lock, self._on_device():
            vec = self.state.stats.cpu().numpy().astype(np.int64) \
                + self._host_stats
            d = dict(zip(STAT_NAMES, (int(x) for x in vec)))
            t = self.tier_stats()
        if t is not None:
            d.update(t)
        d["uptime_s"] = time.monotonic() - self._t0
        if tele.enabled():
            # the device vector stays the source of truth; each snapshot
            # is published into a per-instance registry scope
            if self._tele_scope is None:
                self._tele_scope = tele.scope("kv")
            for k, v in d.items():
                if isinstance(v, (int, float)):
                    self._tele_scope.set(k, v)
        return d

    def print_stats(self) -> str:
        """Human stats dump (ref `PrintStats`)."""
        line = ", ".join(f"{k}={v}" for k, v in self.stats().items())
        print(f"[kv] {line}")
        return line
