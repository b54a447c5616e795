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
copy. Not ported yet: the sharded extent insert, the recovering serving
state, `fast_view` and the host-side stats overlays.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

from pmdfc_tpu_torch import tier as tier_mod
from pmdfc_tpu_torch.config import KVConfig, TierConfig
from pmdfc_tpu_torch.models.base import dedupe_last_wins, get_index_ops
from pmdfc_tpu_torch.models.rowops import first_lane
from pmdfc_tpu_torch.ops import bloom as bloom_ops
from pmdfc_tpu_torch.ops import fused as fused_ops
from pmdfc_tpu_torch.ops import pagepool
from pmdfc_tpu_torch.utils import u32
from pmdfc_tpu_torch.utils.hashing import hash_u64
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
    # flat PoolState, or TierState when `config.tier` is set
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


def _tcfg(config: KVConfig) -> TierConfig:
    """Tier knobs of a tiered state: `config.tier` (the defaults where a
    tiered state meets a config without one)."""
    return config.tier if config.tier is not None else TierConfig()


def _tiered(state: KVState) -> bool:
    return isinstance(state.pool, tier_mod.TierState)


def init(config: KVConfig, device="cuda") -> KVState:
    dev = resolve_device(device)
    ops = get_index_ops(config.index.kind)
    n = ops.num_slots(config.index)
    pool = None
    if config.paged and config.tier is not None:
        pool = tier_mod.init(n, config.page_words, config.tier, device=dev)
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


def _get_core(state: KVState, config: KVConfig, keys: torch.Tensor,
              lean: bool = False):
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
    state.stats += bumps
    return state, out, found


def get(state: KVState, config: KVConfig, keys: torch.Tensor,
        lean: bool = False):
    """Batched Get -> (state, values_or_pages, found). Configs the fused
    GET supports always run it (the CUDA kernel on the card). `lean` skips
    the tiered pool's hotness bookkeeping and migration (the sampled
    path); it changes nothing on a flat pool."""
    if fused_ops.supports(config):
        return fused_ops.get_core(state, config, keys, lean=lean)
    return _get_core(state, config, keys, lean=lean)


def get_compact(state: KVState, config: KVConfig, keys: torch.Tensor,
                lean: bool = False):
    """Get with hit rows compacted to the front -> (state, out_sorted,
    order, found, nfound): a stable sort on `~found` keeps request order
    among hits, so the host fetches just `nfound` rows."""
    state, out, found = get(state, config, keys, lean=lean)
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


def insert_extent(state: KVState, config: KVConfig, key, value, length: int):
    """InsertExtent(key[2], value[2], len) (ref `KV::InsertExtent`), in
    place: one record in the extent ring, and one index entry per cover,
    valued `[EXTENT_TAG, record id]`. A cover over a page entry releases
    its pool row. -> (state, InsertResult over the covers, uncovered)."""
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


def get_extent(state: KVState, config: KVConfig, keys: torch.Tensor):
    """Batched GetExtent (ref `KV::GetExtent`, address arithmetic
    `KV.cpp:170-173`) -> (state, values[B, 2], found[B]). All B x H
    height-masked probes go through one index get. Writes only stats."""
    b, hmax = keys.shape[0], config.extent_max_height
    res = get_index_ops(config.index.kind).get_batch(
        state.index, _build_extent_probe(keys, hmax))
    out, found, _ = _resolve_covers(state.extents.recs, keys,
                                    res.values.reshape(b, hmax, 2),
                                    res.found.reshape(b, hmax), hmax)
    valid = ~is_invalid(keys)
    bumps = torch.zeros(NSTATS, dtype=torch.int32, device=keys.device)
    bumps[GETS] = valid.sum(dtype=torch.int32)
    bumps[HITS] = found.sum(dtype=torch.int32)
    bumps[MISSES] = (valid & ~found).sum(dtype=torch.int32)
    _index_miss_causes(bumps, state, config, keys, valid & ~found)
    state.stats += bumps
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
    """

    def __init__(self, config: KVConfig | None = None,
                 state: KVState | None = None, device="cuda"):
        self.config = config or KVConfig()
        self.device = resolve_device(device)
        self.state = state if state is not None else init(self.config,
                                                          self.device)
        self._ops = get_index_ops(self.config.index.kind)
        self._t0 = time.monotonic()
        self._lock = threading.RLock()
        self._batches_since_touch = 0
        self._gets_since_decay = 0

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

    @staticmethod
    def _out(x: torch.Tensor, host: bool, words: bool = True):
        """A result back to the caller: the tensor for tensor callers,
        numpy for numpy callers (u32 `words` as uint32, others as is)."""
        if not host:
            return x
        return u32.to_numpy(x) if words else x.cpu().numpy()

    def insert(self, keys, values):
        """keys[B, 2]; values = pages[B, page_words] or u64 vals[B, 2]
        -> InsertResult of the B rows."""
        host = not isinstance(keys, torch.Tensor)
        res, b = self.insert_async(keys, values)
        return type(res)(**{
            f: self._out(x[:b], host, words=f.startswith("evicted"))
            for f, x in res._asdict().items()})

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
        return (self._out(out[:b], host),
                self._out(found[:b], host, words=False))

    def delete(self, keys):
        """-> hit[B]."""
        host = not isinstance(keys, torch.Tensor)
        hit, b = self.delete_async(keys)
        return self._out(hit[:b], host, words=False)

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
            b = len(keys)
            w = _pad_pow2(b, lo=pad_floor)
            self.state, res = insert(self.state, self.config,
                                     self._keys(keys, w),
                                     self._padded(values, w, 0))
            return res, b

    def get_async(self, keys, pad_floor: int = 16):
        """Like `get` -> (device out, device found, b)."""
        with self._lock:
            b = len(keys)
            self.state, out, found = get(
                self.state, self.config,
                self._keys(keys, _pad_pow2(b, lo=pad_floor)),
                lean=not self._touch_due())
            self._maybe_decay(b)
            return out, found, b

    def get_compact_async(self, keys, pad_floor: int = 16):
        """Hit-compacted get -> (device out_sorted, order, found, nfound, b).

        `out_sorted[:nfound]` are the hit rows in request order and
        `order[:nfound]` their request indices (the found-compressed page
        return, `server/rdma_svr.cpp:706-719`).
        """
        with self._lock:
            b = len(keys)
            self.state, out, order, found, nfound = get_compact(
                self.state, self.config,
                self._keys(keys, _pad_pow2(b, lo=pad_floor)),
                lean=not self._touch_due())
            self._maybe_decay(b)
            return out, order, found, nfound, b

    def get_extent_async(self, keys, pad_floor: int = 16):
        """Like `get_extent` -> (device vals, device found, b)."""
        with self._lock:
            b = len(keys)
            self.state, out, found = get_extent(
                self.state, self.config,
                self._keys(keys, _pad_pow2(b, lo=pad_floor)))
            return out, found, b

    def delete_async(self, keys, pad_floor: int = 16):
        """Like `delete` -> (device hit mask, b)."""
        with self._lock:
            b = len(keys)
            self.state, hit = delete(
                self.state, self.config,
                self._keys(keys, _pad_pow2(b, lo=pad_floor)))
            return hit, b

    def insert_extent(self, key, value, length: int):
        """key[2], value[2] u32 words, length in pages -> (InsertResult
        over the covers, uncovered tail pages). `uncovered > 0` means the
        run needed more than `config.extent_max_covers` covers and its
        tail was not indexed."""
        host = not isinstance(key, torch.Tensor)
        with self._lock:
            self.state, res, uncovered = insert_extent(
                self.state, self.config, key, value, length)
            return type(res)(**{
                f: self._out(x, host, words=f.startswith("evicted"))
                for f, x in res._asdict().items()}), uncovered

    def get_extent(self, keys):
        """-> (values[B, 2] u64 words of each key's address, found[B])."""
        host = not isinstance(keys, torch.Tensor)
        out, found, b = self.get_extent_async(keys)
        return (self._out(out[:b], host),
                self._out(found[:b], host, words=False))

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
            return True

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

    # -- tier surface (no-ops on a flat pool) --

    def tier_stats(self) -> dict | None:
        """Per-tier counters (`hot_hits`, `promotions`, `demotions`,
        `balloon_*`, `migrated_bytes`, occupancy, the admission lanes) —
        None when flat."""
        with self._lock:
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
        with self._lock:
            if not _tiered(self.state):
                return None
            return tier_mod.balloon_state(self.state.pool,
                                          _tcfg(self.config).balloon_step)

    def balloon_grow(self, rows: int) -> bool:
        """Ensure at least `rows` free cold rows circulate (parked capacity
        returns first; rounded up to whole extents). False on a flat
        pool."""
        with self._lock:
            if not _tiered(self.state):
                return False
            tier_mod.grow(self.state.pool, self._balloon_rows(rows))
            return True

    def balloon_shrink(self, rows: int) -> bool:
        """Balloon the cold pool down by up to `rows` rows now (rounded up
        to whole extents). Free rows park first; then the coldest live
        rows are evicted, their pages degrading to legal misses. False on
        a flat pool."""
        with self._lock:
            if not _tiered(self.state):
                return False
            tier_mod.shrink(self.state.pool, self._balloon_rows(rows))
            return True

    def admit_state(self) -> dict | None:
        """The admission gate's snapshot (threshold, epoch progress,
        counter lanes); None when the pool is flat or has no gate."""
        with self._lock:
            pool = self.state.pool
            if not _tiered(self.state) or pool.admit_cm is None:
                return None
            return tier_mod.admit_state(
                pool, tier_mod.admit_cfg(pool, _tcfg(self.config)))

    def set_admit_threshold(self, value: int) -> bool:
        """Live admission-threshold write (clamped to >= 0). False when no
        gate is installed."""
        with self._lock:
            pool = self.state.pool
            if not _tiered(self.state) or pool.admit_cm is None:
                return False
            tier_mod.set_admit_threshold(pool, value)
            return True

    def stats(self) -> dict:
        with self._lock:
            vec = self.state.stats.cpu().numpy().astype(np.int64)
            d = dict(zip(STAT_NAMES, (int(x) for x in vec)))
            t = self.tier_stats()
        if t is not None:
            d.update(t)
        d["uptime_s"] = time.monotonic() - self._t0
        return d

    def print_stats(self) -> str:
        """Human stats dump (ref `PrintStats`)."""
        line = ", ".join(f"{k}={v}" for k, v in self.stats().items())
        print(f"[kv] {line}")
        return line
