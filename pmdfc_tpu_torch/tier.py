"""Tiered page store: hot/cold pools, LRFU migration, capacity ballooning
(twin of `pmdfc_tpu/tier.py`).

One backing array holds both tiers: global rows [0, H) are HOT (H =
slots // `hot_fraction`, at least 16), rows [H, H+C) are COLD, one per
index slot. The index stores one row id per entry, so the tiered GET is
one gather, as over the flat pool; migration changes an entry's row id
through the index's `set_values` and nothing else.

- Placement (`on_get`, after every counting GET): hot hits bump the
  policy metric (lru / lfu / fifo), cold hits bump a per-row touch
  counter; a cold row reaching `promote_touches` (or a key in the ghost
  ring of recently demoted keys) promotes into a free hot row or over the
  min-metric victim, whose page and digest move into the vacated cold row.
  Digests travel with the page and are never recomputed.
- Admission (`TierConfig.admit`, W-TinyLFU): a count-min sketch with a
  doorkeeper and periodic halving; a candidate below the threshold, or
  whose estimate does not beat its victim's, keeps its cold row, unless
  the ghost ring vouches for it. Its leaves exist only with the gate.
- Ballooning: cold rows circulate in `balloon_step` extents; a forced
  `shrink` parks free rows, then evicts the coldest live ones. Every cold
  entry value carries its row's GENERATION in the hi word ([gen, row]; the
  top two bits stay the kv tag space), and an eviction bumps the
  generation, so a stale entry reads as a legal miss and never frees or
  overwrites the row under a new owner (`entry_current`).

In place, like the rest of the port: every verb updates the state's
tensors in place (the full-size backing array is 9 GiB and is never
copied) and returns the same state. The JAX program skips the migration
block and the sketch fold under `lax.cond` when nothing qualifies; here
they always run, since on an empty mask every write is masked out, so no
decision reads a flag back from the card. Every gather that JAX orders
before a write to the same tensor stays before it.

u32 leaves (`hot_keys`, `metric`, `tick`, `touch`, `ghost`, `gcur`,
`cgen`, `admit_cm`, `admit_ops`, `admit_thresh`) are int32 bits; their
sorts and compares widen to int64 first (`utils/u32.py`), and every
victim sort is stable, as `jnp.argsort` is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pmdfc_tpu_torch.config import AdmitConfig, TierConfig
from pmdfc_tpu_torch.models.base import dedupe_last_wins
from pmdfc_tpu_torch.ops import pagepool
from pmdfc_tpu_torch.utils import u32
from pmdfc_tpu_torch.utils.hashing import hash_u64
from pmdfc_tpu_torch.utils.keys import INVALID_I32, INVALID_WORD, is_invalid
from pmdfc_tpu_torch.utils.u32 import M32, narrow, widen

# tier stats vector layout (a leaf of the state)
(T_HOT_HITS, T_COLD_HITS, T_PROMOTIONS, T_DEMOTIONS, T_GHOST_READMITS,
 T_BALLOON_GROWS, T_BALLOON_SHRINKS, T_SHRINK_EVICTIONS,
 T_MIGRATED_PAGES) = range(9)
TIER_STAT_NAMES = [
    "hot_hits", "cold_hits", "promotions", "demotions", "ghost_readmits",
    "balloon_grows", "balloon_shrinks", "shrink_evictions", "migrated_pages",
]
NTSTATS = len(TIER_STAT_NAMES)

# admission-gate stats vector (its own leaf, present only with the gate)
(A_DENIED, A_VICTIM_KEPT, A_GHOST_OVERRIDE, A_AGE_EPOCHS) = range(4)
ADMIT_STAT_NAMES = ["admit_denied", "admit_victim_kept",
                    "admit_ghost_override", "admit_age_epochs"]
NASTATS = len(ADMIT_STAT_NAMES)

# admission hash family: CM rows and doorkeeper lanes each their own salt
_ADMIT_CM_SEEDS = (0x0AD317C5, 0x0AD317C5 ^ 0x9E3779B9)
_ADMIT_DOOR_SEEDS = (0xD00A11CE, 0xD00A11CE ^ 0x85EBCA6B)

_GEN_MASK = 0x3FFFFFFF  # gens live below the kv façade's tag bits


@dataclasses.dataclass
class TierState:
    # ONE backing array for both tiers: global rows [0, H) hot, [H, H+C)
    # cold. Row stacks hold GLOBAL row ids; the per-cold-row planes are
    # indexed LOCALLY (crow = row - H).
    pages: torch.Tensor     # int32[H+C, W] u32 bits
    sums: torch.Tensor      # int32[H+C] digest sidecar bits
    hfree: torch.Tensor     # int32[H] hot free stack (global ids < H)
    htop: torch.Tensor      # int32[]
    cfree: torch.Tensor     # int32[C] cold free stack (global ids >= H)
    ctop: torch.Tensor      # int32[]
    hot_keys: torch.Tensor  # int32[H, 2] u32 bits: owning key (INVALID = free)
    metric: torch.Tensor    # int32[H] u32 bits: eviction metric
    tick: torch.Tensor      # int32[] u32 bits: logical clock, one per GET
    touch: torch.Tensor     # int32[C] u32 bits: per-cold-row reuse counter
    live: torch.Tensor      # bool[C] row holds servable bytes
    pmask: torch.Tensor     # bool[C] row is parked (ballooned out)
    parked: torch.Tensor    # int32[C] stack of parked GLOBAL row ids
    ptop: torch.Tensor      # int32[] parked stack depth
    hwm: torch.Tensor       # int32[] materialized-cold-row high-water mark
    ghost: torch.Tensor     # int32[G, 2] u32 bits: recently demoted keys
    gcur: torch.Tensor      # int32[] u32 bits: ghost ring cursor
    cgen: torch.Tensor      # int32[C] u32 bits: per-cold-row generation
    tstats: torch.Tensor    # int32[NTSTATS]
    # TinyLFU admission gate: these exist iff the config carries a gate
    admit_cm: torch.Tensor | None = None      # int32[2, W] u32 bits
    admit_door: torch.Tensor | None = None    # bool[D] doorkeeper bloom
    admit_ops: torch.Tensor | None = None     # int32[] u32 bits
    admit_thresh: torch.Tensor | None = None  # int32[] u32 bits
    admit_stats: torch.Tensor | None = None   # int32[NASTATS]


def num_hot_rows(num_slots: int, cfg: TierConfig) -> int:
    return max(16, num_slots // cfg.hot_fraction)


def _h(ts: TierState) -> int:
    return ts.hfree.shape[0]


def _c(ts: TierState) -> int:
    return ts.cfree.shape[0]


def _i32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=device)


def init_admission(acfg: AdmitConfig, device="cuda") -> dict:
    """Fresh (empty) admission-gate leaves."""
    return {
        "admit_cm": torch.zeros((2, acfg.sketch_width), dtype=torch.int32,
                                device=device),
        "admit_door": torch.zeros(acfg.door_bits, dtype=torch.bool,
                                  device=device),
        "admit_ops": _i32(0, device),
        "admit_thresh": narrow(torch.tensor(acfg.threshold, device=device)),
        "admit_stats": torch.zeros(NASTATS, dtype=torch.int32, device=device),
    }


def init(num_slots: int, page_words: int, cfg: TierConfig,
         device="cuda") -> TierState:
    h = num_hot_rows(num_slots, cfg)
    c = num_slots
    ci = c if cfg.cold_init_rows is None else min(
        max(int(cfg.cold_init_rows), 1), c)
    cfree = np.zeros(c, np.int32)
    cfree[:ci] = h + np.arange(ci - 1, -1, -1, dtype=np.int32)
    i32 = dict(dtype=torch.int32, device=device)
    return TierState(
        **(init_admission(cfg.admit, device) if cfg.admit is not None
           else {}),
        pages=torch.zeros((h + c, page_words), **i32),
        sums=torch.zeros(h + c, **i32),
        hfree=torch.arange(h - 1, -1, -1, **i32),
        htop=_i32(h, device),
        cfree=torch.from_numpy(cfree).to(device),
        ctop=_i32(ci, device),
        hot_keys=torch.full((h, 2), INVALID_I32, **i32),
        metric=torch.zeros(h, **i32),
        tick=_i32(0, device),
        touch=torch.zeros(c, **i32),
        live=torch.zeros(c, dtype=torch.bool, device=device),
        pmask=torch.zeros(c, dtype=torch.bool, device=device),
        parked=torch.zeros(c, **i32),
        ptop=_i32(0, device),
        hwm=_i32(ci, device),
        ghost=torch.full((max(1, cfg.ghost_rows), 2), INVALID_I32, **i32),
        gcur=_i32(0, device),
        cgen=torch.zeros(c, **i32),
        tstats=torch.zeros(NTSTATS, **i32),
    )


# ---------------------------------------------------------------------------
# masked scatters and clamped gathers (the JAX programs' semantics)
# ---------------------------------------------------------------------------

def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] with idx clamped into t, as a JAX gather clamps."""
    return t[idx.to(torch.int64).clamp(0, t.shape[0] - 1)]


def _put(t: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, vals) -> None:
    """t[idx] = vals where mask, in place; an index past the end writes
    nothing (the JAX scatters' mode="drop"). `vals` is a scalar or a
    0-d tensor, or one value per lane."""
    ok = mask & (idx < t.shape[0])
    if isinstance(vals, torch.Tensor) and vals.dim():
        vals = vals[ok]
    t[idx[ok].to(torch.int64)] = vals


def _add(t: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> None:
    """t[idx] += 1 where mask, in place, accumulating repeated indices (the
    JAX `.at[].add`); past-the-end indices drop. Masked-off lanes add 0 at
    a valid index, so nothing is read back from the device. `index_add_`
    adds with atomics (integer sums, so the order does not matter);
    `index_put_(accumulate=True)` sorts the indices first, which took 0.6
    ms a call on a 2^21-row plane."""
    ok = mask & (idx >= 0) & (idx < t.shape[0])
    t.index_add_(0, torch.where(ok, idx, 0).to(torch.int64), ok.to(t.dtype))


def _cnt(m: torch.Tensor) -> torch.Tensor:
    return m.sum(dtype=torch.int32)


def _rank(m: torch.Tensor) -> torch.Tensor:
    """0-based rank of each True lane among the True lanes (batch order)."""
    return torch.cumsum(m.to(torch.int32), 0, dtype=torch.int32) - 1


def _sort_u32(m: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of u32 words `m`, lanes outside `keep` last
    (as 0xFFFFFFFF): `jnp.argsort(where(keep, m, INVALID))`. Ties are the
    common case (zero counters, equal ticks), so the sort is stable and
    unsigned."""
    return torch.argsort(torch.where(keep, widen(m), M32), stable=True)


# ---------------------------------------------------------------------------
# row verbs (the pagepool surface, over the split row space)
# ---------------------------------------------------------------------------

def _split(ts: TierState, rows: torch.Tensor):
    """Global rows -> (in_hot, in_cold, cold-local crow); -1 rides through
    False/False."""
    h = _h(ts)
    in_hot = (rows >= 0) & (rows < h)
    in_cold = rows >= h
    crow = torch.where(in_cold, rows - h, -1)
    return in_hot, in_cold, crow


def read_batch(ts: TierState, rows: torch.Tensor) -> torch.Tensor:
    """ONE gather over the shared backing array, as the flat pool's."""
    return pagepool.read_batch(ts.pages, rows)


def row_live(ts: TierState, rows: torch.Tensor) -> torch.Tensor:
    """Whether each row may serve bytes: hot rows always, cold rows while
    `live` (a ballooned-out row reads as a miss, never wrong bytes)."""
    in_hot, in_cold, crow = _split(ts, rows)
    return in_hot | (in_cold & _take(ts.live, crow))


def stored_sums(ts: TierState, rows: torch.Tensor) -> torch.Tensor:
    return torch.where(rows >= 0, _take(ts.sums, rows), 0)


def live_mask(ts: TierState) -> np.ndarray:
    """Host bool[H+C] liveness over the global row space: hot rows always
    live, cold rows per the `live` bitmap."""
    h = _h(ts)
    out = np.ones(h + ts.live.shape[0], bool)
    out[h:] = ts.live.cpu().numpy()
    return out


def verify_batch(ts: TierState, rows: torch.Tensor,
                 pages_out: torch.Tensor) -> torch.Tensor:
    """ok[B] — `pagepool.verify_batch`'s contract over global rows."""
    return row_live(ts, rows) & (pagepool.page_digest(pages_out)
                                 == stored_sums(ts, rows))


def row_values(ts: TierState, rows: torch.Tensor) -> torch.Tensor:
    """[B, 2] index values for global rows: [generation, row]. Hot rows
    carry gen 0, cold rows their current generation; row -1 gives [0, 0]
    (callers mask the slot, not the value)."""
    _, in_cold, crow = _split(ts, rows)
    gen = torch.where(in_cold, _take(ts.cgen, crow), 0)
    return torch.stack([gen, rows.clamp(min=0)], dim=-1)


def entry_current(ts: TierState, vals: torch.Tensor) -> torch.Tensor:
    """True where a page-row value's generation matches its row's current
    one: a stale value must read as a legal miss and never free or
    overwrite the row. Meaningful only for non-special values."""
    h, c = _h(ts), _c(ts)
    rows = vals[..., 1].to(torch.int64)
    in_cold = (rows >= h) & (rows < h + c)
    gen_ok = vals[..., 0] == _take(ts.cgen, rows - h)
    return torch.where(in_cold, gen_ok, vals[..., 0] == 0)


def write_rows(ts: TierState, rows: torch.Tensor, batch: torch.Tensor,
               digs: torch.Tensor) -> TierState:
    """Scatter pages and digests at global rows (-1 drops), in place; cold
    targets become live with a fresh reuse history."""
    _, in_cold, crow = _split(ts, rows)
    pagepool.write_batch(ts.pages, rows, batch)
    pagepool.write_sums(ts.sums, rows, digs)
    _put(ts.live, crow, in_cold, True)
    _put(ts.touch, crow, in_cold, 0)
    return ts


# ---------------------------------------------------------------------------
# ballooning (dynamic cold capacity)
# ---------------------------------------------------------------------------

def _grow_if_pressed(ts: TierState, cfg: TierConfig,
                     want_mask: torch.Tensor) -> TierState:
    """Materialize cold rows in `balloon_step` units when the free stack
    cannot cover this batch's demand plus the low-water headroom. Parked
    rows return first, then never-circulated rows above the high-water
    mark."""
    step = cfg.balloon_step
    gmax = want_mask.shape[0] + cfg.grow_free_rows + step  # lane bound
    h, c = _h(ts), _c(ts)
    need = _cnt(want_mask) + cfg.grow_free_rows
    deficit = (need - ts.ctop).clamp(min=0)
    amount = (deficit + step - 1) // step * step  # extent-sized steps
    headroom = ts.ptop + (c - ts.hwm)
    amount = torch.minimum(amount, headroom).clamp(max=gmax)
    i = torch.arange(gmax, dtype=torch.int32, device=want_mask.device)
    from_parked = torch.minimum(amount, ts.ptop)
    take_parked = i < from_parked
    prow = _take(ts.parked, ts.ptop - 1 - i)  # global ids
    row = torch.where(take_parked, prow, h + ts.hwm + (i - from_parked))
    ok = i < amount
    _put(ts.cfree, ts.ctop + i, ok, row)
    _put(ts.pmask, prow - h, take_parked & ok, False)
    ts.tstats[T_BALLOON_GROWS] += (amount > 0).to(torch.int32)
    ts.ctop += amount
    ts.ptop -= from_parked
    ts.hwm += amount - from_parked
    return ts


def _auto_park(ts: TierState, cfg: TierConfig) -> TierState:
    """Shrink on surplus: when the free stack holds more than
    `shrink_free_rows` spare rows, park one `balloon_step` of them (free
    rows only)."""
    step = cfg.balloon_step
    h = _h(ts)
    do = ts.ctop >= cfg.shrink_free_rows + step
    amount = torch.where(do, step, 0).to(torch.int32)
    i = torch.arange(step, dtype=torch.int32, device=ts.ctop.device)
    ok = i < amount
    row = _take(ts.cfree, ts.ctop - 1 - i)  # global ids
    _put(ts.parked, ts.ptop + i, ok, row)
    _put(ts.pmask, row - h, ok, True)
    ts.tstats[T_BALLOON_SHRINKS] += do.to(torch.int32)
    ts.ctop -= amount
    ts.ptop += amount
    return ts


def shrink(ts: TierState, k: int) -> TierState:
    """Forced balloon-down by up to `k` rows now, in place. Free rows park
    first; the rest evicts the COLDEST live rows (min touch, stable): their
    bytes degrade to legal misses, and their generations bump, so the
    entries left behind are stale (`entry_current`) and can neither read
    nor free the row once it recirculates."""
    h, c = _h(ts), _c(ts)
    i = torch.arange(k, dtype=torch.int32, device=ts.ctop.device)
    from_free = ts.ctop.clamp(max=k)
    take_free = i < from_free
    frow = _take(ts.cfree, ts.ctop - 1 - i)      # global ids
    cand = ts.live & ~ts.pmask
    order = _sort_u32(ts.touch, cand)
    j = i - from_free
    vloc = _take(order, j).to(torch.int32)       # local ids
    v_ok = ~take_free & (j < _cnt(cand))
    row = torch.where(take_free, frow, h + vloc)
    ok = take_free | v_ok  # prefix mask: free rows first, then victims
    _put(ts.parked, ts.ptop + i, ok, row)
    _put(ts.pmask, row - h, ok, True)
    _put(ts.live, vloc, v_ok, False)
    _put(ts.cgen, vloc, v_ok, (_take(ts.cgen, vloc) + 1) & _GEN_MASK)
    n_parked = _cnt(ok)
    ts.tstats[T_BALLOON_SHRINKS] += (n_parked > 0).to(torch.int32)
    ts.tstats[T_SHRINK_EVICTIONS] += _cnt(v_ok)
    ts.ctop -= from_free
    ts.ptop += n_parked
    return ts


def grow(ts: TierState, rows: int) -> TierState:
    """Forced balloon-up, in place: at least `rows` FREE cold rows in
    circulation. Parked rows return first, then fresh ones."""
    want = torch.zeros(rows, dtype=torch.bool, device=ts.ctop.device)
    return _grow_if_pressed(
        ts, TierConfig(balloon_step=1, grow_free_rows=rows), want)


# ---------------------------------------------------------------------------
# allocation (the fused push-grow-pop over the cold stack)
# ---------------------------------------------------------------------------

def recycle_and_alloc(ts: TierState, cfg: TierConfig,
                      freed_mask: torch.Tensor, freed_rows: torch.Tensor,
                      want_mask: torch.Tensor, *, balloon: bool = True):
    """Tier analog of `pagepool.recycle_and_alloc` over GLOBAL row ids, in
    place -> (ts, rows[B], -1 where not wanted or exhausted).

    Freed rows return to their own tier's stack (hot frees also clear the
    row's ownership); fresh rows always come from COLD. Between push and
    pop the balloon may grow under pressure (and park surplus after).
    `balloon=False` skips that for push-only call sites. Callers
    generation-guard `freed_rows` (`entry_current`)."""
    h = _h(ts)
    in_hot, in_cold, crow = _split(ts, freed_rows)
    f_hot = freed_mask & in_hot
    # a parked row's id may still sit in a stale entry: its eviction or
    # delete must not re-circulate it
    f_cold = freed_mask & in_cold & ~_take(ts.pmask, crow)

    # hot push + ownership clear
    _put(ts.hfree, ts.htop + _rank(f_hot), f_hot, freed_rows)
    ts.htop += _cnt(f_hot)
    _put(ts.hot_keys, freed_rows, f_hot, INVALID_I32)
    _put(ts.metric, freed_rows, f_hot, 0)

    # cold push
    _put(ts.cfree, ts.ctop + _rank(f_cold), f_cold, freed_rows)
    ts.ctop += _cnt(f_cold)
    _put(ts.live, crow, f_cold, False)
    _put(ts.touch, crow, f_cold, 0)

    if balloon:
        _grow_if_pressed(ts, cfg, want_mask)

    # cold pop
    pop_pos = ts.ctop - 1 - _rank(want_mask)
    ok = want_mask & (pop_pos >= 0)
    rows = torch.where(ok, _take(ts.cfree, pop_pos), -1)
    ts.ctop -= _cnt(ok)
    if balloon and cfg.shrink_free_rows:
        _auto_park(ts, cfg)
    return ts, rows


# ---------------------------------------------------------------------------
# TinyLFU admission gate (frequency sketch + doorkeeper + aging)
# ---------------------------------------------------------------------------

def admit_cfg(ts: TierState, cfg: TierConfig) -> AdmitConfig | None:
    """Effective admission config of a built state: the state's leaves
    decide whether there is a gate; the config (or the defaults) its
    knobs."""
    if ts.admit_cm is None:
        return None
    return cfg.admit if cfg.admit is not None else AdmitConfig()


def _admit_cm_slots(acfg: AdmitConfig, keys: torch.Tensor) -> torch.Tensor:
    """int64[2, B] count-min column per hash row."""
    return torch.stack([hash_u64(keys[..., 0], keys[..., 1], seed=s)
                        % acfg.sketch_width for s in _ADMIT_CM_SEEDS])


def _admit_door_slots(acfg: AdmitConfig, keys: torch.Tensor) -> torch.Tensor:
    """int64[2, B] doorkeeper bit positions."""
    return torch.stack([hash_u64(keys[..., 0], keys[..., 1], seed=s)
                        % acfg.door_bits for s in _ADMIT_DOOR_SEEDS])


def admit_estimate(ts: TierState, acfg: AdmitConfig,
                   keys: torch.Tensor) -> torch.Tensor:
    """int64[B] u32 frequency estimate: min over the CM rows plus the
    doorkeeper bit; INVALID lanes estimate 0."""
    c = _admit_cm_slots(acfg, keys)
    d = _admit_door_slots(acfg, keys)
    est = torch.minimum(widen(ts.admit_cm[0, c[0]]),
                        widen(ts.admit_cm[1, c[1]]))
    kept = ts.admit_door[d[0]] & ts.admit_door[d[1]]
    est = (est + kept.to(torch.int64)) & M32
    return torch.where(is_invalid(keys), 0, est)


def admit_observe(ts: TierState, acfg: AdmitConfig, keys: torch.Tensor,
                  mask: torch.Tensor) -> TierState:
    """Fold one batch of key touches into the sketch, in place: a key's
    first touch of the epoch sets its doorkeeper bits, later ones count in
    the CM rows (repeats accumulate). When the epoch's `reset_ops` touches
    are spent every CM counter halves and the doorkeeper clears."""
    mask = mask & ~is_invalid(keys)
    d = _admit_door_slots(acfg, keys)
    kept = ts.admit_door[d[0]] & ts.admit_door[d[1]]
    inc = mask & kept          # already doorkept: count in the CM
    first = mask & ~kept       # first touch this epoch: doorkeeper
    _put(ts.admit_door, d[0], first, True)
    _put(ts.admit_door, d[1], first, True)
    c = _admit_cm_slots(acfg, keys)
    _add(ts.admit_cm[0], c[0], inc)
    _add(ts.admit_cm[1], c[1], inc)
    ops_ct = widen(ts.admit_ops) + mask.sum()
    age = mask.any() & (ops_ct >= acfg.reset_ops)
    cm = ts.admit_cm
    cm.copy_(torch.where(age, (cm >> 1) & 0x7FFFFFFF, cm))  # logical shift
    ts.admit_door &= ~age
    ts.admit_stats[A_AGE_EPOCHS] += age.to(torch.int32)
    ts.admit_ops.copy_(narrow(torch.where(age, 0, ops_ct)))
    return ts


def set_admit_threshold(ts: TierState, value: int) -> TierState:
    """Live threshold write, in place."""
    ts.admit_thresh.fill_(narrow(torch.tensor(max(0, int(value)))).item())
    return ts


def admit_counters_dict(astats) -> dict:
    """The admission-counter naming rule (ADMIT_STAT_NAMES zip)."""
    return dict(zip(ADMIT_STAT_NAMES,
                    (int(x) for x in torch.as_tensor(astats).tolist())))


def admit_state(ts: TierState, acfg: AdmitConfig) -> dict:
    """Host snapshot of the gate: live threshold, epoch progress and the
    counter lanes."""
    d = admit_counters_dict(ts.admit_stats)
    d.update({
        "threshold": int(widen(ts.admit_thresh)),
        "ops": int(widen(ts.admit_ops)),
        "reset_ops": int(acfg.reset_ops),
        "epochs": d["admit_age_epochs"],
    })
    return d


# ---------------------------------------------------------------------------
# the GET-side migration program
# ---------------------------------------------------------------------------

def _fresh_metric(cfg: TierConfig, tick: torch.Tensor):
    # policy_cache semantics: LFU counts from 1, the tick policies stamp
    # the clock
    return 1 if cfg.hot_policy == "lfu" else tick


def on_get(ops, index, ts: TierState, cfg: TierConfig, keys: torch.Tensor,
           slots: torch.Tensor, rows: torch.Tensor, pages_out: torch.Tensor,
           found: torch.Tensor):
    """Hotness bookkeeping + batched migration after a counting GET, in
    place -> (index, ts).

    Inputs are the GET batch's index results (`slots`, `rows` the resolved
    global rows, `pages_out` the verified pages, `found` the hit mask).
    Every batch: hot hits bump the policy metric, cold hits their touch
    counters (repeats accumulate), the tick advances; with a gate, the
    batch's keys fold into the sketch first. Then `_migrate` promotes the
    qualifying lanes (a no-op when none qualifies)."""
    rows_f = torch.where(found, rows, -1)
    in_hot, in_cold, crow = _split(ts, rows_f)
    tick = narrow(widen(ts.tick) + 1)

    if cfg.hot_policy == "lru":
        _put(ts.metric, rows_f, in_hot, tick)
    elif cfg.hot_policy == "lfu":
        _add(ts.metric, rows_f, in_hot)
    # fifo: placement order only
    _add(ts.touch, crow, in_cold)

    valid = ~is_invalid(keys)
    ghit = ((ts.ghost[None, :, 0] == keys[:, None, 0])
            & (ts.ghost[None, :, 1] == keys[:, None, 1])).any(dim=1) & valid

    # the batch's touches fold into the sketch FIRST, so a key on its
    # threshold-crossing batch reads its full count
    acfg = admit_cfg(ts, cfg)
    est = None
    if acfg is not None:
        admit_observe(ts, acfg, keys, dedupe_last_wins(keys, valid))
        est = admit_estimate(ts, acfg, keys)

    # one promotion per distinct key (two lanes of one key share a row)
    winner = dedupe_last_wins(keys, in_cold)
    tcount = widen(_take(ts.touch, crow))
    promo_want = in_cold & winner & (ghit | (tcount >= cfg.promote_touches))
    if acfg is not None:
        # scan-flood block: a non-ghost candidate below the threshold
        # keeps serving from its cold row
        pass_t = ghit | (est >= widen(ts.admit_thresh))
        ts.admit_stats[A_DENIED] += _cnt(promo_want & ~pass_t)
        promo_want = promo_want & pass_t
    prank = _rank(promo_want)
    promo = promo_want & (prank < cfg.max_promotes_per_batch)

    ts.tstats[T_HOT_HITS] += _cnt(in_hot)
    ts.tstats[T_COLD_HITS] += _cnt(in_cold)
    ts.tick.copy_(tick)
    _migrate(ops, index, ts, cfg, acfg, keys, slots, rows_f, pages_out,
             promo, prank, ghit, est)
    return index, ts


def _migrate(ops, index, ts: TierState, cfg: TierConfig, acfg, keys, slots,
             rows_f, pages_out, promo, prank, ghit, est) -> None:
    """The promotion/demotion block of `on_get` (JAX: `_go`, run under
    `lax.cond(promo.any())`), in place. Every write is masked by `promo`,
    so with no promoted lane it changes nothing."""
    h, c = _h(ts), _c(ts)
    g = ts.ghost.shape[0]
    in_hot, _, crow = _split(ts, rows_f)

    # hot targets: free rows first (pops), then min-metric victims
    nfree = ts.htop
    use_free = promo & (prank < nfree)
    hfree_rows = _take(ts.hfree, nfree - 1 - prank)
    need_vic = promo & ~use_free
    vrank = _rank(need_vic)
    hit_now = torch.zeros(h, dtype=torch.bool, device=keys.device)
    _put(hit_now, rows_f, in_hot, True)
    occ = ~is_invalid(ts.hot_keys) & ~hit_now  # never victimize a row
    order = _sort_u32(ts.metric, occ)          # this batch just hit
    vrow = _take(order, vrank).to(torch.int32)  # hot row = global row
    avail = need_vic & (vrank < _cnt(occ))
    if acfg is not None:
        # the W-TinyLFU duel: the incumbent keeps its slot unless the
        # candidate's estimate STRICTLY beats it; a ghost hit overrides
        vk_all = torch.where(avail[:, None],
                             _take(ts.hot_keys, torch.where(avail, vrow, 0)),
                             INVALID_I32)
        vest = admit_estimate(ts, acfg, vk_all)
        v_win = ghit | (est > vest)
        v_ok = avail & v_win
        kept = avail & ~v_win
    else:
        v_ok = avail
    hrow_new = torch.where(use_free, hfree_rows, vrow)
    promo2 = use_free | v_ok

    # victim side: pages + digests move verbatim; every gather here lands
    # before the scatters below write the same tensors
    vsafe = torch.where(v_ok, vrow, 0).to(torch.int64)
    vkeys = torch.where(v_ok[:, None], ts.hot_keys[vsafe], INVALID_I32)
    vpages = ts.pages[vsafe]
    vsums = ts.sums[vsafe]
    psums = _take(ts.sums, rows_f)  # before the demote scatter lands

    # demoted pages land in the cold rows the promotions vacate (a swap)
    dest_v = torch.where(v_ok, rows_f, -1)
    pagepool.write_batch(ts.pages, dest_v, vpages)
    pagepool.write_sums(ts.sums, dest_v, vsums)
    _put(ts.touch, crow, v_ok, 0)

    # free-row promotions vacate their cold row outright
    f_cold = promo2 & ~v_ok
    _put(ts.cfree, ts.ctop + _rank(f_cold), f_cold, rows_f)
    ts.ctop += _cnt(f_cold)
    _put(ts.live, crow, f_cold, False)
    _put(ts.touch, crow, f_cold, 0)

    # hot side: scatter the already-verified gathered pages
    hrows_w = torch.where(promo2, hrow_new, -1)
    pagepool.write_batch(ts.pages, hrows_w, pages_out)
    pagepool.write_sums(ts.sums, hrows_w, psums)
    ts.htop -= _cnt(use_free & promo2)
    _put(ts.hot_keys, hrow_new, promo2, keys)
    _put(ts.metric, hrow_new, promo2, _fresh_metric(cfg, ts.tick))

    # the ghost ring remembers the demoted keys (one touch readmits)
    gpos = ((widen(ts.gcur) + vrank) & M32) % g
    _put(ts.ghost, gpos, v_ok, vkeys)
    ts.gcur.copy_(narrow(widen(ts.gcur) + v_ok.sum()))

    # index re-point: promoted entries -> hot row (gen 0)
    ops.set_values(index, torch.where(promo2, slots, -1),
                   torch.stack([torch.zeros_like(hrow_new), hrow_new], -1))
    # demoted entries -> their new cold row (found by key: hot_keys is
    # coherent with the index)
    vres = ops.get_batch(index, vkeys)
    ops.set_values(index, torch.where(v_ok & vres.found, vres.slots, -1),
                   row_values(ts, rows_f))
    # a victim whose key is gone from the index: free the cold row its
    # bytes landed in instead of leaking it
    orphan = v_ok & ~vres.found
    _put(ts.cfree, ts.ctop + _rank(orphan), orphan, rows_f)
    ts.ctop += _cnt(orphan)
    _put(ts.live, crow, orphan, False)

    n_promo, n_demo = _cnt(promo2), _cnt(v_ok)
    ts.tstats[T_PROMOTIONS] += n_promo
    ts.tstats[T_DEMOTIONS] += n_demo
    ts.tstats[T_GHOST_READMITS] += _cnt(promo2 & ghit)
    ts.tstats[T_MIGRATED_PAGES] += n_promo + n_demo
    if acfg is not None:
        # ghost overrides: promotions the frequency evidence alone would
        # have refused
        freq_just = (est >= widen(ts.admit_thresh)) & (
            use_free | (avail & (est > vest)))
        ts.admit_stats[A_VICTIM_KEPT] += _cnt(kept)
        ts.admit_stats[A_GHOST_OVERRIDE] += _cnt(promo2 & ghit & ~freq_just)


# ---------------------------------------------------------------------------
# host-side reporting
# ---------------------------------------------------------------------------

def stats_arrays(ts: TierState) -> dict:
    """Small host fetches for reporting (tstats vector + occupancy and
    balloon scalars)."""
    return {
        "tstats": ts.tstats.cpu().numpy(),
        "hot_rows": _h(ts),
        "hot_occupied": int((~is_invalid(ts.hot_keys)).sum()),
        "cold_rows": _c(ts),
        "cold_circulating": int(ts.hwm) - int(ts.ptop),
        "cold_free": int(ts.ctop),
        "tick": int(widen(ts.tick)),
    }


def balloon_state(ts: TierState, step: int) -> dict:
    """The balloon snapshot: circulating vs parked cold rows, the free
    stack depth, and the extent step one move covers."""
    return {
        "cold_rows": _c(ts),
        "circulating": int(ts.hwm) - int(ts.ptop),
        "parked": int(ts.ptop),
        "free": int(ts.ctop),
        "step": int(step),
    }


def counters_dict(tstats, page_bytes: int) -> dict:
    """The tier-counter naming rule (TIER_STAT_NAMES zip) plus
    `migrated_bytes = migrated_pages * page_bytes`."""
    d = dict(zip(TIER_STAT_NAMES, (int(x) for x in np.asarray(tstats))))
    d["migrated_bytes"] = d["migrated_pages"] * page_bytes
    return d


def stats_dict(ts: TierState, page_bytes: int) -> dict:
    """The per-tier counter surface, plus the admission lanes with the
    gate."""
    a = stats_arrays(ts)
    d = counters_dict(a["tstats"], page_bytes)
    d.update({k: a[k] for k in (
        "hot_rows", "hot_occupied", "cold_rows", "cold_circulating",
        "cold_free")})
    if ts.admit_stats is not None:
        d.update(admit_counters_dict(ts.admit_stats))
        d["admit_threshold"] = int(widen(ts.admit_thresh))
    return d


def hot_heat_arrays(hot_keys: np.ndarray, metric: np.ndarray, tick: int,
                    lam: float = 0.1) -> float:
    """CRF-style combined recency over host arrays (u32 words): the sum
    over occupied hot rows of 0.5^(lam * (tick - metric))."""
    occ = ~np.all(hot_keys == INVALID_WORD, axis=-1)
    if not occ.any():
        return 0.0
    age = np.maximum(int(tick) - metric[occ].astype(np.int64), 0)
    return float(np.sum(np.power(0.5, lam * age)))


def hot_heat(ts: TierState, lam: float = 0.1) -> float:
    """`hot_heat_arrays` over a live TierState."""
    return hot_heat_arrays(u32.to_numpy(ts.hot_keys), u32.to_numpy(ts.metric),
                           int(widen(ts.tick)), lam)
