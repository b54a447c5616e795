"""CCEH — cacheline-conscious extendible hashing (twin of
`pmdfc_tpu/models/cceh.py`), and with `msb=False` the classic LSB
extendible hashing of `models/extendible.py`.

Reference: `server/CCEH_hybrid.{h,cpp}`: 16 KB segments probed through a
32-slot window (`CCEH_hybrid.h:14-19`), MSB directory, segment split
(`CCEH_hybrid.cpp:30-67`), directory doubling (`:198-295`) and `Recovery`
(`:391-410`); the DRAM CCEH's eviction on unsplittable overflow
(`server/src/cceh.h:169`).

Layout and algorithm as in the JAX package: a segment is `W` rows of the
fused `[khi | klo | vhi | vlo]` layout (`models/rowops.py`); the directory
`dirr[Smax]` is stored replicated to the maximum depth `Gmax`, so lookups
never depend on the global depth and doubling is a scalar bump; an insert
runs rounds of (place into free lanes, split every overflowing segment,
at most `k_splits` at once), then a tail that fills what the last split
opened and evicts an occupant not placed by this batch.

In place. `insert_batch`, `delete_batch`, `set_values` and `recovery`
update the state's tensors in place and return the same state. Every
gather that JAX orders before a write stays before it here (`_attempt`
reads the rows before it scatters; `_split_round` reads the source
blocks before it writes the buddies and the sources).

Rounds without a branch on the card's data. JAX loops while some winner
is unplaced (`lax.while_loop`), splits only when a round overflowed and
runs the eviction tail only when keys are left (`lax.cond`). Each of
those skipped passes leaves every leaf unchanged when its mask is empty
(an empty round places nothing, a split with no segment to split moves
nothing, a tail with nothing pending evicts nothing and returns the
`no_evict_stub` payload), so here every round and the tail always run:
the results are the same, and no control decision reads a flag back
from the card. (The masked writes index with boolean masks, as the
linear index's do, and each such index counts its rows on the host.)
"""

from __future__ import annotations

import dataclasses

import torch

from pmdfc_tpu_torch.config import IndexConfig, IndexKind
from pmdfc_tpu_torch.models.base import (
    GetResult,
    IndexOps,
    InsertResult,
    batch_rank_by_segment,
    dedupe_last_wins,
    register_index,
)
from pmdfc_tpu_torch.models.rowops import (
    first_lane,
    free_lanes,
    lane_pick,
    match_mask,
    match_rows,
    no_evict_stub,
    nth_lane,
    pick_kv,
    scatter_entry,
)
from pmdfc_tpu_torch.utils.hashing import hash_u64
from pmdfc_tpu_torch.utils.keys import INVALID_I32, is_invalid
from pmdfc_tpu_torch.utils.u32 import widen

WINDOW_SEED = 0x77AA55EE  # window hash family, independent of directory bits


@dataclasses.dataclass
class CCEHState:
    table: torch.Tensor   # int32[R, 4*P] u32 bits, fused rows; R = Smax * W
    ld: torch.Tensor      # int32[Smax] (u32 in JAX) local depth per segment
    dirr: torch.Tensor    # int32[Smax] replicated directory: prefix -> segment
    gdepth: torch.Tensor  # int32[] (u32 in JAX) global depth
    nseg: torch.Tensor    # int32[] allocated segment count
    # static knobs (not leaves; from the config)
    k_splits: int = 64
    rounds: int = 3
    msb: bool = True      # MSB directory (CCEH) vs LSB (extendible hashing)


@dataclasses.dataclass(frozen=True)
class _Geom:
    P: int      # probe window lanes per row
    W: int      # rows (windows) per segment
    Gmax: int   # max depth
    Smax: int   # max segments = 2**Gmax
    R: int      # total rows
    K: int      # max splits per round
    rounds: int
    msb: bool


def _geom(state: CCEHState) -> _Geom:
    r, lanes = state.table.shape
    smax = state.ld.shape[0]
    return _Geom(P=lanes // 4, W=r // smax, Gmax=smax.bit_length() - 1,
                 Smax=smax, R=r, K=state.k_splits, rounds=state.rounds,
                 msb=state.msb)


def _init_geom(config: IndexConfig):
    p = config.probe_window
    w = max(1, config.segment_slots // p)
    s0 = max(1, config.capacity // (w * p))
    if s0 & (s0 - 1):
        s0 = 1 << (s0 - 1).bit_length()
    g0 = s0.bit_length() - 1
    gmax = max(1, g0 + config.split_headroom)
    return p, w, s0, g0, gmax, 1 << gmax


def num_slots(config: IndexConfig) -> int:
    p, w, _, _, _, smax = _init_geom(config)
    return smax * w * p


def static_fields(config: IndexConfig) -> dict:
    """The state's static knobs for a config (they are not leaves)."""
    smax = _init_geom(config)[5]
    return dict(k_splits=min(config.max_splits_per_round, smax),
                rounds=config.split_headroom + 2)


def init(config: IndexConfig, msb: bool = True, device="cuda") -> CCEHState:
    p, w, s0, g0, gmax, smax = _init_geom(config)
    table = torch.zeros((smax * w, 4 * p), dtype=torch.int32, device=device)
    table[:, :2 * p] = INVALID_I32
    i = torch.arange(smax, dtype=torch.int32, device=device)
    ld = torch.where(i < s0, g0, 0).to(torch.int32)
    # prefix i's g0 directory bits (top for MSB, low for LSB) name its segment
    dirr = (i >> (gmax - g0)) if msb else (i & (s0 - 1))
    return CCEHState(
        table=table, ld=ld, dirr=dirr,
        gdepth=torch.tensor(g0, dtype=torch.int32, device=device),
        nseg=torch.tensor(s0, dtype=torch.int32, device=device),
        msb=msb, **static_fields(config))


def _locate(g: _Geom, dirr: torch.Tensor, hdir: torch.Tensor,
            hwin: torch.Tensor) -> torch.Tensor:
    """int64[B] table row: the directory entry's segment, then the window."""
    idx = (hdir >> (32 - g.Gmax)) if g.msb else (hdir & (g.Smax - 1))
    return dirr[idx].to(torch.int64) * g.W + hwin


def _hashes(g: _Geom, keys: torch.Tensor):
    hdir = hash_u64(keys[..., 0], keys[..., 1])
    hwin = hash_u64(keys[..., 0], keys[..., 1], seed=WINDOW_SEED) & (g.W - 1)
    return hdir, hwin


def _values(rows, eq, p):
    return torch.stack([lane_pick(rows, eq, 2 * p, p),
                        lane_pick(rows, eq, 3 * p, p)], dim=-1)


def get_batch(state: CCEHState, keys: torch.Tensor) -> GetResult:
    g = _geom(state)
    row = _locate(g, state.dirr, *_hashes(g, keys))
    rows = state.table[row]
    eq, lane = match_rows(rows, keys, g.P)
    found = lane >= 0
    gslot = torch.where(found, (row * g.P + lane.clamp(min=0)).to(torch.int32),
                        -1)
    return GetResult(values=_values(rows, eq, g.P), found=found, slots=gslot)


def get_values(state: CCEHState, keys: torch.Tensor):
    """Lean GET: (values[B, 2] zero on miss, found[B]), no slot math."""
    g = _geom(state)
    rows = state.table[_locate(g, state.dirr, *_hashes(g, keys))]
    eq = match_mask(rows, keys, g.P)
    return _values(rows, eq, g.P), eq.any(dim=1)


def _split_round(g: _Geom, state: CCEHState, want: torch.Tensor) -> None:
    """Split every flagged segment (at most K, capacity permitting) at
    once, in place. `want: bool[Smax]`."""
    table, dirr = state.table, state.dirr
    dev = want.device
    ld_old = state.ld.clone()  # pre-split depths (the directory math needs them)
    nseg = state.nseg.to(torch.int64)
    can = want & (ld_old < g.Gmax)
    srank = torch.cumsum(can, 0) - 1
    avail = torch.clamp(g.Smax - nseg, max=g.K)
    doit = can & (srank < avail)

    # compact the <= K splitting segment ids
    seg_list = torch.full((g.K,), -1, dtype=torch.int64, device=dev)
    seg_list[srank[doit]] = torch.arange(g.Smax, device=dev)[doit]
    ok = seg_list >= 0
    ld_old_k = widen(ld_old[seg_list.clamp(min=0)])

    # move entries whose next hash bit is 1 into the buddy segment
    warange = torch.arange(g.W, device=dev)
    src_rows = seg_list.clamp(min=0)[:, None] * g.W + warange[None, :]
    blocks = table[src_rows]                                  # [K, W, 4P]
    khi, klo = blocks[..., 0:g.P], blocks[..., g.P:2 * g.P]
    occupied = ~((khi == INVALID_I32) & (klo == INVALID_I32))
    hb = hash_u64(khi, klo)
    shift_e = (31 - ld_old_k) if g.msb else ld_old_k
    bit = (hb >> shift_e[:, None, None]) & 1
    move = occupied & (bit == 1) & ok[:, None, None]

    move4 = move.repeat(1, 1, 4)
    keymask4 = torch.zeros_like(move4)
    keymask4[..., :2 * g.P] = True
    # buddy gets the moved entries, INVALID keys elsewhere (values don't matter)
    tgt_blocks = torch.where(move4, blocks,
                             torch.where(keymask4, INVALID_I32, blocks))
    # source keeps the entries that stay, moved keys cleared
    src_after = torch.where(move4 & keymask4, INVALID_I32, blocks)

    new_ids = nseg + torch.arange(g.K, device=dev)            # [K]
    tgt_rows = new_ids[:, None] * g.W + warange[None, :]
    table[tgt_rows[ok]] = tgt_blocks[ok]
    table[src_rows[ok]] = src_after[ok]

    # depths: the split segment and its buddy both deepen to ld_old + 1
    ld = torch.where(doit, ld_old + 1, ld_old)
    ld[new_ids[ok]] = (ld_old_k[ok] + 1).to(torch.int32)
    state.ld.copy_(ld)
    state.gdepth.copy_(torch.maximum(state.gdepth,
                                     torch.where(doit, ld, 0).max()))
    new_of_seg = torch.zeros(g.Smax, dtype=torch.int64, device=dev)
    new_of_seg[seg_list[ok]] = new_ids[ok]

    # directory: prefixes owned by s whose bit at ld_old[s] is 1 -> buddy
    i = torch.arange(g.Smax, device=dev)
    s_i = dirr.to(torch.int64)
    ld_s = ld_old[s_i].to(torch.int64)
    # clamped: the MSB shift only matters where doit (ld_old < Gmax)
    shift = (g.Gmax - 1 - ld_s).clamp(min=0) if g.msb else ld_s
    move_dir = doit[s_i] & (((i >> shift) & 1) == 1)
    dirr.copy_(torch.where(move_dir, new_of_seg[s_i], s_i).to(torch.int32))
    state.nseg += doit.sum(dtype=torch.int32)


def _attempt(g: _Geom, state: CCEHState, keys, values, hashes, slots, fresh,
             pending):
    """Place pending keys: update in place where the key is present, else
    take a free lane of its window (ranked within the batch). Updates
    `table`, `slots` and `fresh` in place; -> (left over pending, row)."""
    table = state.table
    row = _locate(g, state.dirr, *hashes)
    rows = table[row]  # read before this round's writes
    mk = torch.where(pending[:, None], keys, INVALID_I32)
    _, lane = match_rows(rows, mk, g.P)
    upd = pending & (lane >= 0)
    l_u = lane[upd].to(torch.int64)
    table[row[upd], 2 * g.P + l_u] = values[upd, 0]
    table[row[upd], 3 * g.P + l_u] = values[upd, 1]
    slots.copy_(torch.where(upd, row * g.P + lane.clamp(min=0), slots))

    new = pending & ~upd
    rank = batch_rank_by_segment(row, new)
    free = free_lanes(rows, g.P)
    can = new & (rank < free.sum(dim=1))
    lane_t = first_lane(nth_lane(free, rank))
    scatter_entry(table, row, lane_t, keys, values, g.P, can)
    slots.copy_(torch.where(can, row * g.P + lane_t, slots))
    fresh |= can
    return new & ~can, row


def insert_batch(state: CCEHState, keys: torch.Tensor, values: torch.Tensor):
    """Batched insert, in place; -> (state, InsertResult). Every round and
    the eviction tail always run (see the module docstring)."""
    g = _geom(state)
    b, dev = keys.shape[0], keys.device
    winner = dedupe_last_wins(keys, ~is_invalid(keys))
    hashes = _hashes(g, keys)
    slots = torch.full((b,), -1, dtype=torch.int64, device=dev)
    fresh = torch.zeros(b, dtype=torch.bool, device=dev)

    for _ in range(g.rounds):
        overflow, row = _attempt(g, state, keys, values, hashes, slots, fresh,
                                 winner & (slots < 0))
        want = torch.zeros(g.Smax, dtype=torch.bool, device=dev)
        want[row[overflow] // g.W] = True
        _split_round(g, state, want)
        # placed entries may have moved: the lane survives a split, the
        # row does not
        row2 = _locate(g, state.dirr, *hashes)
        slots.copy_(torch.where(slots >= 0, row2 * g.P + slots % g.P, slots))

    # tail: fill what the last split opened, then evict — never a lane
    # placed or updated by this batch
    still, row = _attempt(g, state, keys, values, hashes, slots, fresh,
                          winner & (slots < 0))
    placed = slots >= 0
    lane_p = slots[placed] % g.P
    # a u32 bit mask per row: a lane past 31 sets no bit, as in JAX
    bits = torch.where(lane_p < 32, 1 << lane_p.clamp(max=31), 0)
    prot_bits = torch.zeros(g.R, dtype=torch.int64, device=dev)
    prot_bits.index_put_((slots[placed] // g.P,), bits, accumulate=True)
    rows2 = state.table[row]
    lanes = torch.arange(g.P, device=dev)[None, :]
    prot = ((prot_bits[row][:, None] >> lanes) & 1).bool()
    cand = ~free_lanes(rows2, g.P) & ~prot
    erank = batch_rank_by_segment(row, still)
    place = still & (erank < cand.sum(dim=1))
    hot = nth_lane(cand, erank) & place[:, None]
    lane_e = first_lane(hot)
    ek, ev = pick_kv(rows2, hot, g.P)
    no_ek, no_ev, _, _ = no_evict_stub(b, dev)
    evicted = torch.where(place[:, None], ek, no_ek)
    evicted_vals = torch.where(place[:, None], ev, no_ev)
    scatter_entry(state.table, row, lane_e, keys, values, g.P, place)
    slots = torch.where(place, row * g.P + lane_e, slots)
    return state, InsertResult(
        slots=slots.to(torch.int32), evicted=evicted, dropped=still & ~place,
        fresh=fresh | place, evicted_vals=evicted_vals)


def delete_batch(state: CCEHState, keys: torch.Tensor):
    """In place; -> (state, hit[B], old_vals[B, 2] (INVALID where no hit))."""
    g = _geom(state)
    row = _locate(g, state.dirr, *_hashes(g, keys))
    rows = state.table[row]
    eq, lane = match_rows(rows, keys, g.P)
    hit = lane >= 0
    old_vals = torch.where(hit[:, None], _values(rows, eq, g.P), INVALID_I32)
    rd, ln = row[hit], lane[hit].to(torch.int64)
    state.table[rd, ln] = INVALID_I32
    state.table[rd, g.P + ln] = INVALID_I32
    return state, hit, old_vals


def set_values(state: CCEHState, slots: torch.Tensor, values: torch.Tensor):
    """Overwrite value lanes at global slots (slot -1 ⇒ no-op), in place."""
    p = state.table.shape[1] // 4
    ok = slots >= 0
    sl = slots[ok].to(torch.int64)
    r, lane = sl // p, sl % p
    state.table[r, 2 * p + lane] = values[ok, 0]
    state.table[r, 3 * p + lane] = values[ok, 1]
    return state


def scan(state: CCEHState):
    """(flat_keys[N, 2], flat_vals[N, 2]) view of every slot."""
    p = state.table.shape[1] // 4
    t = state.table
    keys = torch.stack([t[:, 0:p].reshape(-1), t[:, p:2 * p].reshape(-1)], -1)
    vals = torch.stack([t[:, 2 * p:3 * p].reshape(-1),
                        t[:, 3 * p:4 * p].reshape(-1)], -1)
    return keys, vals


def recovery(state: CCEHState) -> CCEHState:
    """Directory repair after restore (ref `CCEH::Recovery`
    `server/CCEH_hybrid.cpp:391-410`), in place: every entry of a
    segment's replication class takes the class's canonical entry (the
    block start for MSB, the residue mod 2**ld for LSB)."""
    g = _geom(state)
    i = torch.arange(g.Smax, device=state.dirr.device)
    ld_s = state.ld[state.dirr.to(torch.int64)].to(torch.int64)
    if g.msb:
        start = i & ~((1 << (g.Gmax - ld_s)) - 1)
    else:
        start = i & ((1 << ld_s) - 1)
    state.dirr.copy_(state.dirr[start])
    state.gdepth.copy_(state.ld[state.dirr.to(torch.int64)].max())
    return state


OPS = dict(get_batch=get_batch, insert_batch=insert_batch,
           delete_batch=delete_batch, num_slots=num_slots,
           set_values=set_values, scan=scan, recovery=recovery,
           get_values=get_values)

register_index(IndexKind.CCEH, IndexOps(init=init, **OPS))
