"""Path hashing — binary-tree fallback levels packed into fused rows (twin
of `pmdfc_tpu/models/path.py`).

Reference: `server/src/path_hashing.{hpp,cpp}`: a tree of cells, level
i+1 halving level i, a key colliding at level i falling back to its
parent cell; two seeds give two fallback paths. As in the JAX package a
key's chain is the ancestor chain of its level-0 cell, and each depth-4
subtree packs into one 16-lane row: bank 0 rows hold levels 0-3 (lanes
0-7, 8-11, 12-13, 14; lane 15 is padding), bank 1 rows levels 4-7 over
the level-4 positions. Slot ids are dense base-15 (`row * 15 + lane`), so
`num_slots` — and the page pool it sizes — carries no pad lane.

Inserts claim cells in reference probe order (level-major, seed A before
B), the rank-0 claimant of a free cell winning. The JAX program runs the
two level-0 rounds at full width, compacts the survivors to B/4 for the
level-1 rounds and to B/16 for the rest, an overflowing stage running at
the width before it, each width picked under `lax.cond`. Every width
gives the same table and results (a round ranks and claims per key, in
batch order), so here all sixteen rounds run at the batch's width and no
host read picks one. Exhausting both paths drops the key. In place.
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
from pmdfc_tpu_torch.models.rowops import empty_table, first_lane, lean_miss_tail
from pmdfc_tpu_torch.utils.hashing import hash_u64
from pmdfc_tpu_torch.utils.keys import INVALID_I32, is_invalid
from pmdfc_tpu_torch.utils.u32 import M32, narrow, widen

SEED_A = 0x0A7B57ED
SEED_B = 0xB17C0DE5
LEVELS = 8
ROW = 16    # lanes per fused row (CELLS cells + 1 pad)
CELLS = 15  # addressable cells per row: slot ids are row * CELLS + lane


@dataclasses.dataclass
class PathState:
    table: torch.Tensor  # int32[R, 4*ROW] u32 bits: k0 | k1 | v0 | v1 blocks
    top: int = 128       # static: level-0 cells


def _top_cells(config: IndexConfig) -> int:
    # sum_{i<L} top/2^i ~= 2*top  =>  top ~= capacity/2, at least a full
    # depth-8 tree
    c = max(1 << (LEVELS - 1), config.capacity // 2)
    return 1 << (c - 1).bit_length() if c & (c - 1) else c


def _bank_rows(top: int) -> tuple[int, int]:
    return top >> 3, max(1, top >> 7)


def num_slots(config: IndexConfig) -> int:
    r0, r1 = _bank_rows(_top_cells(config))
    return (r0 + r1) * CELLS


def init(config: IndexConfig, device="cuda") -> PathState:
    top = _top_cells(config)
    r0, r1 = _bank_rows(top)
    return PathState(table=empty_table(r0 + r1, ROW, device), top=top)


def _locate(p: torch.Tensor, base_row: int):
    """(row, [lane_L0..lane_L3]) of the 4-level chain rooted at position p
    of the bank's top level."""
    return (p >> 3) + base_row, (p & 7, 8 + ((p >> 1) & 3),
                                 12 + ((p >> 2) & 1), torch.full_like(p, 14))


def _paths(top: int, keys: torch.Tensor):
    """Per seed: ((bank-0 row, lanes4), (bank-1 row, lanes4)); levels 4-7
    live in the bank-1 row of p4 = p0 >> 4."""
    r0, _ = _bank_rows(top)
    out = []
    for seed in (SEED_A, SEED_B):
        p0 = hash_u64(keys[..., 0], keys[..., 1], seed=seed) & (top - 1)
        out.append((_locate(p0, 0), _locate(p0 >> 4, r0)))
    return out


def _row_eq(rowdata: torch.Tensor, keys: torch.Tensor, lanes) -> torch.Tensor:
    """bool[B, ROW]: key match within the chain lanes of a gathered row."""
    ar = torch.arange(ROW, device=keys.device)[None, :]
    chain = ar == lanes[0][:, None]
    for ln in lanes[1:]:
        chain = chain | (ar == ln[:, None])
    return ((rowdata[:, 0:ROW] == keys[:, None, 0])
            & (rowdata[:, ROW:2 * ROW] == keys[:, None, 1])
            & chain & ~is_invalid(keys)[:, None])


def _masked_vals(rowdata: torch.Tensor, eq: torch.Tensor):
    """(v0, v1) int64 u32 values at the matching lane (0 without one)."""
    v0 = (widen(rowdata[:, 2 * ROW:3 * ROW]) * eq).sum(dim=1) & M32
    v1 = (widen(rowdata[:, 3 * ROW:4 * ROW]) * eq).sum(dim=1) & M32
    return v0, v1


def _probe(table: torch.Tensor, keys: torch.Tensor, chains):
    """Probe chains in order -> (hit, cell int64 or -1 (the last hit
    wins), v0, v1); the matching cells' values OR together (a key sits in
    one cell, which two chains may share)."""
    b = keys.shape[0]
    dev = keys.device
    hit = torch.zeros(b, dtype=torch.bool, device=dev)
    cell = torch.full((b,), -1, dtype=torch.int64, device=dev)
    v0 = torch.zeros(b, dtype=torch.int64, device=dev)
    v1 = torch.zeros_like(v0)
    for row, lanes in chains:
        rd = table[row]
        eq = _row_eq(rd, keys, lanes)
        h = eq.any(dim=1)
        w0, w1 = _masked_vals(rd, eq)
        v0, v1 = v0 | w0, v1 | w1
        cell = torch.where(h, row * CELLS + first_lane(eq), cell)
        hit = hit | h
    return hit, cell, v0, v1


def _values(found, v0, v1):
    return torch.where(found[:, None], narrow(torch.stack([v0, v1], -1)), 0)


def get_batch(state: PathState, keys: torch.Tensor) -> GetResult:
    """Full GET: all four rows gathered."""
    (a0, a1), (b0, b1) = _paths(state.top, keys)
    found, cell, v0, v1 = _probe(state.table, keys, (a0, b0, a1, b1))
    return GetResult(values=_values(found, v0, v1), found=found,
                     slots=cell.to(torch.int32))


def get_values(state: PathState, keys: torch.Tensor):
    """Lean GET: the bank-0 rows of both seeds; a bank-0 miss takes what
    the bank-1 rows hold (`rowops.lean_miss_tail`)."""
    (a0, a1), (b0, b1) = _paths(state.top, keys)
    found, _, v0, v1 = _probe(state.table, keys, (a0, b0))
    f1, _, w0, w1 = _probe(state.table, keys, (a1, b1))
    return lean_miss_tail(~found & ~is_invalid(keys), _values(found, v0, v1),
                          found, narrow(torch.stack([w0, w1], -1)), f1)


def _cand(top: int, keys: torch.Tensor):
    """The 16 candidate (row, lane) pairs in reference probe order:
    level-major, seed A before seed B."""
    (a0, a1), (b0, b1) = _paths(top, keys)
    return ([(ch[0], ch[1][lvl]) for lvl in range(4) for ch in (a0, b0)]
            + [(ch[0], ch[1][lvl]) for lvl in range(4) for ch in (a1, b1)])


def _write_cells(table, rows, lanes, keys, values, mask) -> None:
    r, ln = rows[mask], lanes[mask]
    table[r, ln] = keys[mask, 0]
    table[r, ROW + ln] = keys[mask, 1]
    table[r, 2 * ROW + ln] = values[mask, 0]
    table[r, 3 * ROW + ln] = values[mask, 1]


def _claim_rounds(table, cands, keys, values, active, slots, j0, j1):
    """Claim rounds [j0, j1) of the candidates `cands`, in place ->
    (active, slots). The rank-0 claimant of each free cell wins; the losers
    fall to their next candidate. Occupancy is read from the live table,
    so a claim of this batch is seen by the next round."""
    for j in range(j0, j1):
        row, lane = cands[j]
        cell = row * CELLS + lane
        free = (table[row, lane] == INVALID_I32) \
            & (table[row, ROW + lane] == INVALID_I32)
        can = active & free & (batch_rank_by_segment(cell, active) == 0)
        _write_cells(table, row, lane, keys, values, can)
        slots = torch.where(can, cell.to(torch.int32), slots)
        active = active & ~can
    return active, slots


def insert_batch(state: PathState, keys: torch.Tensor, values: torch.Tensor):
    """In place -> (state, InsertResult); path hashing never evicts."""
    b = keys.shape[0]
    top, table = state.top, state.table
    winner = dedupe_last_wins(keys, ~is_invalid(keys))

    # update in place (the 4 chain rows, gathered once)
    (a0, a1), (b0, b1) = _paths(top, keys)
    mk = torch.where(winner[:, None], keys, INVALID_I32)
    u_hit, u_cell, _, _ = _probe(table, mk, (a0, b0, a1, b1))
    set_values(state, u_cell, values)  # u_cell is -1 where no update

    active = winner & ~u_hit
    slots = u_cell.to(torch.int32)  # -1 where no update
    # the JAX program's stages (level 0; level 1; levels 2-7), all at the
    # batch's width
    cands = _cand(top, keys)
    for j0, j1 in ((0, 2), (2, 4), (4, 16)):
        active, slots = _claim_rounds(table, cands, keys, values, active,
                                      slots, j0, j1)

    inv2 = torch.full((b, 2), INVALID_I32, dtype=torch.int32,
                      device=keys.device)
    return state, InsertResult(slots=slots, evicted=inv2, dropped=active,
                               fresh=(slots >= 0) & ~u_hit,
                               evicted_vals=inv2.clone())


def delete_batch(state: PathState, keys: torch.Tensor):
    """In place -> (state, hit[B], old_vals[B, 2] (INVALID where no hit))."""
    (a0, a1), (b0, b1) = _paths(state.top, keys)
    hit, cell, v0, v1 = _probe(state.table, keys, (a0, b0, a1, b1))
    old_vals = torch.where(hit[:, None], narrow(torch.stack([v0, v1], -1)),
                           INVALID_I32)
    c = cell.clamp(min=0)
    r, ln = (c // CELLS)[hit], (c % CELLS)[hit]
    state.table[r, ln] = INVALID_I32
    state.table[r, ROW + ln] = INVALID_I32
    return state, hit, old_vals


def set_values(state: PathState, slots: torch.Tensor, values: torch.Tensor):
    """Overwrite value lanes at base-15 slots (slot -1 ⇒ no-op), in place."""
    ok = slots >= 0
    sl = slots[ok].to(torch.int64)
    r, ln = sl // CELLS, sl % CELLS
    state.table[r, 2 * ROW + ln] = values[ok, 0]
    state.table[r, 3 * ROW + ln] = values[ok, 1]
    return state


def scan(state: PathState):
    """Slot-aligned flatten of the CELLS real lanes per row: scan position
    == slot id."""
    t = state.table

    def block(lo):
        return t[:, lo:lo + CELLS].reshape(-1)

    return (torch.stack([block(0), block(ROW)], -1),
            torch.stack([block(2 * ROW), block(3 * ROW)], -1))


register_index(
    IndexKind.PATH,
    IndexOps(
        init=init,
        get_batch=get_batch,
        insert_batch=insert_batch,
        delete_batch=delete_batch,
        num_slots=num_slots,
        set_values=set_values,
        scan=scan,
        get_values=get_values,
        rows_per_get=2,  # bank-0 rows of both seeds (bank 1 only on miss)
        gather_row_slots=ROW,
    ),
)
