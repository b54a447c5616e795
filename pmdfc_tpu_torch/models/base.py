"""Index-op result types, the index registry and the batched insert plan
(twin of `pmdfc_tpu/models/base.py`).

Reference interface: `IHash` (`server/IHash.h:10-24`) lifted to
fixed-shape batches; INVALID (padding) keys are no-ops.

Sort order. `jnp.lexsort` orders u32 words unsigned and is stable; the
plan's ranks (and with them the FIFO lanes, slot ids and evictions) hang
on both. Here a (hi, lo) pair sorts as ONE int64 key whose top word is
`hi` with its sign bit flipped (so signed int64 order is unsigned (hi, lo)
order), in stable `torch.sort` passes from the least to the most
significant key.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, NamedTuple

import torch

from pmdfc_tpu_torch.config import IndexConfig, IndexKind
from pmdfc_tpu_torch.utils.u32 import widen


class GetResult(NamedTuple):
    values: torch.Tensor  # int32[B, 2] u32 bits; zero where not found
    found: torch.Tensor   # bool[B]
    slots: torch.Tensor   # int32[B] global slot id; -1 if miss


class InsertResult(NamedTuple):
    slots: torch.Tensor         # int32[B] slot the key landed in; -1 if not placed
    evicted: torch.Tensor       # int32[B, 2] keys evicted to make room (INVALID if none)
    dropped: torch.Tensor       # bool[B] the key itself was dropped (legal)
    fresh: torch.Tensor         # bool[B] the key landed in a NEW slot
    evicted_vals: torch.Tensor  # int32[B, 2] values of evicted entries


@dataclasses.dataclass(frozen=True)
class IndexOps:
    """Vtable for one index family (fields as in the JAX package)."""

    init: Callable[..., Any]
    get_batch: Callable[..., GetResult]
    insert_batch: Callable[..., tuple]
    delete_batch: Callable[..., tuple]
    num_slots: Callable[[IndexConfig], int]
    set_values: Callable[..., Any] | None = None
    scan: Callable[[Any], tuple] | None = None
    # post-restart directory repair (ref `CCEH::Recovery`); None where an
    # index needs none
    recovery: Callable[[Any], Any] | None = None
    # (state, hit_slots[B]) -> state: access-heat bookkeeping on a counting
    # GET (hotring's counter bump); the KV calls it when set
    touch: Callable[..., Any] | None = None
    # state -> state: periodic heat drain (hotring's counter halving and
    # hot-point shift), every `IndexConfig.decay_every_gets` GET keys
    decay: Callable[[Any], Any] | None = None
    get_values: Callable[..., tuple] | None = None
    # rows one GET probes and the slots of each gathered row (None: the
    # config's cluster width), the test_kv roofline's metadata
    rows_per_get: int = 1
    gather_row_slots: int | None = None


_REGISTRY: dict[IndexKind, IndexOps] = {}


def register_index(kind: IndexKind, ops: IndexOps) -> None:
    _REGISTRY[kind] = ops


_MODULES = {
    IndexKind.LINEAR: "pmdfc_tpu_torch.models.linear",
    IndexKind.CCEH: "pmdfc_tpu_torch.models.cceh",
    IndexKind.CUCKOO: "pmdfc_tpu_torch.models.cuckoo",
    IndexKind.CUCKOO_PROBING: "pmdfc_tpu_torch.models.cuckoo_probing",
    IndexKind.LEVEL: "pmdfc_tpu_torch.models.level",
    IndexKind.PATH: "pmdfc_tpu_torch.models.path",
    IndexKind.EXTENDIBLE: "pmdfc_tpu_torch.models.extendible",
    IndexKind.STATIC: "pmdfc_tpu_torch.models.static",
    IndexKind.HOTRING: "pmdfc_tpu_torch.models.hotring",
}


def get_index_ops(kind: IndexKind) -> IndexOps:
    """The family's ops; its module is imported (and registers) on first
    use."""
    if kind not in _REGISTRY:
        importlib.import_module(_MODULES[kind])
    return _REGISTRY[kind]


def compact_mask(mask: torch.Tensor, width: int):
    """Gather plan for compacting the True lanes of `mask[B]` into a
    width-W buffer (the straggler-round idiom of cuckoo's kick loop) ->
    `(idx, in_w, safe, overflow)`:

    - `idx[W]` int64: original positions of the first W True lanes (B pads);
    - `in_w[W]`: which buffer lanes are real;
    - `safe[W]`: `idx` clamped for gathering (`x[safe]`, then mask);
    - `overflow[B]`: True lanes that did not fit.

    `jnp.nonzero(size=W)` would sync the host and give a dynamic shape
    here, so each True lane scatters its position to its running count
    (a cumsum) in a W + 1 buffer whose last lane takes the rest."""
    b = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    fits = mask & (pos < width)
    idx = torch.full((width + 1,), b, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, torch.where(fits, pos, width),
                 torch.arange(b, device=mask.device))
    idx = idx[:width]
    in_w = idx < b
    return idx, in_w, idx.clamp(max=b - 1), mask & ~fits


class InsertPlan(NamedTuple):
    """Products of ONE sort serving both dedupe and segment ranking
    (see the JAX package's `InsertPlan`)."""

    order: torch.Tensor      # int64[B]: sorted positions (original indices)
    seg_start: torch.Tensor  # bool[B] in SORTED space: first row of a run
    winner: torch.Tensor     # bool[B] in ORIGINAL space: last dup occurrence


def _key64(keys: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the unsigned (hi, lo) order."""
    hi = keys[..., 0].to(torch.int64) ^ (-(1 << 31))  # flip hi's sign bit
    return (hi << 32) | widen(keys[..., 1])


def _stable_lexsort(*cols: torch.Tensor) -> torch.Tensor:
    """`jnp.lexsort` for int64 columns: the LAST column is the primary key."""
    order = torch.argsort(cols[0], stable=True)
    for col in cols[1:]:
        order = order[torch.argsort(col[order], stable=True)]
    return order


def _scatter_back(order: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(sorted_vals)
    out[order] = sorted_vals
    return out


def batch_rank_by_segment(segment_ids: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """int32[B]: rank of each masked element among the masked elements
    with the same segment id, in batch order (one stable sort; masked-off
    elements sort last, as INVALID, and get arbitrary ranks). Ids are
    taken as u32 and widened to int64, so INVALID sorts after every id."""
    b = segment_ids.shape[0]
    key = torch.where(mask, widen(segment_ids), 0xFFFFFFFF)
    order = torch.argsort(key, stable=True)
    s_key = key[order]
    idx = torch.arange(b, device=segment_ids.device)
    start = torch.ones_like(mask)
    start[1:] = s_key[1:] != s_key[:-1]
    first = torch.cummax(torch.where(start, idx, 0), 0).values
    return _scatter_back(order, (idx - first).to(torch.int32))


def plan_insert(keys: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                num_segments: int | None = None) -> InsertPlan:
    # the invalid flag rides bit 31 of the segment word
    if num_segments is not None and num_segments >= (1 << 31):
        raise ValueError(
            f"plan_insert: {num_segments} segments >= 2^31 would collide "
            "with the packed invalid bit")
    segp = seg.to(torch.int64) | ((~valid).to(torch.int64) << 31)
    k64 = _key64(keys)
    order = _stable_lexsort(k64, segp)
    s_k, s_segp = k64[order], segp[order]
    same_next = torch.zeros_like(valid)
    same_next[:-1] = (s_k[:-1] == s_k[1:]) & (s_segp[:-1] == s_segp[1:])
    winner = _scatter_back(order, ~same_next & ((s_segp >> 31) == 0))
    seg_start = torch.ones_like(valid)
    seg_start[1:] = s_segp[1:] != s_segp[:-1]
    return InsertPlan(order=order, seg_start=seg_start, winner=winner)


def plan_rank(plan: InsertPlan, mask: torch.Tensor) -> torch.Tensor:
    """int32[B]: 0-based rank of each masked row among masked rows of its
    segment (plan order); unmasked rows get 0x7FFFFFFF."""
    m = mask[plan.order].to(torch.int64)
    c = torch.cumsum(m, 0)
    base = torch.cummax(torch.where(plan.seg_start, c - m, 0), 0).values
    rank = _scatter_back(plan.order, c - m - base)
    return torch.where(mask, rank, 0x7FFFFFFF).to(torch.int32)


def dedupe_last_wins(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mask selecting, for each distinct valid key, its LAST occurrence."""
    inv = (~valid).to(torch.int64)
    k64 = _key64(keys)
    order = _stable_lexsort(k64, inv)  # (inv, hi, lo), stable by position
    s_k, s_inv = k64[order], inv[order]
    same_next = torch.zeros_like(valid)
    same_next[:-1] = (s_k[:-1] == s_k[1:]) & (s_inv[:-1] == s_inv[1:])
    return _scatter_back(order, ~same_next) & valid
