"""Fused serving GET: probe→gather→verify→classify in ONE launch
(twin of `pmdfc_tpu/ops/fused.py`: the linear index and CCEH, over the
flat or the tiered pool).

Three pieces:

- `fused_get` — the wrapper. On CUDA tensors it launches the hand-written
  Hopper kernel `csrc/fused_get.cu` (and raises if the launch fails); on
  CPU tensors it runs `get_core_reference`. There is no fallback between
  the two: the device of the tensors decides. Given a CCEH directory
  (`dirr`) it runs a cceh variant, else a linear one; given the tiered
  pool's sidecars (`cgen`, `live`, `hot_rows`) a tiered one, else flat.
- `get_core_reference` — the plain PyTorch version, same inputs and
  outputs, the kernel's arithmetic written as tensor ops.
- `get_core` — the drop-in twin of `kv._get_core` for configurations
  `supports()` accepts: the wrapper, the tiered pool's migration
  epilogue `tier.on_get` (composed torch after the kernel, as it stays
  composed XLA after the Pallas kernel), then the stats fold in int32.

Per key (stages as in the JAX module's docstring): murmur3 address fold
(linear: bucket = hash & (C - 1); CCEH: directory entry of the hash's top
`Gmax` bits (MSB) or low bits (LSB), times `W`, plus the window hash)
and two evicted-sketch slots; bucket-row lane match with masked-sum
values; tag split (flat: EXTENT by the exact tag word; tiered: `vhi >>
30`, 3 = NOPAGE, any other nonzero = EXTENT, since the hi word of a page
entry is its generation); tiered: the generation gate (STALE) and the
liveness gate (PARKED, also for a row word >= 2^31); page + digest-word
gather at the row clamped into the pool; digest recompute; one cause
code, later codes winning; misses zeroed.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from pmdfc_tpu_torch import tier as tier_mod
from pmdfc_tpu_torch.config import IndexKind, KVConfig
from pmdfc_tpu_torch.models.base import get_index_ops
from pmdfc_tpu_torch.models.cceh import WINDOW_SEED
from pmdfc_tpu_torch.models.rowops import first_lane, lane_pick, match_mask
from pmdfc_tpu_torch.ops.pagepool import page_digest
from pmdfc_tpu_torch.utils.hashing import hash_u64
from pmdfc_tpu_torch.utils.keys import is_invalid

# per-lane outcome codes (disjoint by construction; HIT ⟺ final found).
# PARKED and STALE occur only over the tiered pool.
(CAUSE_HIT, CAUSE_PAD, CAUSE_COLD, CAUSE_EVICTED, CAUSE_EXT,
 CAUSE_PARKED, CAUSE_STALE, CAUSE_DIGEST) = range(8)

SKETCH_SEEDS = (0x0E51C7ED, 0x0E51C7ED ^ 0x9E3779B9)
EXTENT_TAG = 0x80000000  # bit 63 of the u64 value marks an extent-record ref
EXTENT_TAG_I32 = EXTENT_TAG - (1 << 32)  # its bits as int32

SECTOR = 32  # bytes: the least the card reads from memory for a scattered word

KERNEL_NAME = "fused_get"
FAMILIES = (IndexKind.LINEAR, IndexKind.CCEH)
# kernel launches made by `fused_get`, by variant ("fused_get_linear_flat",
# "fused_get_cceh_flat", "fused_get_linear_tiered", "fused_get_cceh_tiered"),
# for showing that a run went through the kernel; callers reset it
# themselves (`launches.clear()`)
launches: collections.Counter = collections.Counter()


def supports(config: KVConfig) -> bool:
    """Whether the fused GET serves this config: the linear index or CCEH
    (the families the JAX package fuses; extendible hashing is not one)
    over a paged flat or tiered pool, with power-of-two sketch bits and a
    power-of-two page width that is a multiple of 4 (the kernel moves
    pages as 16-byte vectors and XOR-folds lanes by halving). Everything
    else runs the composed GET (`kv._get_core`)."""
    if config.index.kind not in FAMILIES or not config.paged:
        return False
    pw, nb = config.page_words, config.evicted_sketch_bits
    return not (pw & (pw - 1) or pw % 4 or nb & (nb - 1))


def fused_get_bytes(causes, w: int, s: int, pw: int, sketch_bytes: int,
                    dir_bytes: int = 0, cold_rows: int = 0) -> int:
    """Least bytes one fused GET must move for a batch of `w` keys with
    these cause counts (indexed by the `CAUSE_*` codes): the keys in, the
    outputs out, and for each key only what its cause reads. Padding keys
    probe nothing; a scattered word costs one sector. CCEH reads a
    directory word per valid key first (at most the whole directory).
    Over the tiered pool a STALE key reads its cold row's generation,
    and each of the `cold_rows` keys past that gate reads the row's
    generation and live byte; PARKED and STALE keys read no page."""
    found = (causes[CAUSE_HIT] + causes[CAUSE_EXT] + causes[CAUSE_DIGEST]
             + causes[CAUSE_PARKED] + causes[CAUSE_STALE])
    index_miss = causes[CAUSE_COLD] + causes[CAUSE_EVICTED]
    valid = w - causes[CAUSE_PAD]
    page = causes[CAUSE_HIT] + causes[CAUSE_DIGEST]
    return (w * (8 + 4 * pw + 12)      # keys in; page, cause, row, slot out
            + min(dir_bytes, valid * SECTOR)  # the directory words
            + valid * 8 * s            # khi and klo halves of the table row
            + found * 2 * SECTOR       # vhi and vlo of the matching lane
            + page * (4 * pw + SECTOR)  # the page and its digest word
            + min(sketch_bytes, index_miss * 2 * SECTOR)  # two sketch bytes
            + (2 * cold_rows + causes[CAUSE_STALE]) * SECTOR)


def hit_bytes(state, w: int) -> int:
    """`fused_get_bytes` of a `w`-key batch over this KV state with every
    key a hit on a hot (or flat) row: the profiler's `cost.*` bytes."""
    index = state.index
    causes = [0] * 8
    causes[CAUSE_HIT] = w
    dirr = getattr(index, "dirr", None)
    return fused_get_bytes(
        causes, w, index.table.shape[1] // 4, state.pool.pages.shape[1],
        state.evicted_filter.numel(),
        dir_bytes=0 if dirr is None else 4 * dirr.numel())


def table_rows(keys, n_rows: int, dirr=None, msb: bool = True):
    """int64[w] table row of each key: the linear bucket `hash & (C - 1)`,
    or with a CCEH directory `dirr[Smax]` the segment of the hash's top
    `Gmax` bits (MSB) or low bits (LSB) times `W = R / Smax`, plus the
    window hash."""
    khi, klo = keys[:, 0], keys[:, 1]
    h = hash_u64(khi, klo)
    if dirr is None:
        return h & (n_rows - 1)
    smax = dirr.shape[0]
    w = n_rows // smax
    bucket = (h >> (32 - (smax.bit_length() - 1))) if msb else h & (smax - 1)
    win = hash_u64(khi, klo, seed=WINDOW_SEED) & (w - 1)
    return dirr[bucket].to(torch.int64) * w + win


def get_core_reference(keys, table, pages, sums, sketch, dirr=None,
                       msb=True, cgen=None, live=None, hot_rows=0):
    """Plain PyTorch version of the kernel.

    keys int32[w, 2], table int32[R, 4S], pages int32[NR, PW], sums
    int32[NR] (all u32 bits), sketch bool[nb], for CCEH the directory
    dirr int32[Smax] with its `msb` flag, and for the tiered pool the
    cold rows' sidecars cgen int32[CC] (u32 bits) and live bool[CC] with
    NR = hot_rows + CC -> (out int32[w, PW], cause int32[w], rows int32[w],
    slots int32[w]).
    """
    s = table.shape[1] // 4
    nr = pages.shape[0]
    nb = sketch.shape[0]
    khi, klo = keys[:, 0], keys[:, 1]
    c = table_rows(keys, table.shape[0], dirr, msb)
    sk0 = hash_u64(khi, klo, seed=SKETCH_SEEDS[0]) & (nb - 1)
    sk1 = hash_u64(khi, klo, seed=SKETCH_SEEDS[1]) & (nb - 1)

    brows = table[c]
    eq = match_mask(brows, keys, s)
    found0 = eq.any(dim=1)
    vhi = lane_pick(brows, eq, 2 * s, s)
    vlo = lane_pick(brows, eq, 3 * s, s)
    slots = torch.where(found0, (c * s + first_lane(eq)).to(torch.int32), -1)
    nopage = stale = dead = torch.zeros_like(found0)
    if cgen is None:
        ext = found0 & (vhi == EXTENT_TAG_I32)
        f2 = found0 & ~ext
    else:
        tag = (vhi >> 30) & 3
        nopage = found0 & (tag == 3)
        ext = found0 & (tag != 0) & ~nopage
        f1 = found0 & (tag == 0)
        # generation gate: a cold row carries its generation, any other
        # row gen 0 (`tier.entry_current`)
        h, cc = hot_rows, cgen.shape[0]
        r = vlo.to(torch.int64)
        crow = (r - h).clamp(0, cc - 1)
        ec_cold = (r >= h) & (r < h + cc)
        gen_ok = torch.where(ec_cold, vhi == cgen[crow], vhi == 0)
        stale = f1 & ~gen_ok
        f2 = f1 & gen_ok
        # liveness gate: hot rows always, cold rows per the live bitmap
        # (`tier.row_live`); a row word >= 2^31 is neither, so dead
        live_ok = ((r >= 0) & (r < h)) | ((r >= h) & live[crow])
        dead = f2 & ~live_ok

    readable = f2 & ~dead
    safe_row = torch.where(readable, vlo, 0).to(torch.int64).clamp(0, nr - 1)
    out = pages[safe_row]
    ok = (vlo >= 0) & (page_digest(out) == sums[safe_row])
    corrupt = readable & ~ok
    found = readable & ok
    rows = torch.where(f2, vlo, -1)

    valid = ~is_invalid(keys)
    idx_miss = valid & ~found0
    ev = idx_miss & sketch[sk0] & sketch[sk1]
    cause = torch.full_like(rows, CAUSE_HIT)
    cause = torch.where(~valid, CAUSE_PAD, cause)
    cause = torch.where(idx_miss & ~ev, CAUSE_COLD, cause)
    cause = torch.where(ev, CAUSE_EVICTED, cause)
    cause = torch.where(ext, CAUSE_EXT, cause)
    cause = torch.where(nopage | dead, CAUSE_PARKED, cause)
    cause = torch.where(stale, CAUSE_STALE, cause)
    cause = torch.where(corrupt, CAUSE_DIGEST, cause)
    out = torch.where(found[:, None], out, 0)
    return out, cause.to(torch.int32), rows, slots


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_ARGTYPES = {
    # keys, w, table, n_clusters, S, pages, n_rows, pw, sums, sketch,
    # sketch_bits, out, cause, rows, slots, stream
    "fused_get_linear_flat": "pipIipqippIppppp",
    # keys, w, table, n_table_rows, S, dirr, smax, msb, pages, n_rows, pw,
    # sums, sketch, sketch_bits, out, cause, rows, slots, stream
    "fused_get_cceh_flat": "pipIipIipqippIppppp",
    # the flat lists with cgen, live, hot_rows after sketch_bits
    "fused_get_linear_tiered": "pipIipqippIppqppppp",
    "fused_get_cceh_tiered": "pipIipIipqippIppqppppp",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "I": ctypes.c_uint,
           "q": ctypes.c_longlong}


def _entry(variant: str):
    from pmdfc_tpu_torch.ops import _build

    fn = getattr(_build.load(KERNEL_NAME), f"pmdfc_{variant}")
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in _ARGTYPES[variant]]
        fn.restype = ctypes.c_int
    return fn


def _pow2(name, n):
    if n < 1 or n & (n - 1):
        raise ValueError(f"{name} must be a power of two, got {n}")


def fused_get(keys, table, pages, sums, sketch, dirr=None, msb=True,
              cgen=None, live=None, hot_rows=None):
    """The fused GET over one padded batch; same contract as
    `get_core_reference`. With a CCEH directory `dirr` it is a cceh
    variant (`msb` picks the directory bits), else a linear one; with the
    tiered pool's `cgen`, `live` and `hot_rows` (all three or none) a
    tiered one, else flat. CPU tensors run the plain version; CUDA tensors
    launch the kernel, or raise."""
    w = keys.shape[0]
    r, lanes = table.shape
    nr, pw = pages.shape
    nb = sketch.shape[0]
    s = lanes // 4
    dev = keys.device
    _check("keys", keys, torch.int32, (w, 2), dev)
    _check("table", table, torch.int32, (r, lanes), dev)
    _check("pages", pages, torch.int32, (nr, pw), dev)
    _check("sums", sums, torch.int32, (nr,), dev)
    _check("sketch", sketch, torch.bool, (nb,), dev)
    _pow2("sketch bits", nb)
    _pow2("page words", pw)
    if s < 1 or lanes != 4 * s or pw % 4:
        raise ValueError(f"bad geometry: row width {lanes}, page words {pw}")
    tiered = cgen is not None
    if tiered != (live is not None) or tiered != (hot_rows is not None):
        raise ValueError("the tiered pool needs cgen, live and hot_rows")
    if tiered:
        hot_rows = int(hot_rows)
        cc = nr - hot_rows
        if hot_rows < 1 or cc < 1:
            raise ValueError(f"bad tiered pool: {hot_rows} hot rows of {nr}")
        _check("cgen", cgen, torch.int32, (cc,), dev)
        _check("live", live, torch.bool, (cc,), dev)
    pool = "tiered" if tiered else "flat"
    if dirr is None:
        variant = f"fused_get_linear_{pool}"
        _pow2("clusters", r)
    else:
        variant = f"fused_get_cceh_{pool}"
        smax = dirr.shape[0]
        _check("dirr", dirr, torch.int32, (smax,), dev)
        _pow2("directory entries", smax)
        if smax < 2 or smax > 1 << 31 or r % smax:
            raise ValueError(f"bad directory: {smax} entries over {r} rows")
    tier_args = dict(cgen=cgen, live=live, hot_rows=hot_rows) if tiered else {}
    if dev.type == "cpu":
        return get_core_reference(keys, table, pages, sums, sketch, dirr, msb,
                                  **tier_args)
    if dev.type != "cuda":
        raise ValueError(f"fused_get runs on cuda or cpu tensors, not {dev}")
    if pages.data_ptr() % 16:
        raise ValueError("pages must be 16-byte aligned")

    out = torch.empty((w, pw), dtype=torch.int32, device=dev)
    cause, rows, slots = (torch.empty(w, dtype=torch.int32, device=dev)
                          for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (keys.data_ptr(), w, table.data_ptr(), r, s)
        if dirr is not None:
            args += (dirr.data_ptr(), smax, int(msb))
        args += (pages.data_ptr(), nr, pw, sums.data_ptr(), sketch.data_ptr(),
                 nb)
        if tiered:
            args += (cgen.data_ptr(), live.data_ptr(), hot_rows)
        err = _entry(variant)(*args, out.data_ptr(), cause.data_ptr(),
                              rows.data_ptr(), slots.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{variant} kernel launch failed: CUDA error {err}")
    launches[variant] += 1
    return out, cause, rows, slots


def get_core(state, config: KVConfig, keys: torch.Tensor,
             lean: bool = False, recovering: bool = False):
    """Fused twin of `kv._get_core` for configs `supports()` accepts:
    (state, out, found), bit-identical outputs and stats. Writes nothing
    but `state.stats` (in place), except that a counting (`lean=False`)
    GET over the tiered pool then runs `tier.on_get`. `recovering` moves
    the batch's cold misses to `miss_recovering` on the bumps vector,
    after the kernel (which does not change)."""
    from pmdfc_tpu_torch import kv as kv_mod

    pool, index = state.pool, state.index
    cceh = config.index.kind == IndexKind.CCEH
    tiered = isinstance(pool, tier_mod.TierState)
    tier_args = dict(cgen=pool.cgen, live=pool.live,
                     hot_rows=pool.hfree.shape[0]) if tiered else {}
    out, cause, rows, slots = fused_get(
        keys, index.table, pool.pages, pool.sums, state.evicted_filter,
        dirr=index.dirr if cceh else None, msb=index.msb if cceh else True,
        **tier_args)
    found = cause == CAUSE_HIT
    valid = ~is_invalid(keys)
    if tiered and not lean:
        # hotness/migration epilogue: composed torch after the kernel
        tier_mod.on_get(get_index_ops(config.index.kind), index, pool,
                        kv_mod._tcfg(config), keys, slots, rows, out, found)

    def cnt(m):
        return m.sum(dtype=torch.int32)

    corrupt = cause == CAUSE_DIGEST
    bumps = torch.zeros(kv_mod.NSTATS, dtype=torch.int32, device=keys.device)
    bumps[kv_mod.GETS] = cnt(valid)
    bumps[kv_mod.HITS] = cnt(found)
    bumps[kv_mod.MISSES] = cnt(valid & ~found)
    bumps[kv_mod.CORRUPT_PAGES] = cnt(corrupt)
    bumps[kv_mod.MISS_EVICTED] = cnt(cause == CAUSE_EVICTED)
    bumps[kv_mod.MISS_COLD] = cnt((cause == CAUSE_COLD) | (cause == CAUSE_EXT))
    bumps[kv_mod.MISS_PARKED] = cnt(cause == CAUSE_PARKED)
    bumps[kv_mod.MISS_STALE] = cnt(cause == CAUSE_STALE)
    bumps[kv_mod.MISS_DIGEST] = cnt(corrupt)
    if recovering:
        kv_mod._reattribute_recovering(bumps)
    state.stats += bumps
    return state, out, found
