"""Fused serving GET: probe→gather→verify→classify in ONE launch
(twin of `pmdfc_tpu/ops/fused.py`, linear index over the flat pool).

Three pieces:

- `fused_get` — the wrapper. On CUDA tensors it launches the hand-written
  Hopper kernel `csrc/fused_get.cu` (and raises if the launch fails); on
  CPU tensors it runs `get_core_reference`. There is no fallback between
  the two: the device of the tensors decides.
- `get_core_reference` — the plain PyTorch version, same inputs and
  outputs, the kernel's arithmetic written as tensor ops.
- `get_core` — the drop-in twin of `kv._get_core` for configurations
  `supports()` accepts: the wrapper, then the stats fold in int32.

Per key (stages as in the JAX module's docstring): murmur3 bucket and two
evicted-sketch slots; bucket-row lane match with masked-sum values;
EXTENT split; page + digest-word gather at the row clamped into the pool;
digest recompute; one cause code, later codes winning; misses zeroed.
"""

from __future__ import annotations

import ctypes

import torch

from pmdfc_tpu_torch.config import IndexKind, KVConfig
from pmdfc_tpu_torch.models.rowops import lane_pick, match_mask
from pmdfc_tpu_torch.ops.pagepool import page_digest
from pmdfc_tpu_torch.utils.hashing import hash_u64
from pmdfc_tpu_torch.utils.keys import is_invalid

# per-lane outcome codes (disjoint by construction; HIT ⟺ final found).
# PARKED and STALE belong to the tiered pool, which is not ported yet.
(CAUSE_HIT, CAUSE_PAD, CAUSE_COLD, CAUSE_EVICTED, CAUSE_EXT,
 CAUSE_PARKED, CAUSE_STALE, CAUSE_DIGEST) = range(8)

SKETCH_SEEDS = (0x0E51C7ED, 0x0E51C7ED ^ 0x9E3779B9)
EXTENT_TAG = 0x80000000  # bit 63 of the u64 value marks an extent-record ref
EXTENT_TAG_I32 = EXTENT_TAG - (1 << 32)  # its bits as int32

KERNEL_NAME = "fused_get"
# kernel launches made by `fused_get`, for showing that a run went
# through the kernel; callers reset it to 0 themselves
launches = 0


def supports(config: KVConfig) -> bool:
    """Whether the fused GET serves this config: the linear index over a
    paged flat pool, with power-of-two sketch bits and a power-of-two
    page width that is a multiple of 4 (the kernel moves pages as 16-byte
    vectors and XOR-folds lanes by halving). Everything else runs the
    composed GET (`kv._get_core`)."""
    if config.index.kind != IndexKind.LINEAR or not config.paged:
        return False
    pw, nb = config.page_words, config.evicted_sketch_bits
    return not (pw & (pw - 1) or pw % 4 or nb & (nb - 1))


def get_core_reference(keys, table, pages, sums, sketch):
    """Plain PyTorch version of the kernel.

    keys int32[w, 2], table int32[C, 4S], pages int32[NR, PW], sums
    int32[NR] (all u32 bits), sketch bool[nb] -> (out int32[w, PW],
    cause int32[w], rows int32[w], slots int32[w]).
    """
    s = table.shape[1] // 4
    nr = pages.shape[0]
    nb = sketch.shape[0]
    khi, klo = keys[:, 0], keys[:, 1]
    c = hash_u64(khi, klo) & (table.shape[0] - 1)
    sk0 = hash_u64(khi, klo, seed=SKETCH_SEEDS[0]) & (nb - 1)
    sk1 = hash_u64(khi, klo, seed=SKETCH_SEEDS[1]) & (nb - 1)

    brows = table[c]
    eq = match_mask(brows, keys, s)
    found0 = eq.any(dim=1)
    vhi = lane_pick(brows, eq, 2 * s, s)
    vlo = lane_pick(brows, eq, 3 * s, s)
    lane = torch.argmax(eq.to(torch.uint8), dim=1)
    slots = torch.where(found0, (c * s + lane).to(torch.int32), -1)
    ext = found0 & (vhi == EXTENT_TAG_I32)
    f1 = found0 & ~ext

    safe_row = torch.where(f1, vlo, 0).to(torch.int64).clamp(0, nr - 1)
    out = pages[safe_row]
    rows = torch.where(f1, vlo, -1)
    ok = (rows >= 0) & (page_digest(out) == sums[safe_row])
    corrupt = f1 & ~ok
    found = f1 & ok

    valid = ~is_invalid(keys)
    idx_miss = valid & ~found0
    ev = idx_miss & sketch[sk0] & sketch[sk1]
    cause = torch.full_like(rows, CAUSE_HIT)
    cause = torch.where(~valid, CAUSE_PAD, cause)
    cause = torch.where(idx_miss & ~ev, CAUSE_COLD, cause)
    cause = torch.where(ev, CAUSE_EVICTED, cause)
    cause = torch.where(ext, CAUSE_EXT, cause)
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


def _entry():
    from pmdfc_tpu_torch.ops import _build

    fn = _build.load(KERNEL_NAME).pmdfc_fused_get_linear_flat
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, ctypes.c_uint, ctypes.c_int, p,
                       ctypes.c_longlong, ctypes.c_int, p, p, ctypes.c_uint,
                       p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def fused_get(keys, table, pages, sums, sketch):
    """The fused GET over one padded batch; same contract as
    `get_core_reference`. CPU tensors run the plain version; CUDA tensors
    launch the kernel, or raise."""
    w = keys.shape[0]
    c, lanes = table.shape
    nr, pw = pages.shape
    nb = sketch.shape[0]
    s = lanes // 4
    dev = keys.device
    _check("keys", keys, torch.int32, (w, 2), dev)
    _check("table", table, torch.int32, (c, lanes), dev)
    _check("pages", pages, torch.int32, (nr, pw), dev)
    _check("sums", sums, torch.int32, (nr,), dev)
    _check("sketch", sketch, torch.bool, (nb,), dev)
    for name, n in (("clusters", c), ("slots per cluster", s),
                    ("sketch bits", nb), ("page words", pw)):
        if n < 1 or n & (n - 1):
            raise ValueError(f"{name} must be a power of two, got {n}")
    if lanes != 4 * s or pw % 4:
        raise ValueError(f"bad geometry: row width {lanes}, page words {pw}")
    if dev.type == "cpu":
        return get_core_reference(keys, table, pages, sums, sketch)
    if dev.type != "cuda":
        raise ValueError(f"fused_get runs on cuda or cpu tensors, not {dev}")
    if pages.data_ptr() % 16:
        raise ValueError("pages must be 16-byte aligned")

    global launches
    out = torch.empty((w, pw), dtype=torch.int32, device=dev)
    cause, rows, slots = (torch.empty(w, dtype=torch.int32, device=dev)
                          for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(keys.data_ptr(), w, table.data_ptr(), c, s,
                       pages.data_ptr(), nr, pw, sums.data_ptr(),
                       sketch.data_ptr(), nb, out.data_ptr(),
                       cause.data_ptr(), rows.data_ptr(), slots.data_ptr(),
                       stream)
    if err:
        raise RuntimeError(f"fused_get kernel launch failed: CUDA error {err}")
    launches += 1
    return out, cause, rows, slots


def get_core(state, config: KVConfig, keys: torch.Tensor):
    """Fused twin of `kv._get_core` for configs `supports()` accepts:
    (state, out, found), bit-identical outputs and stats. Writes nothing
    but `state.stats` (in place)."""
    from pmdfc_tpu_torch import kv as kv_mod

    pool = state.pool
    out, cause, _, _ = fused_get(keys, state.index.table, pool.pages,
                                 pool.sums, state.evicted_filter)
    found = cause == CAUSE_HIT
    valid = ~is_invalid(keys)

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
    bumps[kv_mod.MISS_DIGEST] = cnt(corrupt)
    state.stats += bumps
    return state, out, found
