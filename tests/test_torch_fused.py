"""PyTorch port: the fused GET against both of the JAX package's GET programs.

One seeded JAX KV state per family (linear: evictions, deletes, one
corrupted page, one slot tagged as an extent; CCEH: splits, evictions,
deletes, one corrupted page and real extent covers) is carried across
with `carry.state_from_numpy`.
The same padded probe — present, deleted, capacity-evicted, never-inserted
and padding keys — then goes through

- `pmdfc_tpu.kv._get_core` (the composed XLA program),
- `pmdfc_tpu.ops.fused.get_core` and its kernel `_pallas_get` (the Pallas
  kernel, in interpret mode off the TPU),
- `pmdfc_tpu_torch.ops.fused.get_core_reference` (the CUDA kernel's plain
  version, which the wrapper runs for CPU tensors), `fused.get_core` and
  the composed `kv._get_core` of the port.

Pages, found masks, cause codes, rows, slots and the 19-lane stats vector
must be identical (tolerance 0: integer arithmetic). Extendible hashing
(CCEH's LSB twin) has no fused GET in the JAX package; the plain
version's `msb=False` branch is held against its composed GET. The CUDA
kernels themselves are held against the plain version on the card by
`chip_smoke.py` and by the one test here that needs a GPU.

The tiered variants run over a seeded tiered state that holds all eight
causes: promotions, demotions and ghost readmits from a small hot tier; a
forced shrink, a grow and re-puts (STALE); real extent covers (EXT); a
corrupted hot and a corrupted cold page (DIGEST); one entry poked to
NOPAGE and one cold row's live bit cleared under a current entry
(PARKED); deletes, capacity evictions and padding. The Pallas kernel
(interpret mode) is run once per family, as the JAX suite keeps the rest
of its tiered grid out of tier-1; every other case is held against the
JAX composed GET, counting (with the `tier.on_get` epilogue, comparing
every state leaf after it) and lean.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import jax_jit_caches_left_cold  # noqa: F401 (fixture)
import torch

from pmdfc_tpu import kv as jkv
from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu.config import TierConfig as JTier
from pmdfc_tpu.ops import fused as jfused
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.config import KVConfig as TKVConfig
from pmdfc_tpu_torch.config import TierConfig as TTier
from pmdfc_tpu_torch.ops import fused as tfused
from pmdfc_tpu_torch.utils import u32

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("jax_jit_caches_left_cold")]

PW = 64  # page words: inside the fused support set


# a 128-row hot tier over 2048 slots, small ghost ring and balloon steps
TIER = dict(hot_fraction=16, ghost_rows=32, balloon_step=32,
            max_promotes_per_batch=16)


def _configs(slots, sketch_bits=1 << 16, kind="linear", tiered=False):
    """(JAX config, port config): the linear index with `slots`-slot
    clusters, or CCEH/extendible with a `slots`-lane probe window
    (8 segments at most, 2048 slots); flat, or tiered with `TIER`."""
    kw = dict(page_words=PW, evicted_sketch_bits=sketch_bits)
    ix = dict(capacity=2048, cluster_slots=slots) if kind == "linear" else \
        dict(capacity=1024, probe_window=slots, segment_slots=256)
    return (JKVConfig(index=JIndexConfig(kind=JKind(kind), **ix), **kw,
                      tier=JTier(**TIER) if tiered else None),
            TKVConfig(index=TIndexConfig(kind=TKind(kind), **ix), **kw,
                      tier=TTier(**TIER) if tiered else None))


def jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _once(build):
    """`build` run once per argument set, as several tests seed the same
    JAX state: the state is immutable, and the probe keys (the last item)
    are handed out as a copy."""
    cached = functools.lru_cache(maxsize=None)(build)

    @functools.wraps(build)
    def call(*args, **kw):
        *head, pk = cached(*args, **kw)
        return (*head, pk.copy())
    return call


@_once
def _seeded(slots, seed=7, kind="linear"):
    """A JAX KV state with capacity evictions (and for CCEH splits) and
    deletes, then one page corrupted and an extent: for CCEH real covers
    inserted by `insert_extent`, for the linear index one present slot's
    value tagged. Returns (config pair, damaged JAX state, padded probe
    keys)."""
    jcfg, tcfg = _configs(slots, kind=kind)
    rng = np.random.default_rng(seed)
    kv = jkv.KV(jcfg)
    n = 3072  # > 2048 slots: evictions feed the evicted-key sketch
    keys = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint32)
    for i in range(0, n, 512):
        kv.insert(keys[i:i + 512],
                  rng.integers(0, 1 << 32, (512, PW), dtype=np.uint32))
    kv.delete(keys[2800:2900])
    covers = np.zeros((0, 2), np.uint32)
    if kind != "linear":
        kv.insert_extent(np.array([5, 1000], np.uint32),
                         np.array([1, 0xFFFFF000], np.uint32), 100)
        bases, _ = jkv._covers(jnp.uint32(1000), jnp.uint32(100), 64, 30)
        bases = np.asarray(bases)[np.asarray(bases) != 0xFFFFFFFF]
        covers = np.stack([np.full_like(bases, 5), bases], -1)
    st = kv.state
    res = jax.tree.map(np.asarray, jkv.get_index_ops(jcfg.index.kind)
                       .get_batch(st.index, jnp.asarray(keys)))
    hit = np.flatnonzero(res.found)
    assert len(hit) > 100 and (~res.found[:2800]).any()  # some were evicted
    kd, ke = hit[-1], hit[-2]
    row = int(res.values[kd, 1])
    pool = dataclasses.replace(
        st.pool, pages=st.pool.pages.at[row, 5].set(
            st.pool.pages[row, 5] ^ jnp.uint32(1 << 9)))
    st = dataclasses.replace(st, pool=pool)
    if kind == "linear":
        s = st.index.table.shape[1] // 4
        c, lane = divmod(int(res.slots[ke]), s)
        index = dataclasses.replace(
            st.index, table=st.index.table.at[c, 2 * s + lane].set(
                jnp.uint32(jkv.EXTENT_TAG)))
        st = dataclasses.replace(st, index=index)
    probe = np.concatenate([
        keys[[kd, ke]], covers[:4], keys[:40], keys[2800:2830],
        keys[2960:3040], rng.integers(0, 1 << 32, (40, 2), dtype=np.uint32)])
    pk = np.full((256, 2), 0xFFFFFFFF, np.uint32)
    pk[:len(probe)] = probe
    return jcfg, tcfg, st, pk


@_once
def _seeded_tiered(slots, kind="linear", seed=11):
    """A JAX KV state over a tiered pool holding every miss cause (see the
    module docstring) -> (config pair, JAX state, padded probe keys)."""
    jcfg, tcfg = _configs(slots, kind=kind, tiered=True)
    rng = np.random.default_rng(seed)
    kv = jkv.KV(jcfg)
    ops = jkv.get_index_ops(jcfg.index.kind)
    n = 3072  # > 2048 slots: evictions feed the evicted-key sketch
    keys = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint32)
    for i in range(0, n, 512):
        kv.insert(keys[i:i + 512],
                  rng.integers(0, 1 << 32, (512, PW), dtype=np.uint32))
    kv.delete(keys[2800:2900])
    live = np.flatnonzero(np.asarray(
        ops.get_batch(kv.state.index, jnp.asarray(keys)).found))
    for r in range(14):  # 128 hot rows: promotions, demotions, readmits
        kv.get(keys[live[(r % 4) * 64:(r % 4) * 64 + 96]])
    kv.insert_extent(np.array([5, 1000], np.uint32),
                     np.array([1, 0xFFFFF000], np.uint32), 100)
    bases, _ = jkv._covers(jnp.uint32(1000), jnp.uint32(100), 64, 30)
    bases = np.asarray(bases)[np.asarray(bases) != 0xFFFFFFFF]
    covers = np.stack([np.full_like(bases, 5), bases], -1)
    free = kv.balloon_state()["free"]
    kv.balloon_shrink(free + 64)  # evicts the coldest live rows
    kv.balloon_grow(64)
    fresh = rng.integers(0, 1 << 32, (64, 2), dtype=np.uint32)
    kv.insert(fresh, rng.integers(0, 1 << 32, (64, PW), dtype=np.uint32))
    ts = kv.tier_stats()
    assert ts["demotions"] and ts["ghost_readmits"] and ts["shrink_evictions"]

    st = kv.state
    pool = st.pool
    h = pool.hfree.shape[0]
    res = jax.tree.map(np.asarray, ops.get_batch(st.index, jnp.asarray(keys)))
    cur = np.asarray(tier_entry_current(pool, res.values))
    rows = res.values[:, 1].astype(np.int64)
    entry = res.found & ((res.values[:, 0] >> 30) == 0)
    page = entry & cur
    livec = np.asarray(pool.live)
    hot = np.flatnonzero(page & (rows < h))
    cold = np.flatnonzero(page & (rows >= h)
                          & livec[np.clip(rows - h, 0, len(livec) - 1)])
    stale = np.flatnonzero(entry & ~cur)
    assert len(hot) > 4 and len(cold) > 4 and len(stale) > 4
    kh, kc, knp, kdead = hot[0], cold[0], cold[1], cold[2]
    # DIGEST: one hot and one cold page corrupted
    pages = pool.pages
    for k in (kh, kc):
        pages = pages.at[rows[k], 5].set(pages[rows[k], 5] ^ jnp.uint32(1 << 9))
    # PARKED: one entry poked to NOPAGE, one cold row's live bit cleared
    index = ops.set_values(st.index, jnp.asarray([res.slots[knp]]),
                           jnp.asarray([[jkv.NOPAGE_TAG, 0]], jnp.uint32))
    pool = dataclasses.replace(
        pool, pages=pages, live=pool.live.at[rows[kdead] - h].set(False))
    st = dataclasses.replace(st, index=index, pool=pool)
    probe = np.concatenate([
        keys[[kh, kc, knp, kdead]], covers[:4], keys[stale[:16]],
        keys[hot[1:17]], keys[:40], keys[2800:2830], keys[2960:3040],
        rng.integers(0, 1 << 32, (40, 2), dtype=np.uint32)])
    pk = np.full((256, 2), 0xFFFFFFFF, np.uint32)
    pk[:len(probe)] = probe
    return jcfg, tcfg, st, pk


def tier_entry_current(pool, vals):
    from pmdfc_tpu import tier as jtier

    return jtier.entry_current(pool, jnp.asarray(vals))


def _pallas(jst, jcfg, pk, slots):
    """The Pallas kernel's own outputs (interpret mode off the TPU)."""
    table = jst.index.table
    if jcfg.index.kind == JKind.CCEH:
        smax = jst.index.ld.shape[0]
        geom = dict(family="cceh", W=table.shape[0] // smax,
                    Gmax=smax.bit_length() - 1, msb=jst.index.msb)
        dirr = jst.index.dirr
    else:
        geom, dirr = dict(family="linear", W=1, Gmax=0, msb=True), None
    pool = jst.pool
    tiered = jcfg.tier is not None
    side = dict(H=pool.hfree.shape[0], CC=pool.live.shape[0]) if tiered \
        else dict(H=0, CC=0)
    return jfused._pallas_get(
        jnp.asarray(pk), table, dirr, pool.pages, pool.sums,
        jst.evicted_filter.astype(jnp.int32),
        pool.cgen if tiered else None,
        pool.live.astype(jnp.int32) if tiered else None, tiered=tiered,
        CL=table.shape[0], S=slots, nb=jcfg.evicted_sketch_bits,
        tile=jfused.tile_for(len(pk)), **side, **geom)


def _wrapper_args(tst):
    """fused_get's arguments for a port state (the directory for CCEH,
    the sidecars for a tiered pool)."""
    ix, pool = tst.index, tst.pool
    kw = dict(dirr=ix.dirr, msb=ix.msb) if hasattr(ix, "dirr") else {}
    if hasattr(pool, "cgen"):
        kw.update(cgen=pool.cgen, live=pool.live,
                  hot_rows=pool.hfree.shape[0])
    return (ix.table, pool.pages, pool.sums, tst.evicted_filter), kw


FAMILIES = [(k, s) for k in ("linear", "cceh") for s in (16, 32)]
FAMILY_IDS = [str(s) if k == "linear" else f"{k}-{s}" for k, s in FAMILIES]


@pytest.mark.parametrize("kind,slots", FAMILIES, ids=FAMILY_IDS)
def test_plain_version_matches_pallas_kernel_and_composed(kind, slots):
    jcfg, tcfg, jst, pk = _seeded(slots, kind=kind)
    assert jfused.supports(jcfg) and tfused.supports(tcfg)
    tst = carry.state_from_numpy(jax_leaves(jst), tcfg, device="cpu")
    keys = u32.from_numpy(pk, "cpu")

    jout, jcause, jrows, jslots = _pallas(jst, jcfg, pk, slots)
    args, kw = _wrapper_args(tst)
    tout, tcause, trows, tslots = tfused.get_core_reference(keys, *args,
                                                            **kw)
    assert np.array_equal(u32.to_numpy(tout), np.asarray(jout)), "pages"
    assert np.array_equal(tcause.numpy(), np.asarray(jcause)), "causes"
    assert np.array_equal(trows.numpy(), np.asarray(jrows)), "rows"
    assert np.array_equal(tslots.numpy(), np.asarray(jslots)), "slots"
    codes = set(tcause.tolist())
    assert {tfused.CAUSE_HIT, tfused.CAUSE_PAD, tfused.CAUSE_COLD,
            tfused.CAUSE_EVICTED, tfused.CAUSE_EXT,
            tfused.CAUSE_DIGEST} <= codes, f"causes exercised: {codes}"

    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = dict(tfused.launches)
    wout = tfused.fused_get(keys, *args, **kw)
    assert dict(tfused.launches) == before
    for a, b in zip(wout, (tout, tcause, trows, tslots)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,slots", FAMILIES, ids=FAMILY_IDS)
def test_get_core_stats_match_both_jax_programs(kind, slots):
    """Pages, found mask and the 19-lane stats vector of the port's fused
    and composed GETs equal the JAX composed program and the JAX fused
    program; `misses == Σ miss_*`, with the digest and extent lanes hit."""
    jcfg, tcfg, jst, pk = _seeded(slots, kind=kind)
    s1, o1, f1 = jkv._get_core(jst, jcfg, jnp.asarray(pk))
    s2, o2, f2 = jfused.get_core(jst, jcfg, jnp.asarray(pk))
    assert np.array_equal(np.asarray(s1.stats), np.asarray(s2.stats))
    keys = u32.from_numpy(pk, "cpu")
    for get in (tfused.get_core, tkv._get_core):
        tst = carry.state_from_numpy(jax_leaves(jst), tcfg, device="cpu")
        leaves0 = carry.state_to_numpy(tst)
        tst, out, found = get(tst, tcfg, keys)
        assert np.array_equal(u32.to_numpy(out), np.asarray(o1))
        assert np.array_equal(found.numpy(), np.asarray(f1))
        assert np.array_equal(tst.stats.numpy(), np.asarray(s1.stats))
        # a GET writes nothing but the stats vector
        after = carry.state_to_numpy(tst)
        assert all(np.array_equal(leaves0[k], after[k])
                   for k in leaves0 if k != "stats")
    st = dict(zip(tkv.STAT_NAMES, tst.stats.tolist()))
    assert st["misses"] == sum(st[c] for c in tkv.MISS_CAUSE_NAMES)
    assert st["miss_digest"] == st["corrupt_pages"] == 1
    assert st["hits"] > 0 and st["miss_evicted"] > 0 and st["miss_cold"] > 0


def test_state_carries_across_leaf_for_leaf():
    jcfg, tcfg, jst, _ = _seeded(32)
    leaves = jax_leaves(jst)
    back = carry.state_to_numpy(carry.state_from_numpy(leaves, tcfg, "cpu"))
    assert sorted(back) == sorted(leaves)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def _small_args(w=16, pw=8):
    keys = torch.full((w, 2), -1, dtype=torch.int32)
    table = torch.zeros((4, 4 * 16), dtype=torch.int32)
    pages = torch.zeros((64, pw), dtype=torch.int32)
    sums = torch.zeros(64, dtype=torch.int32)
    sketch = torch.zeros(64, dtype=torch.bool)
    return [keys, table, pages, sums, sketch]


@pytest.mark.parametrize("arg,bad,err", [
    (0, lambda t: t.to(torch.int64), TypeError),
    (2, lambda t: t.t().contiguous().t(), ValueError),   # not contiguous
    (3, lambda t: t[:32], ValueError),                   # sums != pool rows
    (4, lambda t: t.to(torch.uint8), TypeError),
    (1, lambda t: torch.zeros((3, 64), dtype=torch.int32), ValueError),
    (1, lambda t: torch.zeros((4, 62), dtype=torch.int32), ValueError),
    (2, lambda t: torch.zeros((64, 6), dtype=torch.int32), ValueError),
    (0, lambda t: t.to("meta"), ValueError),             # other device
])
def test_wrapper_checks_its_arguments(arg, bad, err):
    args = _small_args()
    args[arg] = bad(args[arg])
    with pytest.raises(err):
        tfused.fused_get(*args)


@pytest.mark.parametrize("dirr,err", [
    (torch.zeros(4, dtype=torch.int64), TypeError),
    (torch.zeros(3, dtype=torch.int32), ValueError),    # not a power of two
    (torch.zeros(1, dtype=torch.int32), ValueError),    # Gmax would be 0
    (torch.zeros(8, dtype=torch.int32), ValueError),    # 4 rows over 8
])
def test_wrapper_checks_the_directory(dirr, err):
    with pytest.raises(err):
        tfused.fused_get(*_small_args(), dirr=dirr)


def test_wrapper_refuses_a_device_it_has_no_kernel_for():
    args = [t.to("meta") for t in _small_args()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfused.fused_get(*args)


def test_lsb_plain_version_matches_jax_composed_get():
    """Extendible hashing (the LSB directory) rides the composed GET in
    both packages; the plain version's `msb=False` branch, which the
    chip smoke holds the kernel against, agrees with it."""
    jcfg, tcfg, jst, pk = _seeded(16, kind="extendible")
    assert not jfused.supports(jcfg) and not tfused.supports(tcfg)
    s1, o1, f1 = jkv._get_core(jst, jcfg, jnp.asarray(pk))
    tst = carry.state_from_numpy(jax_leaves(jst), tcfg, device="cpu")
    assert not tst.index.msb
    args, kw = _wrapper_args(tst)
    out, cause, _, _ = tfused.get_core_reference(u32.from_numpy(pk, "cpu"),
                                                 *args, **kw)
    assert np.array_equal(u32.to_numpy(out), np.asarray(o1))
    assert np.array_equal((cause == tfused.CAUSE_HIT).numpy(), np.asarray(f1))
    bumps = np.asarray(s1.stats) - np.asarray(jst.stats)
    st = dict(zip(tkv.STAT_NAMES, bumps.tolist()))
    n = torch.bincount(cause, minlength=8).tolist()
    assert st["miss_digest"] == n[tfused.CAUSE_DIGEST] == 1
    assert st["miss_evicted"] == n[tfused.CAUSE_EVICTED] > 0
    assert st["miss_cold"] == n[tfused.CAUSE_COLD] + n[tfused.CAUSE_EXT]
    assert n[tfused.CAUSE_EXT] > 0


def test_supports_gates_the_kernel_geometry():
    assert tfused.supports(TKVConfig())
    assert tfused.supports(TKVConfig(index=TIndexConfig(kind=TKind.CCEH)))
    assert not tfused.supports(
        TKVConfig(index=TIndexConfig(kind=TKind.EXTENDIBLE)))
    assert not tfused.supports(TKVConfig(paged=False))
    assert not tfused.supports(TKVConfig(page_words=48))   # not pow2
    assert not tfused.supports(TKVConfig(page_words=2))    # not 16-byte rows
    assert not tfused.supports(TKVConfig(evicted_sketch_bits=96))


@pytest.mark.parametrize("pool", ["flat", "tiered"])
@pytest.mark.parametrize("kind", ["linear", "cceh"])
def test_kernel_matches_plain_version_on_card(kind, pool):
    """Needs a GPU (and nvcc): builds the kernel and holds each variant
    against the plain version on the carried state. Skips elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    seeded = _seeded_tiered if pool == "tiered" else _seeded
    jcfg, tcfg, jst, pk = seeded(32, kind=kind)
    tst = carry.state_from_numpy(jax_leaves(jst), tcfg, device="cuda")
    args, kw = _wrapper_args(tst)
    args = (u32.from_numpy(pk, "cuda"), *args)
    variant = f"fused_get_{kind}_{pool}"
    before = tfused.launches[variant]
    got = tfused.fused_get(*args, **kw)
    want = tfused.get_core_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tfused.launches[variant] == before + 1
    for g, r in zip(got, want):
        assert torch.equal(g, r)


ALL_CAUSES = set(range(8))


@pytest.mark.parametrize("kind", ["linear", "cceh"])
def test_tiered_plain_version_matches_pallas_kernel(kind):
    """The tiered Pallas kernel (interpret mode), one case per family,
    against the port's plain version: pages, causes, rows, slots, with
    all eight causes in the batch."""
    jcfg, tcfg, jst, pk = _seeded_tiered(32, kind=kind)
    assert jfused.supports(jcfg) and tfused.supports(tcfg)
    tst = carry.state_from_numpy(jax_leaves(jst), tcfg, device="cpu")
    keys = u32.from_numpy(pk, "cpu")
    jout, jcause, jrows, jslots = _pallas(jst, jcfg, pk, 32)
    args, kw = _wrapper_args(tst)
    tout, tcause, trows, tslots = tfused.get_core_reference(keys, *args,
                                                            **kw)
    assert np.array_equal(u32.to_numpy(tout), np.asarray(jout)), "pages"
    assert np.array_equal(tcause.numpy(), np.asarray(jcause)), "causes"
    assert np.array_equal(trows.numpy(), np.asarray(jrows)), "rows"
    assert np.array_equal(tslots.numpy(), np.asarray(jslots)), "slots"
    assert set(tcause.tolist()) == ALL_CAUSES
    before = dict(tfused.launches)
    wout = tfused.fused_get(keys, *args, **kw)
    assert dict(tfused.launches) == before
    for a, b in zip(wout, (tout, tcause, trows, tslots)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lean", [False, True], ids=["counting", "lean"])
@pytest.mark.parametrize("kind,slots", FAMILIES, ids=FAMILY_IDS)
def test_tiered_get_core_matches_jax_composed(kind, slots, lean):
    """The port's fused and composed tiered GETs against the JAX composed
    GET: pages, found, stats (all eight cause lanes in play) and, after
    the counting path's `tier.on_get`, every state leaf."""
    jcfg, tcfg, jst, pk = _seeded_tiered(slots, kind=kind)
    s1, o1, f1 = jkv._get_core(jst, jcfg, jnp.asarray(pk), lean=lean)
    want = jax_leaves(s1)
    keys = u32.from_numpy(pk, "cpu")
    for get in (tfused.get_core, tkv._get_core):
        tst = carry.state_from_numpy(jax_leaves(jst), tcfg, device="cpu")
        tst, out, found = get(tst, tcfg, keys, lean=lean)
        assert np.array_equal(u32.to_numpy(out), np.asarray(o1))
        assert np.array_equal(found.numpy(), np.asarray(f1))
        got = carry.state_to_numpy(tst)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), (get.__module__, k)
    bumps = np.asarray(s1.stats) - np.asarray(jst.stats)
    st = dict(zip(tkv.STAT_NAMES, bumps.tolist()))
    assert st["misses"] == sum(st[c] for c in tkv.MISS_CAUSE_NAMES)
    assert all(st[c] > 0 for c in ("hits", "miss_cold", "miss_evicted",
                                   "miss_parked", "miss_stale",
                                   "miss_digest"))
    assert st["miss_digest"] == st["corrupt_pages"] >= 2


def test_tiered_lsb_plain_version_matches_jax_composed_get():
    """Extendible hashing over the tiered pool: the plain version's
    `msb=False` tiered branch (what the chip smoke holds the kernel
    against) agrees with the JAX composed GET, cause by cause."""
    jcfg, tcfg, jst, pk = _seeded_tiered(16, kind="extendible")
    s1, o1, f1 = jkv._get_core(jst, jcfg, jnp.asarray(pk), lean=True)
    tst = carry.state_from_numpy(jax_leaves(jst), tcfg, device="cpu")
    args, kw = _wrapper_args(tst)
    assert kw["msb"] is False and "cgen" in kw
    out, cause, _, _ = tfused.get_core_reference(u32.from_numpy(pk, "cpu"),
                                                 *args, **kw)
    assert np.array_equal(u32.to_numpy(out), np.asarray(o1))
    assert np.array_equal((cause == tfused.CAUSE_HIT).numpy(), np.asarray(f1))
    assert set(cause.tolist()) == ALL_CAUSES
    st = dict(zip(tkv.STAT_NAMES,
                  (np.asarray(s1.stats) - np.asarray(jst.stats)).tolist()))
    n = torch.bincount(cause, minlength=8).tolist()
    assert st["miss_parked"] == n[tfused.CAUSE_PARKED]
    assert st["miss_stale"] == n[tfused.CAUSE_STALE]
    assert st["miss_digest"] == n[tfused.CAUSE_DIGEST]
    assert st["miss_cold"] == n[tfused.CAUSE_COLD] + n[tfused.CAUSE_EXT]


def test_tiered_negative_row_word_is_parked():
    """A tiered page entry whose row word is >= 2^31 (negative as int32)
    is dead, so PARKED, where the flat pool calls it DIGEST; both JAX
    programs agree on this, and so does the plain version."""
    jcfg, tcfg, jst, pk = _seeded_tiered(32)
    ops = jkv.get_index_ops(jcfg.index.kind)
    res = ops.get_batch(jst.index, jnp.asarray(pk[16:17]))  # a hot key
    assert bool(res.found[0])
    index = ops.set_values(jst.index, res.slots,
                           jnp.asarray([[0, 0x80000005]], jnp.uint32))
    jst = dataclasses.replace(jst, index=index)
    probe = np.full((16, 2), 0xFFFFFFFF, np.uint32)
    probe[0] = pk[16]
    _, _, f1 = jkv._get_core(jst, jcfg, jnp.asarray(probe), lean=True)
    jout, jcause, jrows, _ = _pallas(jst, jcfg, probe, 32)
    tst = carry.state_from_numpy(jax_leaves(jst), tcfg, device="cpu")
    args, kw = _wrapper_args(tst)
    out, cause, rows, _ = tfused.get_core_reference(
        u32.from_numpy(probe, "cpu"), *args, **kw)
    assert int(cause[0]) == int(jcause[0]) == tfused.CAUSE_PARKED
    assert not bool(f1[0])
    assert np.array_equal(rows.numpy(), np.asarray(jrows))
    assert not out.any() and not np.asarray(jout).any()


@pytest.mark.parametrize("bad,err", [
    (dict(cgen=torch.zeros(48, dtype=torch.int64)), TypeError),
    (dict(cgen=torch.zeros(40, dtype=torch.int32)), ValueError),
    (dict(live=torch.zeros(48, dtype=torch.int32)), TypeError),
    (dict(live=None), ValueError),                 # all three or none
    (dict(hot_rows=64), ValueError),               # no cold rows left
])
def test_wrapper_checks_the_tiered_sidecars(bad, err):
    kw = dict(cgen=torch.zeros(48, dtype=torch.int32),
              live=torch.zeros(48, dtype=torch.bool), hot_rows=16)
    kw.update(bad)
    with pytest.raises(err):
        tfused.fused_get(*_small_args(), **kw)
