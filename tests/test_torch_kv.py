"""PyTorch port: the slice end to end — `KV` verb by verb against the JAX `KV`.

The same seeded mix of insert (updates, in-batch duplicates, padding,
capacity evictions, CCEH splits), get, get_compact, delete (with
duplicates) and get again goes through `pmdfc_tpu.kv.KV` and
`pmdfc_tpu_torch.kv.KV(device="cpu")`, for the linear index, CCEH and
extendible hashing, over the flat pool and over the tiered one (with and
without the admission gate, with balloon shrinks and grows, extents and
lean sampled GETs mixed in). Every result, `stats()` (the tier counters
among them), the packed bloom, capacity, utilization and every state leaf
at the end must be identical. The tiered pool's verb sequences are in
`test_torch_kv_tiered.py`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

from pmdfc_tpu import kv as jkv
from pmdfc_tpu.config import BloomConfig as JBloomConfig
from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu.config import TierConfig as JTier
from pmdfc_tpu.ops import fused as jfused
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.config import BloomConfig as TBloomConfig
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.config import AdmitConfig as TAdmit
from pmdfc_tpu_torch.config import KVConfig as TKVConfig
from pmdfc_tpu_torch.config import TierConfig as TTier
from pmdfc_tpu_torch.ops import fused as tfused
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

CASES = {
    # name: (cluster slots or probe window, page_words, paged, bloom bits
    # or None, index kind)
    "paged-s32": (32, 64, True, 1 << 12, "linear"),
    "paged-s16": (16, 64, True, 1 << 12, "linear"),
    "unpaged": (16, 1024, False, 1 << 12, "linear"),
    "paged-composed-nobloom": (32, 48, True, None, "linear"),  # no fused GET
    "cceh-paged-s32": (32, 64, True, 1 << 12, "cceh"),
    "cceh-paged-s16": (16, 64, True, None, "cceh"),
    "cceh-unpaged": (32, 1024, False, 1 << 12, "cceh"),
    "extendible-paged": (32, 64, True, 1 << 12, "extendible"),  # composed
}
FUSED = {"paged-s32", "paged-s16", "cceh-paged-s32", "cceh-paged-s16"}


def _configs(slots, pw, paged, bits, kind="linear"):
    """2048 slots either way: 64 linear clusters, or CCEH/extendible with
    4 segments of 256 slots growing to 8."""
    ix = dict(capacity=2048, cluster_slots=slots) if kind == "linear" else \
        dict(capacity=1024, probe_window=slots, segment_slots=256)

    def make(K, I, B, Kind):
        return K(index=I(kind=Kind(kind), **ix), page_words=pw,
                 paged=paged, bloom=B(num_bits=bits) if bits else None,
                 evicted_sketch_bits=1 << 10)
    return (make(JKVConfig, JIndexConfig, JBloomConfig, JKind),
            make(TKVConfig, TIndexConfig, TBloomConfig, TKind))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert np.array_equal(a, b), f"{what} differs"


def jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


@pytest.mark.parametrize("case", list(CASES))
def test_kv_verb_sequence_matches_jax(case):
    slots, pw, paged, bits, kind = CASES[case]
    jcfg, tcfg = _configs(slots, pw, paged, bits, kind)
    assert tfused.supports(tcfg) == (case in FUSED) == jfused.supports(jcfg)
    a, b = jkv.KV(jcfg), tkv.KV(tcfg, device="cpu")
    assert a.capacity() == b.capacity()
    rng = np.random.default_rng(len(case))
    vw = pw if paged else 2
    live = np.zeros((0, 2), np.uint32)
    for step, n in enumerate((300, 700, 513, 1024, 700)):
        keys = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint32)
        keys[: n // 8] = keys[n // 8: 2 * (n // 8)]      # in-batch duplicates
        if len(live):
            keys[n // 4: n // 4 + 64] = live[rng.integers(0, len(live), 64)]
        keys[rng.integers(0, n, 5)] = 0xFFFFFFFF          # padding keys
        keys[rng.integers(0, n, 20), 0] |= 0x80000000     # hi >= 2^31
        vals = rng.integers(0, 1 << 32, (n, vw), dtype=np.uint32)
        ra, rb = a.insert(keys, vals), b.insert(keys, vals)
        for f in ra._fields:
            _same(getattr(ra, f), getattr(rb, f), f"insert {step} {f}")
        live = np.concatenate([live, keys])

        probe = np.concatenate([
            live[rng.integers(0, len(live), 150)],
            rng.integers(0, 1 << 32, (40, 2), dtype=np.uint32),
            np.full((3, 2), 0xFFFFFFFF, np.uint32)])
        (oa, fa), (ob, fb) = a.get(probe), b.get(probe)
        _same(oa, ob, f"get {step} out")
        _same(fa, fb, f"get {step} found")
        ca, cb = a.get_compact_async(probe), b.get_compact_async(probe)
        for x, y, what in zip(ca[:4], cb[:4], ("out", "order", "found",
                                                "nfound")):
            y = u32.to_numpy(y) if what == "out" else y.numpy()
            _same(x, y, f"get_compact {step} {what}")
        assert ca[4] == cb[4]
        if step in (2, 4):
            gone = np.concatenate([live[rng.integers(0, len(live), 80)],
                                   live[:6], live[:6]])    # dup deletes
            _same(a.delete(gone), b.delete(gone), f"delete {step}")

    sa, sb = a.stats(), b.stats()
    for k in tkv.STAT_NAMES:
        assert sa[k] == sb[k], f"stat {k}: {sa[k]} vs {sb[k]}"
    assert sb["evictions"] > 0 and sb["misses"] > 0 and sb["hits"] > 0
    assert sb["misses"] == sum(sb[c] for c in tkv.MISS_CAUSE_NAMES)
    assert a.utilization() == b.utilization()
    pa, pb = a.packed_bloom(), b.packed_bloom()
    assert (pa is None) == (pb is None)
    if pa is not None:
        assert pa.tobytes() == pb.tobytes()
    la, lb = jax_leaves(a.state), carry.state_to_numpy(b.state)
    assert sorted(la) == sorted(lb)
    for k in la:
        _same(la[k], lb[k], f"leaf {k}")
    assert "uptime_s" in sb and b.print_stats().startswith("puts=")


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
def test_kv_facade_end_to_end_with_cceh(paged):
    """Mirrors the JAX package's CCEH facade test through both `KV`s, then
    damages one replicated directory entry in both states: GETs lose
    keys, `recovery()` restores the directory, and everything agrees
    again — results, `find_anyway`, stats and leaves."""
    kw = dict(bloom=None, paged=paged, page_words=64)
    ix = dict(capacity=1 << 9, segment_slots=128, split_headroom=2)
    a = jkv.KV(JKVConfig(index=JIndexConfig(kind=JKind.CCEH, **ix), **kw))
    b = tkv.KV(TKVConfig(index=TIndexConfig(kind=TKind.CCEH, **ix), **kw),
               device="cpu")
    lo = np.arange(400, dtype=np.uint32)
    ks = np.stack([np.ones(400, np.uint32), lo], -1)
    vals = np.stack([np.zeros(400, np.uint32), lo * 5], -1) if not paged \
        else np.random.default_rng(1).integers(0, 1 << 32, (400, 64),
                                               dtype=np.uint32)
    ra, rb = a.insert(ks, vals), b.insert(ks, vals)
    _same(ra.slots, rb.slots, "insert slots")
    (oa, fa), (ob, fb) = a.get(ks), b.get(ks)
    assert fb.all() and np.array_equal(ob, vals)
    _same(oa, ob, "get")
    for x, y in zip(a.find_anyway(ks[:4]), b.find_anyway(ks[:4])):
        _same(x, y, "find_anyway")
    assert b.find_anyway(ks[:4])[1].all()

    dirr, ld = u32.to_numpy(b.state.index.dirr), b.state.index.ld.numpy()
    gmax = len(dirr).bit_length() - 1
    i = next(i for i in range(len(dirr))
             if i & ((1 << (gmax - ld[dirr[i]])) - 1))  # not a block start
    bad = dirr.view(np.int32).copy()
    bad[i] = (bad[i] + 1) % len(bad)
    a.state = dataclasses.replace(
        a.state, index=dataclasses.replace(a.state.index,
                                           dirr=jnp.asarray(bad)))
    b.state.index.dirr.copy_(torch.from_numpy(bad))
    (oa, fa), (ob, fb) = a.get(ks), b.get(ks)
    _same(oa, ob, "damaged get")
    assert not fb.all(), "the damaged entry should hide keys"
    assert a.recovery() and b.recovery()
    assert np.array_equal(u32.to_numpy(b.state.index.dirr), dirr)
    (oa, fa), (ob, fb) = a.get(ks), b.get(ks)
    assert fb.all() and np.array_equal(ob, vals)
    _same(oa, ob, "recovered get")
    sa, sb = a.stats(), b.stats()
    assert all(sa[k] == sb[k] for k in tkv.STAT_NAMES)
    la, lb = jax_leaves(a.state), carry.state_to_numpy(b.state)
    for k in la:
        _same(la[k], lb[k], f"leaf {k}")


def test_kv_tensor_calls_return_tensors():
    """Tensor in, tensor out (the device-side path `chip_smoke.py` uses):
    same answers as the numpy calls, no host copy of pages."""
    _, tcfg = _configs(32, 64, True, 1 << 12)
    kv_n, kv_t = tkv.KV(tcfg, device="cpu"), tkv.KV(tcfg, device="cpu")
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 32, (200, 2), dtype=np.uint32)
    pages = rng.integers(0, 1 << 32, (200, 64), dtype=np.uint32)
    rn = kv_n.insert(keys, pages)
    rt = kv_t.insert(u32.from_numpy(keys, "cpu"), u32.from_numpy(pages, "cpu"))
    assert isinstance(rt.slots, torch.Tensor)
    assert np.array_equal(rn.slots, rt.slots.numpy())
    on, fn = kv_n.get(keys[:50])
    ot, ft = kv_t.get(u32.from_numpy(keys[:50], "cpu"))
    assert isinstance(ot, torch.Tensor) and ot.dtype == torch.int32
    assert np.array_equal(on, u32.to_numpy(ot)) and fn.all()
    assert np.array_equal(fn, ft.numpy())
    assert np.array_equal(on, pages[:50])


def test_kv_without_a_device_raises_when_cuda_is_absent(monkeypatch):
    """The default device is CUDA and there is no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        tkv.KV()
    with pytest.raises(RuntimeError, match="no GPU"):
        tkv.init(TKVConfig(index=TIndexConfig(capacity=64)))
    assert tkv.KV(TKVConfig(index=TIndexConfig(capacity=64)),
                  device="cpu").device.type == "cpu"


def test_tiered_config_is_refused():
    """A tiered config out of range is refused, as the JAX package refuses
    it; a valid one builds a tiered pool."""
    for bad in (dict(hot_fraction=1), dict(promote_touches=0),
                dict(ghost_rows=0), dict(max_promotes_per_batch=0),
                dict(balloon_step=0), dict(hot_policy="mru")):
        with pytest.raises(ValueError):
            TTier(**bad)
        with pytest.raises(ValueError):
            JTier(**bad)
    for bad in (dict(sketch_width=32), dict(door_bits=32),
                dict(reset_ops=0), dict(threshold=-1)):
        with pytest.raises(ValueError):
            TAdmit(**bad)
    kv = tkv.KV(TKVConfig(index=TIndexConfig(capacity=256), page_words=64,
                          tier=TTier()), device="cpu")
    assert kv.state.pool.hfree.shape[0] == 32 and kv.tier_stats() is not None
    assert kv.admit_state() is None and not kv.set_admit_threshold(1)
