"""PyTorch port: CCEH and extendible hashing against the JAX package.

Mirrors `tests/test_cceh.py` (no-split round trip, splits that grow
segments, the eviction fallback, update in place and delete, last-wins
duplicates, `recovery`, pages surviving splits). The same seeded batches
go through `pmdfc_tpu.models.cceh` and `pmdfc_tpu_torch.models.cceh` on
states that start equal, for the MSB directory (CCEH) and the LSB one
(extendible hashing); after every batch every leaf (`table`, `ld`,
`dirr`, `gdepth`, `nseg`) and every `InsertResult` field must be
identical (exact: integer arithmetic).

The port runs every insert round and the eviction tail unconditionally,
where JAX skips them under `lax.while_loop`/`lax.cond`; the batches here
include ones that place everything in the first round, ones that split,
and ones that evict, which pins that equivalence.
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
from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu.models import cceh as jcceh
from pmdfc_tpu.models.base import get_index_ops as jops
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.config import KVConfig as TKVConfig
from pmdfc_tpu_torch.models import base as tbase
from pmdfc_tpu_torch.models import cceh as tcceh
from pmdfc_tpu_torch.models.base import get_index_ops as tops
from pmdfc_tpu_torch.models.rowops import no_evict_stub
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

INV = 0xFFFFFFFF
KINDS = {True: "cceh", False: "extendible"}  # msb -> IndexKind value
LEAVES = ("table", "ld", "dirr", "gdepth", "nseg")


def _cfgs(msb, capacity=1 << 9, segment_slots=128, headroom=2):
    kw = dict(capacity=capacity, segment_slots=segment_slots,
              split_headroom=headroom)
    return (JIndexConfig(kind=JKind(KINDS[msb]), **kw),
            TIndexConfig(kind=TKind(KINDS[msb]), **kw))


def _init(msb, **kw):
    jc, tc = _cfgs(msb, **kw)
    return (jops(jc.kind), tops(tc.kind), jops(jc.kind).init(jc),
            tops(tc.kind).init(tc, device="cpu"), tc)


def _t(a):
    return u32.from_numpy(np.asarray(a, np.uint32), "cpu")


def _keys(lo, hi=1):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.full_like(lo, hi), lo], -1)


def _vals(lo):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.zeros_like(lo), lo], -1)


def _same_state(js, ts):
    for f in LEAVES:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f)
        b = u32.to_numpy(b).astype(a.dtype)
        assert np.array_equal(a, b), f"{f} drift"
    assert (ts.k_splits, ts.rounds, ts.msb) == (js.k_splits, js.rounds,
                                               js.msb)


def _same_result(jr, tr):
    for f in jr._fields:
        a, b = np.asarray(getattr(jr, f)), getattr(tr, f)
        b = u32.to_numpy(b) if a.dtype == np.uint32 else b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _insert_both(jo, to, js, ts, keys, vals):
    js, jr = jo.insert_batch(js, jnp.asarray(keys), jnp.asarray(vals))
    ts, tr = to.insert_batch(ts, _t(keys), _t(vals))
    _same_result(jr, tr)
    _same_state(js, ts)
    return js, ts, jr


def _get_both(jo, to, js, ts, keys):
    jr, tr = jo.get_batch(js, jnp.asarray(keys)), to.get_batch(ts, _t(keys))
    _same_result(jr, tr)
    jv, jf = jo.get_values(js, jnp.asarray(keys))
    tv, tf = to.get_values(ts, _t(keys))
    assert np.array_equal(u32.to_numpy(tv), np.asarray(jv))
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    return tr


@pytest.mark.parametrize("msb", [True, False], ids=KINDS.get)
def test_roundtrip_no_split(msb):
    jo, to, js, ts, _ = _init(msb)
    _same_state(js, ts)
    ks = _keys(np.arange(64))
    js, ts, jr = _insert_both(jo, to, js, ts, ks, _vals(np.arange(64) * 2))
    assert not np.asarray(jr.dropped).any() and int(ts.nseg) == 4
    got = _get_both(jo, to, js, ts, ks)
    assert got.found.all()
    assert np.array_equal(u32.to_numpy(got.values)[:, 1], np.arange(64) * 2)


@pytest.mark.parametrize("msb", [True, False], ids=KINDS.get)
def test_splits_grow_segments_and_keep_entries(msb):
    jo, to, js, ts, _ = _init(msb)
    rng = np.random.default_rng(3)
    lo = rng.choice(1 << 20, size=896, replace=False)
    ks = _keys(lo)
    for i in range(0, 896, 128):
        js, ts, _ = _insert_both(jo, to, js, ts, ks[i:i + 128],
                                 _vals(lo[i:i + 128]))
    assert int(ts.nseg) > 4 and int(ts.gdepth) > 2, "no split happened"
    got = _get_both(jo, to, js, ts, ks[:256])
    ok = got.found.numpy()
    assert ok.sum() > 200
    assert np.array_equal(u32.to_numpy(got.values)[ok, 1], lo[:256][ok])
    for a, b in zip(jo.scan(js), to.scan(ts)):
        assert np.array_equal(u32.to_numpy(b), np.asarray(a))


@pytest.mark.parametrize("msb", [True, False], ids=KINDS.get)
def test_eviction_fallback_when_headroom_exhausted(msb):
    jo, to, js, ts, tc = _init(msb, capacity=1 << 8, segment_slots=64,
                               headroom=1)
    n = to.num_slots(tc) * 3
    assert n == jo.num_slots(_cfgs(msb, 1 << 8, 64, 1)[0]) * 3
    rng = np.random.default_rng(5)
    lo = rng.choice(1 << 22, size=n, replace=False)
    ks = _keys(lo)
    ev = drop = 0
    for i in range(0, n, 256):
        js, ts, jr = _insert_both(jo, to, js, ts, ks[i:i + 256],
                                  _vals(lo[i:i + 256]))
        ev += int((np.asarray(jr.evicted) != INV).all(-1).sum())
        drop += int(np.asarray(jr.dropped).sum())
    assert ev > 0, "expected the eviction fallback"
    got = _get_both(jo, to, js, ts, ks[:256])
    assert int((~got.found).sum()) > 0


@pytest.mark.parametrize("msb", [True, False], ids=KINDS.get)
def test_update_in_place_delete_and_set_values(msb):
    jo, to, js, ts, _ = _init(msb)
    ks = _keys([7, 8, 9])
    js, ts, _ = _insert_both(jo, to, js, ts, ks, _vals([1, 2, 3]))
    js, ts, jr = _insert_both(jo, to, js, ts, ks[:1], _vals([9]))
    assert not bool(jr.fresh[0])
    gone = np.concatenate([ks[:1], ks[:1], _keys([99])])  # dup + absent
    js, jh, jold = jo.delete_batch(js, jnp.asarray(gone))
    ts, th, told = to.delete_batch(ts, _t(gone))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(u32.to_numpy(told), np.asarray(jold))
    assert th.tolist() == [True, True, False]
    _same_state(js, ts)
    got = _get_both(jo, to, js, ts, ks)
    assert got.found.tolist() == [False, True, True]
    sl = np.concatenate([[-1], got.slots.numpy()[1:]]).astype(np.int32)
    vals = np.array([[1, 2], [3, 4], [0x80000000, 5]], np.uint32)
    js = jo.set_values(js, jnp.asarray(sl), jnp.asarray(vals))
    ts = to.set_values(ts, torch.from_numpy(sl), _t(vals))
    _same_state(js, ts)


@pytest.mark.parametrize("msb", [True, False], ids=KINDS.get)
def test_duplicate_keys_in_batch_last_wins(msb):
    jo, to, js, ts, _ = _init(msb)
    ks = _keys([5, 5, 6, 5])
    js, ts, jr = _insert_both(jo, to, js, ts, ks, _vals([1, 2, 4, 3]))
    assert int((np.asarray(jr.slots) >= 0).sum()) == 2
    got = _get_both(jo, to, js, ts, ks[:1])
    assert int(u32.to_numpy(got.values)[0, 1]) == 3


@pytest.mark.parametrize("msb", [True, False], ids=KINDS.get)
def test_recovery_repairs_a_damaged_directory(msb):
    jo, to, js, ts, _ = _init(msb)
    rng = np.random.default_rng(11)
    lo = rng.choice(1 << 20, size=600, replace=False)
    ks = _keys(lo)
    js, ts, _ = _insert_both(jo, to, js, ts, ks[:512], _vals(lo[:512]))
    g = jcceh._geom(js)
    dirr, ld = np.asarray(js.dirr).copy(), np.asarray(js.ld)
    # damage an entry that is not its replication class's canonical one
    for i in range(g.Smax):
        s = dirr[i]
        canon = (i & ~((1 << (g.Gmax - ld[s])) - 1)) if msb \
            else (i & ((1 << ld[s]) - 1))
        if canon != i:
            dirr[i] = (s + 1) % g.Smax
            break
    else:
        pytest.fail("no replicated directory entry to damage")
    bad_j = dataclasses.replace(js, dirr=jnp.asarray(dirr),
                                gdepth=jnp.uint32(0))
    bad_t = dataclasses.replace(ts, dirr=torch.from_numpy(dirr.copy()),
                                gdepth=torch.tensor(0, dtype=torch.int32))
    fixed_j = jo.recovery(bad_j)
    fixed_t = to.recovery(bad_t)
    assert fixed_t is bad_t  # in place
    _same_state(fixed_j, fixed_t)
    _same_state(js, fixed_t)
    assert _get_both(jo, to, fixed_j, fixed_t, ks[:512]).found.all()


@pytest.mark.parametrize("msb", [True, False], ids=KINDS.get)
def test_split_round_with_nothing_to_split_changes_nothing(msb):
    """The always-run equivalence at its root: a split round with an
    empty `want`, and an insert of nothing but padding (every round and
    the tail run on empty masks), leave every leaf as it was."""
    _, to, _, ts, _ = _init(msb)
    ks = _keys(np.arange(300))
    to.insert_batch(ts, _t(ks), _t(_vals(np.arange(300))))
    before = {f: getattr(ts, f).clone() for f in LEAVES}
    g = tcceh._geom(ts)
    tcceh._split_round(g, ts, torch.zeros(g.Smax, dtype=torch.bool))
    pad = _t(np.full((16, 2), INV, np.uint32))
    _, res = to.insert_batch(ts, pad, pad)
    for f in LEAVES:
        assert torch.equal(getattr(ts, f), before[f]), f
    no_ek, no_ev, no_drop, _ = no_evict_stub(16, "cpu")
    assert (res.slots == -1).all() and not res.fresh.any()
    assert torch.equal(res.evicted, no_ek)
    assert torch.equal(res.evicted_vals, no_ev)
    assert torch.equal(res.dropped, no_drop)


def test_batch_rank_by_segment_matches_jax():
    from pmdfc_tpu.models import base as jbase

    rng = np.random.default_rng(2)
    seg = rng.integers(0, 9, 200).astype(np.uint32)
    mask = rng.random(200) < 0.6
    want = np.asarray(jbase.batch_rank_by_segment(jnp.asarray(seg),
                                                  jnp.asarray(mask)))
    got = tbase.batch_rank_by_segment(torch.from_numpy(seg.astype(np.int64)),
                                      torch.from_numpy(mask))
    assert np.array_equal(got.numpy()[mask], want[mask])


def jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


@pytest.mark.parametrize("msb", [True, False], ids=KINDS.get)
def test_paged_kv_pages_survive_splits(msb):
    """Through both `KV`s: pages stay attached to their keys across the
    splits later batches trigger; every leaf, stat and result agrees."""
    jc, tc = _cfgs(msb)
    a = jkv.KV(JKVConfig(index=jc, bloom=None, page_words=8))
    b = tkv.KV(TKVConfig(index=tc, bloom=None, page_words=8), device="cpu")
    rng = np.random.default_rng(7)
    n = 1024
    lo = rng.choice(1 << 20, size=n, replace=False)
    ks = _keys(lo)
    pages = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    for i in range(0, n, 128):
        ra, rb = a.insert(ks[i:i + 128], pages[i:i + 128]), \
            b.insert(ks[i:i + 128], pages[i:i + 128])
        for f in ra._fields:
            assert np.array_equal(np.asarray(getattr(ra, f)),
                                  getattr(rb, f)), f
    (oa, fa), (ob, fb) = a.get(ks), b.get(ks)
    assert np.array_equal(oa, ob) and np.array_equal(fa, fb)
    assert np.array_equal(ob[fb], pages[fb])
    sa, sb = a.stats(), b.stats()
    assert all(sa[k] == sb[k] for k in tkv.STAT_NAMES)
    assert (~fb).sum() <= sb["evictions"] + sb["drops"]
    la, lb = jax_leaves(a.state), carry.state_to_numpy(b.state)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k


@pytest.mark.parametrize("msb", [True, False], ids=KINDS.get)
def test_state_carries_across_leaf_for_leaf(msb):
    """state_to_numpy(state_from_numpy(x)) == x for a split, paged state
    with extents, dtypes included (ld and gdepth are uint32 in JAX); the
    static knobs come from the config."""
    jc, tc = _cfgs(msb)
    kv = jkv.KV(JKVConfig(index=jc, page_words=8))
    rng = np.random.default_rng(4)
    lo = rng.choice(1 << 20, size=768, replace=False)
    kv.insert(_keys(lo), rng.integers(0, 1 << 32, (768, 8), dtype=np.uint32))
    kv.insert_extent(np.array([9, 4000], np.uint32),
                     np.array([1, 2], np.uint32), 37)
    leaves = jax_leaves(kv.state)
    assert int(leaves["index.nseg"]) > 4
    tst = carry.state_from_numpy(leaves, TKVConfig(index=tc, page_words=8),
                                 "cpu")
    assert (tst.index.k_splits, tst.index.rounds, tst.index.msb) == (
        kv.state.index.k_splits, kv.state.index.rounds, msb)
    back = carry.state_to_numpy(tst)
    assert sorted(back) == sorted(leaves)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
