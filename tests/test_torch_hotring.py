"""PyTorch port: HotRing's hotness machinery against the JAX package.

The twins of `tests/test_hotring.py` (hot-point shift into the mirror,
the mirror never serving a stale value, decay running the shift, the
tag-half rehash), each run through both packages on the same seeded keys
and held leaf by leaf, plus the port's own hazards: `touch` with a slot
repeated in one batch (every repeat counts), the two u32 sorts
(`hotspot_shift`'s heat order and the eviction's coldness order) over
tied counters and counters at or above 2^31, and `decay`'s shift of
such counters (no sign bit shifted in).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.models import hotring as jhr
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.models import hotring as thr
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

CFG = dict(capacity=1 << 10, cluster_slots=16, hot_lanes=4)


def _t(a):
    return u32.from_numpy(np.asarray(a, np.uint32), "cpu")


def _init():
    return (jhr.init(JIndexConfig(kind=JKind.HOTRING, **CFG)),
            thr.init(TIndexConfig(kind=TKind.HOTRING, **CFG), device="cpu"))


def _same_state(js, ts, what):
    for f in dataclasses.fields(js):
        a, b = np.asarray(getattr(js, f.name)), getattr(ts, f.name)
        b = b.numpy() if a.dtype == np.int32 else u32.to_numpy(b)
        assert a.shape == b.shape and np.array_equal(a, b), \
            f"{what}: leaf {f.name} differs"


def _same(a, b, what):
    b = b.numpy() if b.dtype != torch.int32 else u32.to_numpy(b)
    a = np.asarray(a)
    if a.dtype == np.int32:
        b = b.view(np.int32)
    assert np.array_equal(a, b), f"{what} differs"


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 20, size=n, replace=False).astype(np.uint32)
    return np.stack([flat >> 10, flat & 0x3FF], axis=-1).astype(np.uint32)


def _vals(keys):
    return np.stack([keys[:, 1], keys[:, 0]], -1).astype(np.uint32)


def _both(fn_j, fn_t, js, ts, *args):
    """Apply a state -> state verb (or one with a result) to both."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) if a.dtype == np.uint32 else torch.from_numpy(a)
             for a in args]
    return fn_j(js, *jargs), fn_t(ts, *targs)


def _insert(js, ts, keys, vals, what):
    (js, jr), (ts, tr) = _both(jhr.insert_batch, thr.insert_batch, js, ts,
                               keys, vals)
    for f in jr._fields:
        _same(getattr(jr, f), getattr(tr, f), f"{what} {f}")
    _same_state(js, ts, what)
    return js, ts, jr


def _touch_gets(js, ts, keys, what):
    """A counting GET's index work: get_batch, then touch its slots."""
    jres, tres = _both(jhr.get_batch, thr.get_batch, js, ts, keys)
    for f in jres._fields:
        _same(getattr(jres, f), getattr(tres, f), f"{what} {f}")
    js = jhr.touch(js, jres.slots)
    ts = thr.touch(ts, tres.slots)
    _same_state(js, ts, what)
    return js, ts


def test_shift_promotes_hot_keys_to_mirror():
    """Zipf-style touches: after the shift every hot key resolves from the
    mirror, most cold ones do not, and GETs answer right — in both."""
    js, ts = _init()
    keys = _keys(512, seed=1)
    js, ts, jr = _insert(js, ts, keys, _vals(keys), "insert")
    placed = ~np.asarray(jr.dropped)
    assert placed[:32].all()
    for _ in range(8):
        js, ts = _touch_gets(js, ts, keys[:32], "hot gets")
    js, ts = _touch_gets(js, ts, keys, "all gets")
    js, ts = jhr.hotspot_shift(js), thr.hotspot_shift(ts)
    _same_state(js, ts, "shift")
    hot_hit = thr.probe_hot(ts, _t(keys)).numpy()
    assert np.array_equal(hot_hit, np.asarray(jhr.probe_hot(js,
                                                            jnp.asarray(keys))))
    assert hot_hit[:32].all() and hot_hit[32:].mean() < 0.8
    out = thr.get_batch(ts, _t(keys))
    assert np.array_equal(out.found.numpy(), placed)
    assert np.array_equal(u32.to_numpy(out.values)[placed],
                          _vals(keys)[placed])
    jv, jf = jhr.get_values(js, jnp.asarray(keys))
    tv, tf = thr.get_values(ts, _t(keys))
    _same(jv, tv, "lean values")
    _same(jf, tf, "lean found")


def test_mirror_never_serves_stale_values():
    """In-place updates and deletes invalidate the mirror rows they touch:
    the new values come from the table, deleted keys from nowhere."""
    js, ts = _init()
    keys = _keys(64, seed=2)
    js, ts, _ = _insert(js, ts, keys, _vals(keys), "insert")
    js, ts = _touch_gets(js, ts, keys, "gets")
    js, ts = jhr.hotspot_shift(js), thr.hotspot_shift(ts)
    assert thr.probe_hot(ts, _t(keys)).all()

    newv = _vals(keys) ^ np.uint32(0xABCD)
    js, ts, _ = _insert(js, ts, keys[:32], newv[:32], "update")
    assert not thr.probe_hot(ts, _t(keys[:32])).any()
    out = thr.get_batch(ts, _t(keys))
    assert out.found.all()
    assert np.array_equal(u32.to_numpy(out.values)[:32], newv[:32])
    assert np.array_equal(u32.to_numpy(out.values)[32:], _vals(keys)[32:])

    (js, jh, jo), (ts, th, to) = _both(jhr.delete_batch, thr.delete_batch,
                                       js, ts, keys[:8])
    _same(jh, th, "delete hit")
    _same(jo, to, "delete old values")
    _same_state(js, ts, "delete")
    assert th.all()
    assert not thr.get_batch(ts, _t(keys[:8])).found.any()
    assert not thr.probe_hot(ts, _t(keys[:8])).any()


def test_decay_halves_and_runs_the_shift():
    js, ts = _init()
    keys = _keys(32, seed=3)
    js, ts, _ = _insert(js, ts, keys, _vals(keys), "insert")
    js, ts = _touch_gets(js, ts, keys, "gets")
    js, ts = jhr.decay(js), thr.decay(ts)
    _same_state(js, ts, "decay")
    assert thr.probe_hot(ts, _t(keys)).sum() > 0


def test_rehash_splits_by_tag_half_losslessly():
    """The bucket array doubles; every placed entry still resolves with its
    value, each old ring split between rows r and r + C — in both."""
    js, ts = _init()
    keys = _keys(700, seed=4)
    js, ts, jr = _insert(js, ts, keys, _vals(keys), "insert")
    placed = np.asarray(jr.slots) >= 0
    c = ts.table.shape[0]
    js2, ts2 = jhr.rehash(js), thr.rehash(ts)
    _same_state(js2, ts2, "rehash")
    assert ts2.table.shape[0] == 2 * c
    out = thr.get_batch(ts2, _t(keys))
    assert out.found.numpy()[placed].all()
    assert np.array_equal(u32.to_numpy(out.values)[placed],
                          _vals(keys)[placed])
    s = CFG["cluster_slots"]
    occ = ~((u32.to_numpy(ts2.table[:, :s]) == 0xFFFFFFFF)
            & (u32.to_numpy(ts2.table[:, s:2 * s]) == 0xFFFFFFFF))
    assert occ[:c].sum() and occ[c:].sum() and occ.sum() == placed.sum()


def test_touch_counts_every_repeat_of_a_slot():
    """A slot repeated in one touch batch gains one count per repeat
    (hazard (w): a scatter that keeps one write per index would lose
    them); -1 slots count nothing."""
    js, ts = _init()
    keys = _keys(64, seed=5)
    js, ts, _ = _insert(js, ts, keys, _vals(keys), "insert")
    probe = np.concatenate([keys[:4]] * 5 + [keys[4:20],
                                             np.full((4, 2), 0xFFFFFFFF,
                                                     np.uint32)])
    js, ts = _touch_gets(js, ts, probe, "repeated touches")
    res = thr.get_batch(ts, _t(keys[:4]))
    s = CFG["cluster_slots"]
    sl = res.slots.numpy()
    assert (u32.to_numpy(ts.counters)[sl // s, sl % s] == 5).all()


# u32 counter values with ties, around 2^31 and at the top of the range
EDGE = np.array([0, 1, 1, 7, 0x7FFFFFFF, 0x80000000, 0x80000000,
                 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _set_counters(js, ts, rng):
    cnt = rng.choice(EDGE, size=tuple(ts.counters.shape)).astype(np.uint32)
    return (dataclasses.replace(js, counters=jnp.asarray(cnt)),
            dataclasses.replace(ts, counters=_t(cnt)))


def test_sorts_and_decay_on_high_and_tied_counters():
    """Hazard (v): the shift's heat order (`min(~counters, 0xFFFFFFFE)`) and
    the eviction's coldness order (`where(cand, counters, 0xFFFFFFFF)`) are
    stable argsorts over u32 words, and `decay` shifts u32 words. Counters
    drawn from tied values and values >= 2^31 must give the same mirror,
    the same victims and the same halved counters as JAX."""
    rng = np.random.default_rng(6)
    js, ts = _init()
    keys = _keys(1024, seed=6)  # 1024 keys over 1024 slots: full buckets
    js, ts, _ = _insert(js, ts, keys, _vals(keys), "fill")
    js, ts = _set_counters(js, ts, rng)
    js, ts = jhr.hotspot_shift(js), thr.hotspot_shift(ts)
    _same_state(js, ts, "shift over edge counters")
    more = _keys(2048, seed=7)[1024:]
    js, ts, jr = _insert(js, ts, more, _vals(more), "evicting insert")
    assert (~(np.asarray(jr.evicted) == 0xFFFFFFFF).all(-1)).sum() > 100
    js, ts = _set_counters(js, ts, rng)
    js, ts = jhr.decay(js), thr.decay(ts)
    _same_state(js, ts, "decay over edge counters")
    assert (u32.to_numpy(ts.counters) == 0x7FFFFFFF).any()  # 0xFFFFFFFF >> 1
