"""PyTorch port: extents and FindAnyway against the JAX package.

- `_covers`, the aligned power-of-two cover decomposition of a page run
  (`CCEH::Insert_extent`), on its edges: length 0, a run that needs more
  than `extent_max_covers` covers, runs around 2^31 and up to and past
  2^32 (u32 wrap), a cover height cap.
- `insert_extent` / `get_extent` / `find_anyway` through both `KV`s, on
  the linear index and on CCEH, over a paged pool: covers over page
  entries (their rows freed), page puts over covers (converted), page
  GETs of cover keys (`miss_cold` through the EXT cause), and every
  result, stat and leaf identical.
- The unsigned carry of `value + 4096 * (key - base)` when the low word
  crosses 2^31 (where a signed compare would go wrong) and 2^32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu import kv as jkv
from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.config import KVConfig as TKVConfig

pytestmark = pytest.mark.torch

INV = 0xFFFFFFFF
PW = 16


@pytest.mark.parametrize("lo,length,max_covers,max_height", [
    (0, 0, 8, 30),                    # nothing to cover
    (5, 0, 8, 30),
    (0, 1, 8, 30),
    (1000, 100, 64, 30),
    (3, 1000, 4, 30),                 # more than max_covers: a tail is left
    (0, 2000, 64, 5),                 # capped at 2^4 pages: 125 covers needed
    (0x7FFFFF00, 0x300, 64, 30),      # across 2^31
    (0xFFFFFF00, 0x100, 64, 30),      # up to 2^32
    (0xFFFFFFF0, 0x40, 64, 30),       # past 2^32: the head wraps
    (0xFFFFFFFF, 1, 8, 30),           # the last word
    (0, 0xFFFFFFFF, 64, 32),          # the whole space, 2^31-page covers
])
def test_covers_match_jax(lo, length, max_covers, max_height):
    jb, jrem = jkv._covers(jnp.uint32(lo), jnp.uint32(length), max_covers,
                           max_height)
    tb, trem = tkv._covers(lo, length, max_covers, max_height)
    assert np.array_equal(np.array(tb, np.uint32), np.asarray(jb))
    assert trem == int(jrem)


def _configs(kind):
    ix = dict(capacity=1024, cluster_slots=32) if kind == "linear" else \
        dict(capacity=512, segment_slots=128, split_headroom=1)
    kw = dict(page_words=PW, evicted_sketch_bits=1 << 10,
              extent_capacity=16, extent_max_covers=16)
    return (JKVConfig(index=JIndexConfig(kind=JKind(kind), **ix), **kw),
            TKVConfig(index=TIndexConfig(kind=TKind(kind), **ix), **kw))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b), what


def jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _addr(value, key_lo, base):
    """The reference's address arithmetic on Python ints (u64)."""
    v = (int(value[0]) << 32) | int(value[1])
    return (v + 4096 * (int(key_lo) - base)) % (1 << 64)


# (hi, base, value hi, value lo, length): the value low words sit just
# below 2^31 and 2^32, so value + 4096 * offset crosses them
EXTENTS = [
    (5, 1000, 0, 0x7FFFF000, 100),
    (5, 0x7FFFFFF0, 1, 0xFFFFE000, 40),      # base across 2^31
    (5, 0xFFFFFF80, 2, 0x12345000, 128),     # base up to 2^32
    (6, 64, 0x7FFFFFFF, 0xFFFFF000, 3),      # value hi carries to 2^31
    (6, 300, 0, 0, 0),                       # empty run
    (7, 2, 0, 0x80000000, 200000),           # more than 16 covers: a tail
]


@pytest.mark.parametrize("kind", ["linear", "cceh"])
def test_extent_verbs_match_jax(kind):
    jcfg, tcfg = _configs(kind)
    a, b = jkv.KV(jcfg), tkv.KV(tcfg, device="cpu")
    rng = np.random.default_rng(3)
    # page entries, some of them at keys a cover will take over
    pk = np.concatenate([
        np.stack([np.full(200, 5, np.uint32),
                  rng.integers(0, 1 << 32, 200, dtype=np.uint32)], -1),
        np.array([[5, 1000], [5, 1024], [5, 0x7FFFFFF0], [6, 64]],
                 np.uint32)])
    pages = rng.integers(0, 1 << 32, (len(pk), PW), dtype=np.uint32)
    a.insert(pk, pages)
    b.insert(pk, pages)
    top0 = int(b.state.pool.top)

    covered = []
    for hi, base, vhi, vlo, n in EXTENTS:
        key = np.array([hi, base], np.uint32)
        val = np.array([vhi, vlo], np.uint32)
        (ra, ua), (rb, ub) = a.insert_extent(key, val, n), \
            b.insert_extent(key, val, n)
        for f in ra._fields:
            _same(getattr(ra, f), getattr(rb, f), f"insert_extent {f}")
        assert ua == ub
        covered.append((hi, base, val, n - ub))
    assert int(b.state.pool.top) > top0, "covers over pages free rows"
    assert covered[-1][3] < EXTENTS[-1][4], "the long run leaves a tail"

    probe = []
    for hi, base, _, m in covered:
        offs = [0, m - 1, m // 2, m, m + 7] if m else [0, 1]
        probe += [[hi, (base + o) & INV] for o in offs]
    probe = np.array(probe + [[9, 9], [INV, INV]], np.uint32)
    (oa, fa), (ob, fb) = a.get_extent(probe), b.get_extent(probe)
    _same(oa, ob, "get_extent out")
    _same(fa, fb, "get_extent found")
    i = 0
    for hi, base, val, m in covered:
        offs = [0, m - 1, m // 2, m, m + 7] if m else [0, 1]
        for o in offs:
            lo = (base + o) & INV
            if o < m and lo >= base:
                assert fb[i], (hi, base, o)
                want = _addr(val, lo, base)
                assert (int(ob[i, 0]) << 32 | int(ob[i, 1])) == want
            i += 1
    assert fb.sum() >= 12 and not fb[-2:].any()

    # a page GET of a cover key is a miss (cause EXT, counted as cold);
    # a page put over a cover converts it
    cover_keys = np.array([[5, 1000], [5, 1024], [6, 64]], np.uint32)
    s0 = b.stats()
    (oa, fa), (ob, fb) = a.get(cover_keys), b.get(cover_keys)
    _same(oa, ob, "page get of covers")
    assert not fb.any() and not ob.any()
    assert b.stats()["miss_cold"] - s0["miss_cold"] == 3
    newp = rng.integers(0, 1 << 32, (2, PW), dtype=np.uint32)
    a.insert(cover_keys[:2], newp)
    b.insert(cover_keys[:2], newp)
    (oa, fa), (ob, fb) = a.get(cover_keys), b.get(cover_keys)
    _same(oa, ob, "page get after conversion")
    assert fb.tolist() == [True, True, False]
    assert np.array_equal(ob[:2], newp)

    fa_ = a.find_anyway(np.concatenate([cover_keys, pk[:5], [[9, 9]]]))
    fb_ = b.find_anyway(np.concatenate([cover_keys, pk[:5], [[9, 9]]]))
    for x, y, what in zip(fa_, fb_, ("values", "found", "slot")):
        _same(x, y, f"find_anyway {what}")
    assert fb_[1][:3].all() and not fb_[1][-1]

    sa, sb = a.stats(), b.stats()
    assert all(sa[k] == sb[k] for k in tkv.STAT_NAMES)
    assert sb["extent_puts"] == len(EXTENTS)
    assert sb["misses"] == sum(sb[c] for c in tkv.MISS_CAUSE_NAMES)
    la, lb = jax_leaves(a.state), carry.state_to_numpy(b.state)
    for k in la:
        _same(la[k], lb[k], f"leaf {k}")


def test_extent_ring_wraps_like_jax():
    """More extents than ring records: the cursor wraps, the newest
    record takes the oldest one's place, and a stale cover no longer
    spans its keys."""
    jcfg, tcfg = _configs("linear")
    a, b = jkv.KV(jcfg), tkv.KV(tcfg, device="cpu")
    n = jcfg.extent_capacity + 3
    for j in range(n):
        key = np.array([3, 1000 * j], np.uint32)
        val = np.array([0, 4096 * j], np.uint32)
        a.insert_extent(key, val, 8)
        b.insert_extent(key, val, 8)
    probe = np.array([[3, 1000 * j + 1] for j in range(n)], np.uint32)
    (oa, fa), (ob, fb) = a.get_extent(probe), b.get_extent(probe)
    _same(oa, ob, "out")
    _same(fa, fb, "found")
    assert not fb[:3].any() and fb[3:].all()
    _same(jax_leaves(a.state)["extents.cursor"],
          carry.state_to_numpy(b.state)["extents.cursor"], "cursor")
