"""PyTorch port: `tests/test_insert_compaction.py`'s drills on both packages.

The JAX suite marks these drills `slow`: batches of B = 2^14 keys, large
enough that cuckoo's and path's narrow rounds (b/8, b/4, b/16) and
level's narrow bottom tail are real, and the high-fill regime that
forces the full-width fallback. Here each drill runs the JAX index ops
and the port's (`device="cpu"`) on the same seeded keys at the JAX
drill's size: every insert result (slots, fresh, dropped, evicted),
every GET and every state leaf must be equal (tolerance 0, integer
arithmetic only), and the JAX drill's own invariants are then held on
the port's results. The fourth drill, eviction-free batches per family,
is in `tests/test_torch_insert_fresh_slots.py`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from test_torch_families import _same, _same_result, _same_state, _t

from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.models.base import get_index_ops as jops
from pmdfc_tpu.utils.keys import pack_key
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.models.base import get_index_ops as tops

pytestmark = pytest.mark.torch

B = 1 << 14  # > 1024 * 8, so cuckoo's W = b/8 and path's W1, W2 engage
INV = 0xFFFFFFFF


def keys_of(lo):
    lo = np.asarray(lo, np.uint32)
    keys = np.stack([np.full_like(lo, 7), lo], -1)
    assert np.array_equal(keys, np.asarray(pack_key(np.full_like(lo, 7),
                                                    lo)))
    return keys


def vals_of(lo):
    lo = np.asarray(lo, np.uint32)
    return np.stack([lo ^ np.uint32(0xABCD), lo], axis=-1)


class Twin:
    """One index of `kind` in each package, driven in step."""

    def __init__(self, kind: str, capacity: int, **kw):
        self.jo, self.to = jops(JKind(kind)), tops(TKind(kind))
        self.js = self.jo.init(JIndexConfig(kind=JKind(kind),
                                            capacity=capacity, **kw))
        self.ts = self.to.init(TIndexConfig(kind=TKind(kind),
                                            capacity=capacity, **kw),
                               device="cpu")
        _same_state(self.js, self.ts, f"{kind} init")
        self.kind = kind

    def insert(self, ks, vs, what):
        self.js, jr = self.jo.insert_batch(self.js, jnp.asarray(ks),
                                           jnp.asarray(vs))
        self.ts, tr = self.to.insert_batch(self.ts, _t(ks), _t(vs))
        _same_result(jr, tr, f"{self.kind} {what}")
        _same_state(self.js, self.ts, f"{self.kind} {what}")
        return tuple(map(np.asarray, (tr.fresh, tr.dropped))) + (
            np.asarray(jr.evicted),)

    def get_batch(self, ks, what):
        jr = self.jo.get_batch(self.js, jnp.asarray(ks))
        _same_result(jr, self.to.get_batch(self.ts, _t(ks)),
                     f"{self.kind} {what}")
        return jr

    def get_values(self, ks, what):
        jv, jf = self.jo.get_values(self.js, jnp.asarray(ks))
        tv, tf = self.to.get_values(self.ts, _t(ks))
        _same(jv, tv, f"{self.kind} {what} values")
        _same(jf, tf, f"{self.kind} {what} found")
        return np.asarray(jv), np.asarray(jf)


def _live_evicted(ev):
    return (ev[:, 0] != INV) | (ev[:, 1] != INV)


@pytest.mark.parametrize("kind", ["cuckoo", "path"])
def test_narrow_rounds_place_everything_at_fill(kind):
    """A 0.5x-capacity fill batch through the narrow rounds: every key not
    reported dropped or evicted is found, bit-exact, in both packages."""
    tw = Twin(kind, 2 * B)
    ks, vs = keys_of(np.arange(B)), vals_of(np.arange(B))
    _, dropped, ev = tw.insert(ks, vs, "fill")
    ev_live = _live_evicted(ev)
    assert dropped.sum() + ev_live.sum() < B // 100
    got = tw.get_batch(ks, "get after fill")
    found = np.asarray(got.found)
    lost = set(map(tuple, ev[ev_live].tolist()))
    for i in np.nonzero(~found)[0]:
        assert dropped[i] or (tuple(ks[i].tolist()) in lost)
    ok = found & ~dropped
    np.testing.assert_array_equal(np.asarray(got.values)[ok], vs[ok])


@pytest.mark.parametrize("kind", ["cuckoo", "path"])
def test_overflow_fallback_keeps_accounting(kind):
    """1.5x-capacity pressure in B/2-key batches forces the full-width
    fallback: every miss is explained by a reported eviction or drop."""
    tw = Twin(kind, B)
    rng = np.random.default_rng(5)
    all_ks = []
    lost = 0
    for r in range(3):
        lo = rng.integers(0, 1 << 30, B // 2).astype(np.uint32)
        ks = keys_of(lo)
        _, dropped, ev = tw.insert(ks, vals_of(lo), f"round {r}")
        lost += int(dropped.sum()) + int(_live_evicted(ev).sum())
        all_ks.append(ks)
    got = tw.get_batch(np.concatenate(all_ks), "get after the rounds")
    misses = int((~np.asarray(got.found)).sum())
    assert misses <= lost


def test_level_narrow_bottom_tail_exact():
    """Level's lean GET probes the bottom tier at a compacted b/8 width:
    keys that live in the bottom rows come back bit-exact on the narrow
    branch, and an absent-key storm takes the full-width branch with no
    key fabricated; both packages equal throughout."""
    tw = Twin("level", B)
    rng = np.random.default_rng(9)
    lo = rng.choice(1 << 24, size=int(B * 0.8), replace=False).astype(
        np.uint32)
    ks, vs = keys_of(lo), vals_of(lo)
    _, dropped, ev = tw.insert(ks, vs, "fill")
    lost = set(map(tuple, ev[_live_evicted(ev)].tolist()))
    live = ~dropped & np.array([tuple(k) not in lost for k in ks.tolist()])
    slots = np.asarray(tw.get_batch(ks, "get").slots)
    top_slots = tw.js.top_rows * (tw.js.table.shape[1] // 4)
    bottom_live = int((live & (slots >= top_slots)).sum())
    assert 0 < bottom_live <= max(1024, B // 8), bottom_live
    vals, found = tw.get_values(ks, "lean get")
    assert found[live].all()
    np.testing.assert_array_equal(vals[live], vs[live])
    ab = keys_of(np.arange(1 << 25, (1 << 25) + B, dtype=np.uint32))
    _, f_ab = tw.get_values(ab, "absent storm")
    assert not f_ab.any()
