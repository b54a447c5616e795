"""PyTorch port: the placement ring and the migration rate bound
(`cluster/ring.py`, `cluster/migrate.py`) against the JAX package.

The port's cluster modules are its own copies (numpy only). For the same
members, vnodes and seed they must give JAX's owner sets (batch and
scalar), ring positions, `moved_mask` and epochs through `join`, `leave`,
`rejoin` and `replace`, and `TokenBucket` must grant the same tokens on
the same clock. The JAX ring drills' twins run on the port: batch vs
scalar identity, immutable epochs, the measured ~rf/N move bound.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu.cluster import migrate as jmig
from pmdfc_tpu.cluster import ring as jring
from pmdfc_tpu_torch.cluster import migrate as tmig
from pmdfc_tpu_torch.cluster import ring as tring
from pmdfc_tpu_torch.cluster.ring import HashRing, moved_mask

pytestmark = pytest.mark.torch


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _hi_keys(n, seed=0):
    """Keys with hi >= 2^31 (the serving paths' key space)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(1 << 31, 1 << 32, n, dtype=np.uint64),
                     rng.integers(0, 1 << 32, n, dtype=np.uint64)],
                    -1).astype(np.uint32)


@pytest.mark.parametrize("members,vnodes,seed", [
    (range(3), 64, 0x51C0_C0DE), (range(5), 32, 1234), ((2, 7, 9, 11), 8, 5)])
def test_ring_matches_jax(members, vnodes, seed):
    keys = np.concatenate([_keys(2048, seed=3), _hi_keys(2048, seed=4)])
    j = jring.HashRing(members, vnodes=vnodes, seed=seed)
    t = tring.HashRing(members, vnodes=vnodes, seed=seed)
    np.testing.assert_array_equal(t.positions(keys), j.positions(keys))
    np.testing.assert_array_equal(tring.key_pos(keys, seed),
                                  jring.key_pos(keys, seed))
    rf = min(3, len(t.members))
    for r in range(1, rf + 1):
        np.testing.assert_array_equal(t.owners_np(keys, r),
                                      j.owners_np(keys, r))
    for i in range(64):
        assert t.owner_set(tuple(keys[i]), rf) == j.owner_set(
            tuple(keys[i]), rf)
    assert t.describe() == j.describe()
    # the same transitions give the same rings and the same moves
    first = t.members[0]
    steps = [("join", 40), ("leave", first), ("rejoin", t.members[-1]),
             ("replace", t.members[-1], 41)]
    for op, *args in steps:
        jn, tn = getattr(j, op)(*args), getattr(t, op)(*args)
        assert (tn.epoch, tn.members) == (jn.epoch, jn.members)
        np.testing.assert_array_equal(tn.owners_np(keys, 2),
                                      jn.owners_np(keys, 2))
        np.testing.assert_array_equal(tring.moved_mask(t, tn, keys, 2),
                                      jring.moved_mask(j, jn, keys, 2))
        j, t = jn, tn


def test_token_bucket_matches_jax_on_one_clock(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    jb, tb = jmig.TokenBucket(1000.0, 100), tmig.TokenBucket(1000.0, 100)
    for dt, n, rate in [(0, 50, None), (0, 100, None), (0.01, 7, None),
                        (0.05, 1000, None), (0.2, 30, 10.0), (0.5, 30, None),
                        (1.0, 500, 2000.0), (0.001, 5, None)]:
        clock[0] += dt
        if rate is not None:
            jb.set_rate(rate), tb.set_rate(rate)
        assert tb.take(n) == jb.take(n)
    assert tmig.TokenBucket(0, 1).take(10**6) == 10**6


def test_token_bucket_rate_bound():
    tb = tmig.TokenBucket(rate=1000.0, burst=100)
    assert tb.take(50) == 50
    assert tb.take(100) == 50
    assert tb.take(100) == 0
    time.sleep(0.05)
    got = tb.take(1000)
    assert 20 <= got <= 100, got


def test_ring_owner_identity_batch_vs_scalar():
    r = HashRing(range(5), vnodes=32, seed=1234)
    keys = _keys(512, seed=3)
    own = r.owners_np(keys, 3)
    assert own.shape == (512, 3)
    assert (own[:, 0] != own[:, 1]).all()
    assert (own[:, 1] != own[:, 2]).all()
    assert (own[:, 0] != own[:, 2]).all()
    for i in range(128):
        assert r.owner_set(tuple(keys[i]), 3) == tuple(own[i])
    prim = np.bincount(own[:, 0], minlength=5)
    assert (prim > 0).all(), prim


def test_ring_epoch_monotonic_and_immutable():
    r1 = HashRing(range(3), vnodes=16)
    r2 = r1.join(7)
    r3 = r2.leave(0)
    r4 = r3.replace(1, 9)
    assert (r1.epoch, r2.epoch, r3.epoch, r4.epoch) == (1, 2, 3, 4)
    assert r1.members == (0, 1, 2)
    assert r4.members == (2, 7, 9)
    with pytest.raises(ValueError):
        r1.join(2)
    with pytest.raises(ValueError):
        r1.leave(9)
    with pytest.raises(ValueError):
        HashRing([0]).leave(0)
    keys = _keys(256, seed=5)
    assert (r1.positions(keys) == r4.positions(keys)).all()
    r5 = r4.rejoin(7)
    assert r5.epoch == 5 and r5.members == r4.members
    np.testing.assert_array_equal(r5.owners_np(keys, 2),
                                  r4.owners_np(keys, 2))
    with pytest.raises(ValueError):
        r4.rejoin(4)


def test_ring_stability_measured_join_and_leave():
    n, rf = 8, 2
    keys = _keys(20000, seed=11)
    r = HashRing(range(n), vnodes=64)
    r2 = r.join(n)
    prim_moved = (r.owners_np(keys, 1)[:, 0]
                  != r2.owners_np(keys, 1)[:, 0]).mean()
    exp = 1.0 / (n + 1)
    assert 0.3 * exp < prim_moved < 2.0 * exp
    set_moved = moved_mask(r, r2, keys, rf).mean()
    exp_set = rf / (n + 1)
    assert 0.3 * exp_set < set_moved < 2.0 * exp_set
    r3 = r2.leave(n)
    assert 0.3 * exp_set < moved_mask(r2, r3, keys, rf).mean() < 2.0 * exp_set
    o1, o2 = r.owners_np(keys, rf), r2.owners_np(keys, rf)
    untouched = ~(o2 == n).any(axis=1)
    assert (o1[untouched] == o2[untouched]).all()
