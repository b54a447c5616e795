"""PyTorch port: the insert plan and the linear index against the JAX package.

The same seeded batches go through `pmdfc_tpu.models.{base,linear}` and
`pmdfc_tpu_torch.models.{base,linear}` on states that start equal; the
outputs and the state after every op must be identical (exact: all of
it is integer arithmetic). Keys with hi >= 2^31 pin the unsigned sort
order the plan's ranks (and so the FIFO lanes) hang on.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.models import base as jbase
from pmdfc_tpu.models import linear as jlin
from pmdfc_tpu.utils.hashing import hash_u64 as jhash_u64
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.models import base as tbase
from pmdfc_tpu_torch.models import linear as tlin
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

INV = 0xFFFFFFFF


def _t(a):
    return u32.from_numpy(np.asarray(a, np.uint32), "cpu")


def _n(t):
    return u32.to_numpy(t)


def _batch(rng, n, dup=16, pad=12):
    """Keys with hi words on both sides of 2^31, duplicates, and padding."""
    keys = np.stack([rng.integers(0, 1 << 32, n, dtype=np.uint32),
                     rng.integers(0, 1 << 32, n, dtype=np.uint32)], -1)
    keys[:n // 4, 0] = 0x80000000 + rng.integers(0, 4, n // 4,
                                                 dtype=np.uint32)
    keys[n // 4:n // 2, 0] = rng.integers(0, 4, n // 4, dtype=np.uint32)
    keys[rng.integers(0, n, dup)] = keys[rng.integers(0, n, dup)]
    keys[rng.integers(0, n, pad)] = INV
    return keys


def _same_cluster(rng, n_clusters, cluster, n):
    """n distinct keys that all hash to one cluster (an overflowing batch)."""
    out = np.zeros((0, 2), np.uint32)
    while len(out) < n:
        cand = rng.integers(0, 1 << 32, (4096, 2), dtype=np.uint32)
        h = np.asarray(jhash_u64(jnp.asarray(cand[:, 0]),
                                 jnp.asarray(cand[:, 1])))
        out = np.concatenate([out, cand[(h & (n_clusters - 1)) == cluster]])
    return out[:n]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_insert_and_rank_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 256
    keys = _batch(rng, n)
    seg = rng.integers(0, 8, n).astype(np.uint32)  # few segments: long runs
    valid = ~((keys[:, 0] == INV) & (keys[:, 1] == INV))
    mask = valid & (rng.random(n) < 0.7)
    jp = jbase.plan_insert(jnp.asarray(keys), jnp.asarray(seg),
                           jnp.asarray(valid), num_segments=8)
    tp = tbase.plan_insert(_t(keys), torch.from_numpy(seg.astype(np.int64)),
                           torch.from_numpy(valid), num_segments=8)
    assert np.array_equal(tp.order.numpy(), np.asarray(jp.order))
    assert np.array_equal(tp.seg_start.numpy(), np.asarray(jp.seg_start))
    assert np.array_equal(tp.winner.numpy(), np.asarray(jp.winner))
    jr = np.asarray(jbase.plan_rank(jp, jnp.asarray(mask)))
    tr = tbase.plan_rank(tp, torch.from_numpy(mask))
    assert np.array_equal(tr.numpy(), jr)
    # the sort is over unsigned words: a signed order would differ here
    assert (keys[:, 0] >= 0x80000000).any() and (keys[:, 0] < 4).any()


def test_plan_insert_rejects_too_many_segments():
    keys = _t(np.zeros((4, 2), np.uint32))
    with pytest.raises(ValueError, match="2\\^31"):
        tbase.plan_insert(keys, torch.zeros(4, dtype=torch.int64),
                          torch.ones(4, dtype=torch.bool),
                          num_segments=1 << 31)


@pytest.mark.parametrize("seed", [3, 4])
def test_dedupe_last_wins_matches_jax(seed):
    rng = np.random.default_rng(seed)
    keys = _batch(rng, 128, dup=40)
    valid = ~((keys[:, 0] == INV) & (keys[:, 1] == INV))
    want = np.asarray(jbase.dedupe_last_wins(jnp.asarray(keys),
                                             jnp.asarray(valid)))
    got = tbase.dedupe_last_wins(_t(keys), torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), want)


def _assert_state(js, ts):
    assert np.array_equal(_n(ts.table), np.asarray(js.table)), "table drift"
    assert np.array_equal(_n(ts.head), np.asarray(js.head)), "head drift"


def _assert_result(jr, tr, words=("values", "evicted", "evicted_vals")):
    for f in jr._fields:
        got = getattr(tr, f)
        got = _n(got) if f in words else got.numpy()
        assert np.array_equal(got, np.asarray(getattr(jr, f))), f


@pytest.mark.parametrize("slots", [16, 32])
def test_linear_ops_match_jax(slots):
    """insert_batch_element / get_batch / get_values / delete_batch /
    set_values / scan on the same states, through cluster overflow (drops
    and FIFO evictions), in-batch duplicates and padding."""
    rng = np.random.default_rng(slots)
    jcfg = JIndexConfig(capacity=1024, cluster_slots=slots)
    tcfg = TIndexConfig(capacity=1024, cluster_slots=slots)
    js, ts = jlin.init(jcfg), tlin.init(tcfg, device="cpu")
    _assert_state(js, ts)
    n_clusters = js.table.shape[0]
    assert tlin.num_slots(tcfg) == jlin.num_slots(jcfg)

    batches = [_batch(rng, 256) for _ in range(4)]
    # one batch with more than S new keys for one cluster: drops + evictions
    batches.insert(2, np.concatenate([
        _same_cluster(rng, n_clusters, 5, slots + 9), _batch(rng, 64)]))
    for keys in batches:
        vals = rng.integers(0, 1 << 32, (len(keys), 2), dtype=np.uint32)
        js, jr = jlin.insert_batch_element(js, jnp.asarray(keys),
                                           jnp.asarray(vals))
        ts, tr = tlin.insert_batch_element(ts, _t(keys), _t(vals))
        _assert_result(jr, tr)
        _assert_state(js, ts)
        probe = np.concatenate([keys[:96], _batch(rng, 32)])
        _assert_result(jlin.get_batch(js, jnp.asarray(probe)),
                       tlin.get_batch(ts, _t(probe)))
        jv, jf = jlin.get_values(js, jnp.asarray(probe))
        tv, tf = tlin.get_values(ts, _t(probe))
        assert np.array_equal(_n(tv), np.asarray(jv))
        assert np.array_equal(tf.numpy(), np.asarray(jf))

    gone = np.concatenate([batches[0][:40], batches[0][:5]])  # dup deletes
    js, jh, jo = jlin.delete_batch(js, jnp.asarray(gone))
    ts, th, to = tlin.delete_batch(ts, _t(gone))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(_n(to), np.asarray(jo))
    _assert_state(js, ts)

    total = jlin.num_slots(jcfg)
    # distinct target slots, plus -1 no-ops
    sl = np.concatenate([np.full(4, -1), rng.choice(total, 60, replace=False)]
                        ).astype(np.int32)
    vals = rng.integers(0, 1 << 32, (len(sl), 2), dtype=np.uint32)
    js = jlin.set_values(js, jnp.asarray(sl), jnp.asarray(vals))
    ts = tlin.set_values(ts, torch.from_numpy(sl), _t(vals))
    _assert_state(js, ts)
    for a, b in zip(jlin.scan(js), tlin.scan(ts)):
        assert np.array_equal(_n(b), np.asarray(a))


def test_overflowing_batch_drops_and_evicts_like_jax():
    """More than S fresh keys for one cluster in one batch: the ranks past
    S drop, and a second such batch FIFO-evicts the first's entries."""
    rng = np.random.default_rng(11)
    s = 16
    jcfg = JIndexConfig(capacity=512, cluster_slots=s)
    js, ts = jlin.init(jcfg), tlin.init(TIndexConfig(capacity=512,
                                                     cluster_slots=s), "cpu")
    n_clusters = js.table.shape[0]
    for k in range(2):
        keys = _same_cluster(rng, n_clusters, 2, s + 7)
        vals = rng.integers(0, 1 << 32, (len(keys), 2), dtype=np.uint32)
        js, jr = jlin.insert_batch_element(js, jnp.asarray(keys),
                                           jnp.asarray(vals))
        ts, tr = tlin.insert_batch_element(ts, _t(keys), _t(vals))
        _assert_result(jr, tr)
        _assert_state(js, ts)
        assert tr.dropped.sum() == 7
        evicted = (_n(tr.evicted) != INV).all(axis=1).sum()
        assert evicted == (s if k else 0)
