"""PyTorch port: the tiered page store against the JAX package's.

Every drill mirrors one of `tests/test_tier.py` / `tests/test_admit.py`
and runs the same seeded verbs through `pmdfc_tpu.kv.KV` and
`pmdfc_tpu_torch.kv.KV(device="cpu")` over a tiered pool, for the linear
index and CCEH. After every verb the results, every state leaf (every
`TierState` leaf among them, the admission leaves with the gate), the
19-lane stats vector and the tier counters must be identical (tolerance
0: integer arithmetic). The JAX `KV` runs its composed GET on the CPU
(held bit-identical to its Pallas kernel by the JAX suite); the port's
linear and CCEH GETs run the fused GET's plain version, so the port's
`tier.on_get` sees exactly the kernel's outputs.

Three hazards of the port are pinned directly: the victim sorts are
stable and unsigned (tied and high-bit metrics, all-zero touch counters),
the touch scatter accumulates a key that occurs twice in a batch, and a
batch that promotes nothing changes no tier leaf but the bookkeeping.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import timeless
import torch

from pmdfc_tpu import kv as jkv
from pmdfc_tpu.config import AdmitConfig as JAdmit
from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu.config import TierConfig as JTier
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch import tier as ttier
from pmdfc_tpu_torch.config import AdmitConfig as TAdmit
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.config import KVConfig as TKVConfig
from pmdfc_tpu_torch.config import TierConfig as TTier
from pmdfc_tpu_torch.models.base import get_index_ops
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

PW = 64
KINDS = ["linear", "cceh"]
# a small hot tier (16 rows over 256 slots) so promotions force demotions,
# a small ghost ring, and balloon steps of 16 rows
TIER = dict(hot_fraction=16, promote_touches=2, ghost_rows=16,
            balloon_step=16, max_promotes_per_batch=8)
GATE = dict(sketch_width=1 << 12, door_bits=1 << 13, reset_ops=4096, threshold=3)


def _pair(kind: str, touch_sample_every: int = 1, admit: bool = False,
          **tier):
    """(JAX KV, port KV) over the same tiered config: 256 slots (linear:
    8 clusters of 32; CCEH: 4 segments of 64 slots with 16-lane windows,
    growing to 8)."""
    ix = dict(capacity=256, touch_sample_every=touch_sample_every)
    if kind == "cceh":
        ix.update(capacity=256, segment_slots=64, probe_window=16)
    tk = {**TIER, **tier}

    def make(K, I, T, A, Kind):
        return K(index=I(kind=Kind(kind), **ix), bloom=None, page_words=PW,
                 tier=T(admit=A(**GATE) if admit else None, **tk))

    return (jkv.KV(make(JKVConfig, JIndexConfig, JTier, JAdmit, JKind)),
            tkv.KV(make(TKVConfig, TIndexConfig, TTier, TAdmit, TKind),
                   device="cpu"))


def _keys(los):
    los = np.asarray(los, np.uint32)
    return np.stack([los >> np.uint32(16) | np.uint32(0x80000000), los],
                    axis=-1).astype(np.uint32)


def _pages(keys):
    lo = np.asarray(keys, np.uint32)[:, 1]
    return (lo[:, None] * np.uint32(2654435761)
            + np.arange(PW, dtype=np.uint32)[None, :])


def jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


class Twin:
    """Drives a JAX KV and a port KV with the same verbs; after each verb
    every result, leaf, stats lane and tier counter must agree."""

    def __init__(self, kind, **kw):
        self.a, self.b = _pair(kind, **kw)
        self.check("init")

    def check(self, what):
        la, lb = jax_leaves(self.a.state), carry.state_to_numpy(self.b.state)
        assert sorted(la) == sorted(lb), f"{what}: leaves {set(la) ^ set(lb)}"
        for k in la:
            assert la[k].dtype == lb[k].dtype, f"{what}: {k} dtype"
            assert np.array_equal(la[k], lb[k]), f"{what}: leaf {k} differs"
        sa, sb = timeless(self.a.stats()), timeless(self.b.stats())
        assert sa == sb, f"{what}: stats {sa} vs {sb}"
        assert sb["misses"] == sum(sb[c] for c in tkv.MISS_CAUSE_NAMES)

    def insert(self, keys, pages=None):
        pages = _pages(keys) if pages is None else pages
        ra, rb = self.a.insert(keys, pages), self.b.insert(keys, pages)
        for f in ra._fields:
            assert np.array_equal(getattr(ra, f), getattr(rb, f)), f
        self.check("insert")
        return rb

    def get(self, keys):
        (oa, fa), (ob, fb) = self.a.get(keys), self.b.get(keys)
        assert np.array_equal(oa, ob) and np.array_equal(fa, fb)
        self.check("get")
        # every served page is the one inserted under its key
        assert np.array_equal(ob[fb], _pages(keys[fb]))
        return ob, fb

    def get_compact(self, keys):
        ca, cb = self.a.get_compact_async(keys), self.b.get_compact_async(keys)
        assert np.array_equal(np.asarray(ca[0]), u32.to_numpy(cb[0]))
        for x, y in zip(ca[1:4], cb[1:4]):
            assert np.array_equal(np.asarray(x), y.numpy())
        self.check("get_compact")
        return cb

    def delete(self, keys):
        ha, hb = self.a.delete(keys), self.b.delete(keys)
        assert np.array_equal(ha, hb)
        self.check("delete")
        return hb

    def verb(self, name, *args):
        ra, rb = getattr(self.a, name)(*args), getattr(self.b, name)(*args)
        assert ra == rb, f"{name}: {ra} vs {rb}"
        self.check(name)
        return rb

    @property
    def ts(self):
        return self.b.state.pool

    def tier(self):
        return self.b.tier_stats()


def _hot_rows_of(twin: Twin, keys) -> np.ndarray:
    """The global row each key's index entry points at (port state)."""
    res = get_index_ops(twin.b.config.index.kind).get_batch(
        twin.b.state.index, u32.from_numpy(keys, "cpu"))
    assert res.found.all()
    return res.values[:, 1].numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_promotion_preserves_bytes_and_digests(kind):
    t = Twin(kind)
    keys = _keys(np.arange(1, 129))
    t.insert(keys)
    hot_set = keys[:12]
    for _ in range(3):
        _, found = t.get(hot_set)
        assert found.all()
    ts = t.tier()
    assert ts["promotions"] >= 12 and ts["hot_hits"] > 0
    assert ts["migrated_bytes"] == ts["migrated_pages"] * PW * 4
    assert (_hot_rows_of(t, hot_set) < ttier.num_hot_rows(256, t.b.config.tier)
            ).all()
    # promoted rows' digests are the pages' digests, bytes the inserted ones
    from pmdfc_tpu_torch.ops.pagepool import page_digest

    occ = ~ttier.is_invalid(t.ts.hot_keys)
    h = t.ts.hfree.shape[0]
    hp = t.ts.pages[:h][occ]
    assert torch.equal(page_digest(hp), t.ts.sums[:h][occ])
    assert np.array_equal(u32.to_numpy(hp),
                          _pages(u32.to_numpy(t.ts.hot_keys[occ])))
    _, found = t.get(keys)
    assert found.all()
    t.get_compact(np.concatenate([keys[:8], _keys(np.arange(900, 908))]))
    # the host reporting helpers read the same
    from pmdfc_tpu import tier as jtier

    assert np.array_equal(ttier.live_mask(t.ts), jtier.live_mask(t.a.state.pool))
    assert ttier.hot_heat(t.ts) == jtier.hot_heat(t.a.state.pool) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_demotion_and_ghost_readmission(kind):
    t = Twin(kind)
    h = t.ts.hfree.shape[0]
    keys = _keys(np.arange(1, 3 * h + 2))
    t.insert(keys)
    a = keys[:1]
    for _ in range(3):
        t.get(a)  # promote A
    rest = keys[1:2 * h + 1]
    for _ in range(7):  # promote enough others to demote A
        _, found = t.get(rest)
        assert found.all()
    assert t.tier()["demotions"] >= 1
    before = t.tier()["ghost_readmits"]
    _, found = t.get(a)  # one touch readmits through the ghost ring
    assert found.all() and t.tier()["ghost_readmits"] > before
    assert t.b.stats()["corrupt_pages"] == 0


@pytest.mark.parametrize("kind", KINDS)
def test_balloon_grow_covers_fill_burst(kind):
    t = Twin(kind, cold_init_rows=32, grow_free_rows=8)
    keys = _keys(np.arange(1, 200))
    for i in range(0, len(keys), 40):
        t.insert(keys[i:i + 40])
    assert t.tier()["balloon_grows"] >= 1
    assert t.b.stats()["drops"] == 0
    t.get(keys)
    assert t.verb("balloon_state")["circulating"] > 32


@pytest.mark.parametrize("kind", KINDS)
def test_forced_shrink_under_load_degrades_to_misses(kind):
    """A shrink past the free rows evicts the coldest live rows (all touch
    counters zero: the stable sort takes them in row order); their keys
    miss as `miss_stale`, every served page stays byte-exact, and new
    puts land after a grow."""
    t = Twin(kind)
    keys = _keys(np.arange(1, 161))
    t.insert(keys)
    free = t.verb("balloon_state")["free"]
    assert t.verb("balloon_shrink", free + 32)
    assert t.tier()["shrink_evictions"] >= 32
    _, found = t.get(keys)
    assert not found.all()
    assert t.b.stats()["miss_stale"] == (~found).sum() > 0
    assert t.verb("balloon_grow", 32)
    more = _keys(np.arange(1000, 1032))
    t.insert(more)
    _, found = t.get(more)
    assert found.all()


@pytest.mark.parametrize("kind", KINDS)
def test_stale_entries_never_alias_recirculated_rows(kind):
    t = Twin(kind)
    keys = _keys(np.arange(1, 129))
    t.insert(keys)
    t.get(keys[:40])  # some touch history, so the victims are not in row order
    free = t.verb("balloon_state")["free"]
    assert t.verb("balloon_shrink", free + 64)  # evict 64 live rows
    assert t.verb("balloon_grow", 64)           # recirculate them
    new = _keys(np.arange(1000, 1064))
    t.insert(new)                               # reuses the evicted rows
    _, found = t.get(keys)                      # stale: miss, never new bytes
    assert (~found).sum() >= 64
    t.insert(keys[:8])                          # a stale re-put takes a row
    t.delete(keys)                              # stale deletes free nothing
    _, found = t.get(new)
    assert found.all()


@pytest.mark.parametrize("kind", KINDS)
def test_delete_frees_hot_row(kind):
    t = Twin(kind)
    keys = _keys(np.arange(1, 33))
    t.insert(keys)
    t.get(keys[:4])
    t.get(keys[:4])  # the second touch promotes
    occ0 = t.tier()["hot_occupied"]
    assert occ0 >= 4
    assert t.delete(keys[:4]).all()
    assert t.tier()["hot_occupied"] == occ0 - 4
    _, found = t.get(keys[:4])
    assert not found.any()


@pytest.mark.parametrize("kind", KINDS)
def test_update_in_place_of_hot_resident_key(kind):
    t = Twin(kind)
    keys = _keys(np.arange(1, 9))
    t.insert(keys)
    t.get(keys)
    t.get(keys)  # promoted
    assert (_hot_rows_of(t, keys) < t.ts.hfree.shape[0]).all()
    new_pages = _pages(keys) ^ np.uint32(0xABCD)
    t.insert(keys, new_pages)
    (oa, fa), (ob, fb) = t.a.get(keys), t.b.get(keys)
    assert fb.all() and np.array_equal(ob, new_pages)
    assert np.array_equal(oa, ob)
    t.check("get after update")


@pytest.mark.parametrize("kind", KINDS)
def test_sampled_touch_cadence(kind):
    """`touch_sample_every=4`: three lean batches are pure reads (no
    touch, no migration); the fourth pays the counting path."""
    t = Twin(kind, touch_sample_every=4, promote_touches=1)
    keys = _keys(np.arange(1, 9))
    t.insert(keys)
    leaves0 = carry.state_to_numpy(t.b.state)
    for _ in range(3):
        _, found = t.get(keys)
        assert found.all()
    after = carry.state_to_numpy(t.b.state)
    assert all(np.array_equal(leaves0[k], after[k])
               for k in leaves0 if k != "stats")
    assert t.tier()["hot_hits"] + t.tier()["cold_hits"] == 0
    t.get(keys)
    assert t.tier()["cold_hits"] == 8 and t.tier()["promotions"] == 8


@pytest.mark.parametrize("kind", KINDS)
def test_admission_gate(kind):
    """A one-touch scan is denied hot slots; a hot set that out-counts it
    is admitted; a duel the candidate does not win keeps the victim; with
    the threshold lowered the flood wins duels, and a demoted key is
    readmitted on the ghost ring's say-so alone."""
    t = Twin(kind, admit=True, promote_touches=1)
    h = t.ts.hfree.shape[0]
    keys = _keys(np.arange(1, h + 101))
    hot, scan = keys[:h], keys[h:]
    t.insert(keys)  # a put is a touch: the doorkeeper holds every key
    t.get(scan)     # estimate 2 < threshold 3
    gate = t.verb("admit_state")
    assert gate["admit_denied"] == 100 and t.tier()["promotions"] == 0
    for _ in range(6):
        t.get(hot)  # estimate climbs to 7, the hot tier fills
    assert t.tier()["hot_occupied"] == h
    for _ in range(3):
        t.get(scan[:40])  # estimates 3..5 duel incumbents at 7 and lose
    assert t.verb("admit_state")["admit_victim_kept"] > 0
    assert t.tier()["demotions"] == 0
    assert t.verb("set_admit_threshold", 0)
    for _ in range(4):
        t.get(scan[:40])  # estimates 6..9: the flood wins at 8
    assert t.tier()["demotions"] > 0
    resident = {tuple(k) for k in u32.to_numpy(t.ts.hot_keys)}
    gone = [k for k in hot if tuple(k) not in resident]
    assert gone
    assert t.verb("set_admit_threshold", 100)
    before = t.tier()
    _, found = t.get(np.array(gone[:1]))
    assert found.all()
    after = t.tier()
    assert after["ghost_readmits"] == before["ghost_readmits"] + 1
    assert after["admit_ghost_override"] == before["admit_ghost_override"] + 1
    assert t.verb("admit_state")["threshold"] == 100


@pytest.mark.parametrize("policy", ["lru", "lfu", "fifo"])
@pytest.mark.parametrize("kind", KINDS)
def test_hot_policy(kind, policy):
    t = Twin(kind, hot_policy=policy)
    h = t.ts.hfree.shape[0]
    keys = _keys(np.arange(1, 3 * h))
    t.insert(keys)
    for r in range(6):
        t.get(keys[(r % 3) * h:(r % 3 + 1) * h + 4])
        t.get(keys[:h // 2])
    assert t.tier()["demotions"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_victim_sort_is_stable_and_unsigned(kind):
    """Victims are the min-metric hot rows by a stable unsigned sort: with
    metrics tied in pairs and half of them >= 2^31, the JAX and port GETs
    must demote the same rows."""
    t = Twin(kind, hot_policy="fifo")
    h = t.ts.hfree.shape[0]
    keys = _keys(np.arange(1, 3 * h))
    t.insert(keys)
    for _ in range(6):
        t.get(keys[:h])  # fill the hot tier, 8 promotions a batch
    assert t.tier()["hot_occupied"] == h
    metric = np.array([(0x80000000 if i % 4 < 2 else 0) + (i // 2) % 3
                       for i in range(h)], np.uint32)
    t.a.state.pool.metric = jax.numpy.asarray(metric)
    t.ts.metric.copy_(u32.from_numpy(metric, "cpu"))
    t.check("metric poke")
    before = u32.to_numpy(t.ts.hot_keys).copy()
    for _ in range(2):
        t.get(keys[h:h + 6])  # 6 promotions over full hot rows
    assert t.tier()["demotions"] == 6
    gone = ~np.all(u32.to_numpy(t.ts.hot_keys) == before, axis=-1)
    # the six lowest unsigned metrics, ties in row order
    assert np.array_equal(np.flatnonzero(gone),
                          np.sort(np.argsort(metric, kind="stable")[:6]))


@pytest.mark.parametrize("kind", KINDS)
def test_touch_scatter_accumulates_repeated_keys(kind):
    """A key twice in one GET batch is two touches of its cold row: with
    `promote_touches=2` it promotes on that batch."""
    t = Twin(kind)
    keys = _keys(np.arange(1, 33))
    t.insert(keys)
    twice = np.concatenate([keys[:5], keys[:5]])
    t.get(twice)
    assert t.tier()["promotions"] == 5
    assert (_hot_rows_of(t, keys[:5]) < t.ts.hfree.shape[0]).all()


@pytest.mark.parametrize("kind", KINDS)
def test_batch_without_promotion_changes_only_bookkeeping(kind):
    """An all-miss batch and a batch whose touches stay below the
    threshold leave every tier leaf as it was, apart from `tick`, `touch`,
    `metric` and the hit lanes of `tstats`; and the migration block itself
    with no promoted lane changes nothing."""
    t = Twin(kind, promote_touches=5)
    keys = _keys(np.arange(1, 65))
    t.insert(keys)
    bookkeeping = {"pool.tick", "pool.touch", "pool.metric", "pool.tstats",
                   "stats"}
    for probe in (_keys(np.arange(5000, 5064)), keys[:20]):
        before = carry.state_to_numpy(t.b.state)
        t.get(probe)
        after = carry.state_to_numpy(t.b.state)
        for k in before:
            if k not in bookkeeping:
                assert np.array_equal(before[k], after[k]), k
        d = after["pool.tstats"] - before["pool.tstats"]
        assert not d[ttier.T_PROMOTIONS:].any()

    st = t.b.state
    before = carry.state_to_numpy(st)
    kt = u32.from_numpy(keys[:16], "cpu")
    no = torch.zeros(16, dtype=torch.bool)
    ttier._migrate(get_index_ops(t.b.config.index.kind), st.index, st.pool,
                   t.b.config.tier, None, kt, torch.arange(16, dtype=torch.int32),
                   torch.full((16,), 300, dtype=torch.int32),
                   torch.zeros((16, PW), dtype=torch.int32), no,
                   torch.zeros(16, dtype=torch.int32), no, None)
    after = carry.state_to_numpy(st)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_extendible_tiered_rides_the_composed_get():
    """Extendible hashing has no fused GET: its tiered GET is the composed
    `kv._get_core` with the epilogue, held against JAX likewise."""
    t = Twin("cceh")
    t.a, t.b = (jkv.KV(JKVConfig(index=JIndexConfig(
        kind=JKind.EXTENDIBLE, capacity=256, segment_slots=64,
        probe_window=16), bloom=None, page_words=PW, tier=JTier(**TIER))),
        tkv.KV(TKVConfig(index=TIndexConfig(
            kind=TKind.EXTENDIBLE, capacity=256, segment_slots=64,
            probe_window=16), bloom=None, page_words=PW, tier=TTier(**TIER)),
            device="cpu"))
    keys = _keys(np.arange(1, 161))
    t.insert(keys)
    for _ in range(3):
        t.get(keys[:24])
    assert t.tier()["promotions"] > 0
    free = t.verb("balloon_state")["free"]
    t.verb("balloon_shrink", free + 16)
    t.get(keys)
    t.delete(keys[:30])
    assert t.b.stats()["miss_stale"] > 0
