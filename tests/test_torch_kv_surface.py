"""PyTorch port: the rest of the `KV` surface against the JAX `KV`.

The same seeded verbs go through `pmdfc_tpu.kv.KV` and
`pmdfc_tpu_torch.kv.KV(device="cpu")` over linear (the fused GET), CCEH
(the fused GET), cuckoo (the composed GET) and linear over the tiered
pool: the host stats overlay (`account_shed`, `account_quarantined`,
`account_deadline`) folded into `stats()`, the recovering serving state
on the fused and the composed GET (`misses == Σ miss_*` with the cold
misses moved to `miss_recovering`), the `dir_epoch`/`_mut_seq` deltas
after each mutating verb (both start at random epochs), and the
one-sided surface: `directory_snapshot`, `fast_view`'s validate and
gather, and `live_entries`. Every value must be equal (tolerance 0).

Then the torn-read drill of the port's fast lane, whose pool is updated
in place: a fast read is one locked step (`FastView.read`), so a put can
never land between the digest check and the gather. The drill fails if
`NetServer._serve_fastread` goes back to a `validate` then a `gather`.
"""

from __future__ import annotations

import threading

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu import kv as jkv
from pmdfc_tpu.config import BloomConfig as JBloomConfig
from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.client.backends import DirectBackend
from pmdfc_tpu_torch.config import BloomConfig as TBloomConfig
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import KVConfig as TKVConfig
from pmdfc_tpu_torch.ops import fused as tfused
from pmdfc_tpu_torch.ops.pagepool import page_digest_np
from pmdfc_tpu_torch.runtime.net import NetServer
from torch_twin import JAX, PORT, jax_registry, same, timeless  # noqa: F401
from torch_twin import kv_configs

pytestmark = pytest.mark.torch

W = 64
CASES = {
    # name: (index kind, tiered, fused GET)
    "linear": ("linear", False, True),
    "cceh": ("cceh", False, True),
    "cuckoo": ("cuckoo", False, False),
    "linear-tiered": ("linear", True, True),
}


def _configs(kind, tiered):
    return kv_configs(kind, "tiered" if tiered else "flat", W,
                      **({"segment_slots": 256} if kind == "cceh" else {}))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert np.array_equal(a, b), f"{what} differs"


def _jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in p): np.asarray(v) for p, v in flat}


def _same_leaves(a, b, what):
    la, lb = _jax_leaves(a.state), carry.state_to_numpy(b.state)
    assert sorted(la) == sorted(lb), f"{what}: {set(la) ^ set(lb)}"
    for k in la:
        _same(la[k], lb[k], f"{what}: leaf {k}")


def _same_stats(a, b, what):
    sa, sb = timeless(a.stats()), timeless(b.stats())
    assert sa.keys() == sb.keys(), f"{what}: {set(sa) ^ set(sb)}"
    for k in sa:
        assert sa[k] == sb[k], f"{what}: stat {k}: {sa[k]} vs {sb[k]}"
    assert sb["misses"] == sum(sb[c] for c in tkv.MISS_CAUSE_NAMES)
    return sb


class _Marks:
    """(dir_epoch, _mut_seq) deltas of both KVs since construction."""

    def __init__(self, a, b):
        self.a, self.b = a, b
        self.a0 = (a.dir_epoch, a._mut_seq)
        self.b0 = (b.dir_epoch, b._mut_seq)
        assert a.dir_epoch & 1 and b.dir_epoch & 1  # random odd starts

    def check(self, what):
        da = (self.a.dir_epoch - self.a0[0], self.a._mut_seq - self.a0[1])
        db = (self.b.dir_epoch - self.b0[0], self.b._mut_seq - self.b0[1])
        assert da == db, f"{what}: (epoch, seq) deltas {da} vs {db}"
        return db


@pytest.mark.parametrize("case", list(CASES))
def test_kv_surface_matches_jax(case):
    kind, tiered, fused = CASES[case]
    jcfg, tcfg = _configs(kind, tiered)
    assert tfused.supports(tcfg) == fused
    a, b = jkv.KV(jcfg), tkv.KV(tcfg, device="cpu")
    marks = _Marks(a, b)
    rng = np.random.default_rng(len(case))
    live = np.zeros((0, 2), np.uint32)
    for step in range(3):
        keys = rng.integers(0, 1 << 32, (300, 2), dtype=np.uint32)
        if len(live):
            keys[:30] = live[rng.integers(0, len(live), 30)]  # updates
        pages = rng.integers(0, 1 << 32, (300, W), dtype=np.uint32)
        e = marks.check(f"before insert {step}")
        a.insert(keys, pages)
        b.insert(keys, pages)
        assert marks.check(f"insert {step}") == (e[0], e[1] + 1)
        live = np.concatenate([live, keys])
        probe = np.concatenate([live[rng.integers(0, len(live), 200)],
                                rng.integers(0, 1 << 32, (50, 2),
                                             dtype=np.uint32)])
        _same(a.get(probe)[0], b.get(probe)[0], f"get {step}")
        e = marks.check(f"get {step}")
        gone = live[rng.integers(0, len(live), 20)]
        _same(a.delete(gone), b.delete(gone), f"delete {step}")
        assert marks.check(f"delete {step}") == (e[0] + 1, e[1] + 1)
        key = np.array([0xE0000000, 4096 * (step + 1)], np.uint32)
        val = np.array([step, 0x7FFFF000], np.uint32)
        assert a.insert_extent(key, val, 9)[1] == b.insert_extent(
            key, val, 9)[1]
        marks.check(f"insert_extent {step}")
    if tiered:
        assert a.balloon_shrink(32) and b.balloon_shrink(32)
        marks.check("balloon_shrink")
        assert a.balloon_grow(64) and b.balloon_grow(64)
        marks.check("balloon_grow")
    assert a.recovery() and b.recovery()
    marks.check("recovery")
    ea, eb = a.bump_dir_epoch(), b.bump_dir_epoch()
    assert ea - marks.a0[0] == eb - marks.b0[0]
    marks.check("bump_dir_epoch")

    # the host overlay: shed, quarantined and deadline-expired ops fold into
    # stats() with no device op
    for kv in (a, b):
        kv.account_shed(5, 3)
        kv.account_quarantined(7, 2)
        kv.account_deadline(4, 1)
    s = _same_stats(a, b, "overlay")
    assert (s["miss_shed"], s["miss_quarantined"], s["miss_deadline"]) \
        == (5, 7, 4)
    _same_leaves(a, b, "overlay")  # the device vector did not move

    # the recovering serving state: cold misses count as miss_recovering
    # on the GET the config takes (fused or composed) and on get_compact
    assert a.recovery_info() == b.recovery_info() == {"recovering": False}
    a.begin_recovering()
    b.begin_recovering()
    assert b.recovery_info()["recovering"]
    cold0 = b.stats()["miss_cold"]
    never = rng.integers(0, 1 << 32, (64, 2), dtype=np.uint32)
    probe = np.concatenate([never, live[rng.integers(0, len(live), 64)]])
    _same(a.get(probe)[1], b.get(probe)[1], "recovering get")
    ra, rb = a.get_compact_async(probe), b.get_compact_async(probe)
    _same(np.asarray(ra[2])[:len(probe)], rb[2][:len(probe)].numpy(),
          "recovering get_compact found")
    s = _same_stats(a, b, "recovering")
    assert s["miss_recovering"] >= 64 and s["miss_cold"] == cold0
    assert a.mark_recovered() and b.mark_recovered()
    assert not b.mark_recovered()
    assert b.recovery_info() == {"recovering": False}
    b.get(never)
    assert b.stats()["miss_cold"] > cold0  # cold again once recovered
    a.get(never)
    _same_stats(a, b, "recovered")

    # the one-sided surface
    sa, sb = a.directory_snapshot(), b.directory_snapshot()
    assert sa["epoch"] - marks.a0[0] == sb["epoch"] - marks.b0[0]
    for k in ("keys", "shards", "rows", "digs"):
        _same(sa[k], sb[k], f"directory {k}")
    assert len(sb["keys"]) > 500
    cut = b.directory_snapshot(max_entries=100)
    _same(cut["keys"], sb["keys"][:100], "directory cut")
    fa, fb = a.fast_view(), b.fast_view()
    assert (fa.epoch - marks.a0[0], fa.seq - marks.a0[1]) == (
        fb.epoch - marks.b0[0], fb.seq - marks.b0[1])
    assert b.fast_view() is fb  # cached until the next mutation
    n = len(sb["rows"])
    rows, digs = sb["rows"].copy(), sb["digs"].copy()
    shards = np.zeros(n, np.uint32)
    digs[::7] ^= 1          # a stale digest
    rows[::11] = 1 << 30    # a row out of range
    shards[::13] = 1        # a shard this KV does not have
    oa = fa.validate(fa.epoch, shards, rows, digs)
    ob = fb.validate(fb.epoch, shards, rows, digs)
    _same(oa, ob, "validate")
    assert 0 < ob.sum() < n
    _same(np.asarray(fa.gather(shards[oa], rows[oa])),
          fb.gather(shards[ob], rows[ob]), "gather")
    ok, hit, epoch = fb.read(fb.epoch, shards, rows, digs)
    _same(ok, ob, "read ok")
    _same(hit, fb.gather(shards[ob], rows[ob]), "read pages")
    assert epoch == b.dir_epoch
    assert not fb.validate(fb.epoch + 2, shards, rows, digs).any()
    for x, y in zip(jkv.live_entries(a.state, a.config),
                    tkv.live_entries(b.state, b.config)):
        _same(x, y, "live_entries")
    _same_leaves(a, b, "end")


def test_unpaged_kv_has_no_fast_surface_and_live_entries_match():
    def make(K, I, B):
        return K(index=I(capacity=1024), bloom=B(num_bits=1 << 12),
                 paged=False)
    a = jkv.KV(make(JKVConfig, JIndexConfig, JBloomConfig))
    b = tkv.KV(make(TKVConfig, TIndexConfig, TBloomConfig), device="cpu")
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 1 << 32, (200, 2), dtype=np.uint32)
    a.insert(keys, keys)
    b.insert(keys, keys)
    key, val = np.array([7, 4096], np.uint32), np.array([1, 2], np.uint32)
    a.insert_extent(key, val, 5)
    b.insert_extent(key, val, 5)
    assert a.fast_view() is None and b.fast_view() is None
    assert a.directory_snapshot() is None and b.directory_snapshot() is None
    for x, y in zip(jkv.live_entries(a.state, a.config),
                    tkv.live_entries(b.state, b.config)):
        _same(x, y, "unpaged live_entries")


# ---------------------------------------------------------------------------
# the torn-read drill
# ---------------------------------------------------------------------------


def _served_kv(n=256, seed=0, p=PORT):
    cfg = p.config.KVConfig(index=p.config.IndexConfig(capacity=1 << 10),
                            page_words=W,
                            bloom=p.config.BloomConfig(num_bits=1 << 12))
    kv = p.KV(cfg)
    rng = np.random.default_rng(seed)
    keys = np.stack([np.full(n, 5, np.uint32),
                     np.arange(n, dtype=np.uint32)], -1)
    kv.insert(keys, rng.integers(0, 1 << 32, (n, W), dtype=np.uint32))
    return kv, keys, rng


def _fastread(srv, be, snap, epoch):
    """One FASTREAD through the server's reader-side handler, the payload
    packed as the wire packs it."""
    n = len(snap["rows"])
    payload = b"".join(np.ascontiguousarray(x, np.uint32).tobytes() for x in (
        snap["keys"], snap["shards"], snap["rows"], snap["digs"]))
    ok, hit, _, ep = srv._serve_fastread(be, n, epoch, payload)
    return ok, hit, ep


def _no_stale_bytes(ok, hit, digs):
    """Every lane served carries bytes whose digest is the client's token:
    bytes from after a rewrite under an older digest never pass."""
    assert np.array_equal(page_digest_np(hit), digs[ok]), \
        "a fast read served bytes under a digest they do not have"


def test_fast_read_after_a_rewrite_serves_new_bytes_or_not_ok():
    kv, keys, rng = _served_kv()
    srv, be = NetServer(lambda: be), DirectBackend(kv)
    old = kv.directory_snapshot()
    kv.fast_view()  # a view taken before the rewrite
    new = rng.integers(0, 1 << 32, (len(keys), W), dtype=np.uint32)
    kv.insert(keys[:128], new[:128])  # in place: same rows, new digests
    ok, hit, ep = _fastread(srv, be, old, old["epoch"])
    assert ep == kv.dir_epoch
    rewritten = old["keys"][:, 1] < 128  # the directory is in scan order
    assert not ok[rewritten].any() and ok[~rewritten].all()
    _no_stale_bytes(ok, hit, old["digs"])
    cur = kv.directory_snapshot()
    ok, hit, _ = _fastread(srv, be, cur, cur["epoch"])
    assert ok.all()
    order = np.argsort(cur["keys"][:, 1])
    assert np.array_equal(hit[order][:128], new[:128])


def _landing(p):
    """A put forced in after the digest check and before the gather, were
    the server to take two steps -> what it served and how often the
    forced put ran. The port's server reads in one locked step
    (`FastView.read`): the put never runs, and were the server to call
    `validate` then `gather`, it would hand out the new bytes under the
    old digest. JAX's server does take the two steps, over a host mirror
    that a put does not touch: the put runs and the old bytes serve."""
    kv, keys, rng = _served_kv(p=p)
    be = p.backends.DirectBackend(kv)
    srv = p.net.NetServer(lambda: be)
    snap = kv.directory_snapshot()
    real_gather = p.kv_mod.FastView.gather
    forced = []

    def gather_after_a_put(self, shards, rows):
        kv.insert(keys, rng.integers(0, 1 << 32, (len(keys), W),
                                     dtype=np.uint32))
        forced.append(len(keys))
        return real_gather(self, shards, rows)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p.kv_mod.FastView, "gather", gather_after_a_put)
        ok, hit, _ = _fastread(srv, be, snap, snap["epoch"])
    assert ok.all()
    _no_stale_bytes(ok, hit, snap["digs"])
    return (ok, hit), len(forced)


def test_put_landing_between_check_and_gather_cannot_serve_wrong_bytes(
        jax_registry):
    (a, forced_j), (b, forced_t) = _landing(JAX), _landing(PORT)
    same(a, b, "served")
    assert (forced_j, forced_t) == (1, 0)


def _rewrites(p) -> int:
    """A writer thread rewrites and recycles rows (delete, then insert a
    new key onto the freed row) while the reader serves fast reads: every
    lane served matches its digest token, whichever side wins -> lanes
    served."""
    kv, keys, rng = _served_kv(seed=1, p=p)
    be = p.backends.DirectBackend(kv)
    srv = p.net.NetServer(lambda: be)
    snap = kv.directory_snapshot()
    stop = threading.Event()

    def writer():
        r = np.random.default_rng(2)
        i = 0
        while not stop.is_set():
            k = keys[r.integers(0, len(keys), 16)]
            if i % 2:
                kv.delete(k)
                k = k.copy()
                k[:, 0] = 6 + i  # new keys onto the freed rows
            kv.insert(k, r.integers(0, 1 << 32, (16, W), dtype=np.uint32))
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    try:
        served = 0
        for _ in range(60):
            ok, hit, _ = _fastread(srv, be, snap, kv.dir_epoch)
            _no_stale_bytes(ok, hit, snap["digs"])
            served += int(ok.sum())
    finally:
        stop.set()
        t.join()
    return served


def test_fast_reads_under_concurrent_rewrites_never_tear(jax_registry):
    """Threaded: each package is held to the drill's invariants (no lane
    served under a digest its bytes do not have, some lanes served), not
    to the other's count."""
    for p in (JAX, PORT):
        assert _rewrites(p) > 0
