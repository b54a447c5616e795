"""PyTorch port: the clients (`pmdfc_tpu_torch.client`) and their host-side
helpers.

- `get_longkey`, `hashing_np` (murmur3, bloom positions, the packed
  mirror's query and add) and `page_digest_np` bit for bit against the JAX
  package's, and against the port's own device bloom (`to_packed_bits`)
  and digest;
- `CleanCacheClient` and `SwapClient` over `LocalBackend`,
  `DirectBackend(port KV)` and `EngineBackend(port KVServer)`;
- the server's bloom push: full first, then dirty-block deltas, with
  `dirty_blocks` equal to JAX's on the same packed filters; no false
  negative when a push races a put, or under a put storm;
- `IntegrityBackend` turns a corrupted page into a miss.
"""

from __future__ import annotations

import functools
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

import pmdfc_tpu.client.backends as jbe
import pmdfc_tpu.config as jconf
import pmdfc_tpu.runtime.engine as jeng
import pmdfc_tpu.runtime.server as jsrv
import pmdfc_tpu_torch.client.backends as tbe
import pmdfc_tpu_torch.client.cleancache as tcc
import pmdfc_tpu_torch.config as tconf
from pmdfc_tpu.client import cleancache as jcc
from pmdfc_tpu.ops import bloom as jbloom
from pmdfc_tpu.ops import pagepool as jpool
from pmdfc_tpu.utils import hashing_np as jhnp
from pmdfc_tpu_torch.client.backends import (
    DirectBackend, EngineBackend, IntegrityBackend, LocalBackend)
from pmdfc_tpu_torch.client.cleancache import (
    CleanCacheClient, SwapClient, get_longkey)
from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
from pmdfc_tpu_torch.kv import KV
from pmdfc_tpu_torch.ops import bloom as tbloom
from pmdfc_tpu_torch.ops import pagepool as tpool
from pmdfc_tpu_torch.runtime.engine import Engine
from pmdfc_tpu_torch.runtime.server import KVServer
from pmdfc_tpu_torch.utils import hashing_np as thnp
from pmdfc_tpu_torch.utils import u32
from pmdfc_tpu_torch.utils.hashing import hash_u64
from torch_twin import bits, twin

pytestmark = pytest.mark.torch

# each package's modules under one name, for the drills run on both
PAIR = (types.SimpleNamespace(name="jax", conf=jconf, Engine=jeng.Engine,
                              KVServer=jsrv.KVServer, be=jbe, cc=jcc,
                              hnp=jhnp),
        types.SimpleNamespace(name="port", conf=tconf, Engine=Engine,
                              KVServer=functools.partial(KVServer,
                                                         device="cpu"),
                              be=tbe, cc=tcc, hnp=thnp))

PW = 16
BLOCK_BYTES = 64  # tiny blocks so deltas exercise multi-block paths
CFG = KVConfig(index=IndexConfig(capacity=1 << 12),
               bloom=BloomConfig(num_bits=1 << 13),  # 16 blocks of 16 words
               page_words=PW)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _server(**kw):
    eng = Engine(num_queues=2, queue_cap=1 << 10, batch=256, timeout_us=200,
                 arena_pages=512, page_bytes=PW * 4)
    return KVServer(CFG, engine=eng, bf_block_bytes=BLOCK_BYTES, device="cpu",
                    **kw)


# -- host helpers, bit for bit --------------------------------------------

def test_get_longkey_matches_jax():
    for oid, idx in [(0, 0), (7, 123), (2**32 + 5, 2**33 + 9), (2**31, 2**31)]:
        assert get_longkey(oid, idx) == jcc.get_longkey(oid, idx)


def test_hashing_np_matches_jax_and_the_device_hash():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << 32, (500, 2), dtype=np.uint64).astype(np.uint32)
    keys[:50, 0] |= 0x80000000
    for seed in (0, 0x9E3779B9, 0xFFFFFFFF):
        got = thnp.hash_u64_np(keys[:, 0], keys[:, 1], seed=seed)
        np.testing.assert_array_equal(
            got, jhnp.hash_u64_np(keys[:, 0], keys[:, 1], seed=seed))
        dev = hash_u64(u32.from_numpy(keys[:, 0], "cpu"),
                       u32.from_numpy(keys[:, 1], "cpu"), seed=seed)
        np.testing.assert_array_equal(got, dev.numpy().astype(np.uint32))
    for bits, k in ((1 << 13, 4), (3 * 1024, 3)):  # pow2 and modulo paths
        np.testing.assert_array_equal(
            thnp.bloom_positions_np(keys, bits, k),
            jhnp.bloom_positions_np(keys, bits, k))


def test_packed_mirror_matches_jax_and_the_device_bloom():
    """The port's device bloom, packed, equals the bits `add_packed_np`
    sets for the same keys; queries agree with JAX's on the same mirror."""
    keys = _keys(300, seed=2)
    st = tbloom.init(BloomConfig(num_bits=1 << 13), device="cpu")
    tbloom.insert_batch(st, u32.from_numpy(keys, "cpu"),
                        torch.ones(300, dtype=torch.bool), num_hashes=4)
    packed = u32.to_numpy(tbloom.to_packed_bits(st))
    mirror = np.zeros(256, np.uint32)
    thnp.add_packed_np(mirror, keys, 4)
    np.testing.assert_array_equal(mirror, packed)
    jm = np.zeros(256, np.uint32)
    jhnp.add_packed_np(jm, keys, 4)
    np.testing.assert_array_equal(jm, mirror)
    probe = np.concatenate([keys, _keys(300, seed=3)])
    maybe = thnp.query_packed_np(mirror, probe, 4)
    np.testing.assert_array_equal(maybe, jhnp.query_packed_np(mirror, probe, 4))
    assert maybe[:300].all() and not maybe[300:].all()


def test_page_digest_np_matches_jax_and_the_device_digest():
    pages = np.random.default_rng(4).integers(0, 1 << 32, (64, 1024),
                                              dtype=np.uint64).astype(np.uint32)
    got = tpool.page_digest_np(pages)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jpool.page_digest_np(pages))
    dev = tpool.page_digest(u32.from_numpy(pages, "cpu"))
    np.testing.assert_array_equal(got, u32.to_numpy(dev))


@pytest.mark.parametrize("block_bytes", [64, 256])
def test_dirty_blocks_matches_jax(block_bytes):
    rng = np.random.default_rng(block_bytes)
    old = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    new = old.copy()
    new[[3, 40, 41, 200]] ^= 1 << 5
    got = tbloom.dirty_blocks(old, new, block_bytes=block_bytes)
    want = np.asarray(jbloom.dirty_blocks(jnp.asarray(old), jnp.asarray(new),
                                          block_bytes=block_bytes))
    assert isinstance(got, np.ndarray) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert got.sum() == len({i * 4 // block_bytes for i in (3, 40, 41, 200)})


# -- the clients over each backend -----------------------------------------

@pytest.fixture(params=["local", "direct", "engine"])
def backend(request):
    if request.param == "local":
        yield LocalBackend(page_words=PW)
    elif request.param == "direct":
        yield DirectBackend(KV(CFG, device="cpu"))
    else:
        with _server() as srv:
            be = EngineBackend(srv, queue=0, slice_pages=64,
                               timeout_us=30_000_000)
            yield be
            be.close()


def test_cleancache_client_over_each_backend(backend):
    cc = CleanCacheClient(backend)
    oids = np.full(100, 42, np.uint32)
    idx = np.arange(100, dtype=np.uint32) + np.uint32(0x80000000)
    pages = (np.arange(100, dtype=np.uint32)[:, None] * 3
             + np.arange(PW, dtype=np.uint32)[None, :])
    cc.put_pages(oids, idx, pages)  # 100 pages: two verbs through a 64 slice
    out, found = cc.get_pages(oids, idx)
    assert found.all()
    np.testing.assert_array_equal(out, pages)
    assert cc.invalidate_pages(oids[:10], idx[:10]).all()
    out, found = cc.get_pages(oids[:20], idx[:20])
    assert found.tolist() == [False] * 10 + [True] * 10
    assert not out[:10].any()
    got = cc.get_page(42, int(idx[50]))
    np.testing.assert_array_equal(got, pages[50])
    assert cc.get_page(43, 0) is None
    s = cc.stats()
    assert s["puts"] == 100 and s["invalidates"] == 10
    assert s["total_gets"] == 122 and s["hit_gets"] == 111
    assert s["miss_gets"] == s["miss_bloom_negative"] + s["miss_remote"] == 11
    if isinstance(backend, LocalBackend):
        assert s["bf_short_circuits"] == 0  # no filter: every GET is asked
    cc.close()


def test_extent_verbs_over_each_backend(backend):
    """insert_extent / get_extent: value + 4096 * (key - base), the key
    past the run's end misses, across 2^32 in the value's low word."""
    assert backend.insert_extent([7, 1000], [1, 0xFFFFF000], 8) == 0
    probe = np.array([[7, 1000], [7, 1001], [7, 1007], [7, 1008]], np.uint32)
    vals, found = backend.get_extent(probe)
    assert found.tolist() == [True, True, True, False]
    np.testing.assert_array_equal(
        vals[:3], [[1, 0xFFFFF000], [2, 0], [2, 6 * 4096]])
    assert not vals[3].any()


def test_swap_client_over_each_backend(backend):
    with SwapClient(backend) as sw:
        pages = np.random.default_rng(5).integers(0, 1 << 32, (40, PW),
                                                  dtype=np.uint64).astype(
                                                      np.uint32)
        sw.store_batch(1, np.arange(40), pages)
        sw.store(2, 7, pages[0])
        out, found = sw.load_batch(1, np.arange(40))
        assert found.all()
        np.testing.assert_array_equal(out, pages)
        np.testing.assert_array_equal(sw.load(2, 7), pages[0])
        assert sw.load(2, 8) is None
        sw.invalidate(2, 7)
        sw.invalidate_batch(1, np.arange(5))
        assert sw.load(2, 7) is None
        assert sw.load_batch(1, np.arange(10))[1].tolist() == \
            [False] * 5 + [True] * 5


def test_tenant_tagging_matches_jax(monkeypatch):
    a = jcc.CleanCacheClient(_Recorder(), tenant=3)
    b = CleanCacheClient(_Recorder(), tenant=3)
    oids = np.array([0, 1, 0xFFFFFFFF, 0x0ABCDEF0], np.uint32)
    np.testing.assert_array_equal(a._tag(oids), b._tag(oids))
    assert (b._tag(oids) >> 28 == 3).all()
    with pytest.raises(ValueError):
        CleanCacheClient(_Recorder(), tenant=16)
    monkeypatch.setenv("PMDFC_QOS", "off")  # the kill switch: untagged
    np.testing.assert_array_equal(
        CleanCacheClient(_Recorder(), tenant=3)._tag(oids), oids)


def test_refresher_thread_pulls_and_close_joins_it():
    kv = KV(CFG, device="cpu")
    with CleanCacheClient(DirectBackend(kv), bloom_refresh_s=0.005) as cc:
        kv.insert(_keys(20, seed=9), np.zeros((20, PW), np.uint32))
        deadline = time.monotonic() + 10
        while not thnp.query_packed_np(cc._bloom, _keys(20, seed=9),
                                       4).all():
            assert time.monotonic() < deadline, "the mirror never refreshed"
            time.sleep(0.005)
        assert cc.counters["bf_refreshes"] >= 2
        th = cc._refresher
    assert cc._refresher is None and not th.is_alive()


class _Recorder:
    page_words = PW

    def packed_bloom(self):
        return None


# -- bloom push ------------------------------------------------------------

def test_first_push_is_full_then_deltas():
    srv = _server()
    cc = CleanCacheClient(DirectBackend(srv.kv))
    cc._bloom = None  # a client that never pulled
    srv.register_bf_client(cc)
    srv.kv.insert(_keys(50, seed=1), np.zeros((50, PW), np.uint32))
    srv.push_bloom_now()
    assert srv.bf_push_stats["full_pushes"] == 1
    np.testing.assert_array_equal(cc._bloom, srv.kv.packed_bloom())
    assert srv.push_bloom_now()["blocks"] == 0  # no change: nothing travels
    assert srv.bf_push_stats["delta_pushes"] == 1
    before = srv.kv.packed_bloom()
    srv.kv.insert(_keys(3, seed=2), np.zeros((3, PW), np.uint32))
    after = srv.kv.packed_bloom()
    want = np.asarray(jbloom.dirty_blocks(
        jnp.asarray(before), jnp.asarray(after), block_bytes=BLOCK_BYTES))
    r = srv.push_bloom_now()
    assert r["blocks"] == int(want.sum()) > 0
    assert r["blocks"] < (CFG.bloom.num_bits // 8) // BLOCK_BYTES
    np.testing.assert_array_equal(cc._bloom, after)
    assert cc.counters["bf_blocks_received"] == r["blocks"]
    # deletes travel too: deleted keys leave the mirror
    keys = _keys(40, seed=3)
    srv.kv.insert(keys, np.zeros((40, PW), np.uint32))
    srv.push_bloom_now()
    srv.kv.delete(keys[:20])
    srv.push_bloom_now()
    maybe = thnp.query_packed_np(cc._bloom, keys, cc.num_hashes)
    assert maybe[20:].all() and not maybe[:20].all()
    srv.engine.close()


def _pserver(p, **kw):
    """`_server` in package `p`: the same config, engine and block size."""
    cfg = p.conf.KVConfig(index=p.conf.IndexConfig(capacity=1 << 12),
                          bloom=p.conf.BloomConfig(num_bits=1 << 13),
                          page_words=PW)
    eng = p.Engine(num_queues=2, queue_cap=1 << 10, batch=256,
                   timeout_us=200, arena_pages=512, page_bytes=PW * 4)
    return p.KVServer(cfg, engine=eng, bf_block_bytes=BLOCK_BYTES, **kw)


def _race(p):
    """A push computed BEFORE a put's server-side insert landed must not
    erase the put from the mirror (the overlay + re-add discipline), and a
    stale snapshot delivered after a newer one is ignored -> the mirrors
    and found masks along the way."""
    srv = _pserver(p)
    cc = p.cc.CleanCacheClient(p.be.DirectBackend(srv.kv))
    srv.register_bf_client(cc)
    stale = srv.kv.packed_bloom()          # snapshot without the put
    cc.put_pages(np.array([9]), np.array([77]),
                 np.arange(PW, dtype=np.uint32)[None])
    cc.receive_bloom_full(stale)           # the racing push arrives
    mirror = bits(cc._bloom)
    assert p.hnp.query_packed_np(cc._bloom, np.array([[9, 77]], np.uint32),
                                 cc.num_hashes)[0]
    _, f1 = cc.get_pages(np.array([9]), np.array([77]))
    assert f1[0]
    t_stale = time.monotonic()
    cc.put_pages(np.array([4]), np.array([44]),
                 np.arange(PW, dtype=np.uint32)[None])
    cc.receive_bloom_full(srv.kv.packed_bloom(), t_snap=time.monotonic())
    assert not cc._overlay  # retired
    cc.receive_bloom_full(stale, t_snap=t_stale)
    _, f2 = cc.get_pages(np.array([4, 9]), np.array([44, 77]))
    assert f2.all()
    srv.engine.close()
    return (bits(stale), mirror, np.asarray(f1), bits(cc._bloom),
            np.asarray(f2))


def test_no_false_negative_when_push_races_put():
    twin(_race, pkgs=PAIR)


def _storm(p) -> dict:
    """Puts stream through the engine while the sender thread pushes every
    few ms, one sink raising: at every observation point each completed
    put answers 'maybe' -> the drill's invariants."""
    class BadSink:
        def receive_bloom_full(self, *a, **k):
            raise RuntimeError("boom")

    with _pserver(p, bf_push_s=0.002) as srv:
        srv.register_bf_client(BadSink())
        with p.be.EngineBackend(srv, slice_pages=128,
                                timeout_us=30_000_000) as be:
            cc = p.cc.CleanCacheClient(be)
            srv.register_bf_client(cc)
            keys = _keys(512, seed=5)
            pages = np.tile(np.arange(PW, dtype=np.uint32), (512, 1))
            violations = []

            def putter():
                for lo in range(0, 512, 32):
                    cc.put_pages(keys[lo:lo + 32, 0], keys[lo:lo + 32, 1],
                                 pages[lo:lo + 32])
                    maybe = p.hnp.query_packed_np(
                        cc._bloom, keys[:lo + 32], cc.num_hashes)
                    if not maybe.all():
                        violations.append(lo)

            t = threading.Thread(target=putter)
            t.start()
            t.join(timeout=60)
            deadline = time.monotonic() + 10
            while srv.bf_push_stats["delta_pushes"] < 3 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            maybe = p.hnp.query_packed_np(cc._bloom, keys, cc.num_hashes)
            _, found = cc.get_pages(keys[:, 0], keys[:, 1])
            return {"done": not t.is_alive(), "violations": violations,
                    "all maybe": bool(maybe.all()),
                    "all found": bool(found.all()),
                    "3 deltas": srv.bf_push_stats["delta_pushes"] >= 3,
                    "sink errors": srv.bf_push_stats["errors"] >= 1,
                    "pushes received": cc.counters["bf_pushes"] >= 1}


def test_put_storm_under_the_push_thread_never_false_negative():
    """Timed and threaded: both packages are held to the drill's
    invariants (no false negative at any observation point, every page
    served, the sender survives a raising sink), not to each other's
    counts."""
    want = {"done": True, "violations": [], "all maybe": True,
            "all found": True, "3 deltas": True, "sink errors": True,
            "pushes received": True}
    for p in PAIR:
        assert _storm(p) == want, p.name


# -- integrity -------------------------------------------------------------

def test_integrity_backend_turns_a_corrupted_page_into_a_miss():
    kv = KV(CFG, device="cpu")
    be = IntegrityBackend(DirectBackend(kv))
    keys = _keys(16, seed=6)
    pages = np.random.default_rng(6).integers(0, 1 << 32, (16, PW),
                                              dtype=np.uint64).astype(np.uint32)
    be.put(keys, pages)

    class Flipper:  # a hostile server: one served page differs in one bit
        page_words = PW

        def get(self, k):
            out, found = kv.get(k)
            out = out.copy()
            out[3, 0] ^= 1
            return out, found

    be._be = Flipper()
    out, found = be.get(keys)
    assert found.tolist() == [True] * 3 + [False] + [True] * 12
    assert not out[3].any()
    np.testing.assert_array_equal(out[4:], pages[4:])
    assert be.counters == {"corrupt_pages": 1, "verified_gets": 16}
    be._be = DirectBackend(kv)
    s = be.stats()
    assert s["integrity.corrupt_pages"] == 1 and s["capacity"] == 4096
    assert be.invalidate(keys[:2]).all()
    assert be.balloon_state() is None  # forwarded to the backend
    # a bounded digest map: keys whose digest was dropped pass unverified
    small = IntegrityBackend(DirectBackend(kv), digest_cap=4)
    small.put(keys, pages)
    small._be = Flipper()
    _, found = small.get(keys)
    assert found.all() and small.counters["verified_gets"] == 4


def test_engine_backend_caller_chosen_arena_slice():
    """`EngineBackend(arena_lo=, arena_hi=)`: the caller's slice is used as
    given (`arena_hi` defaults to the arena's end, as JAX's does), two
    clients on disjoint caller slices round-trip their own pages, and
    close() leaves a caller's slice alone (only an owned slice returns
    to the engine)."""
    from pmdfc_tpu.client.backends import EngineBackend as JEngineBackend

    with _server() as srv:
        eng = srv.engine
        a = EngineBackend(srv, queue=0, arena_lo=0, arena_hi=64,
                          timeout_us=30_000_000)
        b = EngineBackend(srv, queue=1, arena_lo=64, timeout_us=30_000_000)
        # the JAX client's slice rule over the same engine
        j = JEngineBackend(srv, queue=1, arena_lo=64)
        assert (b.arena_lo, b.arena_hi) == (j.arena_lo, j.arena_hi) == (
            64, eng.arena_pages)
        assert (a.arena_lo, a.arena_hi) == (0, 64)
        ka, kb = _keys(100, seed=1), _keys(100, seed=2) + np.uint32(1 << 12)
        pa = ka[:, 1:2] * np.uint32(7) + np.arange(PW, dtype=np.uint32)
        pb = kb[:, 1:2] * np.uint32(5) + np.arange(PW, dtype=np.uint32)
        a.put(ka, pa)  # 100 pages through a 64-page slice: two verbs
        b.put(kb, pb)
        out_a, fa = a.get(ka)
        out_b, fb = b.get(kb)
        assert fa.all() and fb.all()
        np.testing.assert_array_equal(out_a, pa)
        np.testing.assert_array_equal(out_b, pb)
        a.close()
        b.close()
        # an owned slice still comes from the free list, past nothing the
        # caller slices were given back
        c = EngineBackend(srv, slice_pages=32)
        assert c._owns_slice and not a._owns_slice and not b._owns_slice
        c.close()
