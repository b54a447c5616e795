"""PyTorch port: the KVServer driver (`pmdfc_tpu_torch.runtime.server`).

- `serve_batch` against the JAX package's `KVServer` on the same coalesced
  flushes (puts, extent inserts, deletes, extent gets and gets mixed in
  one flush, paged and unpaged, pad floor 16 and 64, linear and CCEH):
  statuses, arena rows, `kv.stats()` and every state leaf, tolerance 0.
- Within one flush puts land before deletes before gets.
- In-flight results are not torn by the next launch: a GET launched before
  an insert that overwrites its keys still returns the old pages.
- A failing flush completes with -2, counts `serve_errors`, and the driver
  carries on; `start()` twice runs one driver; a threaded storm through
  the driver loop verifies every page.

The port's server runs with `device="cpu"` here; its default, `cuda`,
raises without a GPU. Every threaded test is bounded by its own timeouts.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu.config import BloomConfig as JBloom
from pmdfc_tpu.config import IndexConfig as JIndex
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu.kv import KV as JKV
from pmdfc_tpu.runtime import engine as jengine
from pmdfc_tpu.runtime.server import KVServer as JServer
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.client.backends import EngineBackend
from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, IndexKind, KVConfig
from pmdfc_tpu_torch.runtime.engine import (
    OP_DEL, OP_GET, OP_GET_EXT, OP_INS_EXT, OP_PUT, Engine)
from pmdfc_tpu_torch.runtime.server import KVServer
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

PW = 16  # page words: 64-byte pages keep the arenas small
EXT_HI = 0x80000002


def small_server(paged: bool = True, bloom_bits: int | None = None,
                 batch: int = 1 << 10, timeout_us: int = 200,
                 **kw) -> KVServer:
    cfg = KVConfig(index=IndexConfig(capacity=1 << 12),
                   bloom=BloomConfig(num_bits=bloom_bits) if bloom_bits
                   else None, paged=paged, page_words=PW)
    eng = Engine(num_queues=4, queue_cap=1 << 12, batch=batch,
                 timeout_us=timeout_us, arena_pages=1 << 10, page_bytes=PW * 4)
    return KVServer(cfg, engine=eng, device="cpu", **kw)


def pages_of(keys: np.ndarray) -> np.ndarray:
    """Page contents as a function of key and word index."""
    with np.errstate(over="ignore"):
        base = keys[:, 0] * np.uint32(2654435761) + keys[:, 1] * np.uint32(40503)
        return base[:, None] + np.arange(PW, dtype=np.uint32)[None, :]


def jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in flat}


# -- serve_batch against the JAX KVServer ------------------------------------

CASES = {
    # name: (paged, pad floor, index kind)
    "paged-floor16": (True, 16, "linear"),
    "paged-floor64": (True, 64, "linear"),
    "unpaged-floor16": (False, 16, "linear"),
    "unpaged-floor64": (False, 64, "linear"),
    "cceh-paged-floor16": (True, 16, "cceh"),
}


def _pair(paged: bool, floor: int, kind: str):
    """A JAX and a port server over the same small config: 256 slots (so
    the flushes evict), a 2^12-bit bloom, a 64-record extent ring."""
    ix = (dict(capacity=256, cluster_slots=16) if kind == "linear"
          else dict(capacity=256, segment_slots=64, probe_window=16))

    def cfg(K, I, B, Kind):
        return K(index=I(kind=Kind(kind), **ix), bloom=B(num_bits=1 << 12),
                 paged=paged, page_words=PW, extent_capacity=64,
                 extent_max_covers=16, evicted_sketch_bits=1 << 10)

    ekw = dict(num_queues=4, queue_cap=1 << 10, batch=1 << 10,
               timeout_us=100, arena_pages=1 << 10, page_bytes=PW * 4)
    a = JServer(cfg(JKVConfig, JIndex, JBloom, JKind),
                engine=jengine.Engine(**ekw), pad_to=floor)
    b = KVServer(cfg(KVConfig, IndexConfig, BloomConfig, IndexKind),
                 engine=Engine(**ekw), pad_floor=floor, device="cpu")
    assert a.pad_floor == b.pad_floor == floor
    return a, b


def _flush_plan(rng, step: int, live: np.ndarray, paged: bool):
    """One flush's requests as (queue, op, keys, staged rows or values):
    puts (with an in-flush duplicate, hi >= 2^31 and an INVALID row), two
    extent inserts, deletes (with a duplicate), extent gets and gets of
    live, fresh and just-put keys."""
    fresh = rng.integers(0, 1 << 32, (90, 2), dtype=np.uint64).astype(np.uint32)
    fresh[:10, 0] |= 0x80000000
    fresh[5] = fresh[4]                      # duplicate within the put
    fresh[7] = 0xFFFFFFFF                    # INVALID: places nothing
    if len(live):
        fresh[60:75] = live[rng.integers(0, len(live), 15)]  # updates
    plan = [(0, OP_PUT, fresh, pages_of(fresh) if paged
             else rng.integers(0, 1 << 32, len(fresh), dtype=np.uint64
                               ).astype(np.uint32))]
    bases = [step * 4096 + 512 * j for j in range(2)]
    ext = [(np.array([[EXT_HI, base]], np.uint32),
            np.array([step, 0x7FFFF000 + 4096 * j, 40 + 7 * j], np.uint32))
           for j, base in enumerate(bases)]
    for j, (k, staged) in enumerate(ext):
        plan.append((1 + j, OP_INS_EXT, k, staged))
    pool = np.concatenate([live, fresh]) if len(live) else fresh
    gone = pool[rng.integers(0, len(pool), 30)]
    gone = np.concatenate([gone, gone[:3]])  # duplicate deletes
    plan.append((3, OP_DEL, gone, None))
    probe = np.array([[EXT_HI, b + o] for b in bases for o in (0, 1, 39, 46)],
                     np.uint32)
    plan.append((2, OP_GET_EXT, probe, None))
    gets = np.concatenate([
        pool[rng.integers(0, len(pool), 80)], gone[:10], fresh[:20],
        rng.integers(0, 1 << 32, (10, 2), dtype=np.uint64).astype(np.uint32)])
    plan.append((1, OP_GET, gets, None))
    return plan, fresh


def _submit(eng, plan, paged: bool):
    """Stage and submit a plan -> [(base id, n)]; every request gets its own
    arena slot (put source, extent staging, get destination)."""
    slot, ids = 0, []
    for q, op, keys, data in plan:
        n = len(keys)
        slots = np.arange(slot, slot + n, dtype=np.uint32)
        slot += n
        if op == OP_PUT and paged:
            eng.arena[slots] = data
        elif op == OP_PUT:
            slots = data  # unpaged: the value rides page_off
        elif op == OP_INS_EXT:
            eng.arena[slots[0]] = 0
            eng.arena[slots[0], :3] = data
        ids.append((eng.submit_batch(q, op, keys, slots), n))
    return ids


@pytest.mark.parametrize("case", list(CASES))
def test_serve_batch_matches_jax(case):
    paged, floor, kind = CASES[case]
    a, b = _pair(paged, floor, kind)
    rng = np.random.default_rng(len(case))
    live = np.zeros((0, 2), np.uint32)
    for step in range(4):
        plan, fresh = _flush_plan(rng, step, live, paged)
        a.engine.arena[:] = 0
        b.engine.arena[:] = 0
        ids_a = _submit(a.engine, plan, paged)
        ids_b = _submit(b.engine, plan, paged)
        assert ids_a == ids_b
        total = sum(n for _, n in ids_a)
        # timeout 0 drains what is queued and stops at the first empty
        # sweep: the round-robin cursor, and so the order, is the same
        ra = a.engine.pop_batch(1 << 10, timeout_us=0)
        rb = b.engine.pop_batch(1 << 10, timeout_us=0)
        assert len(ra) == len(rb) == total, "the plan must pop as one flush"
        assert ra.tobytes() == rb.tobytes()
        a.serve_batch(ra)
        b.serve_batch(rb)
        for (base, n), (q, op, _, _) in zip(ids_a, plan):
            sa = a.engine.wait_many(base, n, timeout_us=1_000_000)
            sb = b.engine.wait_many(base, n, timeout_us=1_000_000)
            np.testing.assert_array_equal(sa, sb, err_msg=f"{step} op {op}")
        np.testing.assert_array_equal(a.engine.arena, b.engine.arena,
                                      err_msg=f"arena after flush {step}")
        live = np.concatenate([live, fresh])
    sa, sb = a.kv.stats(), b.kv.stats()
    for k in tkv.STAT_NAMES:
        assert sa[k] == sb[k], f"stat {k}: {sa[k]} vs {sb[k]}"
    assert sb["hits"] > 0 and sb["deletes"] > 0
    if kind == "linear":  # CCEH splits into its headroom instead
        assert sb["evictions"] > 0
    else:
        assert int(b.kv.state.index.nseg) > 4
    assert sb["extent_puts"] == 8 and sb["misses"] > 0
    assert sb["misses"] == sum(sb[c] for c in tkv.MISS_CAUSE_NAMES)
    la, lb = jax_leaves(a.kv.state), carry.state_to_numpy(b.kv.state)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k
    a.engine.close()
    b.engine.close()


# -- ordering, in-flight results, failures -----------------------------------

def test_single_flush_put_delete_get_ordering():
    """Submit all three op kinds for overlapping keys BEFORE the driver
    starts (long coalescer timeout, deep batch): the one flush serializes
    puts, then deletes, then gets."""
    srv = small_server(batch=256, timeout_us=200_000)
    eng = srv.engine
    ka, kb = (1, 10), (1, 11)  # a: put then deleted -> miss; b: put -> hit
    pa = np.full(PW, 0xAAAAAAAA, np.uint32)
    pb = np.full(PW, 0xBBBBBBBB, np.uint32)
    eng.arena[0] = pa
    eng.arena[1] = pb
    ids = [("put_a", eng.submit(0, OP_PUT, *ka, 0)),
           ("put_b", eng.submit(1, OP_PUT, *kb, 1)),
           ("del_a", eng.submit(2, OP_DEL, *ka, 0)),
           ("get_a", eng.submit(3, OP_GET, *ka, 2)),
           ("get_b", eng.submit(0, OP_GET, *kb, 3))]
    srv.start()
    try:
        st = {name: eng.wait(rid, timeout_us=30_000_000) for name, rid in ids}
        assert st == {"put_a": 0, "put_b": 0, "del_a": 0, "get_a": -1,
                      "get_b": 0}
        np.testing.assert_array_equal(eng.arena[3], pb)
        np.testing.assert_array_equal(eng.arena[2], 0)
        assert eng.stats()["batches"] == 1
    finally:
        srv.stop()


def test_inflight_get_is_not_torn_by_the_next_insert():
    """The driver launches flush N+1 before it reads flush N. A GET
    launched first and read after an insert that overwrites the same keys
    with new pages returns the OLD pages — in the port's KV (which updates
    its state in place), through the server's launch/finalize, and in the
    JAX KV alike."""
    keys = np.stack([np.full(64, 3, np.uint32),
                     np.arange(64, dtype=np.uint32)], -1)
    old, new = pages_of(keys), pages_of(keys) ^ np.uint32(0x5A5A5A5A)
    jcfg = JKVConfig(index=JIndex(capacity=1 << 10), bloom=None, page_words=PW)
    tcfg = KVConfig(index=IndexConfig(capacity=1 << 10), bloom=None,
                    page_words=PW)
    for kv in (JKV(jcfg), tkv.KV(tcfg, device="cpu")):
        kv.insert(keys, old)
        out, order, found, nfound, b = kv.get_compact_async(keys)
        kv.insert_async(keys, new)
        got = np.asarray(out[:b]) if isinstance(kv, JKV) else u32.to_numpy(out[:b])
        assert int(nfound) == 64 and np.asarray(found)[:b].all()
        np.testing.assert_array_equal(got[np.argsort(np.asarray(order[:b]))],
                                      old)
        np.testing.assert_array_equal(kv.get(keys)[0], new)

    srv = small_server()
    eng = srv.engine
    eng.arena[:64] = old
    put = eng.submit_batch(0, OP_PUT, keys, np.arange(64, dtype=np.uint32))
    srv.serve_batch(eng.pop_batch(timeout_us=10_000))
    assert (eng.wait_many(put, 64) == 0).all()
    get = eng.submit_batch(1, OP_GET, keys,
                           np.arange(64, 128, dtype=np.uint32))
    get_reqs = eng.pop_batch(timeout_us=10_000)
    handles = srv._launch(get_reqs)                   # flush N: the GET
    eng.arena[:64] = new
    upd = eng.submit_batch(0, OP_PUT, keys, np.arange(64, dtype=np.uint32))
    upd_reqs = eng.pop_batch(timeout_us=10_000)
    upd_handles = srv._launch(upd_reqs)               # flush N+1: the insert
    srv._finalize(get_reqs, handles)                  # read N after N+1
    srv._finalize(upd_reqs, upd_handles)
    assert (eng.wait_many(get, 64) == 0).all()
    assert (eng.wait_many(upd, 64) == 0).all()
    np.testing.assert_array_equal(eng.arena[64:128], old)
    np.testing.assert_array_equal(srv.kv.get(keys)[0], new)
    eng.close()


def test_put_values_are_copied_off_the_arena():
    """A put's pages are copied when the flush launches: a client that
    rewrites its staging slot right after its request completes does not
    change what was stored."""
    srv = small_server()
    eng = srv.engine
    keys = np.stack([np.full(8, 4, np.uint32), np.arange(8, dtype=np.uint32)],
                    -1)
    eng.arena[:8] = pages_of(keys)
    base = eng.submit_batch(0, OP_PUT, keys, np.arange(8, dtype=np.uint32))
    srv.serve_batch(eng.pop_batch(timeout_us=10_000))
    assert (eng.wait_many(base, 8) == 0).all()
    eng.arena[:8] = 0xDEADBEEF
    out, found = srv.kv.get(keys)
    assert found.all()
    np.testing.assert_array_equal(out, pages_of(keys))
    eng.close()


def test_failed_flush_completes_minus_two_and_the_driver_carries_on():
    srv = small_server()
    failing = threading.Event()
    failed = []
    real = srv.kv.get_compact_async

    def broken(*a, **kw):
        if failing.is_set():
            failed.append(1)
            raise RuntimeError("kernel launch failed")
        return real(*a, **kw)

    srv.kv.get_compact_async = broken
    with srv.start():
        be = EngineBackend(srv, queue=0, slice_pages=64, timeout_us=10_000_000)
        keys = np.stack([np.full(32, 9, np.uint32),
                         np.arange(32, dtype=np.uint32)], -1)
        be.put(keys, pages_of(keys))
        failing.set()
        base = srv.engine.submit_batch(1, OP_GET, keys,
                                       np.arange(32, dtype=np.uint32))
        st = srv.engine.wait_many(base, 32, timeout_us=10_000_000)
        failing.clear()
        assert (st == -2).all()
        assert srv.health()["serve_errors"] == len(failed) >= 1
        out, found = be.get(keys)  # the next flush serves
        assert found.all()
        np.testing.assert_array_equal(out, pages_of(keys))
        be.close()
        h = srv.health()
    assert h["serve_errors"] == len(failed) and h["kv"]["hits"] == 32
    assert h["engine"]["submitted"] == h["engine"]["completed"] == 96


def test_fault_injected_drop_leaves_requests_to_time_out():
    class DropAll:
        def on_batch(self, reqs):
            return "drop"

    srv = small_server(fault_injector=DropAll())
    with srv.start():
        base = srv.engine.submit_batch(0, OP_GET, np.array([[1, 2]], np.uint32))
        with pytest.raises(TimeoutError):
            srv.engine.wait_many(base, 1, timeout_us=100_000)


def test_double_start_is_idempotent():
    """`with KVServer(...).start()` calls start() twice: one driver only,
    and none survives stop()."""
    pre = {t for t in threading.enumerate() if t.name == "pmdfc-driver"}
    with small_server(bloom_bits=1 << 13).start() as srv:
        drivers = [t for t in threading.enumerate()
                   if t.name == "pmdfc-driver" and t not in pre]
        assert drivers == [srv._thread]
        be = EngineBackend(srv)
        keys = np.stack([np.full(32, 5, np.uint32),
                         np.arange(32, dtype=np.uint32)], -1)
        be.put(keys, pages_of(keys))
        out, found = be.get(keys)
        assert found.all()
        np.testing.assert_array_equal(out, pages_of(keys))
        be.close()
    assert not [t for t in threading.enumerate()
                if t.name == "pmdfc-driver" and t not in pre]


def test_reporter_prints_the_servers_counters(capsys):
    srv = small_server(report_every_s=0.01)
    with srv.start():
        deadline = time.monotonic() + 10
        while "[indicator] phases" not in capsys.readouterr().out:
            assert time.monotonic() < deadline, "no indicator line"
            time.sleep(0.01)


def test_abandoned_backend_slice_is_held_until_the_engine_drains():
    srv = small_server()
    eng = srv.engine
    be = EngineBackend(srv, slice_pages=eng.arena_pages)  # the whole arena
    rid = eng.submit(0, OP_GET, 1, 2, 0)  # a request still in flight
    be.abandon()
    be.close()  # no-op: the slice went to quarantine
    with pytest.raises(MemoryError, match="quarantined"):
        EngineBackend(srv, slice_pages=8)
    srv.serve_batch(eng.pop_batch(timeout_us=10_000))
    assert eng.wait(rid) == -1
    assert EngineBackend(srv, slice_pages=8).arena_lo == 0  # drained
    eng.close()


def test_default_device_raises_without_a_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        KVServer(KVConfig(index=IndexConfig(capacity=1 << 10), bloom=None,
                          page_words=PW))


def test_warmup_runs_every_width_and_changes_nothing():
    srv = small_server(bloom_bits=1 << 13, batch=1 << 8)
    before = carry.state_to_numpy(srv.kv.state)
    assert srv.warmup() == 3 * 5  # widths 16..256, three kinds
    after = carry.state_to_numpy(srv.kv.state)
    for k in before:
        if k != "stats":
            np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    s = srv.kv.stats()
    assert s["puts"] == s["gets"] == s["deletes"] == 0
    srv.engine.close()


# -- the driver loop under threads ---------------------------------------------

def test_threaded_storm_with_content_verification():
    """4 threads x 25 verbs of 8 pages through EngineBackend into the
    running driver, each read back and verified; then deletes and a miss
    check, and the driver's phase timers saw every phase."""
    with small_server(bloom_bits=1 << 14) as srv:
        nthreads, verbs, n = 4, 25, 8
        errors: list[BaseException] = []
        bes = [EngineBackend(srv, queue=t, slice_pages=n * 2,
                             timeout_us=30_000_000) for t in range(nthreads)]

        def worker(t):
            try:
                be = bes[t]
                for v in range(verbs):
                    keys = np.stack([np.full(n, t + 1, np.uint32),
                                     np.arange(v * n, (v + 1) * n,
                                               dtype=np.uint32)], -1)
                    be.put(keys, pages_of(keys))
                    out, found = be.get(keys)
                    assert found.all(), f"t{t} v{v} miss"
                    np.testing.assert_array_equal(out, pages_of(keys))
                    if v % 5 == 4:
                        assert be.invalidate(keys[:2]).all()
                        _, found = be.get(keys[:4])
                        assert found.tolist() == [False, False, True, True]
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(nthreads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert all(not th.is_alive() for th in threads)
        assert not errors, errors[:1]
        for be in bes:
            be.close()
        h = srv.health()
        assert h["serve_errors"] == 0
        e = h["engine"]
        assert e["submitted"] == e["completed"] > 0
        assert h["kv"]["hits"] == nthreads * (verbs * n + verbs // 5 * 2)
        counts = srv.timers.counts()
        assert {"pop", "launch", "write", "read", "delete",
                "poll"} <= set(counts)


def test_extent_verbs_through_the_transport():
    """INS_EXT and GET_EXT cross the engine: the resolved address is
    value + 4096 * (key - base), the probe past the end misses, and the
    extent put's status is its uncovered tail."""
    cfg = KVConfig(index=IndexConfig(capacity=1 << 12), bloom=None,
                   page_words=PW, extent_capacity=64, extent_max_covers=16)
    eng = Engine(num_queues=2, queue_cap=1 << 10, batch=1 << 9,
                 timeout_us=200, arena_pages=1 << 9, page_bytes=PW * 4)
    with KVServer(cfg, engine=eng, device="cpu") as srv:
        be = EngineBackend(srv, queue=0, slice_pages=32, timeout_us=30_000_000)
        for j in range(4):
            base = np.uint32(0x80000000 + j * 256)
            assert be.insert_extent([100, base], [j, j << 20], 48) == 0
            ds = np.array([0, 1, 24, 47, 48], np.uint32)
            vals, found = be.get_extent(
                np.stack([np.full(5, 100, np.uint32), base + ds], -1))
            assert found.tolist() == [True] * 4 + [False]
            np.testing.assert_array_equal(vals[:4, 1],
                                          (j << 20) + ds[:4] * 4096)
            np.testing.assert_array_equal(vals[:4, 0], j)
        # a run past extent_max_covers leaves an uncovered tail
        assert be.insert_extent([101, 1], [0, 0], 1 << 20) > 0
        be.close()
        assert srv.kv.stats()["extent_puts"] == 5
