"""PyTorch port: `tests/test_runtime.py`, drill by drill.

Each test carries its JAX drill's name and runs the drill's script on
both packages: each package's native `Engine` (the port builds its own
copy of the C++) and its `KVServer` driver loop over a `KV` (the port's
on the CPU). The deterministic drills (a single put/get of known content,
`submit_batch`/`wait_many`, the queue-full partial count, the completion
table's wraparound, the unpaged value mode, one flush's put/delete/get
order) compare the two transcripts exactly: statuses, arena pages,
engine counters. The threaded drills (storms, the pipelined client, the
arena isolation, the engine torn down under fire, the double start) run
on both packages under the JAX drill's own invariants, and what the
script fixes (statuses, counts, found masks) is compared exactly. The
reference-grade storm (`slow` in JAX, 4 x 250k pages; on the card phase
7's 32-client serving storm) runs here at 4 x 8,192 pages on a 2^16-slot
server.
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import JAX as _JAX
from torch_twin import PORT as _PORT
from torch_twin import counters, fresh_jax_registry, registries  # noqa: F401
from torch_twin import twin as twin_of
from torch_twin import walk_in_reverse

import pmdfc_tpu.runtime.engine as jengine
import pmdfc_tpu.runtime.server as jserver
import pmdfc_tpu_torch.runtime.engine as tengine
import pmdfc_tpu_torch.runtime.server as tserver

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

JAX = types.SimpleNamespace(**vars(_JAX), name="jax", engine=jengine,
                            server=jserver, server_kw={})
PORT = types.SimpleNamespace(**vars(_PORT), name="port", engine=tengine,
                             server=tserver, server_kw={"device": "cpu"})
PKGS = (JAX, PORT)
OP_PUT, OP_GET, OP_DEL = jengine.OP_PUT, jengine.OP_GET, jengine.OP_DEL
assert (OP_PUT, OP_GET, OP_DEL) == (tengine.OP_PUT, tengine.OP_GET,
                                    tengine.OP_DEL)


def twin(drill, *args):
    return twin_of(drill, *args, pkgs=PKGS)


def _server(p, paged=True, capacity=1 << 12, bloom=None, eng=None, **kw):
    c = p.config
    cfg = c.KVConfig(index=c.IndexConfig(capacity=capacity), bloom=bloom,
                     paged=paged, page_words=16, **kw)
    if eng is None:
        eng = p.engine.Engine(num_queues=4, queue_cap=1 << 12,
                              batch=1 << 10, timeout_us=200,
                              arena_pages=1 << 10, page_bytes=64)
    return p.server.KVServer(cfg, engine=eng, **p.server_kw)


def _fill(khi, klo, words: int) -> np.ndarray:
    base = (khi * np.uint32(2654435761) + klo * np.uint32(40503))
    return base[:, None] + np.arange(words, dtype=np.uint32)[None, :]


def _engine_stats(eng) -> dict:
    return {k: int(v) for k, v in eng.stats().items()}


def test_engine_mpmc_roundtrip_no_server():
    def drill(p):
        eng = p.engine.Engine(num_queues=2, queue_cap=1 << 8, batch=64,
                              timeout_us=100, arena_pages=16, page_bytes=64)
        ids = [eng.submit(i % 2, OP_PUT, 1, i, i % 16) for i in range(100)]
        got, seen = 0, set()
        while got < 100:
            reqs = eng.pop_batch(64, timeout_us=1000)
            got += len(reqs)
            seen.update(int(r) for r in reqs["req_id"])
            eng.complete(reqs["req_id"], np.zeros(len(reqs), np.int32))
        assert seen == set(ids)
        sts = [eng.wait(rid) for rid in ids]
        assert sts == [0] * 100
        s = eng.stats()
        assert s["submitted"] == 100 and s["completed"] == 100
        eng.close()
        return ids, sts, int(s["submitted"]), int(s["completed"])

    twin(drill)


def test_single_put_get_known_content():
    def drill(p):
        with _server(p) as srv:
            page = np.zeros(16, np.uint32)
            page[:3] = [0x68692C20, 0x6469636C, 0x21]
            e = srv.engine
            e.arena[3] = page
            sts = [e.wait(e.submit(0, OP_PUT, 7, 1234, 3)),
                   e.wait(e.submit(1, OP_GET, 7, 1234, 5))]
            got = np.array(e.arena[5])
            np.testing.assert_array_equal(got, page)
            sts += [e.wait(e.submit(0, OP_GET, 7, 9999, 6)),
                    e.wait(e.submit(0, OP_DEL, 7, 1234, 0)),
                    e.wait(e.submit(0, OP_GET, 7, 1234, 6))]
            assert sts == [0, 0, -1, 0, -1]
            return sts, got, counters(srv.kv.stats())

    twin(drill)


def test_threaded_storm_with_content_verification():
    def drill(p):
        with _server(p) as srv:
            nthreads, per = 4, 200
            errors = []
            e = srv.engine

            def worker(t):
                try:
                    rng = np.random.default_rng(t)
                    stage, dst = t * 2, t * 2 + 1
                    for i in range(per):
                        key = (t << 16) | i
                        page = rng.integers(0, 2**32, 16, dtype=np.uint32)
                        e.arena[stage] = page
                        assert e.wait(e.submit(t, OP_PUT, 1, key, stage)) == 0
                        st = e.wait(e.submit(t, OP_GET, 1, key, dst))
                        assert st == 0, f"t{t} i{i} unexpected miss"
                        assert (e.arena[dst] == page).all(), f"t{t} i{i}"
                except Exception as ex:  # noqa: BLE001
                    errors.append(ex)

            ths = [threading.Thread(target=worker, args=(t,))
                   for t in range(nthreads)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=120)
            assert not errors, (p.name, errors[:1])
            s = e.stats()
            assert s["submitted"] == nthreads * per * 2
            assert s["completed"] == s["submitted"] and s["batches"] >= 1
            st = srv.kv.stats()
            return (int(s["submitted"]), int(s["completed"]), st["puts"],
                    st["hits"], st["misses"])

    twin(drill)


def test_submit_batch_wait_many_roundtrip():
    def drill(p):
        with _server(p) as srv:
            e, n = srv.engine, 256
            keys = np.stack([np.full(n, 9, np.uint32),
                             np.arange(n, dtype=np.uint32)], -1)
            slots = np.arange(n, dtype=np.uint32) % e.arena_pages
            pages = np.random.default_rng(0).integers(
                0, 2**32, (n, 16), dtype=np.uint32)
            e.arena[slots] = pages
            st_put = e.wait_many(e.submit_batch(0, OP_PUT, keys, slots), n)
            st_get = e.wait_many(e.submit_batch(1, OP_GET, keys, slots), n)
            assert (st_put == 0).all() and (st_get == 0).all()
            got = np.array(e.arena[slots])
            np.testing.assert_array_equal(got, pages)
            return st_put, st_get, got, counters(srv.kv.stats())

    twin(drill)


def test_queue_full_backpressure_without_driver():
    def drill(p):
        eng = p.engine.Engine(num_queues=1, queue_cap=1 << 8, batch=64,
                              timeout_us=100, arena_pages=16, page_bytes=64)
        n = (1 << 8) + 50
        keys = np.stack([np.zeros(n, np.uint32),
                         np.arange(n, dtype=np.uint32)], -1)
        with pytest.raises(TimeoutError, match=r"256/306") as ex:
            eng.submit_batch(0, OP_PUT, keys, timeout_us=50_000)
        got, klo = 0, []
        while True:
            reqs = eng.pop_batch(64, timeout_us=10_000)
            if len(reqs) == 0:
                break
            eng.complete(reqs["req_id"], np.zeros(len(reqs), np.int32))
            got += len(reqs)
            klo += [int(k) for k in reqs["klo"]]
        assert got == 1 << 8
        eng.close()
        return str(ex.value), got, sorted(klo)

    twin(drill)


def test_completion_slot_wraparound():
    def drill(p):
        eng = p.engine.Engine(num_queues=1, queue_cap=1 << 8, batch=64,
                              timeout_us=100, arena_pages=16, page_bytes=64)
        rounds, out = 40, []
        for r in range(rounds):
            n = 1 << 8
            keys = np.stack([np.full(n, r, np.uint32),
                             np.arange(n, dtype=np.uint32)], -1)
            base = eng.submit_batch(0, OP_PUT, keys)
            done = 0
            while done < n:
                reqs = eng.pop_batch(64, timeout_us=10_000)
                eng.complete(reqs["req_id"],
                             (reqs["klo"] % 7).astype(np.int32))
                done += len(reqs)
            st = eng.wait_many(base, n)
            np.testing.assert_array_equal(st, np.arange(n) % 7)
            out.append(st)
        s = eng.stats()
        assert s["submitted"] == s["completed"] == rounds * 256
        eng.close()
        return out, int(s["submitted"])

    twin(drill)


def _pipelined(p, comp_slots: bool):
    nverbs, vb = 16, 64
    if comp_slots:
        eng = p.engine.Engine(num_queues=1, queue_cap=1 << 10, batch=64,
                              timeout_us=100, arena_pages=16, page_bytes=64,
                              comp_slots=4 * nverbs * vb)
    else:
        eng = p.engine.Engine(num_queues=1, queue_cap=64, batch=64,
                              timeout_us=100, arena_pages=16, page_bytes=64)
    stop = threading.Event()

    def driver():
        while not stop.is_set():
            reqs = eng.pop_batch(64, timeout_us=5_000)
            if len(reqs):
                eng.complete(reqs["req_id"],
                             (reqs["klo"] % 5).astype(np.int32))

    th = threading.Thread(target=driver, daemon=True)
    th.start()
    try:
        pending = []
        for v in range(nverbs):
            keys = np.stack([np.full(vb, v, np.uint32),
                             np.arange(vb, dtype=np.uint32)], -1)
            pending.append(eng.submit_batch(0, OP_PUT, keys,
                                            timeout_us=2_000_000))
        if comp_slots:
            out = [eng.wait_many(base, vb, timeout_us=5_000_000)
                   for base in pending]
            for st in out:
                np.testing.assert_array_equal(st, np.arange(vb) % 5)
            return out
        last = eng.wait_many(pending[-1], vb, timeout_us=5_000_000)
        with pytest.raises(TimeoutError):
            eng.wait_many(pending[0], vb, timeout_us=50_000)
        return [last]
    finally:
        stop.set()
        th.join(timeout=5)
        eng.close()


def test_deep_pipelined_client_needs_comp_slots():
    twin(_pipelined, True)


def test_deep_pipelined_client_wedges_without_comp_slots():
    twin(_pipelined, False)


def test_reference_grade_storm():
    """The JAX drill (`slow` there: 4 threads x 250k pages; on the card
    phase 7's serving storm) at 4 x 8,192 pages, 2,048 a verb, on a
    2^16-slot server: every hit content-verified, every miss an eviction
    or a drop, at least half the pages verified."""
    per, nthreads, cb = 8192, 4, 2048

    def drill(p):
        eng = p.engine.Engine(num_queues=8, queue_cap=1 << 14,
                              batch=1 << 13, timeout_us=300,
                              arena_pages=1 << 14, page_bytes=64)
        with _server(p, capacity=1 << 16, eng=eng) as srv:
            e = srv.engine
            errors = []
            verified = np.zeros(nthreads, np.int64)
            misses = np.zeros(nthreads, np.int64)

            def worker(t):
                try:
                    bslots = np.arange(t * cb, (t + 1) * cb, dtype=np.uint32)
                    for lo in range(0, per, cb):
                        n = min(cb, per - lo)
                        slots = bslots[:n]
                        khi = np.full(n, t + 1, np.uint32)
                        klo = np.arange(lo, lo + n, dtype=np.uint32)
                        keys = np.stack([khi, klo], -1)
                        pages = _fill(khi, klo, e.page_words)
                        e.arena[slots] = pages
                        e.wait_many(e.submit_batch(
                            t, OP_PUT, keys, slots, timeout_us=60_000_000),
                            n, timeout_us=60_000_000)
                        st = e.wait_many(e.submit_batch(
                            (t + 4) % 8, OP_GET, keys, slots,
                            timeout_us=60_000_000), n, timeout_us=60_000_000)
                        hit = st == 0
                        if not (e.arena[slots[hit]] == pages[hit]).all():
                            raise AssertionError(f"t{t} block@{lo}")
                        verified[t] += int(hit.sum())
                        misses[t] += int((~hit).sum())
                except Exception as ex:  # noqa: BLE001
                    errors.append(ex)

            ths = [threading.Thread(target=worker, args=(t,))
                   for t in range(nthreads)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=600)
            assert not errors, (p.name, errors[:1])
            total = nthreads * per
            s = e.stats()
            assert s["submitted"] == total * 2
            assert s["completed"] == s["submitted"]
            kvs = srv.kv.stats()
            assert misses.sum() <= kvs["evictions"] + kvs["drops"]
            assert verified.sum() >= total * 0.5
            return int(s["submitted"]), int(verified.sum() + misses.sum())

    twin(drill)


def test_extent_verbs_through_transport_storm():
    nthreads, rounds, elen = 4, 8, 48

    def drill(p):
        eng = p.engine.Engine(num_queues=8, queue_cap=1 << 12,
                              batch=1 << 11, timeout_us=300,
                              arena_pages=1 << 12, page_bytes=64)
        with _server(p, capacity=1 << 14, eng=eng, extent_capacity=256,
                     extent_max_covers=16) as srv:
            bes = [p.backends.EngineBackend(srv, queue=t,
                                            timeout_us=60_000_000)
                   for t in range(nthreads)]
            errors, seen = [], {}

            def worker(t):
                try:
                    be = bes[t]
                    khi = np.uint32(100 + t)
                    for j in range(rounds):
                        base = np.uint32(j * 256)
                        vhi, vlo = np.uint32(t), np.uint32(j << 20)
                        assert be.insert_extent([khi, base], [vhi, vlo],
                                                elen) == 0
                        pk = np.stack([np.full(32, 1000 + t, np.uint32),
                                       np.arange(j * 32, j * 32 + 32,
                                                 dtype=np.uint32)], -1)
                        be.put(pk, _fill(pk[:, 0], pk[:, 1], 16))
                        ds = np.array([0, 1, elen // 2, elen - 1, elen],
                                      np.uint32)
                        probe = np.stack([np.full(len(ds), khi), base + ds],
                                         -1)
                        vals, found = be.get_extent(probe)
                        assert found.tolist() == [True] * 4 + [False]
                        np.testing.assert_array_equal(
                            vals[:4, 1], vlo + ds[:4] * np.uint32(4096))
                        np.testing.assert_array_equal(vals[:4, 0],
                                                      np.full(4, vhi))
                        out, pfound = be.get(pk)
                        assert pfound.all()
                        np.testing.assert_array_equal(
                            out, _fill(pk[:, 0], pk[:, 1], 16))
                        seen[(t, j)] = np.asarray(vals)
                except BaseException as ex:  # noqa: BLE001
                    errors.append(ex)

            ths = [threading.Thread(target=worker, args=(t,))
                   for t in range(nthreads)]
            for th in ths:
                th.start()
            for th in ths:
                th.join()
            for be in bes:
                be.close()
            assert not errors, (p.name, errors[0])
            s = srv.kv.stats()
            assert s["extent_puts"] == nthreads * rounds, s
            return [seen[k] for k in sorted(seen)], s["extent_puts"]

    twin(drill)


def test_multi_client_arena_isolation():
    def drill(p):
        with _server(p) as srv:
            b1 = p.backends.EngineBackend(srv, queue=0)
            b2 = p.backends.EngineBackend(srv, queue=1)
            assert b1.arena_hi <= b2.arena_lo or b2.arena_hi <= b1.arena_lo
            errors = []

            def client(b, tag):
                try:
                    rng = np.random.default_rng(tag)
                    for i in range(30):
                        n = 64
                        keys = np.stack(
                            [np.full(n, tag, np.uint32),
                             np.arange(i * n, (i + 1) * n, dtype=np.uint32)],
                            -1)
                        pages = rng.integers(0, 2**32, (n, 16),
                                             dtype=np.uint32)
                        b.put(keys, pages)
                        out, found = b.get(keys)
                        assert found.all(), f"client{tag} round {i} miss"
                        assert (out == pages).all(), f"client{tag} clobbered"
                except Exception as ex:  # noqa: BLE001
                    errors.append(ex)

            ths = [threading.Thread(target=client, args=(b, t))
                   for t, b in ((100, b1), (200, b2))]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=300)
            assert not errors, (p.name, errors[:1])
            return (b1.arena_lo, b1.arena_hi, b2.arena_lo, b2.arena_hi,
                    srv.kv.stats()["puts"])

    twin(drill)


def test_unpaged_u64_values_mode():
    def drill(p):
        with _server(p, paged=False) as srv:
            e = srv.engine
            sts = [e.wait(e.submit(0, OP_PUT, 2, 77, 4242)),
                   e.wait(e.submit(0, OP_GET, 2, 77, 0))]
            out, found = srv.kv.get(np.array([[2, 77]], np.uint32))
            assert sts == [0, 0] and found.all() and out[0, 1] == 4242
            return sts, np.asarray(out).astype(np.int64) & 0xFFFFFFFF, \
                np.asarray(found)

    twin(drill)


def test_double_start_is_idempotent():
    def drill(p):
        c = p.config
        cfg = c.KVConfig(index=c.IndexConfig(capacity=1 << 12),
                         bloom=c.BloomConfig(num_bits=1 << 13), paged=True,
                         page_words=16)
        eng = p.engine.Engine(num_queues=2, queue_cap=1 << 10, batch=256,
                              timeout_us=200, arena_pages=512, page_bytes=64)
        pre = {t for t in threading.enumerate() if t.name == "pmdfc-driver"}
        with p.server.KVServer(cfg, engine=eng,
                               **p.server_kw).start() as srv:
            drivers = [t for t in threading.enumerate()
                       if t.name == "pmdfc-driver" and t not in pre]
            assert len(drivers) == 1 and srv._thread in drivers
            be = p.backends.EngineBackend(srv)
            rng = np.random.default_rng(41)
            flat = rng.choice(1 << 22, size=32, replace=False)
            keys = np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)
            pages = (keys[:, 0] * 7 + keys[:, 1])[:, None] + np.arange(
                16, dtype=np.uint32)
            results = []

            def work():
                be.put(keys, pages)
                results.append(be.get(keys))

            th = threading.Thread(target=work)
            th.start()
            th.join()
            assert results and results[0][1].all(), "insert lost"
            be.close()
        assert not [t for t in threading.enumerate()
                    if t.name == "pmdfc-driver" and t not in pre]
        return results[0][0], results[0][1]

    twin(drill)


def test_engine_destroy_under_client_fire():
    def drill(p):
        for _ in range(6):
            eng = p.engine.Engine(num_queues=2, queue_cap=1 << 8, batch=64,
                                  timeout_us=100, arena_pages=8,
                                  page_bytes=64)
            stop = threading.Event()
            errors = []

            def fire(t):
                rng = np.random.default_rng(t)
                keys = rng.integers(0, 2**32, (16, 2), dtype=np.uint64
                                    ).astype(np.uint32)
                while not stop.is_set():
                    try:
                        base = eng.submit_batch(t % 2, OP_GET, keys,
                                                timeout_us=1000)
                        eng.wait_many(base, len(keys), timeout_us=1000)
                    except (TimeoutError, RuntimeError):
                        if eng._h is None:
                            return
                    except BaseException as ex:  # noqa: BLE001
                        errors.append(ex)
                        return

            ths = [threading.Thread(target=fire, args=(t,)) for t in range(4)]
            for th in ths:
                th.start()
            time.sleep(0.05)
            eng.close()
            stop.set()
            for th in ths:
                th.join(timeout=10)
            assert not errors, (p.name, errors[:1])
            assert all(not th.is_alive() for th in ths)
        return True

    twin(drill)


def test_single_flush_put_delete_get_ordering():
    def drill(p):
        eng = p.engine.Engine(num_queues=4, queue_cap=1 << 8, batch=256,
                              timeout_us=200_000, arena_pages=64,
                              page_bytes=64)
        srv = _server(p, capacity=1 << 10, eng=eng)
        ka, kb = (1, 10), (1, 11)
        pa = np.full(16, 0xAAAAAAAA, np.uint32)
        pb = np.full(16, 0xBBBBBBBB, np.uint32)
        eng.arena[0] = pa
        eng.arena[1] = pb
        ids = [("put_a", eng.submit(0, OP_PUT, *ka, 0)),
               ("put_b", eng.submit(1, OP_PUT, *kb, 1)),
               ("del_a", eng.submit(2, OP_DEL, *ka, 0)),
               ("get_a", eng.submit(3, OP_GET, *ka, 2)),
               ("get_b", eng.submit(0, OP_GET, *kb, 3))]
        srv.start()
        try:
            st = {name: eng.wait(rid, timeout_us=30_000_000)
                  for name, rid in ids}
            assert st == {"put_a": 0, "put_b": 0, "del_a": 0, "get_a": -1,
                          "get_b": 0}
            got = np.array(eng.arena[3])
            np.testing.assert_array_equal(got, pb)
            return st, got, counters(srv.kv.stats())
        finally:
            srv.stop()

    twin(drill)


walk_in_reverse(globals())
