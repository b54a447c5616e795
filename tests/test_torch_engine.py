"""PyTorch port: the native coalescing engine (`pmdfc_tpu_torch.runtime.engine`).

The port builds its own copy of the engine (`pmdfc_tpu_torch/native/
runtime.cpp`) with g++ into `build/pmdfc_tpu_torch/`. Here it takes the same
request stream as the JAX package's engine and must pop the same batches,
and it passes the twins of the JAX engine tests (`tests/test_runtime.py`):
MPMC round trip, backpressure when a queue is full, completion-slot
wraparound, deep pipelined clients with and without `comp_slots`, and
`close()` under client fire. Every threaded test is bounded by its own
timeouts.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu.runtime import engine as jengine
from pmdfc_tpu_torch.ops import _build
from pmdfc_tpu_torch.runtime import engine as tengine
from pmdfc_tpu_torch.runtime.engine import OP_DEL, OP_GET, OP_PUT, Engine

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]


def _keys(n: int, hi: int, start: int = 0) -> np.ndarray:
    return np.stack([np.full(n, hi, np.uint32),
                     np.arange(start, start + n, dtype=np.uint32)], -1)


def test_engine_is_built_from_the_ports_own_source():
    Engine(num_queues=1, queue_cap=1 << 4, batch=4, arena_pages=4,
           page_bytes=64).close()
    lib = Path(tengine.get_lib()._name).resolve()
    assert lib == (_build.BUILD_DIR / "libpmdfc_runtime.so").resolve()
    assert lib.is_relative_to(ROOT / "build" / "pmdfc_tpu_torch")
    assert _build.NATIVE == ROOT / "pmdfc_tpu_torch" / "native"
    assert tengine.REQ_DTYPE == jengine.REQ_DTYPE
    assert (tengine.OP_PUT, tengine.OP_GET, tengine.OP_DEL, tengine.OP_INS_EXT,
            tengine.OP_GET_EXT) == (jengine.OP_PUT, jengine.OP_GET,
                                    jengine.OP_DEL, jengine.OP_INS_EXT,
                                    jengine.OP_GET_EXT)


def test_native_source_is_a_copy_but_for_its_header():
    """The port's runtime.cpp differs from the JAX package's only in the
    header comment above the first #include."""
    def body(p):
        text = p.read_text()
        return text[text.index("#include"):]

    assert body(ROOT / "pmdfc_tpu_torch" / "native" / "runtime.cpp") == \
        body(ROOT / "native" / "runtime.cpp")


@pytest.mark.parametrize("max_n", [64, 7])
def test_engine_pops_the_same_batches_as_the_jax_engine(max_n):
    """One request stream (single submits and batches over 4 queues, all
    five ops, keys with hi >= 2^31) into both engines: the popped batches,
    completions and stats agree field for field."""
    kw = dict(num_queues=4, queue_cap=1 << 8, batch=64, timeout_us=100,
              arena_pages=64, page_bytes=64)
    a, b = jengine.Engine(**kw), Engine(**kw)
    rng = np.random.default_rng(max_n)
    ids_a, ids_b = [], []
    for step in range(12):
        q, op = step % 4, step % 5
        if step % 3 == 0:
            khi, klo, off = (int(x) for x in rng.integers(0, 1 << 32, 3))
            ids_a.append((a.submit(q, op, khi, klo, off % 64), 1))
            ids_b.append((b.submit(q, op, khi, klo, off % 64), 1))
        else:
            n = int(rng.integers(1, 40))
            keys = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64
                                ).astype(np.uint32)
            keys[:, 0] |= 0x80000000
            off = rng.integers(0, 64, n).astype(np.uint32)
            ids_a.append((a.submit_batch(q, op, keys, off), n))
            ids_b.append((b.submit_batch(q, op, keys, off), n))
    assert ids_a == ids_b
    total = sum(n for _, n in ids_a)
    got = 0
    while got < total:
        # timeout 0: no dwell, so the round-robin cursor advances the same
        ra = a.pop_batch(max_n, timeout_us=0)
        rb = b.pop_batch(max_n, timeout_us=0)
        assert ra.dtype == rb.dtype and ra.tobytes() == rb.tobytes()
        assert 0 < len(ra) <= max_n
        st = (ra["klo"] % 11).astype(np.int32) - 1
        a.complete(ra["req_id"], st)
        b.complete(rb["req_id"], st)
        got += len(ra)
    assert len(b.pop_batch(max_n, timeout_us=100)) == 0
    for (base, n), _ in zip(ids_a, ids_b):
        np.testing.assert_array_equal(a.wait_many(base, n),
                                      b.wait_many(base, n))
    assert a.stats() == b.stats()
    assert b.stats()["submitted"] == b.stats()["completed"] == total
    a.close()
    b.close()


def test_engine_mpmc_roundtrip_no_server():
    eng = Engine(num_queues=2, queue_cap=1 << 8, batch=64, timeout_us=100,
                 arena_pages=16, page_bytes=64)
    ids = [eng.submit(i % 2, OP_PUT, 1, i, i % 16) for i in range(100)]
    got = 0
    seen = set()
    while got < 100:
        reqs = eng.pop_batch(64, timeout_us=1000)
        got += len(reqs)
        seen.update(int(r) for r in reqs["req_id"])
        eng.complete(reqs["req_id"], np.zeros(len(reqs), np.int32))
    assert seen == set(ids)
    for rid in ids:
        assert eng.wait(rid) == 0
    s = eng.stats()
    assert s["submitted"] == 100 and s["completed"] == 100
    eng.close()


def test_queue_full_backpressure_without_driver():
    """No driver: the queue fills, submit_batch times out with an exact
    partial count, and the submitted prefix still drains."""
    eng = Engine(num_queues=1, queue_cap=1 << 8, batch=64, timeout_us=100,
                 arena_pages=16, page_bytes=64)
    n = (1 << 8) + 50
    with pytest.raises(TimeoutError, match=r"256/306"):
        eng.submit_batch(0, OP_PUT, _keys(n, 0), timeout_us=50_000)
    got = 0
    while True:
        reqs = eng.pop_batch(64, timeout_us=10_000)
        if len(reqs) == 0:
            break
        eng.complete(reqs["req_id"], np.zeros(len(reqs), np.int32))
        got += len(reqs)
    assert got == 1 << 8
    eng.close()


def test_completion_slot_wraparound():
    """Ids far past the completion table's capacity: every waiter still
    sees its own completion (slot reuse is keyed by req_id)."""
    eng = Engine(num_queues=1, queue_cap=1 << 8, batch=64, timeout_us=100,
                 arena_pages=16, page_bytes=64)
    rounds = 40  # 40 * 256 ids >> comp_cap
    for r in range(rounds):
        n = 1 << 8
        base = eng.submit_batch(0, OP_PUT, _keys(n, r))
        done = 0
        while done < n:
            reqs = eng.pop_batch(64, timeout_us=10_000)
            eng.complete(reqs["req_id"],
                         (reqs["klo"] % 7).astype(np.int32))
            done += len(reqs)
        np.testing.assert_array_equal(eng.wait_many(base, n),
                                      np.arange(n) % 7)
    s = eng.stats()
    assert s["submitted"] == s["completed"] == rounds * 256
    eng.close()


def _driver(eng, stop, mod):
    while not stop.is_set():
        reqs = eng.pop_batch(64, timeout_us=5_000)
        if len(reqs):
            eng.complete(reqs["req_id"], (reqs["klo"] % mod).astype(np.int32))


@pytest.mark.parametrize("comp_slots", [True, False],
                         ids=["with-comp-slots", "legacy-wedges"])
def test_deep_pipelined_client(comp_slots):
    """Ids live from allocation until the WAITER reads them: a client that
    submits 16 verbs before waiting needs `comp_slots` sized to that; with
    the legacy sizing the first verb's slots are overwritten and its wait
    times out (the failure the knob exists for)."""
    nverbs, vb = 16, 64
    kw = (dict(queue_cap=1 << 10, comp_slots=4 * nverbs * vb) if comp_slots
          else dict(queue_cap=64))
    eng = Engine(num_queues=1, batch=64, timeout_us=100, arena_pages=16,
                 page_bytes=64, **kw)
    stop = threading.Event()
    th = threading.Thread(target=_driver, args=(eng, stop, 5), daemon=True)
    th.start()
    try:
        pending = [eng.submit_batch(0, OP_PUT, _keys(vb, v),
                                    timeout_us=2_000_000)
                   for v in range(nverbs)]
        if comp_slots:
            for base in pending:
                np.testing.assert_array_equal(
                    eng.wait_many(base, vb, timeout_us=5_000_000),
                    np.arange(vb) % 5)
        else:
            eng.wait_many(pending[-1], vb, timeout_us=5_000_000)
            with pytest.raises(TimeoutError):
                eng.wait_many(pending[0], vb, timeout_us=50_000)
    finally:
        stop.set()
        th.join(timeout=5)
        assert not th.is_alive()
        eng.close()


def test_engine_close_under_client_fire():
    """Closing the engine while client threads are mid-submit/wait
    degrades to failure codes and never touches freed memory."""
    for _ in range(4):
        eng = Engine(num_queues=2, queue_cap=1 << 8, batch=64,
                     timeout_us=100, arena_pages=8, page_bytes=64)
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
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
                    return

        threads = [threading.Thread(target=fire, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        time.sleep(0.05)
        eng.close()
        stop.set()
        for th in threads:
            th.join(timeout=10)
        assert not errors, errors[:1]
        assert all(not th.is_alive() for th in threads)
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(0, OP_DEL, 1, 2)
        eng.close()  # idempotent


def test_arena_slices_are_disjoint_and_recycled():
    """First-fit slices, returned slices reused, quarantined slices held
    back until the engine drains."""
    eng = Engine(num_queues=1, queue_cap=1 << 4, batch=16, timeout_us=100,
                 arena_pages=32, page_bytes=64)
    assert eng.arena.shape == (32, 16) and eng.arena.dtype == np.uint32
    a, b = eng.alloc_arena_slice(16), eng.alloc_arena_slice(16)
    assert (a, b) == ((0, 16), (16, 32))
    with pytest.raises(MemoryError, match="arena exhausted"):
        eng.alloc_arena_slice(1)
    eng.free_arena_slice(*a)
    assert eng.alloc_arena_slice(8) == (0, 8)
    assert eng.alloc_arena_slice(8) == (8, 16)
    eng.quarantine_arena_slice(0, 16)
    rid = eng.submit(0, OP_GET, 1, 2, 0)  # in flight: not drained
    with pytest.raises(MemoryError, match="16 quarantined"):
        eng.alloc_arena_slice(4)
    reqs = eng.pop_batch(16, timeout_us=1000)
    eng.complete(reqs["req_id"], np.zeros(len(reqs), np.int32))
    assert eng.wait(rid) == 0
    assert eng.alloc_arena_slice(4) == (0, 4)  # drained: reclaimed
    eng.close()
