"""ctypes bindings for the native coalescing engine (twin of
`pmdfc_tpu/runtime/engine.py`).

The engine is the in-process transport: lock-free MPMC submission queues, a
page staging arena, adaptive batch flush, and per-request completion slots —
the native data-plane the reference builds from rdma_svr.cpp poller threads
+ circular_queue.cpp, with the NIC replaced by shared memory (the same move
the reference's own `client/dram-backend/` makes for testing).

The library is the port's own copy, `pmdfc_tpu_torch/native/runtime.cpp`,
built with g++ by `ops/_build.load_host` into `build/pmdfc_tpu_torch/` at
the first `Engine()` — never at import. It is host code: it builds and
runs without a GPU.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from pmdfc_tpu_torch.ops import _build
from pmdfc_tpu_torch.runtime import sanitizer as san

OP_PUT, OP_GET, OP_DEL = 0, 1, 2
# Extent verbs: INS_EXT stages [val_hi, val_lo, length] in its arena slot;
# GET_EXT gets its resolved value[2] written back into its slot. The native
# engine treats `op` as an opaque u32.
OP_INS_EXT, OP_GET_EXT = 3, 4

REQ_DTYPE = np.dtype(
    [
        ("op", np.uint32),
        ("khi", np.uint32),
        ("klo", np.uint32),
        ("page_off", np.uint32),
        ("req_id", np.uint64),
    ]
)
assert REQ_DTYPE.itemsize == 24


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32, u64, p = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p
    lib.pm_create.restype = p
    lib.pm_create.argtypes = [u32, u32, u32, u32, u32, u32]
    lib.pm_create2.restype = p
    lib.pm_create2.argtypes = [u32, u32, u32, u32, u32, u32, u64]
    lib.pm_close.argtypes = [p]
    lib.pm_destroy.argtypes = [p]
    lib.pm_arena.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.pm_arena.argtypes = [p]
    lib.pm_set_arena.argtypes = [p, ctypes.POINTER(ctypes.c_uint8)]
    lib.pm_submit.restype = u64
    lib.pm_submit.argtypes = [p, u32, u32, u32, u32, u32, u32]
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    lib.pm_submit_batch.restype = u32
    lib.pm_submit_batch.argtypes = [p, u32, u32, pu32, pu32, pu32, u32, u32,
                                    ctypes.POINTER(ctypes.c_uint64)]
    lib.pm_wait_many.restype = u32
    lib.pm_wait_many.argtypes = [p, u64, u32, ctypes.POINTER(ctypes.c_int32),
                                 u32]
    lib.pm_pop_batch.restype = u32
    lib.pm_pop_batch.argtypes = [p, ctypes.c_void_p, u32, u32]
    lib.pm_complete.argtypes = [p, ctypes.c_void_p, ctypes.c_void_p, u32]
    lib.pm_wait.restype = ctypes.c_int32
    lib.pm_wait.argtypes = [p, u64, u32]
    lib.pm_stats.argtypes = [p, ctypes.c_void_p]
    return lib


_lib = None
_lib_lock = san.lock("engine._lib_lock")  # guarded-by: _lib


def get_lib() -> ctypes.CDLL:
    """The engine library, built and declared on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _declare(_build.load_host("runtime"))
        return _lib


class Engine:
    """One coalescing engine instance.

    `arena` is exposed as a numpy uint32 view [arena_pages, page_words]; puts
    stage pages there before submit, gets read their page back from their
    destination slot after completion — exactly the reference's
    staging-region discipline with DMA replaced by shared memory.
    """

    def __init__(self, num_queues: int = 8, queue_cap: int = 1 << 14,
                 batch: int = 1 << 12, timeout_us: int = 200,
                 arena_pages: int = 1 << 12, page_bytes: int = 4096,
                 comp_slots: int = 0):
        """`comp_slots` must cover the TOTAL ids outstanding at once —
        allocated at submit and live until the waiter READS the status, so
        pipelined clients contribute threads x verb_keys x inflight_depth
        even after the driver completed their slots. 0 = legacy sizing
        ((queue_cap*num_queues + batch) * 2), which is only safe for
        synchronous clients. An undersized table silently wedges waiters
        whose slot a newer id overwrote (see pm_create2 in runtime.cpp)."""
        if queue_cap & (queue_cap - 1):
            raise ValueError("queue_cap must be a power of two")
        self._lib = get_lib()
        self._h = self._lib.pm_create2(
            num_queues, queue_cap, batch, timeout_us, arena_pages,
            page_bytes, comp_slots
        )
        if not self._h:
            raise MemoryError("pm_create failed")
        self.num_queues = num_queues
        self.batch = batch
        self.timeout_us = timeout_us
        self.arena_pages = arena_pages
        self.page_words = page_bytes // 4
        # The arena buffer is PYTHON-owned (numpy allocation) and adopted by
        # the native engine: teardown then never frees page memory under an
        # in-flight client's numpy view — any view into the arena keeps the
        # allocation alive through numpy's base-chain refcounting.
        self._arena_buf = np.zeros(arena_pages * page_bytes, np.uint8)
        self._lib.pm_set_arena(
            self._h,
            self._arena_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        self.arena = self._arena_buf.view(np.uint32).reshape(
            arena_pages, self.page_words
        )
        self._slice_cursor = 0
        # Host-side call gate: close() must not free the native engine while
        # a thread is INSIDE a ctypes call (the native Gate alone cannot
        # stop a caller that read the handle before `closing` was set).
        # Every native entry runs under _entered(); close() flips _closing,
        # calls pm_close (native spin loops bail promptly, so even waiters
        # parked on long timeouts drain in microseconds), waits for the
        # call count to hit zero, then destroys.
        # guarded-by: _calls, _closing
        self._call_lock = san.lock("Engine._call_lock")
        self._calls = 0
        self._closing = False
        # guarded-by: _slice_free, _slice_quar, _slice_cursor
        self._slice_lock = san.lock("Engine._slice_lock")
        self._slice_free: list[tuple[int, int]] = []  # returned slices
        # quarantined slices: freed by a backend torn down after a
        # transport failure, so in-flight requests may still reference
        # them. Reclaimed only when the engine is fully drained
        # (submitted == completed ⇒ no request anywhere can touch them).
        self._slice_quar: list[tuple[int, int]] = []

    def alloc_arena_slice(self, n_pages: int) -> tuple[int, int]:
        """Hand out a disjoint [lo, hi) arena slice (per-client staging
        region, `server/rdma_svr.cpp:873-886` discipline). Pair with
        `free_arena_slice` (or close the owning backend) — slices are a
        finite resource."""
        with self._slice_lock:
            for attempt in range(2):
                for i, (lo, hi) in enumerate(self._slice_free):
                    if hi - lo >= n_pages:  # first fit from returned slices
                        self._slice_free.pop(i)
                        if hi - lo > n_pages:
                            self._slice_free.append((lo + n_pages, hi))
                        return lo, lo + n_pages
                lo = self._slice_cursor
                hi = lo + n_pages
                if hi <= self.arena_pages:
                    self._slice_cursor = hi
                    return lo, hi
                # exhausted: reclaim quarantined slices iff drained
                if attempt == 0 and self._slice_quar and self._drained():
                    self._slice_free.extend(self._slice_quar)
                    self._slice_quar.clear()
                    continue
                raise MemoryError(
                    f"arena exhausted: want {n_pages}, "
                    f"have {self.arena_pages - self._slice_cursor} "
                    f"unreserved "
                    f"(+{sum(h - l for l, h in self._slice_free)} in "
                    f"returned fragments, "
                    f"+{sum(h - l for l, h in self._slice_quar)} "
                    f"quarantined)"
                )

    def _drained(self) -> bool:
        s = self.stats()
        return s["submitted"] == s["completed"]

    def free_arena_slice(self, lo: int, hi: int) -> None:
        with self._slice_lock:
            self._slice_free.append((lo, hi))

    def quarantine_arena_slice(self, lo: int, hi: int) -> None:
        """Return a slice that in-flight requests may still reference; it
        becomes allocatable again only once the engine drains."""
        with self._slice_lock:
            self._slice_quar.append((lo, hi))

    def close(self) -> None:
        """Free the native engine, draining in-flight calls first.

        Safe under client fire: threads mid-call are drained (the native
        stop sign makes their spin loops return failure codes promptly),
        later calls raise. The arena buffer itself is numpy-owned, so any
        in-flight view keeps the page memory alive regardless.
        """
        with self._call_lock:
            if self._closing or not self._h:
                self._closing = True
                return
            self._closing = True
        self._lib.pm_close(self._h)  # native spin loops bail from here on
        while True:
            with self._call_lock:
                if self._calls == 0:
                    break
            time.sleep(0.0002)
        self._lib.pm_destroy(self._h)
        self._h = None
        self.arena = None

    class _Entered:
        def __init__(self, eng):
            self._eng = eng

        def __enter__(self):
            eng = self._eng
            with eng._call_lock:
                if eng._closing or not eng._h:
                    raise RuntimeError("engine is closed")
                eng._calls += 1
            return eng._h

        def __exit__(self, *exc):
            with self._eng._call_lock:
                self._eng._calls -= 1

    def _entered(self) -> "Engine._Entered":
        return Engine._Entered(self)

    # -- client side --
    def submit(self, queue: int, op: int, khi: int, klo: int,
               page_off: int = 0, timeout_us: int = 10_000_000) -> int:
        with self._entered() as h:
            rid = self._lib.pm_submit(
                h, queue, op, khi, klo, page_off, timeout_us
            )
        if rid == 0:
            raise TimeoutError("submission queue full (driver stalled?)")
        return rid

    def submit_batch(self, queue: int, op: int, keys: np.ndarray,
                     page_off: np.ndarray | None = None,
                     timeout_us: int = 10_000_000) -> int:
        """Submit keys[B, 2] (+ optional page offsets) as ONE native call.

        Returns the base request id; ids are contiguous [base, base+B).
        Raises if the queue stayed full past the timeout for any tail
        (backpressure must not become silent loss).
        """
        keys = np.ascontiguousarray(keys, np.uint32)
        n = len(keys)
        khi = np.ascontiguousarray(keys[:, 0])
        klo = np.ascontiguousarray(keys[:, 1])
        off = (np.ascontiguousarray(page_off, np.uint32)
               if page_off is not None else np.zeros(n, np.uint32))
        base = ctypes.c_uint64()
        pu32 = ctypes.POINTER(ctypes.c_uint32)
        with self._entered() as h:
            sub = self._lib.pm_submit_batch(
                h, queue, op,
                khi.ctypes.data_as(pu32), klo.ctypes.data_as(pu32),
                off.ctypes.data_as(pu32), n, timeout_us, ctypes.byref(base)
            )
        if sub != n:
            raise TimeoutError(
                f"submitted {sub}/{n}: queue full (driver stalled?)"
            )
        return base.value

    def wait_many(self, base_id: int, n: int,
                  timeout_us: int = 10_000_000) -> np.ndarray:
        """Wait for n contiguous-id completions; returns status[n] int32.

        Raises on timeout (some slot still INT32_MIN)."""
        status = np.empty(n, np.int32)
        with self._entered() as h:
            done = self._lib.pm_wait_many(
                h, base_id, n,
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                timeout_us
            )
        if done != n:
            raise TimeoutError(f"completed {done}/{n} before timeout")
        return status

    def wait(self, req_id: int, timeout_us: int = 10_000_000) -> int:
        """Block until completed; returns status (>=0 ok/hit, -1 miss),
        raises on timeout."""
        with self._entered() as h:
            st = self._lib.pm_wait(h, req_id, timeout_us)
        if st == -(2**31):
            raise TimeoutError(f"request {req_id} timed out")
        return st

    # -- driver side --
    def pop_batch(self, max_n: int | None = None,
                  timeout_us: int | None = None) -> np.ndarray:
        max_n = max_n or self.batch
        timeout_us = self.timeout_us if timeout_us is None else timeout_us
        out = np.empty(max_n, REQ_DTYPE)
        with self._entered() as h:
            n = self._lib.pm_pop_batch(
                h, out.ctypes.data, max_n, timeout_us
            )
        return out[:n]

    def complete(self, req_ids: np.ndarray, status: np.ndarray) -> None:
        req_ids = np.ascontiguousarray(req_ids, np.uint64)
        status = np.ascontiguousarray(status, np.int32)
        with self._entered() as h:
            self._lib.pm_complete(
                h, req_ids.ctypes.data, status.ctypes.data, len(req_ids)
            )

    def stats(self) -> dict:
        out = np.zeros(4, np.uint64)
        with self._entered() as h:
            self._lib.pm_stats(h, out.ctypes.data)
        return dict(zip(["submitted", "completed", "batches", "flushes"],
                        (int(x) for x in out)))
