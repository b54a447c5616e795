"""Client transport backends (twin of `pmdfc_tpu/client/backends.py`).

The reference client stack swaps transports underneath a fixed put/get
surface (`client/rdpma.h:136-139`: two-sided RDMA, one-sided, kernel TCP,
and a no-network dram-backend for testing). The port mirrors that with a
small Backend protocol:

- `EngineBackend` — the serving path: requests ride the native coalescing
  engine (`native/runtime.cpp`) into the `KVServer` driver loop.
- `DirectBackend` — in-process calls straight into a `kv.KV` (no engine):
  the functional equivalent of linking client and server into one process.
- `LocalBackend` — the `client/dram-backend/` analog: a host-memory dict,
  no device, no server; lets the whole client stack run hermetically.
- `IntegrityBackend` — a wrapper adding CLIENT-side end-to-end page
  verification: digest at put, verify at get, mismatch → legal miss.

All backends speak batched numpy: `put(keys[B,2], pages[B,W])`,
`get(keys[B,2]) -> (pages[B,W], found[B])`, `invalidate(keys[B,2])`.
"""

from __future__ import annotations

import collections

import numpy as np

from pmdfc_tpu_torch.ops.pagepool import page_digest_np
from pmdfc_tpu_torch.runtime import sanitizer as san
from pmdfc_tpu_torch.runtime import telemetry as tele
from pmdfc_tpu_torch.runtime.engine import (
    OP_DEL, OP_GET, OP_GET_EXT, OP_INS_EXT, OP_PUT)


class LocalBackend:
    """Host-dict clean cache (`client/dram-backend/pmdfc.c:26-80` analog):
    bounded, FIFO-dropping, miss-is-legal."""

    def __init__(self, page_words: int = 1024, capacity: int = 1 << 16):
        self.page_words = page_words
        self.capacity = capacity
        self._store: dict[tuple[int, int], np.ndarray] = {}
        # extent records: (khi, base, vhi, vlo, length), newest-wins
        self._extents: list[tuple] = []
        # concurrent clients share one backend; the FIFO drop is a
        # read-modify-write
        # guarded-by: _store, _extents
        self._lock = san.lock("LocalBackend._lock")

    _INVALID = (0xFFFFFFFF, 0xFFFFFFFF)

    def put(self, keys: np.ndarray, pages: np.ndarray) -> None:
        with self._lock:
            for k, p in zip(keys, pages):
                kk = (int(k[0]), int(k[1]))
                if kk == self._INVALID:
                    # the reserved empty-slot sentinel places nothing (KV
                    # parity)
                    continue
                if kk not in self._store \
                        and len(self._store) >= self.capacity:
                    self._store.pop(next(iter(self._store)))  # FIFO drop
                self._store[kk] = p.copy()

    def get(self, keys: np.ndarray):
        out = np.zeros((len(keys), self.page_words), np.uint32)
        found = np.zeros(len(keys), bool)
        with self._lock:
            for i, k in enumerate(keys):
                p = self._store.get((int(k[0]), int(k[1])))
                if p is not None:
                    out[i] = p
                    found[i] = True
        return out, found

    def invalidate(self, keys: np.ndarray) -> np.ndarray:
        hit = np.zeros(len(keys), bool)
        with self._lock:
            for i, k in enumerate(keys):
                hit[i] = self._store.pop(
                    (int(k[0]), int(k[1])), None) is not None
        return hit

    def insert_extent(self, key, value, length: int) -> int:
        """Loopback extent registration: newest covering record wins on
        resolution (adequate for disjoint test runs). Extent records don't
        consume page capacity, mirroring the real KV's separate ring."""
        with self._lock:
            k = np.asarray(key, np.uint32)
            v = np.asarray(value, np.uint32)
            self._extents.append(
                (int(k[0]), int(k[1]), int(v[0]), int(v[1]), int(length)))
        return 0

    def get_extent(self, keys: np.ndarray):
        keys = np.asarray(keys, np.uint32)
        vals = np.zeros((len(keys), 2), np.uint32)
        found = np.zeros(len(keys), bool)
        with self._lock:
            recs = list(reversed(self._extents))
        for i, k in enumerate(keys):
            khi, klo = int(k[0]), int(k[1])
            for rhi, rbase, vhi, vlo, rlen in recs:
                if rhi == khi and rbase <= klo < rbase + rlen:
                    v64 = ((vhi << 32) | vlo) + (klo - rbase) * 4096
                    vals[i] = [(v64 >> 32) & 0xFFFFFFFF, v64 & 0xFFFFFFFF]
                    found[i] = True
                    break
        return vals, found

    def packed_bloom(self) -> np.ndarray | None:
        return None

    def stats(self) -> dict:
        with self._lock:
            return {"stored": len(self._store), "extents": len(self._extents)}


class IntegrityBackend:
    """End-to-end page verification wrapped around ANY backend.

    The server's pool digests prove bytes at rest; this wrapper closes the
    gap between this client's put() call and its get() return by
    remembering a host-side digest of every page it put (`page_digest_np`,
    bit-identical to the device digest) and verifying returned pages
    against it. A mismatch degrades to a first-class miss and bumps
    `corrupt_pages`; a page this client never put (no digest on record)
    passes through unverified — clean-cache peers may legitimately serve
    pages another client wrote.

    The digest is recorded only after the underlying put RETURNS: a put
    that raises is never recorded (its pages may not have landed). The
    digest map is bounded (`digest_cap`, FIFO): an evicted digest only
    downgrades verification to pass-through for that key, never a false
    corruption verdict.
    """

    def __init__(self, backend, digest_cap: int = 1 << 20):
        self._be = backend
        self.page_words = backend.page_words
        self.digest_cap = digest_cap
        self._digests: collections.OrderedDict = collections.OrderedDict()
        # guarded-by: _digests, counters
        self._lock = san.lock("IntegrityBackend._lock")
        # registry-backed; `counters` keeps the direct mapping reads
        # (`be.counters["corrupt_pages"]`) the drills assert on
        self.counters = tele.scope("integrity", {
            "corrupt_pages": 0, "verified_gets": 0})

    def put(self, keys: np.ndarray, pages: np.ndarray) -> None:
        digs = page_digest_np(pages)
        self._be.put(keys, pages)  # raises ⇒ nothing recorded
        with self._lock:
            for k, d in zip(np.asarray(keys, np.uint32), digs):
                kk = (int(k[0]), int(k[1]))
                self._digests.pop(kk, None)
                self._digests[kk] = int(d)
            while len(self._digests) > self.digest_cap:
                self._digests.popitem(last=False)

    def get(self, keys: np.ndarray):
        out, found = self._be.get(keys)
        if not found.any():
            return out, found
        digs = page_digest_np(out)
        found = np.array(found, bool, copy=True)
        corrupt = []
        with self._lock:
            for i, k in enumerate(np.asarray(keys, np.uint32)):
                if not found[i]:
                    continue
                want = self._digests.get((int(k[0]), int(k[1])))
                if want is None:
                    continue  # not our put: pass through unverified
                self.counters.inc("verified_gets")
                if int(digs[i]) != want:
                    self.counters.inc("corrupt_pages")
                    corrupt.append([int(k[0]), int(k[1])])
                    found[i] = False
                    if not out.flags.writeable:
                        out = out.copy()
                    out[i] = 0
        # rungs fire OUTSIDE the lock: a flight dump is file IO, and
        # concurrent ops must not stall behind it
        for kk in corrupt:
            tele.rung("digest_mismatch", source="integrity_backend",
                      key=kk)
        return out, found

    def invalidate(self, keys: np.ndarray) -> np.ndarray:
        with self._lock:
            for k in np.asarray(keys, np.uint32):
                self._digests.pop((int(k[0]), int(k[1])), None)
        return self._be.invalidate(keys)

    def insert_extent(self, key, value, length: int) -> int:
        return self._be.insert_extent(key, value, length)

    def get_extent(self, keys: np.ndarray):
        return self._be.get_extent(keys)

    def packed_bloom(self):
        return self._be.packed_bloom()

    def stats(self) -> dict:
        """The wrapped backend's stats plus this wrapper's verification
        counters under the `integrity.` namespace (a collision with a key
        of the wrapped backend raises: the client-side count must never
        shadow the server's)."""
        fn = getattr(self._be, "stats", None)
        out = dict(fn()) if fn is not None else {}
        for k, v in self.counters.items():
            nk = f"integrity.{k}"
            if nk in out:
                raise ValueError(
                    f"stats key collision: {nk!r} already reported by "
                    f"the wrapped backend")
            out[nk] = v
        return out

    def close(self) -> None:
        if hasattr(self._be, "close"):
            self._be.close()

    def __getattr__(self, name):
        # forward the rest (abandon, bloom_pull_t_snap, client_id, ...)
        return getattr(self._be, name)


class DirectBackend:
    """Straight into a `kv.KV` instance (device index, no transport)."""

    def __init__(self, kv):
        self.kv = kv
        self.page_words = kv.config.page_words
        # the KV's device: a serving thread that drives this backend
        # enters it (`runtime/net.py`)
        self.device = kv.device

    def put(self, keys: np.ndarray, pages: np.ndarray) -> None:
        self.kv.insert(keys, pages)

    def get(self, keys: np.ndarray):
        return self.kv.get(keys)

    def invalidate(self, keys: np.ndarray) -> np.ndarray:
        return self.kv.delete(keys)

    def insert_extent(self, key, value, length: int) -> int:
        _, uncovered = self.kv.insert_extent(key, value, length)
        return uncovered

    def get_extent(self, keys: np.ndarray):
        return self.kv.get_extent(keys)

    def packed_bloom(self) -> np.ndarray | None:
        return self.kv.packed_bloom()

    def stats(self) -> dict:
        """KV counter snapshot (with the tier counters when tiered) plus
        `capacity`, the serving surface's working-set yardstick."""
        return dict(self.kv.stats(), capacity=self.kv.capacity())

    # -- one-sided fast-path surface (NetServer's reader-side lane) --

    def fast_view(self):
        return self.kv.fast_view()

    def directory_snapshot(self, max_entries: int = 1 << 20):
        return self.kv.directory_snapshot(max_entries=max_entries)

    def bump_dir_epoch(self) -> int:
        return self.kv.bump_dir_epoch()

    # balloon surface (no-ops/None on a flat pool)
    def balloon_state(self) -> dict | None:
        return self.kv.balloon_state()

    def balloon_grow(self, rows: int) -> bool:
        return self.kv.balloon_grow(rows)

    def balloon_shrink(self, rows: int) -> bool:
        return self.kv.balloon_shrink(rows)

    # admission surface (None/False when the pool is flat or ungated)
    def admit_state(self) -> dict | None:
        return self.kv.admit_state()

    def set_admit_threshold(self, value: int) -> bool:
        return self.kv.set_admit_threshold(value)

    # QoS shed and deadline-shed attribution: shed page counts land in
    # the KV's host stats overlay so `misses == Σ causes` stays exact
    def account_shed(self, gets: int, puts: int = 0) -> None:
        self.kv.account_shed(gets, puts)

    def account_deadline(self, gets: int, puts: int = 0) -> None:
        self.kv.account_deadline(gets, puts)

    # warm-restart surface (MSG_RECOVERY on the wire)
    def recovery_info(self) -> dict:
        fn = getattr(self.kv, "recovery_info", None)
        return fn() if fn is not None else {"recovering": False}

    def mark_recovered(self) -> bool:
        fn = getattr(self.kv, "mark_recovered", None)
        return bool(fn()) if fn is not None else False


class EngineBackend:
    """Through the native coalescing engine into a running KVServer.

    Pages stage through a slice of the engine arena owned by this client
    (the registered-MR region discipline, `server/rdma_svr.cpp:873-886`).
    """

    def __init__(self, server, queue: int = 0, arena_lo: int | None = None,
                 arena_hi: int | None = None, slice_pages: int | None = None,
                 timeout_us: int = 10_000_000):
        self.server = server
        self.engine = server.engine
        self.queue = queue
        self.timeout_us = timeout_us
        self._owns_slice = arena_lo is None
        if arena_lo is None:
            # A disjoint staging slice per client (default: an eighth of
            # the arena) — two clients must never clobber each other. The
            # slice width caps one verb; a bigger batch splits into
            # back-to-back verbs. close() returns the slice.
            want = slice_pages or max(1, self.engine.arena_pages // 8)
            self.arena_lo, self.arena_hi = self.engine.alloc_arena_slice(
                want)
        else:
            # a caller-chosen slice [arena_lo, arena_hi) (default: to the
            # arena's end): the caller keeps it disjoint from every other
            # client's, and close() leaves it to the caller
            self.arena_lo = arena_lo
            self.arena_hi = arena_hi or self.engine.arena_pages
        self.page_words = self.engine.page_words
        self.device = server.kv.device

    def close(self) -> None:
        if self._owns_slice:
            self.engine.free_arena_slice(self.arena_lo, self.arena_hi)
            self._owns_slice = False

    def __enter__(self) -> "EngineBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def abandon(self) -> None:
        """Tear down via QUARANTINE instead of the free list: requests this
        backend submitted may still be queued, and a late completion
        writes into its staging slice, so the slice becomes allocatable
        again only once the engine drains."""
        if self._owns_slice:
            try:
                self.engine.quarantine_arena_slice(self.arena_lo, self.arena_hi)
            except Exception:  # noqa: BLE001 — engine may already be freed
                pass
            self._owns_slice = False

    def _slots(self, n: int) -> np.ndarray:
        if self.engine.arena is None:
            raise RuntimeError("engine is closed")
        width = self.arena_hi - self.arena_lo
        if n > width:
            raise ValueError(f"batch {n} exceeds arena slice {width}")
        return np.arange(self.arena_lo, self.arena_lo + n)

    def _chunks(self, n: int):
        """(lo, hi) verb windows bounded by the staging slice — the move
        the reference client makes at BATCH_SIZE=4 pages/verb
        (`client/rdpma.c:307-320`), at slice depth."""
        width = self.arena_hi - self.arena_lo
        for lo in range(0, n, width):
            yield lo, min(lo + width, n)

    def put(self, keys: np.ndarray, pages: np.ndarray) -> None:
        for lo, hi in self._chunks(len(keys)):
            slots = self._slots(hi - lo)
            self.engine.arena[slots] = pages[lo:hi]
            base = self.engine.submit_batch(
                self.queue, OP_PUT, keys[lo:hi], slots.astype(np.uint32),
                timeout_us=self.timeout_us,
            )
            self.engine.wait_many(base, hi - lo, timeout_us=self.timeout_us)

    def get(self, keys: np.ndarray):
        n = len(keys)
        out = np.zeros((n, self.page_words), np.uint32)
        found = np.zeros(n, bool)
        for lo, hi in self._chunks(n):
            slots = self._slots(hi - lo)
            base = self.engine.submit_batch(
                self.queue, OP_GET, keys[lo:hi], slots.astype(np.uint32),
                timeout_us=self.timeout_us,
            )
            status = self.engine.wait_many(base, hi - lo,
                                           timeout_us=self.timeout_us)
            hit = status == 0
            # gather ONLY the hit rows out of the arena (miss rows of the
            # zeroed `out` are never touched)
            if hit.any():
                out[lo:hi][hit] = self.engine.arena[slots[hit]]
            found[lo:hi] = hit
        return out, found

    def invalidate(self, keys: np.ndarray) -> np.ndarray:
        base = self.engine.submit_batch(self.queue, OP_DEL, keys,
                                        timeout_us=self.timeout_us)
        return self.engine.wait_many(base, len(keys),
                                     timeout_us=self.timeout_us) == 0

    # -- extent verbs: range requests cross the transport too --

    def insert_extent(self, key, value, length: int) -> int:
        """Register the extent [key, key+length) as ONE verb: stages
        [val_hi, val_lo, length] in this client's arena slice and waits.
        Returns the UNCOVERED tail length the server reported (0 = fully
        indexed). Raises on a server-side failure (-2 status)."""
        if self.page_words < 3:
            raise ValueError("extent verbs need page_words >= 3 to stage "
                             "[val_hi, val_lo, length]")
        key = np.asarray(key, np.uint32).reshape(1, 2)
        slots = self._slots(1)
        staged = np.zeros(self.page_words, np.uint32)
        staged[0:2] = np.asarray(value, np.uint32)
        staged[2] = length
        self.engine.arena[slots[0]] = staged
        base = self.engine.submit_batch(
            self.queue, OP_INS_EXT, key, slots.astype(np.uint32),
            timeout_us=self.timeout_us,
        )
        status = int(self.engine.wait_many(
            base, 1, timeout_us=self.timeout_us)[0])
        if status < 0:
            raise RuntimeError(f"insert_extent failed (status {status})")
        return status

    def get_extent(self, keys: np.ndarray):
        """Batched cover resolution -> (values[B, 2], found[B]); each
        request's resolved value comes back through its arena slot."""
        keys = np.asarray(keys, np.uint32)
        n = len(keys)
        out = np.zeros((n, 2), np.uint32)
        found = np.zeros(n, bool)
        for lo, hi in self._chunks(n):
            slots = self._slots(hi - lo)
            base = self.engine.submit_batch(
                self.queue, OP_GET_EXT, keys[lo:hi],
                slots.astype(np.uint32), timeout_us=self.timeout_us,
            )
            status = self.engine.wait_many(base, hi - lo,
                                           timeout_us=self.timeout_us)
            hit = status == 0
            if hit.any():
                out[lo:hi][hit] = self.engine.arena[slots[hit], :2]
            found[lo:hi] = hit
        return out, found

    def packed_bloom(self) -> np.ndarray | None:
        return self.server.kv.packed_bloom()

    def stats(self) -> dict:
        """Server-side KV counters plus table capacity (the serving-surface
        convention, see `DirectBackend.stats`)."""
        return dict(self.server.kv.stats(),
                    capacity=self.server.kv.capacity())

    # -- one-sided fast-path surface (NetServer's reader-side lane): the
    # engine stages VERB batches, but a fast read bypasses staging, so it
    # goes straight at the server's KV --

    def fast_view(self):
        return self.server.kv.fast_view()

    def directory_snapshot(self, max_entries: int = 1 << 20):
        return self.server.kv.directory_snapshot(max_entries=max_entries)

    def bump_dir_epoch(self) -> int:
        return self.server.kv.bump_dir_epoch()

    # QoS shed and deadline-shed attribution (the DirectBackend contract)
    def account_shed(self, gets: int, puts: int = 0) -> None:
        self.server.kv.account_shed(gets, puts)

    def account_deadline(self, gets: int, puts: int = 0) -> None:
        self.server.kv.account_deadline(gets, puts)

    # balloon and admission surfaces, forwarded to the server's KV
    def balloon_state(self) -> dict | None:
        return self.server.kv.balloon_state()

    def balloon_grow(self, rows: int) -> bool:
        return self.server.kv.balloon_grow(rows)

    def balloon_shrink(self, rows: int) -> bool:
        return self.server.kv.balloon_shrink(rows)

    def admit_state(self) -> dict | None:
        return self.server.kv.admit_state()

    def set_admit_threshold(self, value: int) -> bool:
        return self.server.kv.set_admit_threshold(value)
