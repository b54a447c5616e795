"""Clean-cache client — the `client/julee.c` kernel hooks as a library (twin
of `pmdfc_tpu/client/cleancache.py`).

Reference behavior being mirrored:
- `get_longkey(oid, index) = oid << 32 | index` (`client/julee.c:64-70`);
- `put_page` adds the key to the CLIENT bloom filter then ships the page
  (`client/rdpma.c:295-305`);
- `get_page` consults the client bloom mirror first — a "not present" answer
  short-circuits the miss with NO network round trip (`client/rdpma.c:
  1050-1061`), and a real miss returns -1 (legal);
- the server pushes its packed filter to the client periodically
  (`send_bf`, `server/rdma_svr.cpp:157-251`; `KVServer.push_bloom_now`
  calls `receive_bloom_full/blocks` here); `refresh_bloom()` pulls the
  packed form, and local put bits overlay it between refreshes;
- debugfs counters `{total,actual,miss,hit}_gets, drop_puts`
  (`client/julee.c:314-322`) are the `counters` dict.

The module is numpy-only: the client never touches the device.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from pmdfc_tpu_torch.config import qos_enabled
from pmdfc_tpu_torch.utils.hashing_np import add_packed_np, query_packed_np


def get_longkey(oid: int, index: int) -> tuple[int, int]:
    """(hi, lo) = inode object id << 32 | page index (`client/julee.c:64`)."""
    return (oid & 0xFFFFFFFF, index & 0xFFFFFFFF)


class CleanCacheClient:
    def __init__(self, backend, num_hashes: int = 4,
                 bloom_refresh_s: float | None = None,
                 tenant: int = 0, tenant_bits: int = 4):
        # function-local import: the sanitizer lives in the runtime
        # package, whose __init__ imports the server and the KV
        from pmdfc_tpu_torch.runtime import sanitizer as san

        self.backend = backend
        self.num_hashes = num_hashes
        # QoS namespace tagging at the client edge: a nonzero tenant id is
        # stamped into the top `tenant_bits` bits of every oid this client
        # sends. PMDFC_QOS=off (or tenant 0, the default) keeps every key
        # bit-preserved. Bloom/overlay bookkeeping happens on the TAGGED
        # keys, so the mirror stays consistent with what the server stores.
        if not (1 <= tenant_bits <= 16):
            raise ValueError("tenant_bits must be in [1, 16]")
        if not (0 <= tenant < (1 << tenant_bits)):
            raise ValueError(
                f"tenant {tenant} does not fit in {tenant_bits} bits")
        self._tenant = int(tenant) if qos_enabled() else 0
        self._tenant_bits = int(tenant_bits)
        self._bloom: np.ndarray | None = None
        # guarded-by: _bloom, _overlay, _last_t_snap
        self._bloom_lock = san.lock("CleanCacheClient._bloom_lock")
        # Put overlay with completion stamps — the no-false-negative
        # protocol. A filter snapshot only reliably contains puts whose
        # server-side insert COMPLETED before the snapshot was taken, and
        # pushes can be delivered after newer state existed. So every
        # local put keeps an overlay entry `key -> completion time` (+inf
        # while in flight); every incoming snapshot re-applies ALL overlay
        # bits, then retires only entries completed BEFORE that snapshot's
        # start stamp. False positives from re-adding are always legal;
        # false negatives never are. Capacity-bounded FIFO.
        self._overlay: dict[tuple[int, int], float] = {}
        self._overlay_cap = 1 << 16
        # counters are bumped from concurrent client threads
        # guarded-by: counters
        self._ctr_lock = san.lock("CleanCacheClient._ctr_lock")
        self._last_t_snap = float("-inf")  # newest snapshot stamp applied
        self.counters = {
            "total_gets": 0, "actual_gets": 0, "hit_gets": 0,
            "miss_gets": 0, "bf_short_circuits": 0, "puts": 0,
            "drop_puts": 0, "invalidates": 0, "bf_refreshes": 0,
            "bf_pushes": 0, "bf_blocks_received": 0,
            # miss-cause split of miss_gets (`miss_gets == bloom_negative
            # + remote` always): the mirror short-circuited with no RTT vs
            # the server was asked and missed
            "miss_bloom_negative": 0, "miss_remote": 0,
        }
        self.refresh_bloom()
        self._refresher: threading.Thread | None = None
        self._stop = threading.Event()
        if bloom_refresh_s:
            self._refresher = threading.Thread(
                target=self._refresh_loop, args=(bloom_refresh_s,),
                daemon=True, name="bf-refresh",
            )
            self._refresher.start()

    def _bump(self, key: str, n) -> None:
        with self._ctr_lock:
            self.counters[key] += int(n)

    def _tag(self, oids) -> np.ndarray:
        """Stamp this client's tenant id into the oid top bits. Tenant 0
        is the identity: untagged IS the default tenant."""
        oids = np.asarray(oids, np.uint32)
        if not self._tenant:
            return oids
        shift = 32 - self._tenant_bits
        low = np.uint32((1 << shift) - 1)
        return ((oids & low)
                | np.uint32(self._tenant << shift)).astype(np.uint32)

    def _keys(self, oids, indexes) -> np.ndarray:
        return np.stack(
            [self._tag(oids), np.asarray(indexes, np.uint32)], axis=-1)

    def close(self) -> None:
        """Stop and JOIN the background refresher. Idempotent; the
        context-manager exit calls it."""
        self._stop.set()
        if self._refresher:
            self._refresher.join(timeout=5)
            if self._refresher.is_alive():
                # the join timed out (a refresh stuck in a slow pull):
                # keep the handle so a later close() can re-join
                return
            self._refresher = None

    def __enter__(self) -> "CleanCacheClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _refresh_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.refresh_bloom()
            # the directory mirror (one-sided fast path) rides the same
            # lifecycle: one thread, one stop event, one join in close()
            fn = getattr(self.backend, "dir_refresh", None)
            if fn is not None:
                try:
                    fn()
                except (ConnectionError, OSError):
                    pass  # backend down: the verb/degrade path handles it
            # a replica-group backend without its own repair thread gets
            # its repair and migration ticks on this refresh cadence
            fn = getattr(self.backend, "repair_tick", None)
            if fn is not None:
                try:
                    fn()
                except Exception:  # noqa: BLE001 — ticks are best-effort
                    pass

    def refresh_bloom(self) -> None:
        """Pull the server's packed filter (client-initiated fallback; the
        server-push path is `receive_bloom_full/blocks` below)."""
        t_snap = time.monotonic()  # every put completed by now is included
        packed = self.backend.packed_bloom()
        if hasattr(self.backend, "bloom_pull_t_snap"):
            # remote backend: the server echoed OUR applied-put stamp for
            # this snapshot. Stamps stay in ONE domain: local 'now' (always
            # ahead of any put SEND stamp) would mark every later push
            # frame stale and freeze the push path. None (no put applied
            # yet) = unstamped: applies, retires nothing.
            t_snap = self.backend.bloom_pull_t_snap
        elif packed is None:
            # no filter came back (backend down, or bloom disabled):
            # nothing to retire against, and advancing the local stamp
            # would stale-freeze later push frames
            t_snap = None
        with self._bloom_lock:
            if self._snap_is_stale_locked(t_snap):
                return
            self._bloom = None if packed is None else packed.copy()
            self._reapply_overlay_locked(t_snap)
        self._bump("bf_refreshes", 1)

    def _reapply_overlay_locked(self, t_snap: float | None) -> None:
        """Re-add every overlay put bit, then retire entries the snapshot
        provably contains (completed before `t_snap`)."""
        if self._bloom is not None and self._overlay:
            recent = np.array(
                list(self._overlay.keys()), np.uint32
            ).reshape(-1, 2)
            add_packed_np(self._bloom, recent, self.num_hashes)
        if t_snap is not None:
            self._overlay = {
                k: t for k, t in self._overlay.items() if t >= t_snap
            }

    # -- server-push sinks (ref `send_bf` one-sided writes the packed bits
    # straight into the client's registered bitmap,
    # `server/rdma_svr.cpp:157-251`; deltas are 8 KB dirty blocks,
    # `counting_bloom_filter.h:101-107`) --

    def _snap_is_stale_locked(self, t_snap: float | None) -> bool:
        """Reject out-of-order snapshots: applying a snapshot OLDER than one
        already applied would clear bits of overlay entries the newer one
        legitimately retired — a false negative. Unstamped (None) snapshots
        apply but never retire overlay entries, so they are always safe."""
        if t_snap is not None and t_snap < self._last_t_snap:
            return True
        if t_snap is not None:
            self._last_t_snap = t_snap
        return False

    def receive_bloom_full(self, packed: np.ndarray,
                           t_snap: float | None = None) -> None:
        with self._bloom_lock:
            if self._snap_is_stale_locked(t_snap):
                return
            self._bloom = packed.copy()
            self._reapply_overlay_locked(t_snap)
        self._bump("bf_pushes", 1)

    def receive_bloom_blocks(self, block_idx: np.ndarray,
                             blocks: np.ndarray, words_per_block: int,
                             t_snap: float | None = None) -> None:
        """Apply a dirty-block delta push.

        Copy-on-write: `get_pages` queries a snapshot reference outside the
        lock, so patching the live array in place could expose a cleared
        overlay bit mid-update (a transient false negative). Only the new
        array ever mutates; the swap is atomic under the lock.
        """
        with self._bloom_lock:
            if self._bloom is None:
                # never saw a full filter: can't patch blocks into nothing
                return
            stale = self._snap_is_stale_locked(t_snap)
            fresh = self._bloom.copy()
            view = fresh.reshape(-1, words_per_block)
            idx = np.asarray(block_idx)
            if stale:
                # A delta that lost the race to a newer snapshot cannot be
                # dropped: the server already advanced its delta baseline
                # past this frame, so its SET bits would never be resent.
                # OR-merging applies the adds (false positives are legal)
                # while suppressing the clears and the overlay retirement.
                view[idx] |= blocks
                self._bloom = fresh
            else:
                view[idx] = blocks
                self._bloom = fresh
                self._reapply_overlay_locked(t_snap)
        self._bump("bf_pushes", 1)
        self._bump("bf_blocks_received", len(block_idx))

    # -- page ops (batched; single-page is a B=1 batch) --

    def put_pages(self, oids: np.ndarray, indexes: np.ndarray,
                  pages: np.ndarray) -> None:
        keys = self._keys(oids, indexes)
        kts = [(int(k[0]), int(k[1])) for k in keys]
        with self._bloom_lock:
            if self._bloom is not None:
                # local overlay so a put is visible before the next refresh
                add_packed_np(self._bloom, keys, self.num_hashes)
            for kt in kts:
                self._overlay[kt] = float("inf")  # in flight
            if len(self._overlay) > self._overlay_cap:
                # retire oldest COMPLETED entries only — an in-flight (+inf)
                # entry is the sole witness of its put until the insert
                # lands
                for kt in list(self._overlay):
                    if len(self._overlay) <= self._overlay_cap:
                        break
                    if self._overlay[kt] != float("inf"):
                        del self._overlay[kt]
        self.backend.put(keys, pages)
        t_done = time.monotonic()
        with self._bloom_lock:
            for kt in kts:
                if self._overlay.get(kt) == float("inf"):
                    self._overlay[kt] = t_done
        self._bump("puts", len(keys))

    def get_pages(self, oids: np.ndarray, indexes: np.ndarray):
        keys = self._keys(oids, indexes)
        n = len(keys)
        self._bump("total_gets", n)
        out = np.zeros((n, self.backend.page_words), np.uint32)
        found = np.zeros(n, bool)
        with self._bloom_lock:
            bloom = self._bloom
        if bloom is not None:
            maybe = query_packed_np(bloom, keys, self.num_hashes)
        else:
            maybe = np.ones(n, bool)
        n_bf = int((~maybe).sum())
        self._bump("bf_short_circuits", n_bf)
        if maybe.any():
            self._bump("actual_gets", int(maybe.sum()))
            got, ok = self.backend.get(keys[maybe])
            out[maybe] = got
            found[maybe] = ok
        hits = int(found.sum())
        self._bump("hit_gets", hits)
        self._bump("miss_gets", n - hits)
        # cause split: bloom-negative short-circuits never left the host;
        # every other miss was asked of the server and answered miss
        self._bump("miss_bloom_negative", n_bf)
        self._bump("miss_remote", n - hits - n_bf)
        return out, found

    def put_page(self, oid: int, index: int, page: np.ndarray) -> None:
        self.put_pages(np.array([oid]), np.array([index]), page[None])

    def get_page(self, oid: int, index: int) -> np.ndarray | None:
        out, found = self.get_pages(np.array([oid]), np.array([index]))
        return out[0] if found[0] else None

    def invalidate_pages(self, oids: np.ndarray,
                         indexes: np.ndarray) -> np.ndarray:
        keys = self._keys(oids, indexes)
        hit = self.backend.invalidate(keys)
        self._bump("invalidates", len(keys))
        return hit

    def stats(self) -> dict:
        with self._ctr_lock:
            return dict(self.counters)


class SwapClient:
    """Frontswap hooks (`client/juleeswap.c:15-38`): store/load keyed by
    (swap type, page offset) — thin wrappers, exactly like the reference."""

    SWAP_OID = 0xFFFF0000  # namespace separating swap from cleancache keys

    def __init__(self, backend, **kw):
        self._cc = CleanCacheClient(backend, **kw)

    def close(self) -> None:
        self._cc.close()

    def __enter__(self) -> "SwapClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def store(self, swap_type: int, offset: int, page: np.ndarray) -> None:
        self._cc.put_page(self.SWAP_OID | swap_type, offset, page)

    def store_batch(self, swap_type: int, offsets: np.ndarray,
                    pages: np.ndarray) -> None:
        """Batched store — the transport-level batching the reference gets
        from its 4-pages/verb fused sends (`client/rdpma.c:307-320`)."""
        oids = np.full(len(offsets), self.SWAP_OID | swap_type, np.uint32)
        self._cc.put_pages(oids, np.asarray(offsets, np.uint32), pages)

    def load(self, swap_type: int, offset: int) -> np.ndarray | None:
        return self._cc.get_page(self.SWAP_OID | swap_type, offset)

    def load_batch(self, swap_type: int, offsets: np.ndarray):
        """Batched load -> (pages, found)."""
        oids = np.full(len(offsets), self.SWAP_OID | swap_type, np.uint32)
        return self._cc.get_pages(oids, np.asarray(offsets, np.uint32))

    def invalidate(self, swap_type: int, offset: int) -> None:
        self._cc.invalidate_pages(
            np.array([self.SWAP_OID | swap_type]), np.array([offset])
        )

    def invalidate_batch(self, swap_type: int, offsets: np.ndarray) -> None:
        oids = np.full(len(offsets), self.SWAP_OID | swap_type, np.uint32)
        self._cc.invalidate_pages(oids, np.asarray(offsets, np.uint32))

    def stats(self) -> dict:
        return self._cc.stats()
