"""One-sided / passive-memory mode — the fastswap-style second operating
mode (twin of `pmdfc_tpu/onesided.py`).

Reference: `server/onesided/rdma_svr.cpp:22-103,178` — the server registers
ONE big memory region, sends `{baseaddr, rkey, size}` to each client, and
then touches NOTHING on the data path: no index, no pollers. The CLIENT owns
the `key → remote offset` mapping in a local hashtable
(`client/julee.c:103-120`) and moves pages with raw one-sided verbs
(`client/onesided/pmdfc_rdma.c:708-790`).

- `PassivePool` is the passive memory node: a page-row array with NO index,
  no bloom filter, no request loop. Its only ops are `write_rows` /
  `read_rows`, one batched scatter / gather each. Row ids are the "remote
  offsets". ``mode="hbm"`` keeps the pool in device memory (an int32 tensor
  of u32 bits on `device`: `cuda` unless the caller asks for the CPU),
  ``mode="host"`` keeps it in host numpy, and ``mode="tiered"`` keeps the
  region in host numpy behind a device mirror of its reuse-heavy rows.
- Region grants replace the MR handshake: `grant(n_rows)` hands a client a
  disjoint `[lo, hi)` row range.
- `OneSidedBackend` is the client: a host dict `key → row`, a free-row list
  over its grant, and clean-cache semantics — when the grant is exhausted
  the OLDEST local mapping is dropped and its row reused (a dropped page is
  a legal miss later).
- Persistence: `PassivePool.save/load` snapshot the raw region in the JAX
  package's file format (`pages` as uint32, `granted`), so a region saved
  by one package loads in the other.

A miss never touches the pool (the local map answers absence in 0 RTT).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from pmdfc_tpu_torch.utils import u32


def _rows_t(rows: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rows, np.int64)).to(device)


def _pages_t(batch: np.ndarray, device) -> torch.Tensor:
    """uint32 pages -> int32 (u32 bits) tensor on `device`."""
    a = np.ascontiguousarray(batch, np.uint32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


class PassivePool:
    """The passive memory node: rows of pages, raw row verbs, region grants.

    No index, no filter, no per-request server logic — the deliberate point
    of the mode (ref `server/onesided/rdma_svr.cpp:178`).
    """

    def __init__(self, num_rows: int, page_words: int = 1024,
                 mode: str = "hbm", hot_rows: int | None = None,
                 promote_touches: int = 2, device="cuda"):
        if mode not in ("hbm", "host", "tiered"):
            raise ValueError(f"unknown pool mode {mode!r}")
        self.num_rows = num_rows
        self.page_words = page_words
        self.mode = mode
        # the device of the device-resident part (hbm: the pool; tiered:
        # the hot mirror); None for a host pool
        self.device = None
        if mode != "host":
            from pmdfc_tpu_torch.kv import resolve_device

            self.device = resolve_device(device)
        if mode == "hbm":
            self.pages = torch.zeros((num_rows, page_words),
                                     dtype=torch.int32, device=self.device)
        else:
            # "host" and the tiered COLD region: host numpy
            self.pages = np.zeros((num_rows, page_words), np.uint32)
        self._granted = 0
        # observability only (the data path has no server logic)
        self.writes = 0
        self.reads = 0
        if mode == "tiered":
            # rows are client-addressed and cannot move, so the HOT tier is
            # a device MIRROR of the reuse-heavy rows over the host cold
            # region (write-through: the cold region stays authoritative,
            # so eviction is a dropped mirror slot, never a writeback).
            # Repeat-read rows promote at `promote_touches`; the LRU
            # mirror slot demotes.
            self.hot_rows = hot_rows or max(1, num_rows // 8)
            self.promote_touches = promote_touches
            self._hot = torch.zeros((self.hot_rows, page_words),
                                    dtype=torch.int32, device=self.device)
            self._hot_slot: dict[int, int] = {}   # row -> mirror slot
            self._hot_lru: dict[int, None] = {}   # row -> (ordered) recency
            self._hot_free = list(range(self.hot_rows - 1, -1, -1))
            self._touch = np.zeros(num_rows, np.uint32)
            self.tier_counters = {"hot_hits": 0, "promotions": 0,
                                  "demotions": 0}

    @property
    def granted_rows(self) -> int:
        """Rows handed out so far (`PoolServer` gauges it)."""
        return self._granted

    # -- MR-handshake analog --

    def grant(self, n_rows: int) -> tuple[int, int]:
        """Disjoint row range for one client; raises when exhausted."""
        lo = self._granted
        hi = lo + n_rows
        if hi > self.num_rows:
            raise ValueError(
                f"pool exhausted: want {n_rows} rows, "
                f"{self.num_rows - self._granted} left"
            )
        self._granted = hi
        return lo, hi

    # -- the one-sided verbs --

    def write_rows(self, rows: np.ndarray, batch: np.ndarray) -> None:
        """RDMA-WRITE analog: scatter batch[B, W] at the given rows; row
        −1 drops its write."""
        rows = np.asarray(rows, np.int32)
        b = len(rows)
        self.writes += b
        ok = rows >= 0
        batch = np.asarray(batch, np.uint32)[:b]
        if self.mode == "hbm":
            self.pages[_rows_t(rows[ok], self.device)] = _pages_t(
                batch[ok], self.device)
            return
        self.pages[rows[ok]] = batch[ok]
        if self.mode == "tiered":
            # fresh bytes, fresh reuse history
            self._touch[rows[ok]] = 0
            # write-through the hot mirror so a promoted row never serves
            # stale bytes
            mirrored = [i for i in range(b) if int(rows[i]) in self._hot_slot]
            if mirrored:
                slots = [self._hot_slot[int(rows[i])] for i in mirrored]
                self._hot[_rows_t(slots, self.device)] = _pages_t(
                    batch[mirrored], self.device)

    def _tier_promote(self, row: int) -> None:
        if self._hot_free:
            slot = self._hot_free.pop()
        else:
            victim = next(iter(self._hot_lru))  # LRU mirror slot
            del self._hot_lru[victim]
            slot = self._hot_slot.pop(victim)
            self.tier_counters["demotions"] += 1
        self._hot[slot] = _pages_t(self.pages[row], self.device)
        self._hot_slot[row] = slot
        self._hot_lru[row] = None
        self.tier_counters["promotions"] += 1

    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        """RDMA-READ analog: gather page rows; row −1 reads zeros."""
        rows = np.asarray(rows, np.int32)
        b = len(rows)
        self.reads += b
        if self.mode == "hbm":
            r = _rows_t(rows, self.device)
            out = torch.where((r >= 0)[:, None], self.pages[r.clamp(min=0)],
                              0)
            return u32.to_numpy(out)
        if self.mode == "tiered":
            out = np.zeros((b, self.page_words), np.uint32)
            hot_lanes = [i for i in range(b) if int(rows[i])
                         in self._hot_slot]
            cold_lanes = [i for i in range(b) if rows[i] >= 0
                          and int(rows[i]) not in self._hot_slot]
            if hot_lanes:
                slots = [self._hot_slot[int(rows[i])] for i in hot_lanes]
                out[hot_lanes] = u32.to_numpy(
                    self._hot[_rows_t(slots, self.device)])
                self.tier_counters["hot_hits"] += len(hot_lanes)
                for i in hot_lanes:  # refresh LRU recency
                    r = int(rows[i])
                    self._hot_lru.pop(r, None)
                    self._hot_lru[r] = None
            if cold_lanes:
                cl = rows[cold_lanes]
                out[cold_lanes] = self.pages[cl]
                # np.add.at: duplicate rows in one batch accumulate every
                # touch
                np.add.at(self._touch, cl, 1)
                for r in np.unique(cl):
                    if self._touch[r] >= self.promote_touches:
                        self._tier_promote(int(r))
                        self._touch[r] = 0
            return out
        out = self.pages[np.maximum(rows, 0)].copy()
        out[rows < 0] = 0
        return out

    # -- persistence (PMEM-file analog) --

    def _host_pages(self) -> np.ndarray:
        if self.mode == "hbm":
            return u32.to_numpy(self.pages)
        return np.asarray(self.pages)

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, pages=self._host_pages(),
                         granted=np.int64(self._granted))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self, path: str) -> None:
        with np.load(path) as z:
            pages = z["pages"]
            granted = int(z["granted"])
        if pages.shape != (self.num_rows, self.page_words):
            raise ValueError(
                f"snapshot shape {pages.shape} != pool "
                f"{(self.num_rows, self.page_words)}"
            )
        if self.mode == "hbm":
            self.pages = _pages_t(pages, self.device)
        else:
            self.pages = np.asarray(pages, np.uint32).copy()
        self._granted = granted
        if self.mode == "tiered":
            # the mirror caches the pre-load region — drop it (a cold
            # mirror is slow, a stale one is wrong)
            self._hot_slot.clear()
            self._hot_lru.clear()
            self._hot_free = list(range(self.hot_rows - 1, -1, -1))
            self._touch[:] = 0

    def stats(self) -> dict:
        d = {
            "reads": self.reads,
            "writes": self.writes,
            "granted_rows": self._granted,
            "num_rows": self.num_rows,
        }
        if self.mode == "tiered":
            d.update(self.tier_counters)
            d["hot_rows"] = self.hot_rows
            d["hot_mirrored"] = len(self._hot_slot)
        return d


class OneSidedBackend:
    """Client with a local key→row map over a granted row range.

    Speaks the same batched Backend protocol as the two-sided backends
    (`client/backends.py`), so `CleanCacheClient`/`SwapClient` ride it
    unchanged. `packed_bloom()` is None — the exact local map subsumes the
    bloom mirror (absence answered locally in 0 RTT).
    """

    def __init__(self, pool, slice_pages: int | None = None,
                 grant: tuple[int, int] | None = None):
        self.pool = pool
        self.page_words = pool.page_words
        if grant is None:
            want = slice_pages or max(1, pool.num_rows // 8)
            grant = pool.grant(want)
        self.grant_lo, self.grant_hi = grant
        # insertion-ordered: FIFO drop victim = first key (dict is ordered)
        self._map: dict[tuple[int, int], int] = {}
        self._free = list(range(self.grant_hi - 1, self.grant_lo - 1, -1))
        self.drops = 0
        self.puts = 0
        self.gets = 0
        self.hits = 0

    def _rows_for_put(self, keys: np.ndarray) -> np.ndarray:
        """Assign a row per key: existing mapping, free row, or FIFO-drop
        the oldest mapping and reuse its row (clean-cache legality)."""
        rows = np.empty(len(keys), np.int32)
        for i, k in enumerate(keys):
            kk = (int(k[0]), int(k[1]))
            row = self._map.get(kk)
            if row is None:
                if self._free:
                    row = self._free.pop()
                else:
                    victim, row = next(iter(self._map.items()))
                    del self._map[victim]
                    self.drops += 1
            else:
                # re-put refreshes recency-of-insertion (FIFO over puts)
                del self._map[kk]
            self._map[kk] = row
            rows[i] = row
        return rows

    def put(self, keys: np.ndarray, pages: np.ndarray) -> None:
        keys = np.asarray(keys, np.uint32)
        rows = self._rows_for_put(keys)
        self.puts += len(keys)
        # duplicate keys in one batch share a row: keep only the LAST write
        # per row (a same-row scatter pair has an undefined winner)
        last = np.zeros(len(rows), bool)
        seen: set[int] = set()
        for i in range(len(rows) - 1, -1, -1):
            r = int(rows[i])
            if r not in seen:
                seen.add(r)
                last[i] = True
        self.pool.write_rows(rows[last], np.asarray(pages)[last])

    def get(self, keys: np.ndarray):
        keys = np.asarray(keys, np.uint32)
        self.gets += len(keys)
        rows = np.full(len(keys), -1, np.int32)
        for i, k in enumerate(keys):
            rows[i] = self._map.get((int(k[0]), int(k[1])), -1)
        found = rows >= 0
        self.hits += int(found.sum())
        if found.any():
            # read_rows zeroes row −1 itself, so miss lanes are already 0
            out = self.pool.read_rows(rows)
        else:
            # pure local miss: zero server traffic
            out = np.zeros((len(keys), self.page_words), np.uint32)
        return out, found

    def invalidate(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.uint32)
        hit = np.zeros(len(keys), bool)
        for i, k in enumerate(keys):
            row = self._map.pop((int(k[0]), int(k[1])), None)
            if row is not None:
                self._free.append(row)
                hit[i] = True
        return hit

    def packed_bloom(self) -> np.ndarray | None:
        return None

    def stats(self) -> dict:
        return {
            "puts": self.puts,
            "gets": self.gets,
            "hits": self.hits,
            "misses": self.gets - self.hits,
            "drops": self.drops,
            "mapped": len(self._map),
            "free_rows": len(self._free),
        }
