"""Client-mirrored directory cache — the one-sided fast path's key→row map.

Reference: in the one-sided operating mode the CLIENT owns the key→offset
mapping in a local hashtable and reads rows with raw one-sided verbs
(`client/julee.c:103-120`, `pmdfc_rdma_read_sync`); HiStore
(arxiv 2208.12987) and RDMA hash-table designs push the same shape to a
client-cached index with version validation. Here the serving KV owns
placement, so the client's map is a CACHE of the server's directory
snapshot (`KV.directory_snapshot`), refreshed full/delta over
`MSG_DIRPULL`/`MSG_DIRDELTA` and validated per read:

- **epoch** — structural generation of the mapping. The server bumps it
  on delete/balloon/reshard/restore; a fast read presenting a stale
  epoch fails every lane and the client falls back to the verb path.
- **digest** — each entry carries the row's at-rest digest at snapshot
  time. The server serves the row only while its CURRENT `sums[row]`
  still equals it, so a recycled or re-written row can never serve
  bytes for the wrong key (the 2^-32 collision class the integrity
  layer already accepts).

Same overlay discipline as the bloom mirror (`cleancache.py`): local
puts/invalidates DROP their entries immediately (the row or digest is
about to change server-side), stale verdicts drop lanes and mark the
cache dirty, and a dirty cache answers no lookups until the next
refresh — a missing entry only costs the verb path, never correctness.
"""

from __future__ import annotations

import numpy as np

from pmdfc_tpu_torch.runtime import sanitizer as san


def key64(keys: np.ndarray) -> np.ndarray:
    """[B, 2] u32 longkeys -> u64 `hi<<32|lo` (the dict key form)."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    return ((keys[:, 0].astype(np.uint64) << np.uint64(32))
            | keys[:, 1].astype(np.uint64))


class DirectoryCache:
    """Bounded key→(shard, row, digest) mirror with epoch tracking."""

    def __init__(self, max_entries: int = 1 << 20):
        self.max_entries = max_entries
        # guarded-by: _map, epoch, _dirty, _has_snapshot, counters
        self._lock = san.lock("DirectoryCache._lock")
        self._map: dict[int, tuple[int, int, int]] = {}
        self.epoch = 0
        self._dirty = True          # no snapshot yet -> fast path off
        self._has_snapshot = False  # ever applied one (delta vs full pull)
        self.counters = {
            "fastpath_gets": 0, "fastpath_hits": 0, "fastpath_stale": 0,
            "dir_refreshes": 0, "dir_upserts": 0, "dir_tombstones": 0,
            "dir_entries": 0, "dir_drops": 0,
        }

    # -- refresh-side surface (driven by TcpBackend.dir_refresh) --

    def wants_delta(self) -> bool:
        with self._lock:
            return self._has_snapshot

    def apply(self, full: bool, epoch: int, keys: np.ndarray,
              shards: np.ndarray, rows: np.ndarray, digs: np.ndarray,
              tombs: np.ndarray) -> None:
        """Install one pull: `full` replaces the table, delta upserts the
        changed entries and removes the tombstoned keys. The epoch
        always advances to the server's — entries surviving a delta
        remain valid under the new epoch (the server diffs content, the
        epoch only gates reads)."""
        k64 = key64(keys).tolist()
        ent = list(zip(shards.tolist(), rows.tolist(), digs.tolist()))
        with self._lock:
            if full:
                self._map = dict(zip(k64, ent))
            else:
                self._map.update(zip(k64, ent))
                for t in key64(tombs).tolist():
                    self._map.pop(t, None)
            while len(self._map) > self.max_entries:
                # FIFO-drop the oldest entries (dict order): a dropped
                # entry only costs the verb path later
                self._map.pop(next(iter(self._map)))
            self.epoch = int(epoch)
            self._dirty = False
            self._has_snapshot = True
            self.counters["dir_refreshes"] += 1
            self.counters["dir_upserts"] += len(k64)
            self.counters["dir_tombstones"] += len(tombs)
            self.counters["dir_entries"] = len(self._map)

    def mark_dirty(self) -> None:
        """Stop answering lookups until the next refresh (set when a
        fast read came back under a NEWER server epoch)."""
        with self._lock:
            self._dirty = True

    def ready(self) -> bool:
        with self._lock:
            return self._has_snapshot and not self._dirty

    # -- read-side surface (driven by TcpBackend.get) --

    def lookup(self, keys: np.ndarray):
        """(mask[B], shards, rows, digs, epoch): mask marks keys with a
        cached entry; the parallel columns are compacted to the masked
        lanes. All-false (and no arrays) while dirty/unfilled."""
        n = len(keys)
        with self._lock:
            if self._dirty or not self._map:
                return np.zeros(n, bool), None, None, None, self.epoch
            mask = np.zeros(n, bool)
            sh, ro, dg = [], [], []
            for i, k in enumerate(key64(keys).tolist()):
                e = self._map.get(k)
                if e is not None:
                    mask[i] = True
                    sh.append(e[0])
                    ro.append(e[1])
                    dg.append(e[2])
            return (mask, np.asarray(sh, np.uint32),
                    np.asarray(ro, np.uint32), np.asarray(dg, np.uint32),
                    self.epoch)

    def note_result(self, keys_tried: np.ndarray, ok: np.ndarray,
                    srv_epoch: int) -> None:
        """Account one fast-read batch: hits stay cached, stale lanes
        drop (their row/digest no longer validates), and a server epoch
        ahead of ours dirties the cache until the next refresh."""
        n, nh = len(ok), int(np.count_nonzero(ok))
        stale = keys_tried[~ok]
        with self._lock:
            self.counters["fastpath_gets"] += n
            self.counters["fastpath_hits"] += nh
            self.counters["fastpath_stale"] += n - nh
            for k in key64(stale).tolist():
                self._map.pop(k, None)
            self.counters["dir_entries"] = len(self._map)
            if int(srv_epoch) != self.epoch:
                self._dirty = True

    def drop(self, keys: np.ndarray) -> None:
        """Local overlay rule: a key this client just put or invalidated
        leaves the cache NOW (its row/digest is changing server-side);
        the next refresh re-adds the current mapping."""
        with self._lock:
            dropped = 0
            for k in key64(keys).tolist():
                dropped += self._map.pop(k, None) is not None
            self.counters["dir_drops"] += dropped
            self.counters["dir_entries"] = len(self._map)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters, epoch=self.epoch,
                        ready=(self._has_snapshot and not self._dirty))
