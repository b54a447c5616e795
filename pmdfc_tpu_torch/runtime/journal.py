"""Write-ahead journal — bounded-RPO durability for the serving tier
(twin of `pmdfc_tpu/runtime/journal.py`: the same records, byte for byte,
so a journal written by either package replays into the other's `KV`).

The reference carried persistence as a first-class capability (clflush /
PMDK discipline and CCEH directory recovery); our functional tree gets
the same guarantee from a host-side journal: every mutation appends a
CRC-framed record BEFORE the device flush acknowledges, so a `kill -9`
loses at most the unsynced tail — bounded by `JournalConfig(rpo_ops,
rpo_ms)`, the knobs the recovery drills assert against.

Record layout (little-endian, `_REC` header + payload + trailing CRC):

    u32 magic (0xJC13 -> 0x4A4C4331 "JLC1")
    u8  type   (1=PUT, 2=DELETE, 3=EXTENT, 4=MARK)
    u8  flags  (reserved, 0)
    u16 words  (page words for PUT/EXTENT payload rows, else 0)
    u64 seq    (journal-wide monotonic record number)
    u32 count  (PUT/DELETE: keys in the batch; EXTENT: run length)
    u32 payload_len
    ... payload bytes ...
    u32 crc32(header + payload)

A record that fails its CRC in the FINAL segment is a torn tail — the
expected `kill -9` artifact — and replay cleanly truncates there,
counting the dropped bytes. A bad record in any EARLIER segment is
`JournalCorruptError`: that is bit rot, not a crash, and silently
skipping it would resurrect an inconsistent prefix.

Segments rotate at `segment_bytes` (`wal-000001.seg`, ...); a fresh
`Journal` always opens a NEW segment so appends never extend a torn
tail. `mark()` records a snapshot boundary (chain id/seq) and makes it
durable immediately; `replay(..., after_mark=True)` applies only the
tail past the newest mark — idempotent under the cold-tier generation
tags, so replaying a tail twice equals replaying it once (the
`test_durability.py` invariant).

`KeyJournal` is the bounded FIFO of recently-put keys that
`client/replica.py` uses as its repair candidate universe — extracted
here so the two journals (repair candidates, durability log) share one
home and one vocabulary.
"""

from __future__ import annotations

import collections
import json
import os
import struct
import threading
import time
import zlib

import numpy as np

from pmdfc_tpu_torch.config import JournalConfig

_MAGIC = 0x4A4C4331  # "JLC1"
_REC = struct.Struct("<IBBHQII")
_CRC = struct.Struct("<I")

REC_PUT = 1
REC_DELETE = 2
REC_EXTENT = 3
REC_MARK = 4

_SEG_FMT = "{name}-{idx:06d}.seg"


class JournalCorruptError(RuntimeError):
    """A journal record failed its CRC somewhere OTHER than the final
    segment's tail — bit rot / truncation of history, refuse replay."""


class KeyJournal:
    """Bounded insertion-ordered set of (hi, lo) key tuples.

    The replica group's repair candidate universe: `note` re-appends
    (recency order), `discard` drops (invalidate path), overflow evicts
    the oldest. NOT thread-safe — callers hold their own lock (the
    replica group's `_maps_lock`), same discipline as the OrderedDict
    this replaces.
    """

    __slots__ = ("cap", "_d")

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._d: collections.OrderedDict = collections.OrderedDict()

    def note(self, kk) -> None:
        self._d.pop(kk, None)
        self._d[kk] = None
        while len(self._d) > self.cap:
            self._d.popitem(last=False)

    def discard(self, kk) -> None:
        self._d.pop(kk, None)

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def __contains__(self, kk) -> bool:
        return kk in self._d

    def keys_array(self) -> np.ndarray:
        """All journaled keys as uint32[N, 2], oldest first."""
        return np.array(list(self._d), np.uint32).reshape(-1, 2)


def _frame(rtype: int, words: int, seq: int, count: int,
           payload: bytes) -> bytes:
    head = _REC.pack(_MAGIC, rtype, 0, words, seq, count, len(payload))
    return head + payload + _CRC.pack(zlib.crc32(payload, zlib.crc32(head)))


def segment_paths(directory: str, name: str = "wal") -> list:
    """Existing segment files, oldest first."""
    pre = name + "-"
    try:
        files = sorted(f for f in os.listdir(directory)
                       if f.startswith(pre) and f.endswith(".seg"))
    except FileNotFoundError:
        return []
    return [os.path.join(directory, f) for f in files]


def iter_segment(path: str, final: bool = False):
    """Yield `(type, words, seq, count, payload)` records; on a torn
    record yield nothing further. Returns (via StopIteration semantics)
    after either a clean end or — when `final` — a truncated tail whose
    byte count the caller reads from the last yielded sentinel: the
    generator's last item is `("__torn__", 0, 0, 0, dropped_bytes)`
    when the tail was torn. Non-final segments raise
    `JournalCorruptError` instead."""
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    n = len(buf)
    while off < n:
        torn = None
        if off + _REC.size > n:
            torn = n - off
        else:
            magic, rtype, _flags, words, seq, count, plen = \
                _REC.unpack_from(buf, off)
            end = off + _REC.size + plen + _CRC.size
            if magic != _MAGIC or end > n:
                torn = n - off
            else:
                head = buf[off:off + _REC.size]
                payload = buf[off + _REC.size:end - _CRC.size]
                (crc,) = _CRC.unpack_from(buf, end - _CRC.size)
                if crc != zlib.crc32(payload, zlib.crc32(head)):
                    torn = n - off
        if torn is not None:
            if not final:
                raise JournalCorruptError(
                    f"journal segment '{path}' has a corrupt record at "
                    f"byte {off} but is not the final segment — refusing "
                    "to replay past damaged history")
            yield ("__torn__", 0, 0, 0, torn)
            return
        yield (rtype, words, seq, count, payload)
        off = end


class Journal:
    """Appendable CRC-framed WAL over a directory of rotating segments.

    Thread-safe; appends are buffered writes, durability comes from
    `sync()` — driven automatically by the `(rpo_ops, rpo_ms)` bound
    when `auto_sync` (a timer thread covers idle tails so rpo_ms holds
    even when appends stop coming).
    """

    def __init__(self, directory: str, config: JournalConfig | None = None,
                 name: str = "wal"):
        # function-local: runtime/__init__ -> server -> kv chains make
        # eager cross-imports circularity-prone (same idiom as kv.stats)
        from pmdfc_tpu_torch.runtime import sanitizer as san
        from pmdfc_tpu_torch.runtime import telemetry as tele

        self.cfg = config or JournalConfig()
        self.dir = directory
        self.name = name
        os.makedirs(directory, exist_ok=True)
        existing = segment_paths(directory, name)
        self._seg_idx = 1
        self._seq = 0
        if existing:
            last = existing[-1]
            self._seg_idx = int(
                os.path.basename(last).rsplit("-", 1)[1].split(".")[0]) + 1
            for rec in iter_segment(last, final=True):
                if rec[0] != "__torn__":
                    self._seq = rec[2] + 1
        # guarded-by: _f, _seq, _pending_*, everything mutable below
        self._lock = san.lock("Journal._lock")
        self._f = None
        self._seg_bytes = 0
        self._pending_ops = 0
        self._pending_bytes = 0
        self._oldest_pending = None  # monotonic ts of first unsynced rec
        self._closed = False
        self.counters = tele.scope("journal", {
            "appends": 0, "syncs": 0, "rotations": 0,
            "replayed_records": 0, "truncated_tails": 0,
        })
        self.counters.set("depth_ops", 0)
        self.counters.set("depth_bytes", 0)
        self.counters.set("fsync_lag_ms", 0.0)
        self.counters.set("segments", len(existing))
        self._open_segment()
        self._flusher = None
        if self.cfg.auto_sync and self.cfg.rpo_ms > 0:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="journal-flush", daemon=True)
            self._flusher.start()

    # -- segment lifecycle (caller holds _lock unless noted) --

    # caller-holds: _lock
    def _open_segment(self) -> None:
        path = os.path.join(self.dir, _SEG_FMT.format(name=self.name,
                                                      idx=self._seg_idx))
        self._f = open(path, "ab", buffering=0)
        self._seg_idx += 1
        self._seg_bytes = 0
        self.counters.set("segments", len(segment_paths(self.dir, self.name)))

    def _rotate(self) -> None:
        self._sync_locked()
        self._f.close()
        self.counters.inc("rotations")
        self._open_segment()

    # -- append surface --

    def _append(self, rtype: int, words: int, count: int,
                payload: bytes) -> int:
        with self._lock:
            if self._closed:
                raise RuntimeError("journal is closed")
            rec = _frame(rtype, words, self._seq, count, payload)
            seq = self._seq
            self._seq += 1
            self._f.write(rec)
            self._seg_bytes += len(rec)
            self._pending_ops += 1
            self._pending_bytes += len(rec)
            if self._oldest_pending is None:
                self._oldest_pending = time.monotonic()
            self.counters.inc("appends")
            self.counters.set("depth_ops", self._pending_ops)
            self.counters.set("depth_bytes", self._pending_bytes)
            due = (self._pending_ops >= self.cfg.rpo_ops
                   or (self.cfg.rpo_ms and
                       (time.monotonic() - self._oldest_pending) * 1000.0
                       >= self.cfg.rpo_ms))
            if self.cfg.auto_sync and due:
                self._sync_locked()
            if self._seg_bytes >= self.cfg.segment_bytes:
                self._rotate()
        return seq

    def append_put(self, keys: np.ndarray, pages: np.ndarray) -> int:
        keys = np.ascontiguousarray(np.asarray(keys, np.uint32)
                                    .reshape(-1, 2))
        pages = np.ascontiguousarray(np.asarray(pages, np.uint32))
        pages = pages.reshape(len(keys), -1)
        return self._append(REC_PUT, pages.shape[1], len(keys),
                            keys.tobytes() + pages.tobytes())

    def append_delete(self, keys: np.ndarray) -> int:
        keys = np.ascontiguousarray(np.asarray(keys, np.uint32)
                                    .reshape(-1, 2))
        return self._append(REC_DELETE, 0, len(keys), keys.tobytes())

    def append_extent(self, key, value, length: int) -> int:
        key = np.ascontiguousarray(np.asarray(key, np.uint32).reshape(2))
        value = np.ascontiguousarray(np.asarray(value, np.uint32)
                                     .reshape(-1))
        return self._append(REC_EXTENT, 0, int(length),
                            key.tobytes() + value.tobytes())

    def mark(self, info: dict) -> int:
        """A snapshot boundary (chain id/seq/path). Durable immediately:
        a mark that could be lost would orphan the chain it names."""
        payload = json.dumps(info, sort_keys=True).encode()
        seq = self._append(REC_MARK, 0, 0, payload)
        self.sync()
        return seq

    # -- durability --

    def _sync_locked(self) -> None:
        if self._pending_ops == 0:
            return
        t0 = time.monotonic()
        self._f.flush()
        os.fsync(self._f.fileno())
        now = time.monotonic()
        lag_ms = (now - (self._oldest_pending or now)) * 1000.0
        sync_ms = (now - t0) * 1000.0
        self._pending_ops = 0
        self._pending_bytes = 0
        self._oldest_pending = None
        self.counters.inc("syncs")
        self.counters.set("depth_ops", 0)
        self.counters.set("depth_bytes", 0)
        self.counters.set("fsync_lag_ms", lag_ms)
        if self.cfg.rpo_ms and sync_ms > max(self.cfg.rpo_ms, 1.0):
            # the disk can't honor the batching window: every future
            # bound check will fire late — the flight recorder should
            # see WHY RPO drifted, not just that it did
            from pmdfc_tpu_torch.runtime import telemetry as tele

            tele.rung("journal_stall", sync_ms=round(sync_ms, 3),
                      rpo_ms=self.cfg.rpo_ms, lag_ms=round(lag_ms, 3))

    def sync(self) -> None:
        with self._lock:
            if not self._closed:
                self._sync_locked()

    def _flush_loop(self) -> None:
        tick = max(self.cfg.rpo_ms / 2000.0, 0.005)
        while True:
            time.sleep(tick)
            with self._lock:
                if self._closed:
                    return
                if (self._oldest_pending is not None
                        and (time.monotonic() - self._oldest_pending)
                        * 1000.0 >= self.cfg.rpo_ms):
                    self._sync_locked()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._sync_locked()
            self._closed = True
            self._f.close()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)

    # -- maintenance --

    def prune_to_mark(self) -> int:
        """Delete whole segments older than the one holding the newest
        MARK (their records predate a durable snapshot boundary and
        replay would skip them anyway). Returns segments removed."""
        with self._lock:
            segs = segment_paths(self.dir, self.name)
            keep_from = None
            for i, p in enumerate(segs):
                final = (i == len(segs) - 1)
                for rec in iter_segment(p, final=final):
                    if rec[0] == REC_MARK:
                        keep_from = i
            if keep_from is None or keep_from == 0:
                return 0
            for p in segs[:keep_from]:
                os.unlink(p)
            self.counters.set("segments",
                              len(segment_paths(self.dir, self.name)))
            return keep_from


def read_records(directory: str, name: str = "wal") -> tuple:
    """All records across all segments in order. Returns
    `(records, truncated_bytes)`; a torn tail is legal only in the
    final segment (`JournalCorruptError` otherwise)."""
    segs = segment_paths(directory, name)
    records = []
    truncated = 0
    for i, p in enumerate(segs):
        final = (i == len(segs) - 1)
        for rec in iter_segment(p, final=final):
            if rec[0] == "__torn__":
                truncated = rec[4]
            else:
                records.append(rec)
    return records, truncated


def replay(directory: str, kv, name: str = "wal",
           after_mark: bool = True) -> dict:
    """Apply the journal (tail) onto a live KV through its own mutation
    surface — `insert` / `delete` / `insert_extent` — in record order.

    Idempotent: last-writer-wins index semantics plus the cold-tier
    generation tags mean replaying the same tail twice leaves the same
    bytes as once (no stale resurrection). `after_mark=True` starts
    strictly past the newest MARK record — the snapshot boundary — which
    is the warm-restart tail; False replays everything (journal-only
    recovery). The KV's own attached journal, if any, is suspended for
    the duration so replay never re-journals itself.
    """
    records, truncated = read_records(directory, name)
    start = 0
    if after_mark:
        for i, rec in enumerate(records):
            if rec[0] == REC_MARK:
                start = i + 1
    report = {"records": len(records) - start, "puts": 0, "deletes": 0,
              "extents": 0, "pages": 0, "truncated_bytes": truncated,
              "last_seq": records[-1][2] if records else None}
    suspended = getattr(kv, "_journal", None)
    if suspended is not None:
        kv.attach_journal(None)
    try:
        for rtype, words, _seq, count, payload in records[start:]:
            if rtype == REC_PUT:
                keys = np.frombuffer(payload, np.uint32,
                                     count=count * 2).reshape(count, 2)
                pages = np.frombuffer(payload, np.uint32,
                                      offset=count * 8).reshape(count,
                                                                words)
                kv.insert(keys, pages)
                report["puts"] += 1
                report["pages"] += count
            elif rtype == REC_DELETE:
                keys = np.frombuffer(payload, np.uint32).reshape(count, 2)
                kv.delete(keys)
                report["deletes"] += 1
            elif rtype == REC_EXTENT:
                key = np.frombuffer(payload, np.uint32, count=2)
                value = np.frombuffer(payload, np.uint32, offset=8)
                kv.insert_extent(key, value, count)
                report["extents"] += 1
            # REC_MARK past `start`: boundary only, nothing to apply
    finally:
        if suspended is not None:
            kv.attach_journal(suspended)
    return report


def warm_restart(config, chain_paths, journal_dir: str,
                 journal_config: JournalConfig | None = None,
                 run_recovery: bool = True, device="cuda") -> tuple:
    """Restore snapshot chain + replay journal tail + enter recovering.

    The rejoin recipe in one call: materialize the chain (empty chain =
    fresh init, journal-only replay from the start), build the state on
    `device`, re-arm bloom/directory via the index recovery hook, replay
    the WAL tail through the KV's mutation surface, flip the KV into its
    `recovering` serving state (GETs answer from restored rows
    immediately; not-yet-caught-up misses land in `miss_recovering`), and
    attach a FRESH journal so new mutations are durable again. Returns
    `(kv, report)`: the replay report plus `timings_s`, the seconds of
    each step (`read` and verify of the chain, `fold` of its deltas,
    `to_device`, `recovery`, `replay`). The caller flips
    `kv.mark_recovered()` once ring migration / anti-entropy has drained
    (replica.repair_tick does it for rejoined endpoints).
    """
    from pmdfc_tpu_torch import checkpoint as ckpt
    from pmdfc_tpu_torch.kv import KV

    timings = dict.fromkeys(("read", "fold", "to_device", "recovery",
                             "replay"), 0.0)
    if chain_paths:
        # run the index recovery hook through the KV wrapper (not the
        # loader) so the restore also bumps dir_epoch/_mut_seq — every
        # client-cached directory entry must stop validating at once
        folded = ckpt.materialize_chain(list(chain_paths))
        timings.update(folded["timings_s"])
        t0 = time.perf_counter()
        state = ckpt.state_from_leaves(folded["leaves"], config,
                                       run_recovery=False, device=device)
        kv = KV(config, state=state, device=device)
        _sync(kv)
        t1 = time.perf_counter()
        if run_recovery:
            kv.recovery()
            _sync(kv)
        timings.update(to_device=t1 - t0,
                       recovery=time.perf_counter() - t1)
        # resume the chain where it left off: the next delta snapshot
        # extends the restored chain rather than starting a new one
        kv.resume_chain(folded["chain"])
        del folded, state  # the host leaves go before the replay
        after_mark = True
    else:
        kv = KV(config, device=device)
        after_mark = False  # no snapshot: the journal IS the history
    t0 = time.perf_counter()
    with kv._on_device():
        report = replay(journal_dir, kv, after_mark=after_mark)
    _sync(kv)
    timings["replay"] = time.perf_counter() - t0
    report["timings_s"] = timings
    kv.begin_recovering()
    kv.attach_journal(Journal(journal_dir, journal_config))
    return kv, report


def _sync(kv) -> None:
    """Wait for the KV's device (a step's time ends when its work does)."""
    if kv.device.type == "cuda":
        import torch

        torch.cuda.synchronize(kv.device)
