"""Workload characterization sketches — what IS the fleet serving?

HiStore (arxiv 2208.12987) shows hot/cold workload awareness is what
unlocks index-side wins, and ROADMAP item 5 (admission intelligence)
cannot exist until the serving tier can *see* its workload. This module
is the host-side sensor pair, computed on the messenger's existing
routing path (the NetServer flush loop already touches every request's
keys — the sketches ride that touch, no device work, no extra pass):

- **Working-set estimation** (`KmvSketch`): bounded streaming
  cardinality over longkeys — a K-minimum-values sketch (keep the `k`
  smallest distinct key hashes; the classic estimator
  `(k-1) / kth_min_normalized` is unbiased with relative error
  ~`1/sqrt(k-2)`; below `k` distinct keys the sketch is EXACT). Memory
  is one sorted uint64[k] array, period.
- **Keyspace heat** (`HeatSketch`): a count-min sketch over key-hash
  PREFIXES (the top 16 bits of the routing-family hash — prefix space,
  not raw keys, so the sketch answers "which key-space REGIONS are
  hot", the shard-balance / scan-detection question). Heavy prefixes
  are read back from a bounded candidate set; `skew` is the top-candidate
  share of window traffic (1/len(candidates)·top≈uniform, →1 = one
  region eating the fleet).

`WorkloadSketch` bundles both behind one thread-safe `observe(keys)`
and WINDOWS itself on wall time (`window_s`): `snapshot()` reports the
cumulative estimates AND the last CLOSED window's, so a single
`MSG_STATS` pull (`tools/teletop.py --once`) yields rates without a
second poll. Shipped under the `workload` key of the `MSG_STATS`
document (`pmdfc-telemetry-v2`); `tools/check_teledump.py` pins the
shape and bounds.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from pmdfc_tpu_torch.utils.hashing_np import hash_u64_np

# independent family members: cardinality hashing and heat-prefix row
# hashing must not alias the index/bloom/shard seeds
_KMV_SEED = 0xCA2D_117E
_CM_SEED = 0x11EA_7000
_INVALID = np.uint32(0xFFFFFFFF)


def _key_hashes(keys: np.ndarray) -> np.ndarray:
    """uint64 hashes of [B, 2] longkeys (INVALID sentinel rows dropped):
    two independent 32-bit family members widened to one 64-bit value so
    KMV collisions are negligible at serving cardinalities."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    live = ~((keys[:, 0] == _INVALID) & (keys[:, 1] == _INVALID))
    keys = keys[live]
    if not len(keys):
        return np.zeros(0, np.uint64)
    h1 = hash_u64_np(keys[:, 0], keys[:, 1], seed=_KMV_SEED)
    h2 = hash_u64_np(keys[:, 0], keys[:, 1], seed=_KMV_SEED ^ 0x9E3779B9)
    return (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)


class KmvSketch:
    """K-minimum-values distinct counter over uint64 hashes."""

    def __init__(self, k: int = 256):
        if k < 8:
            raise ValueError("k must be >= 8")
        self.k = k
        self._mins = np.empty(0, np.uint64)  # sorted ascending, distinct

    def add_hashes(self, h: np.ndarray) -> None:
        if not len(h):
            return
        if len(self._mins) >= self.k:
            # warm sketch: only hashes below the current kth-min can
            # change it — one vectorized compare drops ~(1 - k/N) of the
            # stream before the sort-merge pays anything
            h = h[h < self._mins[-1]]
            if not len(h):
                return
        self._mins = np.unique(np.concatenate([self._mins, h]))[: self.k]

    def estimate(self) -> float:
        n = len(self._mins)
        if n < self.k:
            return float(n)  # exact below k distinct values
        kth = float(self._mins[self.k - 1]) / float(1 << 64)
        if kth <= 0.0:
            return float(n)
        return (self.k - 1) / kth


class HeatSketch:
    """Count-min over 16-bit key-hash prefixes + bounded heavy-hitter
    candidate set."""

    def __init__(self, depth: int = 4, width: int = 256,
                 max_candidates: int = 1024):
        if depth < 1 or width < 2:
            raise ValueError("depth must be >= 1, width >= 2")
        self.depth = depth
        self.width = width
        self.max_candidates = max_candidates
        self.counts = np.zeros((depth, width), np.int64)
        self.total = 0
        # bounded heavy-hitter candidate set (numpy, newest-first): a
        # python dict walked per fold cost milliseconds at fold batch
        # sizes; heavy prefixes reappear in every fold, so bounded
        # recency keeps them resident
        self._cand = np.empty(0, np.uint32)

    def _rows(self, prefixes: np.ndarray) -> np.ndarray:
        """[depth, B] column per row for each prefix."""
        z = np.zeros_like(prefixes)
        return np.stack([
            hash_u64_np(prefixes, z,
                        seed=(_CM_SEED + 0x61C88647 * r) & 0xFFFFFFFF)
            % np.uint32(self.width)
            for r in range(self.depth)
        ])

    def add(self, prefixes: np.ndarray) -> None:
        if not len(prefixes):
            return
        # fold the batch through its UNIQUE prefixes: row hashing and
        # the candidate merge then scale with distinct regions touched,
        # not raw keys (prefix space is 16-bit, so ≤65536 either way)
        u, cnt = np.unique(prefixes, return_counts=True)
        cols = self._rows(u)
        for r in range(self.depth):
            # bincount-and-add beats np.add.at by ~an order of magnitude
            # at fold-batch sizes (the fold cadence amortizes both)
            self.counts[r] += np.bincount(
                cols[r], weights=cnt, minlength=self.width
            ).astype(np.int64)
        self.total += int(len(prefixes))
        if len(u) > self.max_candidates:
            # keep the batch's heaviest prefixes as candidates — the
            # bound is what keeps fold cost flat under scan workloads
            u = u[np.argsort(-cnt)[: self.max_candidates]]
        merged = np.concatenate([u, self._cand])
        _, first = np.unique(merged, return_index=True)
        # earliest position wins ⇒ this batch's prefixes refresh their
        # recency; survivors keep newest-first order
        self._cand = merged[np.sort(first)[: self.max_candidates]]

    def estimate(self, prefixes: np.ndarray) -> np.ndarray:
        """Count-min point estimates (min over rows) per prefix."""
        if not len(prefixes):
            return np.zeros(0, np.int64)
        cols = self._rows(np.asarray(prefixes, np.uint32))
        return np.min(
            np.stack([self.counts[r][cols[r]]
                      for r in range(self.depth)]), axis=0)

    def top(self, n: int = 8) -> list:
        """[[prefix, est_count, share], ...] heaviest candidate
        prefixes (count-min estimates are upper bounds; shares are
        clipped to [0, 1])."""
        cand = self._cand
        if not len(cand) or not self.total:
            return []
        est = self.estimate(cand)
        order = np.argsort(-est)[:n]
        return [[int(cand[i]), int(est[i]),
                 round(min(1.0, est[i] / self.total), 4)]
                for i in order]


class WorkloadSketch:
    """The NetServer's workload sensor: thread-safe `observe(keys)` on
    the routing path; self-windowing `snapshot()` for the wire.

    Hot-path cost discipline: `observe` only HASHES the batch
    (vectorized, two murmur passes) and parks the hashes in a bounded
    buffer — the expensive folds (KMV `unique`, count-min scatter,
    candidate upkeep) run once per `fold_keys` hashes or per window
    roll, so the flush loop pays amortized nanoseconds per key instead
    of a sort per verb (`bench/telemetry_overhead.py` holds the whole
    sensor array inside the 3% gate)."""

    def __init__(self, k: int = 256, cm_depth: int = 4,
                 cm_width: int = 256, window_s: float = 5.0,
                 fold_keys: int = 8192):
        self.window_s = window_s
        self.fold_keys = fold_keys
        # guarded-by: _kmv, _heat, _win_kmv, _win_ops, _ops, _t_win,
        # guarded-by: _last, _buf, _buf_n
        self._l = threading.Lock()
        self._kmv = KmvSketch(k)
        self._heat = HeatSketch(cm_depth, cm_width)
        self._win_kmv = KmvSketch(k)
        self._buf: list = []
        self._buf_n = 0
        self._win_ops = 0
        self._ops = 0
        self._t_win = time.monotonic()
        self._last: dict | None = None

    # caller-holds: _l
    def _fold_locked(self) -> None:
        if not self._buf:
            return
        keys = (np.concatenate(self._buf) if len(self._buf) > 1
                else self._buf[0])
        self._buf = []
        self._buf_n = 0
        # hashing happens HERE, vectorized over the whole fold batch —
        # per-verb numpy fixed costs (~30 tiny-array ops per hash pass)
        # would otherwise dominate the serving path's per-key cost
        h = _key_hashes(keys)
        if not len(h):
            return
        self._kmv.add_hashes(h)
        self._win_kmv.add_hashes(h)
        self._heat.add((h >> np.uint64(48)).astype(np.uint32))

    # caller-holds: _l
    def _roll_locked(self, now: float) -> None:
        self._fold_locked()
        dt = now - self._t_win
        self._last = {
            "working_set": round(self._win_kmv.estimate(), 1),
            "ops": self._win_ops,
            "dt_s": round(dt, 3),
            "heat_top": self._heat.top(),
        }
        self._win_kmv = KmvSketch(self._kmv.k)
        self._win_ops = 0
        self._t_win = now

    def observe(self, keys: np.ndarray) -> None:
        """Park one routed batch's longkeys (INVALID rows are dropped at
        fold time). Cheap per call: one small COPY + append. The copy is
        deliberate — callers pass views into frame payload buffers, and
        a PUT frame's payload also holds its pages, so retaining the
        view would pin megabytes of page bytes per buffered verb until
        the next fold; the key block itself is a few hundred bytes."""
        keys = np.array(keys, np.uint32).reshape(-1, 2)
        n = int(np.count_nonzero(
            (keys[:, 0] != _INVALID) | (keys[:, 1] != _INVALID)))
        if not n:
            return
        with self._l:
            now = time.monotonic()
            if now - self._t_win >= self.window_s:
                # close the elapsed window BEFORE folding this batch in:
                # the new arrivals belong to the window that starts now
                self._roll_locked(now)
            self._buf.append(keys)
            self._buf_n += n
            self._ops += n
            self._win_ops += n
            if self._buf_n >= self.fold_keys:
                self._fold_locked()

    def snapshot(self) -> dict:
        """The `workload` block of the MSG_STATS document."""
        with self._l:
            now = time.monotonic()
            if self._last is None or now - self._t_win >= self.window_s:
                # close the open window so a single pull still reports a
                # fresh rate (teletop --once needs no second poll)
                self._roll_locked(now)
            else:
                self._fold_locked()
            top = self._heat.top()
            return {
                "schema": "pmdfc-workload-v1",
                "ops": self._ops,
                "working_set": round(self._kmv.estimate(), 1),
                "window": dict(self._last),
                "heat": {
                    "depth": self._heat.depth,
                    "width": self._heat.width,
                    "total": self._heat.total,
                    "top": top,
                    # top-candidate share of all traffic: ~uniform →
                    # small; one hot key-space region → approaches 1
                    "skew": top[0][2] if top else 0.0,
                },
            }
