"""Unified telemetry — metrics registry, op trace spans, flight recorder
(twin of `pmdfc_tpu/runtime/telemetry.py`).

Differences, all in the recompile tracker. The JAX package counts true
backend compiles (`recompile.backend_compiles`,
`recompile.backend_compile_ms`) with a `jax.monitoring` listener. Torch
has no such event, so the port has no listener and never registers those
two metrics. JAX also reports a program signature from three dispatch
seams, each a jit cache the port does not have: `KV`'s padded verbs
(`recompile.kv.*`), the sharded plane's `_wrap` cache
(`recompile.plane.*`) and the fused GET's Pallas program
(`recompile.kv.get_fused.kernel`). The port calls `track_program` from
none of them, so driving its `KV`, plane or fused GET moves no
`recompile.*` counter and rings no `recompile` event. The seam itself
(`track_program`) counts first sightings exactly as JAX's does for any
caller that reports one (`tests/test_torch_tracing.py` pins both).

The reference system's operators lived off per-queue counters and
`PrintStats` dumps (`server/rdma_svr.cpp:107-150`); this repo had grown
the same way — ~28 files of ad-hoc `stats()` dicts with no latency
distributions and no way to follow one hedged GET through a half-open
breaker. This module is the single process-wide observability surface
the four tiers (engine, tiered pool, coalesced net, replica group) now
share:

- **Metrics registry.** Monotonic `Counter`s, `Gauge`s, and fixed-bucket
  log2 `Histogram`s (p50/p95/p99 snapshots) live under `Scope`s — one
  scope per instrumented instance (`net0`, `breaker3`, ...), so two
  servers in one process never share a counter. A `Scope` is a read-only
  Mapping of its counter/gauge values, which is exactly the shape the
  repo's `stats` dicts had — the migrated surfaces (`NetServer.stats`,
  `CircuitBreaker.stats`, `ReconnectingClient.stats()`, ...) read the
  registry instead of hand-kept dicts, so there is ONE source of truth.
  Registration asserts no-collision: the same full metric name cannot be
  claimed twice (the stats-merge shadowing class of bug, caught at
  construction instead of silently in a merged dict).

- **Trace spans.** `mint_trace()` issues 32-bit nonzero trace ids;
  `TcpBackend`/`ReplicaGroup` mint one per op, the wire carries it in
  the request frame's (otherwise unused) `words` field — negotiated via
  `TRACE_FLAG` in the HOLA handshake like `PIPE_FLAG`, so mixed fleets
  interop — and `NetServer` recovers it in the staging queue and stamps
  it onto flush-phase records. `record_span()` appends one bounded
  record per op side (client/server/group), so one GET can be followed
  client → hedge → wire → coalesced batch → engine phase.

- **Causal span trees.** `span_begin()`/`span_end()` bracket one stage
  of one op as a TIMED TREE NODE: monotonic-ns start/end, a 32-bit span
  id, a parent id (explicit, or inherited from the per-thread ambient
  span stack so a callee's span nests under its caller's without any
  plumbing), and free-form attributes (shard/conn/phase/endpoint).
  `record_span()` remains the one-shot form — it mints a span id and
  parents off the same ambient stack. One pipelined GET through the
  mesh plane yields a nested client→hedge→wire→queue-wait→flush-phase→
  shard-program tree; `tools/tracetool.py` merges client+server flight
  dumps (clock offset estimated from the HOLA exchange, see
  `clock_event`) into a Chrome-trace/Perfetto timeline.

- **Continuous profiling.** `track_program()` is the program-cache miss
  tracker: a caller reports its program signature, and the first
  sighting per registry bumps a NAMED `recompile.*` counter and rings a
  `recompile` event (no port seam reports one; see above).

- **Flight recorder.** A bounded ring of recent span/event records.
  `rung(name, **detail)` marks a degradation-ladder rung firing (digest
  mismatch, bad frame, breaker open, replica-set exhausted, phase
  failure): it counts the rung, appends an event record, and — when a
  dump directory is configured — writes a JSON snapshot (counters +
  gauges + the ring tail) so "hit-rate dipped" becomes an attributable
  post-mortem artifact. Dumps are cooldown-limited per rung, and the
  dump dir is ROTATED (`dump_max_files`, oldest-first) so a long soak
  cannot fill the disk. `dump_now()` writes one on demand (the
  tracetool workflow). Schema `pmdfc-flight-v2` (v1 + span-tree record
  fields + clock records; `tools/check_teledump.py` pins both).

Cost discipline: counters/gauges are one uncontended lock acquire per
bump (always on — correctness surfaces read them). The TRACING tier —
spans, histograms, the ring, dumps — is gated by
`TelemetryConfig(enabled=...)` / `PMDFC_TELEMETRY=off` and compiles to
an early-out when disabled; `bench/telemetry_overhead.py` holds the
net-smoke overhead of `on` vs `off` within 3%.

Exports: `telemetry.render()` (Prometheus-style text),
`telemetry.snapshot()` (the JSON form `MSG_STATS` ships and
`tools/teledump.py` pulls), `telemetry.configure()` (tests/benches swap
a fresh registry in).
"""

from __future__ import annotations

import collections
import collections.abc
import itertools
import json
import os
import re
import threading
import time

from pmdfc_tpu_torch.config import TelemetryConfig, telemetry_enabled

# the rung vocabulary (runtime/failure.py's ladder, host-visible sites):
# informational only — rung() accepts any name, but these are the ones
# the instrumented tiers fire and the docs table enumerates
RUNGS = (
    "digest_mismatch",    # rung 1: end-to-end digest gate refused a page
    "bad_frame",          # rung 2: CRC/desync dropped a connection
    "breaker_open",       # rung 3 feeder: endpoint health gate opened
    "phase_failure",      # rung 3: a fused serve phase failed (conns drop)
    "torn_checkpoint",    # rung 4: a corrupt snapshot was rejected
    "journal_stall",      # rung 4 feeder: a WAL fsync outran the
                          # JournalConfig rpo_ms window (RPO drifting)
    "replica_exhausted",  # rung 6: whole replica set open -> legal miss
    "slo_breach",         # watchdog: a declared SLO target burned through
)


class Counter:
    """Monotonic counter. `inc` is one uncontended lock acquire; reads
    are lock-free (int loads are atomic under the GIL)."""

    __slots__ = ("_v", "_l")

    def __init__(self):
        self._v = 0
        self._l = threading.Lock()  # guarded-by: _v

    def inc(self, n: int = 1) -> None:
        with self._l:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    """Last-write-wins scalar, with a `max_update` mode for high-water
    marks (`flush_max` and friends)."""

    __slots__ = ("_v", "_l")

    def __init__(self):
        self._v = 0
        # guarded-by: <none>  (`set` is deliberately lock-free last-write
        # -wins; the lock only serializes the max_update read-modify-write)
        self._l = threading.Lock()

    def set(self, v) -> None:
        self._v = v

    def max_update(self, v) -> None:
        with self._l:
            if v > self._v:
                self._v = v

    @property
    def value(self):
        return self._v


class Histogram:
    """Fixed-bucket log2 histogram: bucket i holds values in
    [2^(i-1), 2^i), bucket 0 holds 0 — 48 buckets cover half a week in
    microseconds. Quantiles come from the bucket walk, reported as the
    bucket's upper bound clipped to the observed max (conservative:
    never under-reports a tail). `observe` early-outs when the tracing
    tier is disabled — latency distributions are diagnostics, not a
    correctness surface."""

    NBUCKETS = 48

    __slots__ = ("_counts", "_l", "_n", "_sum", "_max")

    def __init__(self):
        self._counts = [0] * self.NBUCKETS
        self._l = threading.Lock()  # guarded-by: _counts, _n, _sum, _max
        self._n = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, v: float) -> None:
        if not _STATE.tracing:
            return
        if v < 0:
            v = 0.0
        i = min(int(v).bit_length(), self.NBUCKETS - 1)
        with self._l:
            self._counts[i] += 1
            self._n += 1
            self._sum += v
            if v > self._max:
                self._max = v

    @staticmethod
    def quantile_from(counts, n: int, vmax: float, q: float) -> float:
        """Bucket-walk quantile over raw (counts, n, max) — the ONE
        implementation of the log2-bucket convention, shared by the
        live snapshot and window-delta consumers (the SLO watchdog
        evaluates it over bucket DELTAS between ticks)."""
        if n <= 0:
            return 0.0
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                return float(min(1 << i, vmax) if i else 0.0)
        return float(vmax)

    def _quantile_locked(self, q: float) -> float:
        return self.quantile_from(self._counts, self._n, self._max, q)

    def bucket_state(self) -> tuple:
        """(counts copy, n, sum, max) — the raw material window-delta
        consumers (the SLO watchdog's burn-rate evaluation) difference
        against a previous snapshot of the same histogram."""
        with self._l:
            return list(self._counts), self._n, self._sum, self._max

    def snapshot(self) -> dict:
        with self._l:
            if self._n == 0:
                return {"count": 0, "sum": 0.0, "max": 0.0,
                        "p50": 0.0, "p95": 0.0, "p99": 0.0}
            return {
                "count": self._n,
                "sum": round(self._sum, 3),
                "max": round(self._max, 3),
                "p50": self._quantile_locked(0.50),
                "p95": self._quantile_locked(0.95),
                "p99": self._quantile_locked(0.99),
            }


class Scope(collections.abc.Mapping):
    """One instrumented instance's metric namespace.

    Behaves as a read-only Mapping over its counter/gauge values (the
    shape every `stats` dict in the repo already had: `srv.stats
    ["bad_frames"]`, `dict(br.stats)`, `"flushes" in srv.stats` all keep
    working). Writers go through `inc`/`set`/`max`/`hist`. Histograms
    are NOT part of the mapping view — they surface in `snapshot()`s and
    `render()` only, so migrated stats dicts keep their exact key sets.
    """

    def __init__(self, registry: "Registry", prefix: str,
                 counters: dict | None = None):
        self._reg = registry
        self.prefix = prefix
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._order: list[str] = []
        # guarded-by: _counters, _gauges, _hists, _order
        self._l = threading.Lock()
        for k, v in (counters or {}).items():
            c = self.counter(k)
            if v:
                c.inc(v)

    # -- writer surface --

    def counter(self, name: str) -> Counter:
        with self._l:
            c = self._counters.get(name)
            if c is None:
                c = self._reg._register(f"{self.prefix}.{name}", Counter)
                self._counters[name] = c
                self._order.append(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._l:
            g = self._gauges.get(name)
            if g is None:
                g = self._reg._register(f"{self.prefix}.{name}", Gauge)
                self._gauges[name] = g
                self._order.append(name)
            return g

    def hist(self, name: str) -> Histogram:
        with self._l:
            h = self._hists.get(name)
            if h is None:
                h = self._reg._register(f"{self.prefix}.{name}", Histogram)
                self._hists[name] = h
            return h

    def hist_family(self, name: str, n: int) -> tuple:
        """A per-member histogram family (`{name}_s0` .. `{name}_s{n-1}`)
        — the per-shard `phase_*_us` surface of the mesh serving plane:
        one label axis, pre-resolved so the hot path indexes a tuple
        instead of paying the name->metric lookup per observation.
        Idempotent per (name, i): a second caller (shared `unique=False`
        scope) gets the same histograms back."""
        return tuple(self.hist(f"{name}_s{i}") for i in range(n))

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v) -> None:
        self.gauge(name).set(v)

    def max(self, name: str, v) -> None:
        self.gauge(name).max_update(v)

    def observe(self, name: str, v: float) -> None:
        self.hist(name).observe(v)

    # -- Mapping surface (counter/gauge values by short name) --

    def __getitem__(self, k: str):
        c = self._counters.get(k)
        if c is not None:
            return c.value
        g = self._gauges.get(k)
        if g is not None:
            return g.value
        raise KeyError(k)

    def __iter__(self):
        return iter(list(self._order))

    def __len__(self) -> int:
        return len(self._order)

    def __repr__(self) -> str:
        return f"Scope({self.prefix}, {dict(self)})"

    def snapshot(self) -> dict:
        return dict(self)


class Registry:
    """Process-wide metric/trace/event store. One lives at a time (the
    module singleton); `configure()` swaps in a fresh one — metric
    objects handed out by a PREVIOUS registry keep working (they are
    self-contained), they just stop being rendered.

    Instance scopes (`unique=True`) live for the REGISTRY's lifetime,
    deliberately: a dead server's final counters remain visible in
    snapshots (post-mortems read them), at the cost that a process
    churning many instrumented instances (a sweep constructing fresh
    KVs per cell) grows the namespace monotonically. Long-lived sweeps
    should `configure()` a fresh registry between cells — the swap is
    the release valve."""

    def __init__(self, config: TelemetryConfig | None = None):
        self.config = config or TelemetryConfig()
        # guarded-by: _metrics, _scope_seq, _last_dump, _programs
        self._l = threading.Lock()
        self._metrics: dict[str, object] = {}
        # program signatures already seen by the recompile tracker —
        # registry-scoped deliberately: a fresh registry re-arms the
        # tracker (tests/benches measure compiles from a clean slate).
        # (a dict used as a set: membership + item store only)
        self._programs: dict = {}
        self._scope_seq: collections.Counter = collections.Counter()
        self.ring: collections.deque = collections.deque(
            maxlen=self.config.ring_capacity)
        self._dump_seq = itertools.count()
        self._last_dump: dict[str, float] = {}
        self._rungs = Scope(self, "rung")
        # windowed time-series sink (`runtime/timeseries.py` attaches a
        # SeriesRing here): when present, snapshots ship the series tail
        # under `series` and flight dumps carry the TRAJECTORY into the
        # failure, not just the instant
        self.series_sink = None
        # device-time profiler attachment (`runtime/profiler.py`); None
        # keeps snapshots byte-identical to the v2 schema
        self.profile_sink = None
        self.dump_dir = self.config.dump_dir or os.environ.get(
            "PMDFC_TELEMETRY_DIR") or None

    # -- registration --

    def _register(self, fullname: str, kind):
        """Create-and-claim one metric. The no-collision assertion: a
        full name can be claimed once, ever — two instances that would
        shadow each other's counters fail loudly at construction (the
        stats-merge drift class of bug), not silently in a merged
        snapshot."""
        with self._l:
            if fullname in self._metrics:
                raise ValueError(
                    f"telemetry metric {fullname!r} already registered "
                    f"(scopes are per-instance; name collisions shadow "
                    f"counts)")
            m = kind()
            self._metrics[fullname] = m
            return m

    def scope(self, prefix: str, counters: dict | None = None,
              unique: bool = True) -> Scope:
        """A new metric namespace. `unique=True` (default) suffixes a
        per-prefix instance number (`net0`, `net1`, ...) so every
        instrumented instance owns its counters; `unique=False` returns
        the shared singleton scope for that prefix (process-wide metrics
        like the client verb latency histograms)."""
        if not unique:
            # constructed OUTSIDE the lock (analyzer lock-order fix: a
            # bare Scope() is lock-free, but its __init__ CAN re-enter
            # _register when seeded — building it under the held lock
            # was a self-deadlock edge in the static graph); the lock
            # only arbitrates which construction wins the singleton slot
            fresh = Scope(self, prefix)
            with self._l:
                m = self._metrics.get(f"scope:{prefix}")
                if m is None:
                    m = fresh
                    self._metrics[f"scope:{prefix}"] = m
                    seed = counters
                else:
                    seed = None  # lost the race: the winner seeds
            for k, v in (seed or {}).items():
                c = m.counter(k)
                if v:
                    c.inc(v)
            return m
        with self._l:
            n = self._scope_seq[prefix]
            self._scope_seq[prefix] += 1
        return Scope(self, f"{prefix}{n}", counters)

    def metric(self, fullname: str):
        """The live metric object registered under `fullname` (None when
        absent) — the SLO watchdog resolves its declared targets here."""
        with self._l:
            return self._metrics.get(fullname)

    # -- continuous profiling: jit program-cache miss tracking --

    def track_program(self, name: str, signature, detail=None) -> bool:
        """One dispatch-seam sighting of jit program `name` with
        `signature` (any hashable — typically (padded width, config)).
        First sighting per registry = a compile the process pays: bump
        the NAMED `recompile.<name>` counter and ring a `recompile`
        event. Returns True on that first sighting."""
        key = (name, signature)
        with self._l:
            if key in self._programs:
                return False
            self._programs[key] = True
        sc = self.scope("recompile", unique=False)
        sc.inc(name)
        sc.inc("programs")
        if _STATE.tracing:
            self.record({"kind": "recompile", "program": name,
                         "sig": str(detail if detail is not None
                                    else signature)[:120],
                         "t": time.time()})
        return True

    # -- spans / events / rungs --

    def record(self, rec: dict) -> None:
        self.ring.append(rec)

    def ring_tail(self, n: int | None = None) -> list:
        """Snapshot of the ring (last `n` records when given), tolerant
        of concurrent appends: deque iteration raises RuntimeError when
        a writer lands mid-copy — and consumers (flight dumps, the SLO
        watchdog's stage attribution) run exactly when traffic is live.
        Retry, then fall back to a bounded element-wise copy."""
        for _ in range(4):
            try:
                out = list(self.ring)
                return out[-n:] if n else out
            except RuntimeError:
                continue
        out = []
        try:
            for i in range(len(self.ring)):
                out.append(self.ring[i])
        except IndexError:
            pass
        return out[-n:] if n else out

    def rung(self, name: str, **detail) -> None:
        """One degradation-ladder rung fired. Counts it (always), records
        the event (when tracing), and dumps a flight snapshot (when a
        dump dir is configured and the rung's cooldown elapsed)."""
        self._rungs.inc(name)
        if _STATE.tracing:
            self.record({"kind": "rung", "rung": name, "t": time.time(),
                         **detail})
        if self.dump_dir is None or not _STATE.tracing:
            return
        now = time.monotonic()
        with self._l:
            last = self._last_dump.get(name, -1e18)
            if now - last < self.config.dump_min_interval_s:
                return
            self._last_dump[name] = now
            seq = next(self._dump_seq)
        try:
            self._dump(name, detail, seq)
        except OSError:
            pass  # a full disk must never take down the serving path

    def dump_now(self, name: str = "manual", **detail) -> str | None:
        """Write one flight dump on demand — no rung, no cooldown (the
        tracetool workflow: capture the ring right after the op of
        interest). None when no dump dir is configured or the tracing
        tier is off."""
        if self.dump_dir is None or not _STATE.tracing:
            return None
        with self._l:
            seq = next(self._dump_seq)
        try:
            return self._dump(name, detail, seq)
        except OSError:
            return None

    def _dump(self, rung_name: str, detail: dict, seq: int) -> str:
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(self.dump_dir,
                            f"flight_{rung_name}_{seq:05d}.json")
        doc = {
            "schema": "pmdfc-flight-v2",
            "rung": rung_name,
            "detail": detail,
            "ts_unix": time.time(),
            "telemetry": self.snapshot(),
            "records": self.ring_tail(self.config.dump_records),
        }
        if self.series_sink is not None:
            # the windowed series tail: a rung dump shows the rate/
            # quantile TRAJECTORY into the failure (the snapshot above
            # already embeds the same tail; duplicated at top level so
            # flight consumers need not know the v2 snapshot layout)
            doc["series"] = self.series_sink.snapshot()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        self._rotate_dumps()
        return path

    def _rotate_dumps(self) -> None:
        """Cap retained `flight_*.json` files (oldest-first deletion):
        the cooldown limits write RATE, this bounds file COUNT — a long
        soak with a firing rung must not fill the disk."""
        cap = self.config.dump_max_files
        if not cap:
            return
        try:
            names = [n for n in os.listdir(self.dump_dir)
                     if n.startswith("flight_") and n.endswith(".json")]
            if len(names) <= cap:
                return
            paths = [os.path.join(self.dump_dir, n) for n in names]
            paths.sort(key=lambda p: (os.path.getmtime(p), p))
            for p in paths[:len(paths) - cap]:
                os.remove(p)
        except OSError:
            pass  # rotation is best-effort, like the dump itself

    # -- export --

    def snapshot(self) -> dict:
        """JSON-safe registry snapshot — the wire form (`MSG_STATS`
        ships it under the `telemetry` key; `tools/teledump.py` pulls
        it; `tools/check_teledump.py` pins this schema)."""
        with self._l:
            items = list(self._metrics.items())
        counters, gauges, hists = {}, {}, {}
        for name, m in items:
            if isinstance(m, Counter):
                counters[name] = m.value
            elif isinstance(m, Gauge):
                v = m.value
                gauges[name] = v if isinstance(v, (int, float)) else str(v)
            elif isinstance(m, Histogram):
                hists[name] = m.snapshot()
        doc = {
            # v2 = v1 + the optional windowed `series` block below; every
            # v1 field keeps its exact shape, so v1 consumers parse v2
            # documents unchanged (and check_teledump accepts both)
            "schema": "pmdfc-telemetry-v2",
            "enabled": _STATE.tracing,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "ring": {"len": len(self.ring),
                     "capacity": self.config.ring_capacity},
        }
        if self.series_sink is not None:
            doc["series"] = self.series_sink.snapshot()
        if self.profile_sink is not None:
            # additive v3: the device-time profile block only exists
            # when a profiler attached (PMDFC_PROF) — with it off the
            # document stays byte-identical v2
            doc["schema"] = "pmdfc-telemetry-v3"
            doc["profile"] = self.profile_sink.snapshot()
        return doc

    def render(self) -> str:
        return render_snapshot(self.snapshot())


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() else "_" for c in name)
    return f"pmdfc_{out}"


# per-shard metric families rendered as REAL labels: the mesh plane's
# histogram families are name-suffixed (`phase_get_us_s3`) and its
# routed-op counters positional (`mesh.shard3_ops`); a stock scraper
# wants `pmdfc_mesh_phase_get_us{shard="3"}` so the shard is an
# aggregatable label axis, not N distinct series names
_FAM_HIST = re.compile(r"^(?P<base>.+)_s(?P<shard>\d+)$")
_FAM_CTR = re.compile(r"^(?P<base>.+\.)shard(?P<shard>\d+)_ops$")


def _shard_family(name: str, kind: str):
    """(base_name, shard_label) when `name` is one member of a per-shard
    family, else None."""
    m = (_FAM_CTR if kind == "counter" else _FAM_HIST).match(name)
    if m is None:
        return None
    base = (m.group("base") + "shard_ops" if kind == "counter"
            else m.group("base"))
    return base, m.group("shard")


def render_snapshot(snap: dict) -> str:
    """Prometheus-style text exposition of a `snapshot()` dict (local or
    pulled over the wire — `tools/teledump.py --format prom`).

    Per-shard families additionally render with a real `shard` label
    (`pmdfc_mesh_phase_get_us{shard="3",quantile="p95"}`) so teledump
    output ingests into a stock scraper; the raw suffixed names remain
    as a DEPRECATED one-release alias for existing dashboards. Labeled
    families are accumulated and emitted as CONTIGUOUS groups after the
    legacy lines — the text format requires all samples of one metric
    to form a single block, and interleaving them with the suffixed
    aliases would make strict ingesters reject the whole exposition."""
    lines = []
    typed: set[str] = set()
    # family name -> (prom type, [sample lines]) — flushed at the end so
    # each family's samples stay one contiguous group
    fams: dict[str, tuple] = {}

    def _type(n: str, kind: str) -> None:
        if n not in typed:
            typed.add(n)
            lines.append(f"# TYPE {n} {kind}")

    def _fam(n: str, kind: str) -> list:
        return fams.setdefault(n, (kind, []))[1]

    for name, v in sorted(snap.get("counters", {}).items()):
        n = _prom_name(name)
        _type(n, "counter")
        lines.append(f"{n} {v}")
        fam = _shard_family(name, "counter")
        if fam is not None:
            _fam(_prom_name(fam[0]), "counter").append(
                f'{_prom_name(fam[0])}{{shard="{fam[1]}"}} {v}')
    for name, v in sorted(snap.get("gauges", {}).items()):
        n = _prom_name(name)
        _type(n, "gauge")
        lines.append(f"{n} {v}")
    for name, h in sorted(snap.get("histograms", {}).items()):
        n = _prom_name(name)
        _type(n, "summary")
        lines.append(f"{n}_count {h['count']}")
        lines.append(f"{n}_sum {h['sum']}")
        for q in ("p50", "p95", "p99"):
            lines.append(f'{n}{{quantile="{q}"}} {h[q]}')
        fam = _shard_family(name, "hist")
        if fam is not None:
            fn = _prom_name(fam[0])
            label = f'shard="{fam[1]}"'
            out = _fam(fn, "summary")
            out.append(f"{fn}_count{{{label}}} {h['count']}")
            out.append(f"{fn}_sum{{{label}}} {h['sum']}")
            for q in ("p50", "p95", "p99"):
                out.append(f'{fn}{{{label},quantile="{q}"}} {h[q]}')
    for fn in sorted(fams):
        kind, samples = fams[fn]
        _type(fn, kind)
        lines.extend(samples)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# module singleton + hot-path gates
# ---------------------------------------------------------------------------


class _State:
    __slots__ = ("registry", "tracing")

    def __init__(self):
        self.registry: Registry | None = None
        # resolved at first use / configure(); the ONE flag every hot
        # path checks (module attr load + bool test — the "compiles to
        # no-ops" guarantee)
        self.tracing = True


_STATE = _State()
# guarded-by: <none>  (double-checked singleton boot: `configure()`'s
# registry swap is a deliberate lock-free last-write-wins)
_BOOT_LOCK = threading.Lock()

# 32-bit nonzero trace ids: a seeded-random base + atomic counter.
# `itertools.count().__next__` is GIL-atomic, so minting needs no lock.
_TRACE_CTR = itertools.count(
    int.from_bytes(os.urandom(4), "little") or 1)
# span ids share the format but not the sequence: a span id names one
# timed tree node inside THIS process; the trace id is the cross-process
# correlation key that rides the wire
_SPAN_CTR = itertools.count(
    int.from_bytes(os.urandom(4), "little") or 1)


class _SpanTls(threading.local):
    """Per-thread ambient span stack: `span_begin` pushes, `span_end`
    pops, and a child begun without an explicit parent inherits the
    top — so a callee's span nests under its caller's with zero
    plumbing (the replica attempt → wire verb nesting)."""

    def __init__(self):
        self.stack: list = []


_SPAN_TLS = _SpanTls()


class Span:
    """One open timed tree node (see `span_begin`). Falsy-safe: hot
    paths hold None when tracing is off and `span_end(None)` no-ops."""

    __slots__ = ("sid", "parent", "trace", "src", "op", "t0", "attrs",
                 "ambient")

    def __init__(self, sid, parent, trace, src, op, t0, attrs, ambient):
        self.sid = sid
        self.parent = parent
        self.trace = trace
        self.src = src
        self.op = op
        self.t0 = t0
        self.attrs = attrs
        self.ambient = ambient


def get() -> Registry:
    reg = _STATE.registry
    if reg is None:
        with _BOOT_LOCK:
            reg = _STATE.registry
            if reg is None:
                reg = Registry(TelemetryConfig(
                    enabled=telemetry_enabled()))
                _STATE.tracing = reg.config.enabled
                _STATE.registry = reg
    return reg


def configure(config: TelemetryConfig | None = None) -> Registry:
    """Install a FRESH registry (tests/benches: isolates the ring and
    the metric namespace). The env kill switch still wins: with
    `PMDFC_TELEMETRY=off` in the environment, tracing stays off no
    matter what the config says."""
    cfg = config or TelemetryConfig(enabled=telemetry_enabled())
    reg = Registry(cfg)
    _STATE.tracing = telemetry_enabled(default=cfg.enabled)
    _STATE.registry = reg
    return reg


def enabled() -> bool:
    """Is the tracing tier live? (Counters/gauges count regardless.)"""
    get()
    return _STATE.tracing


def set_enabled(on: bool) -> None:
    """Flip the tracing tier LIVE — spans, histograms, ring appends and
    dumps all honor the flag on their next call, across every existing
    scope and connection (traced connections simply mint no ids while
    off). The in-process form of the kill switch: operators drop the
    tracing tax under pressure without reconnecting anything, and the
    overhead bench measures on/off over identical infrastructure."""
    get()
    _STATE.tracing = bool(on)


def scope(prefix: str, counters: dict | None = None,
          unique: bool = True) -> Scope:
    return get().scope(prefix, counters, unique=unique)


def mint_trace() -> int:
    """A 32-bit nonzero trace id (0 on the wire = untraced)."""
    t = next(_TRACE_CTR) & 0xFFFFFFFF
    return t if t else 1


def mint_span() -> int:
    """A 32-bit nonzero span id (process-local tree-node identity)."""
    t = next(_SPAN_CTR) & 0xFFFFFFFF
    return t if t else 1


def current_trace() -> int:
    """The ambient trace id (innermost open span carrying one), 0 when
    none: a lower layer joins the op ALREADY in flight — the wire verb
    under a replica attempt reuses the group op's trace, so the whole
    walk shares one cross-process correlation key."""
    for sp in reversed(_SPAN_TLS.stack):
        if sp.trace:
            return sp.trace
    return 0


def span_begin(src: str, op: str, trace: int = 0,
               parent: int | None = None, ambient: bool = True,
               t0_ns: int | None = None, **attrs) -> Span | None:
    """Open one timed tree node. Returns None when the tracing tier is
    off (callers pass the handle straight to `span_end`, which no-ops
    on None).

    `parent=None` inherits the calling thread's ambient top (0 = root);
    pass an explicit parent id for cross-thread children (a server op
    span begun in a reader thread, closed by the flush loop — those
    also set `ambient=False` so the begin thread's stack is untouched).
    `t0_ns` backdates the start (queue-wait spans open at staging
    time)."""
    if not _STATE.tracing:
        return None
    if parent is None:
        stack = _SPAN_TLS.stack
        parent = stack[-1].sid if stack else 0
    sp = Span(mint_span(), parent, trace, src, op,
              t0_ns if t0_ns is not None else time.monotonic_ns(),
              attrs, ambient)
    if ambient:
        _SPAN_TLS.stack.append(sp)
    return sp


def span_end(span: Span | None, ok: bool = True,
             t1_ns: int | None = None, **extra) -> None:
    """Close a tree node and ring its completed record. The record
    carries BOTH the tree fields (span/parent/t0_ns/t1_ns) and the flat
    PR-5 fields (src/op/trace/ok/t/dur_us), so every existing consumer
    of flat spans keeps working on v2 rings."""
    if span is None:
        return
    if span.ambient:
        stack = _SPAN_TLS.stack
        if stack and stack[-1] is span:
            stack.pop()
        else:  # out-of-order end (error unwind): remove, don't corrupt
            try:
                stack.remove(span)
            except ValueError:
                pass
    if not _STATE.tracing:
        return  # toggled off mid-span: unwind the stack, record nothing
    t1 = t1_ns if t1_ns is not None else time.monotonic_ns()
    rec = {"kind": "span", "src": span.src, "op": span.op,
           "trace": span.trace, "span": span.sid, "parent": span.parent,
           "ok": bool(ok), "t": time.time(),
           "t0_ns": span.t0, "t1_ns": t1,
           "dur_us": round((t1 - span.t0) / 1e3, 1)}
    if span.attrs:
        rec.update(span.attrs)
    if extra:
        rec.update(extra)
    get().record(rec)


def record_tree_span(src: str, op: str, trace: int, parent: int,
                     t0_ns: int, t1_ns: int, ok: bool = True,
                     **attrs) -> None:
    """One COMPLETED tree node straight into the ring — the lean form of
    a `span_begin`/`span_end` pair for spans whose endpoints were both
    measured out-of-band (the flush loop's per-op queue-wait/phase
    children: same v2 record shape, no Span allocation, no ambient-stack
    traffic — this path runs per op per flush on the serving tier)."""
    if not _STATE.tracing:
        return
    rec = {"kind": "span", "src": src, "op": op, "trace": trace,
           "span": mint_span(), "parent": parent, "ok": ok,
           "t": time.time(), "t0_ns": t0_ns, "t1_ns": t1_ns,
           "dur_us": round((t1_ns - t0_ns) / 1e3, 1)}
    if attrs:
        rec.update(attrs)
    get().record(rec)


def unwind_ambient(ok: bool = False, **extra) -> None:
    """Close every span still open on THIS thread's ambient stack — the
    error-unwind for a long-lived serving loop's catch-all: a leaked
    ambient node would silently mis-parent every later span the thread
    records, corrupting all future trees, which is strictly worse than
    closing the orphans as failed."""
    stack = _SPAN_TLS.stack
    while stack:
        span_end(stack[-1], ok=ok, **extra)


def record_span(src: str, op: str, trace: int, ok: bool,
                dur_us: float | None = None, **extra) -> None:
    """One-shot span record into the ring (no begin/end bracket — used
    where the duration was measured out-of-band). Mints a span id and
    parents off the ambient stack like `span_begin`, so one-shot spans
    still land in the tree. `src` ∈ {client, server, group}; `trace`
    0 = untraced peer."""
    if not _STATE.tracing:
        return
    stack = _SPAN_TLS.stack
    rec = {"kind": "span", "src": src, "op": op, "trace": trace,
           "span": mint_span(),
           "parent": stack[-1].sid if stack else 0,
           "ok": bool(ok), "t": time.time()}
    if dur_us is not None:
        rec["dur_us"] = round(dur_us, 1)
    if extra:
        rec.update(extra)
    get().record(rec)


def clock_event(conn: int, offset_ns: int, rtt_ns: int) -> None:
    """Ring one clock-sync record: `offset_ns` maps the PEER's
    monotonic clock into this process's (peer_t - offset = local_t),
    estimated from the HOLA/HOLASI exchange (server stamp vs the
    midpoint of the client's send/recv). `tools/tracetool.py` uses it
    to place server spans on the client timeline."""
    if not _STATE.tracing:
        return
    get().record({"kind": "clock", "conn": conn,
                  "offset_ns": int(offset_ns), "rtt_ns": int(rtt_ns),
                  "t": time.time()})


# -- continuous profiling ---------------------------------------------------

def track_program(name: str, signature, detail=None) -> bool:
    """Report one dispatch with program `name` and `signature` (any
    hashable; typically (padded width, config)). First sighting per
    registry = a compile: bumps `recompile.<name>` + `recompile.
    programs` and rings a `recompile` event. Gated by the tracing tier
    — with telemetry off the call is one flag test."""
    if not _STATE.tracing:
        return False
    return get().track_program(name, signature, detail)


def record_event(kind: str, **fields) -> None:
    if not _STATE.tracing:
        return
    get().record({"kind": kind, "t": time.time(), **fields})


def rung(name: str, **detail) -> None:
    get().rung(name, **detail)


def dump_now(name: str = "manual", **detail) -> str | None:
    return get().dump_now(name, **detail)


def snapshot() -> dict:
    return get().snapshot()


def render() -> str:
    return get().render()
