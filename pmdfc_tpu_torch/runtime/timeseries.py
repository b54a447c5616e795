"""Windowed time-series over the telemetry registry — rates, not totals.

The registry (`runtime/telemetry.py`) answers "how many, ever" and "what
does the lifetime latency distribution look like". Operating a serving
fleet needs the OTHER question — "what is the workload doing *right
now*" — and RDMAbox (arxiv 2104.12197) argues batched remote-memory
stacks need that per-stage *rate* visibility before any self-tuning
controller can exist. This module is the one windowing convention the
repo uses for it:

- **`DeltaTracker`** — the window-delta primitive: per-metric previous
  snapshots keyed on the metric OBJECT's identity (a `configure()` swap
  or a rebuilt instance re-arms cleanly — the first sight of a new
  object yields no window, never a garbage delta against a stranger's
  counts). Counter windows are value deltas; histogram windows are
  log2-bucket-count deltas whose quantiles come from the SAME
  `Histogram.quantile_from` walk the live snapshots use. The SLO
  watchdog (`runtime/slo.py`) evaluates its burn windows on this
  tracker — one windowing convention, not a private fork.
- **`SeriesRing`** — a fixed-capacity ring of completed windows. Memory
  is bounded by `capacity × live-metric-count`: each window stores only
  the counters that MOVED and the histograms that OBSERVED during the
  window, so an idle fleet's ring costs almost nothing.
- **`Collector`** — the low-duty sampler: one daemon thread (or
  deterministic `tick()` calls from tests) differences the whole
  registry every `interval_s` and appends one window to the ring. The
  ring is attached to the registry (`Registry.series_sink`), so
  `telemetry.snapshot()` ships the series tail over `MSG_STATS`
  (`pmdfc-telemetry-v2`) and every flight dump carries the trajectory
  INTO the failure, not just the instant. The thread self-terminates
  when its registry stops being the live one (a `configure()` swap
  mid-soak cannot leak collectors).

Window record shape (the `series` schema `tools/check_teledump.py`
pins):

    {"t": <unix time at window close>, "dt_s": <window length>,
     "counters": {fullname: delta, ...},          # only nonzero deltas
     "gauges": {fullname: value, ...},            # sampled levels
     "hists": {fullname: {"count": dn, "sum": dsum,
                          "p50": .., "p95": .., "p99": ..}, ...}}

Everything rides the PR-5 kill switch: with the tracing tier off,
`Collector.tick()` early-outs and the ring stays empty.
"""

from __future__ import annotations

import collections
import threading
import time

from pmdfc_tpu_torch.runtime import telemetry as tele

# one collector per registry: `ensure_collector` parks its instance on
# the registry object itself, so two servers in one process share one
# sampler instead of double-differencing the same counters
_SINK_ATTR = "series_sink"
_COLLECTOR_ATTR = "_series_collector"


class DeltaTracker:
    """Per-metric window deltas keyed on metric object identity.

    NOT thread-safe by itself — each consumer owns one tracker and
    serializes its own calls (the collector ticks from one thread; the
    SLO watchdog calls under its own lock). Two consumers never share a
    tracker: windows are defined by the CALLER's tick cadence.
    """

    def __init__(self):
        self._prev: dict[str, tuple] = {}

    def counter_window(self, name: str, c) -> int | None:
        """Delta of counter `c` since this tracker last saw it under
        `name`; None on first sight (or when the underlying object was
        replaced — no window exists yet)."""
        v = c.value
        prev = self._prev.get(name)
        self._prev[name] = (id(c), v)
        if prev is None or prev[0] != id(c):
            return None
        return v - prev[1]

    def hist_window(self, name: str, h) -> tuple | None:
        """(dcounts, dn, dsum, vmax) for histogram `h`'s window since
        the last sight, or None (first sight / replaced object). `vmax`
        is the LIFETIME max — the same conservative clip the live
        snapshot's quantile walk uses."""
        counts, n, s, vmax = h.bucket_state()
        prev = self._prev.get(name)
        self._prev[name] = (id(h), counts, n, s)
        if prev is None or prev[0] != id(h):
            return None
        dcounts = [c - p for c, p in zip(counts, prev[1])]
        return dcounts, n - prev[2], s - prev[3], vmax

    def window_quantiles(self, name: str, h) -> dict | None:
        """One histogram window as the series-record dict (None when no
        window or nothing observed) — the ONE log2-bucket convention
        (`Histogram.quantile_from`) applied to the window's deltas."""
        w = self.hist_window(name, h)
        if w is None:
            return None
        dcounts, dn, dsum, vmax = w
        if dn <= 0:
            return None
        q = tele.Histogram.quantile_from
        return {
            "count": dn,
            "sum": round(dsum, 3),
            "p50": q(dcounts, dn, vmax, 0.50),
            "p95": q(dcounts, dn, vmax, 0.95),
            "p99": q(dcounts, dn, vmax, 0.99),
        }


class SeriesRing:
    """Fixed-capacity ring of completed windows (thread-safe appends and
    snapshots — dump writers and the collector race by design)."""

    def __init__(self, capacity: int = 120, interval_s: float = 1.0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.interval_s = interval_s
        self._windows: collections.deque = collections.deque(
            maxlen=capacity)
        self._l = threading.Lock()  # guarded-by: _windows

    def push(self, window: dict) -> None:
        with self._l:
            self._windows.append(window)

    def tail(self, n: int | None = None) -> list:
        with self._l:
            out = list(self._windows)
        return out[-n:] if n else out

    def __len__(self) -> int:
        with self._l:
            return len(self._windows)

    def snapshot(self, n: int | None = None) -> dict:
        """The JSON form `telemetry.snapshot()` ships under `series`."""
        return {"interval_s": self.interval_s,
                "capacity": self.capacity,
                "windows": self.tail(n)}


class Collector:
    """Low-duty registry sampler: one `tick()` differences every live
    counter/gauge/histogram against the previous tick and appends one
    window to the ring. Drive deterministically (`tick()`) or as a
    daemon (`start()`/`stop()`); the daemon self-terminates when its
    registry is no longer the live one."""

    def __init__(self, interval_s: float = 1.0, capacity: int = 120,
                 registry=None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self._reg = registry if registry is not None else tele.get()
        self.ring = SeriesRing(capacity, interval_s)
        self.interval_s = interval_s
        self._tracker = DeltaTracker()
        self._t_prev = time.monotonic()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # guarded-by: _thread, _t_prev, _tracker
        self._l = threading.Lock()
        setattr(self._reg, _SINK_ATTR, self.ring)

    # -- sampling --

    def tick(self) -> dict | None:
        """Close one window now. Returns the appended window (None when
        the tracing tier is off — rates are diagnostics, and the off
        lane must stay an early-out). Serialized on the collector lock:
        a deterministic test/driver tick racing the daemon's must not
        interleave the tracker's read-then-store (the same movement
        would be counted into BOTH windows)."""
        if not tele.enabled():
            return None
        reg = self._reg
        with reg._l:
            items = list(reg._metrics.items())
        with self._l:
            now_m = time.monotonic()
            dt = now_m - self._t_prev
            self._t_prev = now_m
            counters: dict = {}
            gauges: dict = {}
            hists: dict = {}
            tr = self._tracker
            for name, m in items:
                if isinstance(m, tele.Counter):
                    d = tr.counter_window(name, m)
                    if d:  # only movement is worth a window slot
                        counters[name] = d
                elif isinstance(m, tele.Gauge):
                    v = m.value
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        gauges[name] = v
                elif isinstance(m, tele.Histogram):
                    q = tr.window_quantiles(name, m)
                    if q is not None:
                        hists[name] = q
            window = {"t": time.time(), "dt_s": round(dt, 6),
                      "counters": counters, "gauges": gauges,
                      "hists": hists}
            self.ring.push(window)
        return window

    # -- lifecycle --

    def start(self) -> "Collector":
        with self._l:
            if self._thread is not None:
                return self
            th = threading.Thread(target=self._loop, daemon=True,
                                  name="telemetry-series")
            self._thread = th
        th.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            # a configure() swap orphans this collector: exit instead of
            # differencing a dead registry forever
            if tele._STATE.registry is not self._reg:
                return
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — diagnostics must outlive
                pass           # any single bad sample

    def stop(self) -> None:
        self._stop.set()
        with self._l:
            th = self._thread
            self._thread = None
        if th is not None:
            th.join(timeout=5)
        self._stop = threading.Event()

    def __enter__(self) -> "Collector":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def ensure_collector(interval_s: float = 1.0,
                     capacity: int = 120) -> Collector:
    """The live registry's collector, started — idempotent per registry
    (two NetServers in one process share one sampler). The first caller
    picks the cadence; later callers get the existing instance back."""
    reg = tele.get()
    col = getattr(reg, _COLLECTOR_ATTR, None)
    if col is None:
        col = Collector(interval_s=interval_s, capacity=capacity,
                        registry=reg)
        setattr(reg, _COLLECTOR_ATTR, col)
    return col.start()


def series_tail(n: int | None = None) -> list:
    """The live registry's series tail ([] when no collector attached) —
    what flight dumps embed next to the event-ring tail."""
    sink = getattr(tele.get(), _SINK_ATTR, None)
    return sink.tail(n) if sink is not None else []
