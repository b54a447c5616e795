"""SLO watchdog — declarative targets over the telemetry registry.

The serving plane's whole value proposition is tail behavior under
fan-in, so "is the tail okay" must be a DECLARED, machine-checked
property, not a dashboard squint. `SloWatchdog` evaluates a set of
`SloTarget`s against the live metrics registry on a burn-rate window:

- **latency_p99** — a histogram's p99 over the WINDOW (delta of the
  log2 bucket counts since the previous tick, not the lifetime
  distribution: a breach must show up while it is happening, and an
  hour of healthy traffic must not bury a bad minute) must stay at or
  under `threshold` (same unit as the histogram, typically µs).
- **ratio_min** — counter(metric) / counter(denominator) over the
  window must stay ≥ `threshold` (hit-rate floors).
- **ratio_max** — the same ratio must stay ≤ `threshold` (error-rate
  ceilings).

A window with fewer than `min_count` observations is STARVED and
leaves the burn state untouched (no traffic is neither compliance nor
violation). A target in violation for `burn_windows` CONSECUTIVE
evaluated windows BREACHES: the watchdog fires the `slo_breach`
flight-recorder rung — which writes an attributable dump when a dump
dir is configured — naming the violating STAGE from the trace data
(the ring's recent span tree: queue wait vs flush phase vs shard
program vs wire), so "p99 blew the target" arrives already pointing at
the stage that grew.

Config is declarative and JSON-friendly (`SloConfig.from_dict`):

    {"window_s": 5.0, "burn_windows": 2, "min_count": 16,
     "targets": [
       {"name": "get_p99", "kind": "latency_p99",
        "metric": "net.client.get_us", "threshold": 50000},
       {"name": "hit_rate", "kind": "ratio_min", "threshold": 0.9,
        "metric": "kv0.gets_found", "denominator": "kv0.gets"},
       {"name": "serve_errors", "kind": "ratio_max", "threshold": 0.01,
        "metric": "net0.serve_errors", "denominator": "net0.ops"}]}

Drive it with `tick()` (deterministic — tests and external schedulers)
or `start()`/`stop()` (a daemon thread ticking every `window_s`).
Everything rides the PR-5 kill switch: with the tracing tier off the
histograms don't fill and `tick()` early-outs.

Window deltas come from the shared `timeseries.DeltaTracker` — the ONE
windowing convention the series collector also samples with — so "a
window" means the same thing to the watchdog's burn state and to the
series ring a flight dump ships.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from pmdfc_tpu_torch.runtime import sanitizer as san
from pmdfc_tpu_torch.runtime import telemetry as tele
from pmdfc_tpu_torch.runtime import timeseries

_KINDS = ("latency_p99", "ratio_min", "ratio_max")


@dataclasses.dataclass(frozen=True)
class SloTarget:
    """One declared objective over a registry metric (full names, e.g.
    `net.client.get_us` — histogram for latency kinds, numerator
    counter plus `denominator` counter for ratio kinds)."""

    name: str
    kind: str
    metric: str
    threshold: float
    denominator: str | None = None

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r} "
                             f"(one of {_KINDS})")
        if self.kind != "latency_p99" and not self.denominator:
            raise ValueError(f"{self.kind} target {self.name!r} needs a "
                             "denominator counter")
        if self.threshold < 0:
            raise ValueError("threshold must be >= 0")


@dataclasses.dataclass(frozen=True)
class SloConfig:
    targets: tuple = ()
    window_s: float = 5.0
    burn_windows: int = 2
    min_count: int = 16

    def __post_init__(self) -> None:
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")
        if self.burn_windows < 1:
            raise ValueError("burn_windows must be >= 1")
        if self.min_count < 1:
            raise ValueError("min_count must be >= 1")

    @classmethod
    def from_dict(cls, d: dict) -> "SloConfig":
        """The JSON form (see module docstring) -> a validated config."""
        return cls(
            targets=tuple(SloTarget(**t) for t in d.get("targets", ())),
            window_s=float(d.get("window_s", 5.0)),
            burn_windows=int(d.get("burn_windows", 2)),
            min_count=int(d.get("min_count", 16)),
        )


def attribute_stage(records) -> tuple[str, dict]:
    """(dominant stage, per-stage total µs) over recent span records —
    the trace-data half of a breach report.

    Ranks only DISJOINT stage buckets, or a containing span would
    always win over its children: per-op `phase` spans are skipped
    entirely (each is one op's view of the SAME shared flush window —
    counting them would multiply the flush total by the op count), and
    the shared `flush:<ph>` span is charged only its EXCLUSIVE time
    (flush wall minus its shard_program children), so a breach whose
    bulk is one slow shard program names `shardN:<ph>`, not the flush
    that merely contains it. Profiler device spans (src "prof",
    op "device") get their own `device:<ph>` bucket and also count
    toward the flush subtraction — they ring only on paths WITHOUT
    shard_program children (kv/engine fetches), so the two never
    double-subtract. Falls back to the wire/op spans when no
    stage-level spans are in the ring (client-only process), and to
    "unknown" on an empty ring."""
    totals: dict[str, float] = {}
    flush_tot: dict[str, float] = {}
    shard_by_phase: dict[str, float] = {}
    fallback: dict[str, float] = {}
    for r in records:
        if r.get("kind") != "span":
            continue
        dur = r.get("dur_us")
        if dur is None:
            continue
        op = r.get("op", "")
        if op == "queue_wait":
            totals["queue_wait"] = totals.get("queue_wait", 0.0) + dur
        elif op.startswith("flush:"):
            ph = r.get("phase", op.split(":", 1)[-1])
            flush_tot[ph] = flush_tot.get(ph, 0.0) + dur
        elif op == "phase":
            continue  # per-op view of the shared flush span: skip
        elif op == "shard_program":
            ph = r.get("phase", "?")
            st = f"shard{r.get('shard', '?')}:{ph}"
            totals[st] = totals.get(st, 0.0) + dur
            shard_by_phase[ph] = shard_by_phase.get(ph, 0.0) + dur
        elif op == "device":
            ph = r.get("phase", "?")
            st = f"device:{ph}"
            totals[st] = totals.get(st, 0.0) + dur
            shard_by_phase[ph] = shard_by_phase.get(ph, 0.0) + dur
        elif r.get("src") in ("client", "server"):
            k = f"{r['src']}:{op or '?'}"
            fallback[k] = fallback.get(k, 0.0) + dur
    for ph, tot in flush_tot.items():
        totals[f"flush:{ph}"] = max(0.0,
                                    tot - shard_by_phase.get(ph, 0.0))
    table = {k: v for k, v in totals.items() if v > 0} or fallback
    if not table:
        return "unknown", {}
    top = max(table, key=table.get)
    return top, {k: round(v, 1) for k, v in sorted(
        table.items(), key=lambda kv: -kv[1])[:8]}


class SloWatchdog:
    """Burn-rate evaluator over the live registry (see module doc).

    Resolves the registry at every tick (`telemetry.get()`), so a
    `configure()` swap mid-soak re-arms cleanly; per-target window
    state keys on the metric OBJECT identity and resets when the
    underlying metric is replaced with it."""

    def __init__(self, config: SloConfig):
        self.config = config
        # guarded-by: _tracker, _burn, _thread
        self._lock = san.lock("SloWatchdog._lock")
        # the ONE windowing convention (`timeseries.DeltaTracker`):
        # counter/histogram window deltas keyed on metric object
        # identity, quantiles from the shared `Histogram.quantile_from`
        # walk — the watchdog's burn windows and the series collector's
        # ring windows cannot drift apart
        self._tracker = timeseries.DeltaTracker()
        self._burn: dict[str, int] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.stats = tele.scope("slo", {
            "ticks": 0, "evaluations": 0, "starved_windows": 0,
            "violations": 0, "breaches": 0})

    # -- evaluation --

    # caller-holds: _lock
    def _window_value(self, t: SloTarget):
        """(value, window count) for one target's CURRENT window, or
        None when the metric is absent or no window exists yet, or
        "starved" below `min_count` observations. Window deltas come
        from the shared `timeseries.DeltaTracker` (callers hold
        `_lock`); a replaced metric object re-arms with no window, never
        a garbage delta."""
        reg = tele.get()
        if t.kind == "latency_p99":
            h = reg.metric(t.metric)
            if not isinstance(h, tele.Histogram):
                return None
            w = self._tracker.hist_window(f"h:{t.name}", h)
            if w is None:
                return None  # first sight of this histogram: no window
            dcounts, dn, _, hmax = w
            if dn < self.config.min_count:
                return "starved"
            # p99 over the WINDOW's bucket deltas — the shared
            # Histogram walk (upper bound clipped to the lifetime max)
            return (tele.Histogram.quantile_from(dcounts, dn, hmax,
                                                 0.99), dn)
        num = reg.metric(t.metric)
        den = reg.metric(t.denominator)
        if not isinstance(num, tele.Counter) \
                or not isinstance(den, tele.Counter):
            return None
        dnum = self._tracker.counter_window(f"rn:{t.name}", num)
        dden = self._tracker.counter_window(f"rd:{t.name}", den)
        if dnum is None or dden is None:
            return None
        if dden < self.config.min_count:
            return "starved"
        return (dnum / dden, dden)

    def tick(self) -> list[dict]:
        """Evaluate every target over the window since the last tick;
        returns the breaches fired (empty = healthy). Rungs fire
        OUTSIDE the lock — a breach dump is file IO and must never
        convoy the next tick behind it."""
        if not tele.enabled():
            return []
        self.stats.inc("ticks")
        breaches = []
        with self._lock:
            for t in self.config.targets:
                wv = self._window_value(t)
                if wv is None:
                    continue
                if wv == "starved":
                    self.stats.inc("starved_windows")
                    continue
                value, count = wv
                self.stats.inc("evaluations")
                violated = (
                    value > t.threshold if t.kind in ("latency_p99",
                                                      "ratio_max")
                    else value < t.threshold)
                if not violated:
                    self._burn[t.name] = 0
                    continue
                self.stats.inc("violations")
                burn = self._burn.get(t.name, 0) + 1
                if burn < self.config.burn_windows:
                    self._burn[t.name] = burn
                    continue
                self._burn[t.name] = 0  # re-arm after firing
                breaches.append({"target": t, "value": value,
                                 "count": count})
        for b in breaches:
            t = b["target"]
            stage, stages = attribute_stage(tele.get().ring_tail())
            self.stats.inc("breaches")
            tele.rung("slo_breach", target=t.name, kind=t.kind,
                      metric=t.metric, threshold=t.threshold,
                      value=round(float(b["value"]), 4),
                      window_count=int(b["count"]),
                      burn_windows=self.config.burn_windows,
                      stage=stage, stages=stages)
        return breaches

    # -- lifecycle --

    def start(self) -> "SloWatchdog":
        with self._lock:
            if self._thread is not None:
                return self
            th = threading.Thread(target=self._loop, daemon=True,
                                  name="slo-watchdog")
            self._thread = th
        th.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.config.window_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the watchdog must outlive
                pass           # any single bad tick (it is diagnostics)

    def stop(self) -> None:
        """Stop the background thread. Restartable: a later `start()`
        spawns a fresh thread (a soak harness stops the watchdog around
        a reconfigure and brings it back)."""
        self._stop.set()
        with self._lock:
            th = self._thread
            self._thread = None
        if th is not None:
            th.join(timeout=5)
        self._stop.clear()

    def __enter__(self) -> "SloWatchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
