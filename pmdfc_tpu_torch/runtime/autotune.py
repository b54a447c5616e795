"""Closed-loop serving controller — telemetry-driven knob auto-tuning
(twin of `pmdfc_tpu/runtime/autotune.py`, the same controller line for
line over the port's `telemetry`, `timeseries`, `sanitizer` and
`config`).

On the card, the balloon and admission rules call `KV.balloon_grow`,
`balloon_shrink`, `set_admit_threshold` and `stats`, which do device work
from the controller's thread; each of those verbs takes the KV's lock
and enters its CUDA device itself (`kv.KV`), as the serving driver
thread does. The stats pull stays on the `balloon_every` cadence: it is
a device sync.

Every serving knob used to be hand-set: the NetServer flush dwell
(`NetConfig.flush_timeout_us`) and settle cutoff (`settle_us`), the
TcpBackend pipeline `window`, the ReplicaGroup hedge deadline
(`hedge_ms`), the KV balloon stepping, and the Migrator's page rate
bound (`RingConfig.migrate_pages_per_s`). The windowed series
(`runtime/timeseries.py`) are exactly the sensor array a controller
needs — per-phase p99s, `queue_wait_us`, `staging_depth`, hit-rate and
miss-cause composition, working-set vs capacity, `migration.lag` — and
the SLO watchdog (`runtime/slo.py`) is the safety governor. This module closes the loop (RDMAbox, arxiv 2104.12197:
batched remote-memory stacks live or die by per-stage visibility
feeding the batching policy):

- **Sensors.** `tick()` consumes the UNSEEN windows of the live
  registry's `SeriesRing` (`timeseries.series_tail()` — the ONE
  windowing convention; the collector both serving drivers start closes
  them). Balloon decisions additionally poll the serving backend's
  stats on a slow cadence (`balloon_every` — a stats pull is a device
  sync and must never ride every tick).
- **Decisions.** Small bounded AIMD-style steps with hysteresis: a knob
  moves only after `hysteresis_windows` CONSECUTIVE evaluated rounds
  proposing the same direction (an evaluated round = one `tick()` that
  consumed at least one new series window; every `*_windows` config
  count — hysteresis, starvation, freeze — burns in this one unit, so
  the thresholds mean the same duration whatever the tick-to-collector
  cadence ratio), up by `max(unit, cur * up_frac)`, down
  multiplicatively by `down_frac`, always clamped to the per-knob hard
  bounds declared in `AutotuneConfig` — the controller can only walk
  inside the declared envelope, so the worst case is the hand-tuned
  default it started from. The sensor→knob rules:

    mean coalesced batch <= light_batch        → dwell/settle DOWN
    staging_depth >= deep_staging              → dwell/settle UP,
                                                 pipeline window UP
    window occupancy p95 vs occ_hi/occ_lo      → window UP / DOWN
    hedge tracks hedge_p99_mult × wire GET p99 (deadband hysteresis)
    migration active + queue-wait p99 healthy  → migrate rate UP
    migration active + queue-wait p99 blown    → migrate rate DOWN
    (miss_evicted+miss_parked)/gets pressure   → balloon GROW a step
    window working-set << capacity, no pressure→ balloon PARK a step
    ghost_readmits/gets >= admit_ghost_hi      → admit threshold DOWN
      (the ghost ring is re-admitting what the sketch refused — the
       gate is too strict; the hot tier is starving)
    demotions/gets >= admit_churn_hi with the
      ghost rate below half the strict mark    → admit threshold UP
      (scan churn is flooding past the gate)
    tenant shed fraction >= qos_shed_hi while
      staging stays below deep_staging         → tenant QoS rate UP
      (the edge bucket is refusing traffic the server had room for)
    staging_depth >= deep_staging while that
      tenant is shedding                       → tenant QoS rate DOWN
      (genuine overload: tighten the noisy tenant's bucket)

  The admission rules ride the BALLOON cadence — both read the same
  backend stats delta, and a stats pull is a device sync that must
  never be paid twice per round (`_propose_balloon` is the one pull).

- **Governor.** The SLO watchdog is the safety authority: a breach
  (its `breaches` counter moved) — or sensor starvation
  (`starve_windows` consecutive zero-traffic evaluated rounds while
  the knobs sit off their last-known-good point) — FREEZES the
  controller for `freeze_windows` evaluated rounds and reverts every
  knob to the last-known-good vector (the values that served the most
  recent healthy window),
  firing rung `autotune_revert` so the event writes an attributable
  flight dump.
- **Observability.** Everything lands in a `ctl` telemetry scope:
  per-knob gauges (`knob_<name>` plus its `_lo`/`_hi` envelope — the
  `tools/check_teledump.py` `check_autotune` pin), `decisions` /
  `reverts` / `governor_freezes` counters, a `frozen` gauge, and one
  `{"kind": "ctl"}` ring event per knob move — so a flight dump's
  record tail shows the decision trajectory into a failure and a bad
  walk is attributable decision by decision.

`PMDFC_AUTOTUNE=off` (env wins over `AutotuneConfig.enabled`, resolved
at construction like every switch) makes a constructed controller fully
inert: no `ctl` scope is registered, `tick()` is a no-op, and every
knob — including the Migrator's static rate bound — keeps its exact
hand-tuned config behavior (conformance-pinned).

Drive it deterministically (`tick()` — tests and the bench harness) or
as a daemon (`start()`/`stop()` at `interval_s`, the Collector /
SloWatchdog lifecycle discipline).
"""

from __future__ import annotations

import threading
import time

from pmdfc_tpu_torch.config import (AutotuneConfig, NetConfig,
                                    autotune_enabled)
from pmdfc_tpu_torch.runtime import sanitizer as san
from pmdfc_tpu_torch.runtime import telemetry as tele
from pmdfc_tpu_torch.runtime import timeseries

# the shared client scope (`runtime/net.py` TcpBackend): window
# occupancy + per-verb latency ride one process-wide namespace
_CLIENT_SCOPE = "net.client"


class _Knob:
    """One live-settable control point: bounds, step unit, hysteresis
    state. `getter`/`setter` are the component hooks (NetServer
    `set_flush_timeout_us`, TcpBackend `set_window`, ReplicaGroup
    `set_hedge_ms`, Migrator `set_rate`, the balloon walker)."""

    __slots__ = ("name", "lo", "hi", "unit", "integer", "single_step",
                 "getter", "setter", "agree", "dirn")

    def __init__(self, name: str, lo: float, hi: float, unit: float,
                 getter, setter, integer: bool = False,
                 single_step: bool = False):
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        self.unit = float(unit)
        self.integer = integer
        # balloon: grow/park exactly one extent per decision, never an
        # AIMD fraction of the offset
        self.single_step = single_step
        self.getter = getter
        self.setter = setter
        self.agree = 0   # consecutive same-direction proposals
        self.dirn = 0    # direction of the streak

    @property
    def value(self) -> float:
        return float(self.getter())


class AutotuneController:
    """The closed-loop controller (see module doc). Construction
    resolves the `PMDFC_AUTOTUNE` switch; bind the live components with
    `bind_server` / `bind_client` / `bind_group` (any subset — rules
    whose sensors or knobs are absent simply never fire)."""

    def __init__(self, cfg: AutotuneConfig | None = None, watchdog=None):
        self.cfg = cfg or AutotuneConfig()
        # construction-time kill switch (env wins) — an off controller
        # registers NO telemetry scope (the scope-present-iff-enabled
        # pin) and never touches a knob
        self.enabled = autotune_enabled(default=self.cfg.enabled)
        # guarded-by: _knobs, _lkg, _lkg_pending, _frozen, _starved,
        # guarded-by: _seen_win, _wd_breaches, _tick_n, _balloon,
        # guarded-by: _balloon_val, _balloon_step_rows, _bstats_prev,
        # guarded-by: _admit, _admit_val, _admit_why, _thread,
        # guarded-by: _qos, _qos_prefixes
        self._lock = san.lock("AutotuneController._lock")
        self._knobs: dict[str, _Knob] = {}
        self._lkg: dict[str, float] = {}   # last-known-good knob vector
        # knobs whose lkg was registered from a FALLBACK because the
        # component could not report a live value yet (a lazily
        # connecting ReconnectingClient): each tick re-probes and
        # adopts the first real sighting as the true starting point
        self._lkg_pending: dict = {}
        self._frozen = 0                   # governor freeze, in windows
        self._starved = 0                  # consecutive no-traffic wins
        self._seen_win = None  # last series window consumed (identity)
        self._tick_n = 0
        self._wd = watchdog
        self._wd_breaches: int | None = None
        self._server = None
        self._srv_prefix: str | None = None
        self._grp_prefix: str | None = None
        self._mig_prefix: str | None = None
        self._migrator = None
        self._balloon = None
        self._balloon_val = 0
        self._balloon_step_rows = 0
        self._bstats_prev: dict | None = None
        self._admit = None
        self._admit_val = 0
        self._admit_why = "pressure"
        self._qos = None
        self._qos_prefixes: dict[int, str] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.stats = None
        if self.enabled:
            self.stats = tele.scope("ctl", {
                "ticks": 0, "windows_seen": 0, "decisions": 0,
                "reverts": 0, "governor_freezes": 0, "holds": 0})
            self.stats.set("frozen", 0)

    # -- binding --

    # caller-holds: _lock
    def _register(self, name: str, lo: float, hi: float, unit: float,
                  getter, setter, integer: bool = False,
                  single_step: bool = False) -> None:
        # the envelope always CONTAINS the hand-tuned starting point: a
        # config whose static value sits outside the declared bounds
        # (NetConfig(flush_timeout_us=50000) vs dwell_us_hi=20000) must
        # neither fail the check_autotune envelope pin at bind time nor
        # have the first walk/revert yank the knob to a bound the
        # operator never chose
        v0 = float(getter())
        lo = min(float(lo), v0)
        hi = max(float(hi), v0)
        k = _Knob(name, lo, hi, unit, getter, setter, integer=integer,
                  single_step=single_step)
        self._knobs[name] = k
        self._lkg[name] = v0
        self.stats.set(f"knob_{name}", v0)
        self.stats.set(f"knob_{name}_lo", k.lo)
        self.stats.set(f"knob_{name}_hi", k.hi)

    def bind_server(self, server) -> "AutotuneController":
        """Attach a coalesced `NetServer`: the flush dwell + settle
        knobs, its staging/batch/queue-wait sensors, and (lazily, once
        the serving backend exists) the KV balloon walker."""
        if not self.enabled:
            return self
        cfg = self.cfg
        with self._lock:
            self._server = server
            self._srv_prefix = server.stats.prefix + "."
            self._register(
                "dwell_us", cfg.dwell_us_lo, cfg.dwell_us_hi, 50.0,
                lambda: server.flush_knobs()[0],
                server.set_flush_timeout_us)
            self._register(
                "settle_us", cfg.settle_us_lo, cfg.settle_us_hi, 20.0,
                lambda: server.flush_knobs()[1],
                server.set_settle_us)
            self._bind_qos_locked(server)
        return self

    def bind_qos(self, server) -> "AutotuneController":
        """Attach the server's QoS plane explicitly (drills;
        `bind_server` already does it for the normal path)."""
        if not self.enabled:
            return self
        with self._lock:
            self._bind_qos_locked(server)
        return self

    # caller-holds: _lock
    def _bind_qos_locked(self, server) -> None:
        """Register one `qos_rate_t<tid>` knob per RATE-LIMITED tenant
        of the server's QoS plane. rate 0 = UNLIMITED is operator
        intent (the TokenBucket contract, the migrate-rate-0 rule) —
        an unbounded tenant gets no knob, or the first shed sighting
        would cap a tenant the operator explicitly left open. The
        envelope is the tenant's declared `rate_lo`/`rate_hi` when set,
        else derived from its configured rate by the
        `qos_rate_lo_frac`/`qos_rate_hi_frac` fractions."""
        probe = getattr(server, "qos_plane", None)
        plane = probe() if probe is not None else None
        if plane is None:
            return
        cfg = self.cfg
        self._qos = plane
        for tid in plane.tids():
            r0 = float(plane.rate(tid))
            if r0 <= 0:
                continue
            tc = plane.tenant(tid)
            lo = tc.rate_lo or r0 * cfg.qos_rate_lo_frac
            hi = tc.rate_hi or r0 * cfg.qos_rate_hi_frac
            self._register(
                f"qos_rate_t{tid}", lo, hi, max(1.0, r0 / 16.0),
                (lambda t=tid: plane.rate(t)),
                (lambda v, t=tid: plane.set_rate(t, v)))
            self._qos_prefixes[tid] = plane.scope(tid).prefix + "."

    def bind_client(self, client) -> "AutotuneController":
        """Attach a pipelined client (`TcpBackend`, or a
        `ReconnectingClient` wrapping one — its `set_window` survives
        reconnects): the pipeline-window knob."""
        if not self.enabled:
            return self
        cfg = self.cfg
        with self._lock:
            # a not-yet-connected ReconnectingClient reports window
            # None: assume the transport default (NetConfig.window ==
            # TcpBackend's default), NOT the envelope floor — the floor
            # would be recorded as last-known-good and a later governor
            # revert would slam the live window 8x below the hand-tuned
            # point the controller never actually moved. The assumption
            # is PROVISIONAL: each tick re-probes, and the first real
            # sighting (a factory built with a custom window) replaces
            # the fallback as the true starting point.
            self._register(
                "window", cfg.window_lo, cfg.window_hi, 1.0,
                lambda: (getattr(client, "window", None)
                         or int(NetConfig.window)),
                client.set_window, integer=True)
            if getattr(client, "window", None) is None:
                self._lkg_pending["window"] = \
                    lambda: getattr(client, "window", None)
        return self

    def bind_group(self, group) -> "AutotuneController":
        """Attach a `ReplicaGroup`: the hedge-deadline knob, and (when
        the elastic ring is live) the migration-rate knob fed from the
        `migration.lag` + serving-p99 series."""
        if not self.enabled:
            return self
        cfg = self.cfg
        with self._lock:
            self._grp_prefix = group.counters.prefix + "."
            # hedge_ms=0 is documented as "hedging disabled" — operator
            # intent, not a point on the deadline axis: no knob, or the
            # first p99 sighting would re-enable duplicate GETs the
            # operator explicitly turned off (the migrate-rate-0 rule)
            if group.hedge_ms_live() > 0:
                self._register(
                    "hedge_ms", cfg.hedge_ms_lo, cfg.hedge_ms_hi, 1.0,
                    group.hedge_ms_live, group.set_hedge_ms)
            mig = getattr(group, "migrator", None)
            # rate 0 = UNBOUNDED is operator intent (TokenBucket's own
            # contract), not a point on the pages/s axis: registering
            # it would gauge 0 outside the envelope and a revert would
            # throttle an intentionally unbounded migrator to the
            # floor — so an unbounded migrator gets no rate knob
            if mig is not None and mig.cfg.migrate_pages_per_s > 0:
                self._migrator = mig
                self._mig_prefix = mig.scope.prefix + "."
                self._register(
                    "migrate_pps", cfg.migrate_pps_lo,
                    cfg.migrate_pps_hi, 256.0, mig.rate, mig.set_rate)
        return self

    def bind_balloon(self, target) -> "AutotuneController":
        """Attach a balloon walker explicitly (any object with
        `balloon_grow`/`balloon_shrink`/`balloon_state`, e.g. a KV or a
        serving backend). When the target also exposes a live TinyLFU
        admission gate (`admit_state`/`set_admit_threshold`), the
        `admit_thresh` knob registers alongside — both walk on the
        balloon cadence off one shared stats pull. `bind_server`
        resolves one lazily from the server's backend; this is the
        direct hook for drills."""
        if not self.enabled:
            return self
        with self._lock:
            self._bind_balloon_locked(target)
        return self

    # caller-holds: _lock
    def _bind_balloon_locked(self, target) -> bool:
        try:
            st = target.balloon_state()
        except Exception:  # noqa: BLE001 — a backend without a tiered
            st = None      # pool simply has no balloon knob
        if not st:
            return False
        self._balloon = target
        self._balloon_step_rows = int(st.get("step", 1024))
        m = self.cfg.balloon_max_extents
        self._register("balloon_x", -m, m, 1.0,
                       lambda: float(self._balloon_val),
                       self._set_balloon, integer=True, single_step=True)
        self._bind_admit_locked(target)
        return True

    # caller-holds: _lock
    def _bind_admit_locked(self, target) -> None:
        """Register the TinyLFU admission-threshold knob when the
        balloon target also exposes a live gate (`admit_state` answers
        — a flat pool or PMDFC_ADMIT=off backend has no knob). The
        live value is tracked HOST-SIDE (`_admit_val`, the balloon-
        offset discipline): the device scalar's truth costs a sync per
        read, and this controller is the only writer."""
        probe = getattr(target, "admit_state", None)
        if probe is None:
            return
        try:
            st = probe()
        except Exception:  # noqa: BLE001 — no gate = no knob, never
            st = None      # a crash in the control loop
        if not st:
            return
        self._admit = target
        self._admit_val = int(st.get("threshold", 0))
        self._register("admit_thresh", self.cfg.admit_lo,
                       self.cfg.admit_hi, 1.0,
                       lambda: float(self._admit_val),
                       self._set_admit, integer=True)

    # caller-holds: _lock
    def _set_admit(self, v) -> float:
        """Write the live admission threshold through the backend; the
        host mirror advances only when the write LANDED (a torn-down
        backend refuses, and the gauge must never claim a move the gate
        refused — the balloon-walker discipline)."""
        v = max(0, int(round(float(v))))
        try:
            ok = self._admit.set_admit_threshold(v)
        except Exception:  # noqa: BLE001 — refusal, never a crash
            ok = False
        if ok:
            self._admit_val = v
        return float(self._admit_val)

    # caller-holds: _lock
    def _resolve_balloon(self) -> None:
        """Lazy balloon-target resolution: the server's serving backend
        exists only after `start()` (coalesced mode builds it then)."""
        if self._balloon is not None or self._server is None:
            return
        be = getattr(self._server, "_co_backend", None)
        for t in (be, getattr(be, "kv", None),
                  getattr(be, "skv", None),
                  getattr(getattr(be, "server", None), "kv", None)):
            if t is None or not hasattr(t, "balloon_state"):
                continue
            if self._bind_balloon_locked(t):
                return

    # caller-holds: _lock
    def _circulating(self) -> int | None:
        try:
            st = self._balloon.balloon_state()
        except Exception:  # noqa: BLE001 — a failed probe reads as
            return None    # "no observable effect", never a crash
        return int(st["circulating"]) if st else None

    # caller-holds: _lock
    def _set_balloon(self, v) -> float:
        """Walk the balloon toward offset `v` (net extents from the
        start point): positive steps grow circulation (`balloon_grow`
        of one extent's rows — parked capacity returns first),
        negative steps park one extent (`balloon_shrink`). The offset
        advances only on OBSERVED pool movement (circulating rows
        changed): a grow against a fully materialized pool is a
        pool-side no-op, and counting it would let later park
        decisions walk REAL capacity below the hand-tuned starting
        point while the gauge read \"back at the default\"."""
        v = int(round(float(v)))
        rows = self._balloon_step_rows
        while self._balloon_val != v:
            before = self._circulating()
            if self._balloon_val < v:
                self._balloon.balloon_grow(rows)
            else:
                self._balloon.balloon_shrink(rows)
            after = self._circulating()
            if before is None or after is None or after == before:
                break  # saturated / unobservable: offset stays honest
            self._balloon_val += 1 if self._balloon_val < v else -1
        return float(self._balloon_val)

    # -- sensing --

    # caller-holds: _lock
    def _sense(self, wins: list) -> dict:
        """Aggregate the unseen series windows into one sensor sample:
        counters sum across windows, gauges/quantiles take the worst
        (max) sighting — a spike in ANY window is evidence."""
        s = {"ops": 0, "mean_batch": None, "staging": 0.0,
             "qwait_p99": None, "occ_p95": None, "get_p99_us": None,
             "mig_lag": 0.0, "mig_active": False,
             "qos": {t: {"ops": 0, "shed": 0}
                     for t in self._qos_prefixes}}
        bn = bs = 0.0
        pfx = self._srv_prefix
        for w in wins:
            c = w.get("counters") or {}
            g = w.get("gauges") or {}
            h = w.get("hists") or {}
            for tid, qpfx in self._qos_prefixes.items():
                d = s["qos"][tid]
                d["ops"] += c.get(qpfx + "ops", 0)
                d["shed"] += c.get(qpfx + "shed_edge", 0) \
                    + c.get(qpfx + "shed_ladder", 0)
            if pfx:
                s["ops"] += c.get(pfx + "coalesced_ops", 0) \
                    + c.get(pfx + "ops", 0)
                fh = h.get(pfx + "flush_ops_hist")
                if fh and fh.get("count"):
                    bn += fh["count"]
                    bs += fh["sum"]
                s["staging"] = max(s["staging"],
                                   g.get(pfx + "staging_depth", 0))
                qh = h.get(pfx + "queue_wait_us")
                if qh:
                    s["qwait_p99"] = max(s["qwait_p99"] or 0.0,
                                         qh["p99"])
            oh = h.get(f"{_CLIENT_SCOPE}.window_occupancy")
            if oh:
                s["occ_p95"] = max(s["occ_p95"] or 0.0, oh["p95"])
            gh = h.get(f"{_CLIENT_SCOPE}.get_us")
            if gh:
                s["get_p99_us"] = max(s["get_p99_us"] or 0.0, gh["p99"])
                if pfx is None:
                    s["ops"] += gh["count"]  # client-only starvation
            if self._grp_prefix:
                s["ops"] += c.get(self._grp_prefix + "gets", 0)
            if self._mig_prefix:
                lag = g.get(self._mig_prefix + "lag")
                if lag is not None:
                    s["mig_lag"] = max(s["mig_lag"], lag)
                if g.get(self._mig_prefix + "active", 0):
                    s["mig_active"] = True
        if bn:
            s["mean_batch"] = bs / bn
        return s

    # caller-holds: _lock
    def _propose(self, s: dict) -> dict:
        """sensor sample -> {knob: direction} (only knobs whose rule
        has evidence this round propose at all)."""
        cfg = self.cfg
        p: dict[str, int] = {}
        if "dwell_us" in self._knobs:
            # deep staging ALONE is the up signal (the documented rule
            # table): a flush-wedged window under load — queue at max,
            # zero completed flushes, so no mean_batch evidence — must
            # keep the fusion knobs' UP streak alive, not reset it
            if s["staging"] >= cfg.deep_staging:
                p["dwell_us"] = +1
                p["settle_us"] = +1
            elif s["mean_batch"] is not None \
                    and s["mean_batch"] <= cfg.light_batch:
                p["dwell_us"] = -1
                p["settle_us"] = -1
        if "window" in self._knobs:
            w = self._knobs["window"].value
            occ = s["occ_p95"]
            if s["staging"] >= cfg.deep_staging or (
                    occ is not None and occ >= cfg.occ_hi_frac * w):
                p["window"] = +1
            elif occ is not None and occ <= cfg.occ_lo_frac * w \
                    and s["staging"] < cfg.deep_staging / 2:
                p["window"] = -1
        if "hedge_ms" in self._knobs and s["get_p99_us"] is not None:
            k = self._knobs["hedge_ms"]
            tgt = min(k.hi, max(k.lo, cfg.hedge_p99_mult
                                * s["get_p99_us"] / 1e3))
            cur = k.value
            if tgt > cur * (1.0 + cfg.deadband):
                p["hedge_ms"] = +1
            elif tgt < cur * (1.0 - cfg.deadband):
                p["hedge_ms"] = -1
        if "migrate_pps" in self._knobs and s["mig_active"]:
            healthy = (s["qwait_p99"] is None
                       or s["qwait_p99"] <= cfg.qwait_healthy_us)
            p["migrate_pps"] = +1 if healthy else -1
        for tid, d in s["qos"].items():
            name = f"qos_rate_t{tid}"
            if name not in self._knobs or d["ops"] <= 0:
                continue
            # shed fraction is per-ARRIVAL (ops counts both staged and
            # shed), so it is a proper fraction even under full refusal
            if s["staging"] >= cfg.deep_staging:
                if d["shed"] > 0:
                    p[name] = -1
            elif d["shed"] / d["ops"] >= cfg.qos_shed_hi:
                p[name] = +1
        return p

    # caller-holds: _lock
    def _propose_balloon(self) -> tuple[int, int]:
        """Slow-cadence backend rules off ONE stats pull (a stats pull
        is a device sync; the rules share it, never pay it twice):
        returns (balloon direction, admission-threshold direction).

        Balloon: miss-cause composition (evicted+parked share of gets)
        grows a step; an over-provisioned window working-set parks one.

        Admission (the `admit_thresh` knob, when bound): the windowed
        ghost-readmit rate at/above `admit_ghost_hi` means the ghost
        ring is re-admitting what the sketch refused — the gate is too
        strict, the threshold walks DOWN; demotion churn at/above
        `admit_churn_hi` while the ghost rate stays below half the
        strict mark means scan churn is flooding past the gate — the
        threshold walks UP."""
        t = self._balloon
        if t is None or not hasattr(t, "stats"):
            return 0, 0
        try:
            st = t.stats()
        except Exception:  # noqa: BLE001 — a failed stats pull is a
            return 0, 0    # hold, never a crash in the control loop
        prev, self._bstats_prev = self._bstats_prev, st
        if prev is None:
            return 0, 0
        dg = st.get("gets", 0) - prev.get("gets", 0)
        if dg <= 0:
            return 0, 0
        ad = self._admit_rule(st, prev, dg)
        dpress = (st.get("miss_evicted", 0) + st.get("miss_parked", 0)
                  - prev.get("miss_evicted", 0)
                  - prev.get("miss_parked", 0))
        if dpress / dg >= self.cfg.miss_pressure:
            return +1, ad
        cap = st.get("capacity")
        ws = None
        if self._server is not None and getattr(
                self._server, "workload", None) is not None:
            try:
                ws = self._server.workload.snapshot()["window"].get(
                    "working_set")
            except Exception:  # noqa: BLE001 — sketch off/any shape
                ws = None
        if (dpress == 0 and cap and ws is not None
                and ws <= self.cfg.wset_shrink_frac * cap):
            return -1, ad
        return 0, ad

    # caller-holds: _lock
    def _admit_rule(self, st: dict, prev: dict, dg: int) -> int:
        """Admission-threshold direction off the shared stats delta
        (see `_propose_balloon`). The sensors are the tier lanes the
        gate itself moves: ghost readmissions (the W-TinyLFU correction
        lane — a high rate means the sketch keeps refusing keys the
        ghost ring then proves hot) versus demotion churn (scan flood
        symptom: the hot tier is turning over)."""
        if "admit_thresh" not in self._knobs:
            return 0
        ghost = (st.get("ghost_readmits", 0)
                 - prev.get("ghost_readmits", 0)) / dg
        churn = (st.get("demotions", 0) - prev.get("demotions", 0)) / dg
        self._admit_why = f"ghost={ghost:.4f} churn={churn:.4f}"
        if ghost >= self.cfg.admit_ghost_hi:
            return -1
        if churn >= self.cfg.admit_churn_hi \
                and ghost < self.cfg.admit_ghost_hi / 2:
            return +1
        return 0

    # -- stepping --

    # caller-holds: _lock
    def _apply(self, k: _Knob, dirn: int, why: str) -> dict | None:
        """One clamped AIMD step. Returns the decision record (None
        when the clamp leaves the knob where it is)."""
        cur = k.value
        if k.single_step:
            new = cur + dirn
        elif dirn > 0:
            new = cur + max(k.unit, cur * self.cfg.up_frac)
        else:
            new = min(cur * self.cfg.down_frac, cur - k.unit)
        new = min(k.hi, max(k.lo, new))
        if k.integer:
            new = float(int(round(new)))
        if abs(new - cur) < 1e-9:
            return None
        applied = k.setter(int(new) if k.integer else new)
        # once the controller has WRITTEN this knob, a later probe of a
        # lazily-reporting component echoes the controller's own pending
        # set (ReconnectingClient.window returns _want_window while
        # disconnected) — adopting that as the "first real sighting"
        # would make a controller-chosen value the governor's revert
        # target; the bind-time fallback stays the lkg instead
        self._lkg_pending.pop(k.name, None)
        if applied is not None:
            # the hook reports what actually landed (the balloon may
            # saturate mid-walk): the gauge/record must never claim a
            # move the pool refused
            new = float(applied)
        if abs(new - cur) < 1e-9:
            return None
        self.stats.inc("decisions")
        self.stats.set(f"knob_{k.name}", new)
        rec = {"kind": "ctl", "knob": k.name, "from": round(cur, 3),
               "to": round(new, 3), "dir": dirn, "why": why,
               "t": time.time()}
        if tele.enabled():
            tele.get().record(rec)
        return rec

    # caller-holds: _lock
    def _revert_locked(self) -> dict:
        """Walk every knob back to the last-known-good vector and arm
        the freeze. Returns {knob: (from, to)} for the moves made."""
        moved: dict[str, tuple] = {}
        for name, k in self._knobs.items():
            tgt = self._lkg.get(name)
            if tgt is None:
                continue
            tgt = min(k.hi, max(k.lo, float(tgt)))
            cur = k.value
            if abs(cur - tgt) < 1e-9:
                continue
            applied = k.setter(int(round(tgt)) if k.integer else tgt)
            self._lkg_pending.pop(name, None)  # same echo guard as _apply
            if applied is not None:
                tgt = float(applied)
            if abs(cur - tgt) < 1e-9:
                continue
            self.stats.inc("decisions")
            self.stats.set(f"knob_{name}", tgt)
            moved[name] = (round(cur, 3), round(tgt, 3))
        self._frozen = self.cfg.freeze_windows
        self.stats.set("frozen", 1)
        self.stats.inc("governor_freezes")
        if moved:
            self.stats.inc("reverts")
        for k in self._knobs.values():
            k.agree = 0
            k.dirn = 0
        return moved

    # caller-holds: _lock
    def _breached(self) -> bool:
        """Did the governor's breach counter move since the last look?
        The first sight only ARMS the delta — pre-existing breaches
        from before this controller attached are not its signal."""
        if self._wd is None:
            return False
        try:
            b = int(self._wd.stats["breaches"])
        except Exception:  # noqa: BLE001 — a torn-down watchdog reads
            return False   # as no signal, never as a crash
        prev, self._wd_breaches = self._wd_breaches, b
        return prev is not None and b > prev

    # -- the loop --

    def tick(self) -> list[dict]:
        """One control round over the unseen series windows; returns
        the decision records made (empty = hold). Rungs fire OUTSIDE
        the lock — a revert dump is file IO and must never convoy the
        serving-path knob reads behind it."""
        if not self.enabled:
            return []
        self.stats.inc("ticks")
        decisions: list[dict] = []
        revert: tuple[str, dict] | None = None
        with self._lock:
            self._tick_n += 1
            # adopt the first REAL sighting of a lazily-reporting
            # component as its true last-known-good (a fallback
            # recorded at bind time must never become a revert target
            # once the live value is observable)
            for n in list(self._lkg_pending):
                v = self._lkg_pending[n]()
                if v is None:
                    continue
                del self._lkg_pending[n]
                k = self._knobs.get(n)
                if k is None:
                    continue
                v = float(v)
                k.lo = min(k.lo, v)
                k.hi = max(k.hi, v)
                self._lkg[n] = v
                self.stats.set(f"knob_{n}", v)
                self.stats.set(f"knob_{n}_lo", k.lo)
                self.stats.set(f"knob_{n}_hi", k.hi)
            if self._breached():
                revert = ("slo_breach", self._revert_locked())
            elif self._frozen > 0:
                pass  # frozen: consume windows below, decide nothing
            tail = timeseries.series_tail()
            # unseen = windows appended AFTER the last one consumed, by
            # OBJECT identity — a wall-clock ratchet (windows stamp
            # time.time()) would read every post-step window as
            # already-seen after an NTP step-back / VM resume and
            # silently disable the whole loop, an armed freeze burn-
            # down included, until the clock re-passed the stale mark.
            # The ring evicts oldest-first, so a last-seen window no
            # longer in the tail means everything remaining is newer.
            wins = tail
            if self._seen_win is not None:
                for i in range(len(tail) - 1, -1, -1):
                    if tail[i] is self._seen_win:
                        wins = tail[i + 1:]
                        break
            if wins:
                self._seen_win = wins[-1]
                self.stats.inc("windows_seen", len(wins))
            if revert is None and wins and self._frozen > 0:
                # freeze burns down one per EVALUATED ROUND (a tick
                # that consumed >= 1 new window) — the same unit the
                # hysteresis streak and starvation counter advance in,
                # so freeze_windows/starve_windows/hysteresis_windows
                # mean the same duration whatever the interval_s to
                # collector-window ratio
                self._frozen -= 1
                if self._frozen <= 0:
                    self._frozen = 0
                    self.stats.set("frozen", 0)
            elif revert is None and wins:
                s = self._sense(wins)
                # a window with zero COMPLETED ops but a deep staging
                # queue is a wedged flush under load, not a dark fleet:
                # it must not burn toward a mid-peak "starved" revert
                if s["ops"] <= 0 and s["staging"] <= 0:
                    self._starved += 1
                    off_lkg = any(
                        abs(k.value - self._lkg.get(n, k.value)) > 1e-9
                        for n, k in self._knobs.items())
                    if self._starved >= self.cfg.starve_windows \
                            and off_lkg:
                        self._starved = 0
                        revert = ("starved", self._revert_locked())
                else:
                    self._starved = 0
                    props = self._propose(s)
                    self._resolve_balloon()
                    bal_round = (self._balloon is not None
                                 and self._tick_n
                                 % self.cfg.balloon_every == 0)
                    if bal_round:
                        bd, ad = self._propose_balloon()
                        if bd:
                            props["balloon_x"] = bd
                        if ad:
                            props["admit_thresh"] = ad
                    # the vector standing BEFORE this tick's moves: by
                    # the hysteresis rule it served at least
                    # `hysteresis_windows` healthy windows, so it is
                    # the governor's revert point the moment any move
                    # lands (updating lkg on every healthy window
                    # instead would let a breach revert to the very
                    # vector that caused it — the watchdog's burn
                    # detection lags the move by design)
                    pre = {n: k.value for n, k in self._knobs.items()}
                    # "CONSECUTIVE same-direction windows" means
                    # consecutive: an evaluated round with no proposal
                    # for a knob breaks its streak, or two transient
                    # sightings hours apart would count as agreement.
                    # The backend-cadence knobs (balloon_x,
                    # admit_thresh) are exempt on non-cadence rounds —
                    # they are only EVALUATED every balloon_every
                    # ticks, and a round that never looked cannot
                    # disagree.
                    for name, k in self._knobs.items():
                        if name in props:
                            continue
                        if name in ("balloon_x", "admit_thresh") \
                                and not bal_round:
                            continue
                        k.agree = 0
                        k.dirn = 0
                    for name, dirn in props.items():
                        k = self._knobs.get(name)
                        if k is None or dirn == 0:
                            continue
                        if dirn == k.dirn:
                            k.agree += 1
                        else:
                            k.dirn = dirn
                            k.agree = 1
                        if k.agree < self.cfg.hysteresis_windows:
                            self.stats.inc("holds")
                            continue
                        k.agree = 0
                        rec = self._apply(
                            k, dirn,
                            why=(self._admit_why
                                 if name == "admit_thresh"
                                 else _why(name, s)))
                        if rec is not None:
                            decisions.append(rec)
                    if decisions:
                        self._lkg = pre
        if revert is not None:
            reason, moved = revert
            rec = {"kind": "ctl", "knob": "*", "why": reason,
                   "revert": {n: list(v) for n, v in moved.items()},
                   "t": time.time()}
            if tele.enabled():
                tele.get().record(rec)
            decisions.append(rec)
            tele.rung("autotune_revert", reason=reason,
                      knobs={n: list(v) for n, v in moved.items()},
                      freeze_windows=self.cfg.freeze_windows)
        return decisions

    # -- lifecycle (the Collector/SloWatchdog daemon discipline) --

    def start(self) -> "AutotuneController":
        with self._lock:
            if self._thread is not None or not self.enabled:
                return self
            th = threading.Thread(target=self._loop, daemon=True,
                                  name="autotune-ctl")
            self._thread = th
        th.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the controller must
                pass           # outlive any single bad round

    def stop(self) -> None:
        """Restartable stop. The thread handle is dropped only after a
        COMPLETED join — a tick blocked past the timeout (the balloon
        stats pull is a device sync; first compiles run seconds) must
        stay re-joinable instead of becoming an orphan that keeps
        walking knobs with no handle left to stop it (the
        CleanCacheClient.close() discipline). On a timed-out join the
        stop event also stays set, so the straggler exits at its next
        wait and a retry can finish the join."""
        self._stop.set()
        with self._lock:
            th = self._thread
        if th is not None:
            th.join(timeout=5)
            if th.is_alive():
                return  # handle kept, stop still set: retry re-joins
            with self._lock:
                if self._thread is th:
                    self._thread = None
        self._stop.clear()

    def __enter__(self) -> "AutotuneController":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- introspection (drills/bench) --

    def knob_values(self) -> dict:
        """{knob: current value} — the live vector."""
        with self._lock:
            return {n: k.value for n, k in self._knobs.items()}

    def frozen(self) -> bool:
        with self._lock:
            return self._frozen > 0


def _why(name: str, s: dict) -> str:
    """Compact decision attribution for the ring record."""
    if name in ("dwell_us", "settle_us"):
        return (f"staging={s['staging']:.0f} "
                f"batch={s['mean_batch'] if s['mean_batch'] is None else round(s['mean_batch'], 1)}")
    if name == "window":
        occ = s["occ_p95"]
        return (f"occ_p95={occ if occ is None else round(occ, 1)} "
                f"staging={s['staging']:.0f}")
    if name == "hedge_ms":
        return f"get_p99_us={round(s['get_p99_us'] or 0, 1)}"
    if name == "migrate_pps":
        return (f"lag={s['mig_lag']:.0f} "
                f"qwait_p99={s['qwait_p99'] if s['qwait_p99'] is None else round(s['qwait_p99'], 1)}")
    if name.startswith("qos_rate_t"):
        d = s.get("qos", {}).get(int(name[len("qos_rate_t"):]),
                                 {"ops": 0, "shed": 0})
        return (f"shed={d['shed']} ops={d['ops']} "
                f"staging={s['staging']:.0f}")
    return "pressure"


def attach(server=None, client=None, group=None, watchdog=None,
           cfg: AutotuneConfig | None = None,
           start: bool = False) -> AutotuneController:
    """Build a controller bound to any subset of the serving plane —
    the one-call harness hook benches and drivers use."""
    ctl = AutotuneController(cfg, watchdog=watchdog)
    if server is not None:
        ctl.bind_server(server)
    if client is not None:
        ctl.bind_client(client)
    if group is not None:
        ctl.bind_group(group)
    if start:
        ctl.start()
    return ctl
