"""Device-time X-ray: per-program on-chip cost attribution (twin of
`pmdfc_tpu/runtime/profiler.py`).

The host-side telemetry stack stops at the dispatch boundary: CUDA work
is asynchronous, so the time a program spends on the device shows only
at the FETCH — the first host access that waits for its result. This
module owns that seam:

- `fetch(program, phase, thunk, ...)` is the ONE sanctioned sync point.
  It runs the blocking fetch, takes the program's `device_us` (below),
  derives the dispatch-vs-device split from the launch stamp when the
  caller has one (`t_launch_ns`), and feeds the per-program
  `device_us`/`dispatch_us` histogram families, the per-shard device-time
  lanes, and the windowed `shard_imbalance` gauge (max/mean device time
  across shards per window). Warmup paths use `block_ready`.
- `cost_probe(program, width, nbytes)` sets `cost.<program>.{flops,bytes}`
  at the first call of each (program, padded width).
- `Profiler.start_capture(ms)` runs one bounded `torch.profiler` session
  under the flight recorder's dump dir with the recorder's own cooldown
  and rotation discipline — the server half of `MSG_PROFILE`.

The attribution table, the `pmdfc-prof-v1` snapshot, the `prof.*`
histograms, the shard lanes and the imbalance window are the JAX
module's, so `tools/proftool.py` reads this module's snapshots
unchanged. The profiler is opt-in (`PMDFC_PROF=on` or `install()`); when
nothing attaches, every seam is a passthrough, no CUDA event is created
or recorded, and telemetry snapshots stay the v2 schema. Recording rides
the TRACING tier: `PMDFC_TELEMETRY=off` silences the device lanes too.

Differences from the JAX module, all from what the card lets a host see:

- `device_us` comes from CUDA events. JAX cannot see the device, so its
  `device_us` is the wall time of the blocking fetch. Here a launch on
  CUDA tensors records a `torch.cuda.Event(enable_timing=True)` pair on
  the current stream (`launch_begin` before its first op, `launch_end`
  after its last, no host sync), the handle carries the pair, and
  `fetch(..., events=pair)` reads `start.elapsed_time(end)` once the
  thunk's copy has waited for the stream. Pairs come from a small reused
  pool. Only a fetch with no pair (CPU tensors) times the thunk on the
  host clock, as JAX does.
- `block_ready(x)` is `torch.cuda.synchronize(device)` for CUDA tensors
  and CUDA devices, and nothing for CPU ones (CPU ops have run when they
  return). It is the port's one sync outside `fetch` and `bench/`.
- `cost_probe`: torch has no `lowered.cost_analysis()`. The seam takes a
  byte count from the caller — the fused GET's own count at that width
  with every key a hit (`ops.fused.hit_bytes`), FLOPs 0 (integer work).
  Programs without a byte count set no `cost.*` gauge.
- `start_capture` runs `torch.profiler.profile(activities=[CPU, CUDA])`
  (CPU alone without a card) on one dedicated capture thread, which both
  starts and stops the session after `duration_ms`, then exports it with
  `export_chrome_trace` to `<dump_dir>/prof_<seq:05d>/trace.json`
  (written to a temporary name and renamed, so a reader never sees half
  a file). The cooldown, rotation and refusal rules are the JAX module's.
"""
from __future__ import annotations

import os
import shutil
import threading
import time

import numpy as np

from pmdfc_tpu_torch.config import ProfilerConfig, profiler_enabled
from pmdfc_tpu_torch.runtime import telemetry as tele

# a capture session must start within this long or the capture is refused
_CAPTURE_START_S = 60.0


class Profiler:
    """Device-time accounting attached to ONE telemetry registry as its
    `profile_sink` (mirrors the series collector's attachment pattern).

    All mutable state is guarded by `_lock`; the metric objects
    themselves (histograms/counters/gauges) carry their own locks, so
    `note_launch` holds `_lock` only for the attribution table and the
    imbalance window."""

    def __init__(self, config: ProfilerConfig | None = None,
                 registry=None):
        self.config = config or ProfilerConfig()
        self._reg = registry if registry is not None else tele.get()
        self._sc = self._reg.scope("prof", unique=False)
        self._cost_sc = self._reg.scope("cost", unique=False)
        # guarded-by: _launches, _n_shards, _shard_us, _shard_ops,
        # guarded-by: _win_us, _win_n, _imbalance, _h_shard, _g_shard,
        # guarded-by: _table, _rows_dropped, _cost, _cost_seen
        self._lock = threading.Lock()
        # program -> (device_us hist, dispatch_us hist), as in JAX: the
        # per-launch path indexes a plain dict instead of paying the
        # scope lookup twice per launch (a lost insert repeats it once)
        self._h_prog: dict = {}
        self._launches = 0
        self._n_shards = 0
        self._shard_us: list[float] = []   # cumulative device µs
        self._shard_ops: list[int] = []    # ops attributed (== mesh lanes)
        self._win_us: list[float] = []     # current imbalance window
        self._win_n = 0
        self._imbalance = 0.0              # 0 until one window completes
        self._h_shard: tuple = ()          # device_us_s{i} hist family
        self._g_shard: tuple = ()          # shard{i}_device_us gauges
        # (phase, program, shard) -> [ops, device_us]; shard -1 = a
        # launch with no per-shard routing (engine/kv transports)
        self._table: dict = {}
        self._rows_dropped = 0
        self._cost: dict = {}
        # (program, padded width) pairs already probed: the port's KV has
        # no recompile tracker to say which call is a signature's first
        self._cost_seen: set = set()
        self._g_imb = self._sc.gauge("shard_imbalance")
        # guarded-by: _trace_active, _last_trace_t, _trace_seq
        self._trace_lock = threading.Lock()
        self._trace_active = False
        self._last_trace_t = -1e18
        self._trace_seq = 0

    # -- per-launch attribution ------------------------------------

    # caller-holds: _lock
    def _grow(self, n: int) -> None:
        # the shard axis is learned from the first routed launch and
        # only ever widens
        while len(self._shard_us) < n:
            self._shard_us.append(0.0)
            self._shard_ops.append(0)
            self._win_us.append(0.0)
        if n > self._n_shards:
            self._n_shards = n
            self._h_shard = self._sc.hist_family("device_us", n)
            self._g_shard = tuple(
                self._sc.gauge(f"shard{i}_device_us") for i in range(n))

    # caller-holds: _lock
    def _bump_row(self, phase: str, program: str, shard: int,
                  ops: int, us: float) -> None:
        key = (phase, program, shard)
        row = self._table.get(key)
        if row is None:
            if len(self._table) >= self.config.table_max_rows:
                self._rows_dropped += 1
                return
            row = self._table[key] = [0, 0.0]
        row[0] += ops
        row[1] += us

    def note_launch(self, program: str, phase: str, device_us: float,
                    dispatch_us: float = 0.0, n_ops: int = 0,
                    counts=None, n_shards: int = 0) -> None:
        """Attribute one fetched launch: `device_us` its device time
        (CUDA events) or, on the CPU, the host time blocked in the fetch;
        `dispatch_us` the launch-to-fetch-begin gap when the caller
        stamped the launch. `counts` (the plane's per-shard routed-op
        vector) splits the device time across shards proportionally —
        the SAME vector that feeds `mesh.shard{i}_ops`, so per-shard
        sums reconcile with the span attribution by construction."""
        if not tele.enabled():
            return
        hp = self._h_prog.get(program)
        if hp is None:
            hp = (self._sc.hist(f"{program}.device_us"),
                  self._sc.hist(f"{program}.dispatch_us"))
            self._h_prog[program] = hp
        hp[0].observe(device_us)
        if dispatch_us:
            # only launches with a real stamp feed the dispatch family
            hp[1].observe(dispatch_us)
        c = None
        if counts is not None:
            c = np.asarray(counts)
            if not int(c.sum()):
                c = None
        with self._lock:
            self._launches += 1
            if c is None:
                self._bump_row(phase, program, -1, int(n_ops),
                               float(device_us))
                return
            self._grow(max(len(c), int(n_shards)))
            total = int(c.sum())
            hot = np.flatnonzero(c)
            for s in hot:
                s = int(s)
                share = float(device_us) * (int(c[s]) / total)
                self._shard_us[s] += share
                self._shard_ops[s] += int(c[s])
                self._win_us[s] += share
                self._h_shard[s].observe(share)
                self._bump_row(phase, program, s, int(c[s]), share)
            self._win_n += 1
            if self._win_n >= self.config.imbalance_window:
                # window boundary: the cumulative lane gauges refresh
                # here, not per launch
                tot = sum(self._win_us)
                if tot > 0:
                    mean = tot / self._n_shards
                    self._imbalance = max(self._win_us) / mean
                    self._g_imb.set(round(self._imbalance, 3))
                for i in range(self._n_shards):
                    self._g_shard[i].set(round(self._shard_us[i], 1))
                self._win_n = 0
                for i in range(len(self._win_us)):
                    self._win_us[i] = 0.0

    # -- static cost capture ---------------------------------------

    def note_cost(self, program: str, width: int, nbytes,
                  flops: float = 0.0) -> bool:
        """First sighting of (program, padded width) -> True, and with a
        byte count (an int, or a callable computing one) the
        `cost.<program>.{flops,bytes}` gauges. Later sightings change
        nothing (-> False)."""
        with self._lock:
            key = (program, int(width))
            if key in self._cost_seen:
                return False
            self._cost_seen.add(key)
        if nbytes is None:
            return True
        byts = float(nbytes() if callable(nbytes) else nbytes)
        with self._lock:
            self._cost[program] = {"flops": float(flops), "bytes": byts}
        self._cost_sc.set(f"{program}.flops", float(flops))
        self._cost_sc.set(f"{program}.bytes", byts)
        return True

    # -- bounded on-demand trace (MSG_PROFILE server half) ---------

    def start_capture(self, duration_ms: int) -> dict | None:
        """Start one bounded `torch.profiler` session under the flight
        recorder's dump dir. Returns `{"path", "duration_ms"}` or None
        when refused: no dump dir configured, a capture is already live,
        the cooldown has not elapsed, or the session failed to start.
        The session runs on its own thread, which stops it after the
        window and writes `trace.json`; the caller waits only for the
        start, never for the capture window."""
        dump_dir = getattr(self._reg, "dump_dir", None)
        if not dump_dir:
            return None
        now = time.monotonic()
        with self._trace_lock:
            if self._trace_active:
                return None
            if now - self._last_trace_t < self.config.trace_min_interval_s:
                return None
            self._trace_active = True
            self._last_trace_t = now
            self._trace_seq += 1
            seq = self._trace_seq
        dur = max(1, min(int(duration_ms), self.config.trace_max_ms))
        path = os.path.join(dump_dir, f"prof_{seq:05d}")
        started = threading.Event()
        box: dict = {}
        try:
            os.makedirs(path, exist_ok=True)
            th = threading.Thread(target=self._capture, name="pmdfc-prof",
                                  args=(path, dur, started, box),
                                  daemon=True)
            th.start()
            if not started.wait(_CAPTURE_START_S) or "error" in box:
                raise RuntimeError(box.get("error", "capture did not start"))
        except Exception:  # noqa: BLE001 — capture is advisory
            # the capture thread (if any) clears `_trace_active` itself
            # once it has nothing left to stop
            if not box.get("thread"):
                with self._trace_lock:
                    self._trace_active = False
            shutil.rmtree(path, ignore_errors=True)
            return None
        self._rotate_captures(dump_dir)
        return {"path": path, "duration_ms": dur}

    def _capture(self, path: str, dur_ms: int, started, box: dict) -> None:
        """The capture thread: start the session, wait out the window,
        stop, export. Start and stop run on this one thread."""
        box["thread"] = True
        prof = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 — refusal, never a crash
            box["error"] = repr(e)
            prof = None
        started.set()
        try:
            if prof is None:
                return
            time.sleep(dur_ms / 1e3)
            prof.stop()
            tmp = os.path.join(path, "trace.json.tmp")
            prof.export_chrome_trace(tmp)
            os.replace(tmp, os.path.join(path, "trace.json"))
        except Exception as e:  # noqa: BLE001 — the device may be gone
            box["error"] = repr(e)
        finally:
            with self._trace_lock:
                self._trace_active = False

    def _rotate_captures(self, dump_dir: str) -> None:
        cap = self.config.trace_max_files
        if not cap:
            return
        try:
            dirs = sorted(
                (e for e in os.scandir(dump_dir)
                 if e.name.startswith("prof_") and e.is_dir()),
                key=lambda e: e.stat().st_mtime)
        except OSError:
            return
        for e in dirs[:-cap]:
            shutil.rmtree(e.path, ignore_errors=True)

    # -- snapshot (the teledump `profile` block) -------------------

    def snapshot(self) -> dict:
        with self._lock:
            # gauges refresh on window boundaries; sync them here so a
            # teledump's gauge view agrees with the profile block
            for i in range(self._n_shards):
                self._g_shard[i].set(round(self._shard_us[i], 1))
            rows = [
                {"phase": ph, "program": pr, "shard": s,
                 "ops": row[0], "device_us": round(row[1], 1)}
                for (ph, pr, s), row in sorted(self._table.items())
            ]
            doc = {
                "schema": "pmdfc-prof-v1",
                "launches": self._launches,
                "n_shards": self._n_shards,
                "rows": rows,
                "rows_dropped": self._rows_dropped,
                "shard_device_us": [round(v, 1) for v in self._shard_us],
                "shard_ops": list(self._shard_ops),
                "imbalance": round(self._imbalance, 3),
                "cost": {k: dict(v) for k, v in sorted(self._cost.items())},
            }
        return doc


# -- CUDA event pairs ----------------------------------------------

class LaunchEvents:
    """A start/end `torch.cuda.Event` pair bracketing one launch on a
    stream."""

    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start = start
        self.end = end


def elapsed_us(events) -> float:
    """A pair's device window in µs (anything with `start.elapsed_time(
    end)` in ms, as torch's events): waits for the end event first (a
    no-op once the fetch's copy has waited for the stream), then returns
    the pair to the pool."""
    sync = getattr(events.end, "synchronize", None)
    if sync is not None:
        sync()
    us = float(events.start.elapsed_time(events.end)) * 1e3
    release(events)
    return us


# guarded-by: <none>
_POOL_LOCK = threading.Lock()
_POOL: list = []       # free LaunchEvents, reused
_POOL_CAP = 64


def _pair():
    with _POOL_LOCK:
        if _POOL:
            return _POOL.pop()
    import torch

    return LaunchEvents(torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))


def release(ev) -> None:
    """Return a pair to the pool once its window has been read (None and
    duck-typed pairs are dropped)."""
    if isinstance(ev, LaunchEvents):
        with _POOL_LOCK:
            if len(_POOL) < _POOL_CAP:
                _POOL.append(ev)


def launch_begin(device) -> LaunchEvents | None:
    """Record the start event of one launch on `device`'s current stream
    -> the pair, or None when no profiler is attached, tracing is off, or
    the device is not CUDA (the fetch then times the host)."""
    if getattr(device, "type", None) != "cuda":
        return None
    if active() is None or not tele.enabled():
        return None
    import torch

    ev = _pair()
    with torch.cuda.device(device):
        ev.start.record()
    return ev


def launch_end(ev: LaunchEvents | None, device=None) -> LaunchEvents | None:
    """Record the end event of a pair `launch_begin` gave (after the
    launch's last op, on the same stream); no host sync."""
    if ev is None:
        return None
    import torch

    if device is not None:
        with torch.cuda.device(device):
            ev.end.record()
    else:
        ev.end.record()
    return ev


# -- module plumbing (mirrors telemetry's _STATE discipline) -------

class _ModState:
    __slots__ = ("registry", "prof")

    def __init__(self):
        self.registry = None
        self.prof = None


_S = _ModState()


def install(config: ProfilerConfig | None = None, registry=None) -> Profiler:
    """Attach a profiler to the registry (idempotent) and return it —
    the explicit form of the `PMDFC_PROF=on` lazy attach."""
    reg = registry if registry is not None else tele.get()
    p = getattr(reg, "profile_sink", None)
    if p is None:
        p = Profiler(config=config, registry=reg)
        reg.profile_sink = p
    _S.registry = reg
    _S.prof = p
    return p


def active() -> Profiler | None:
    """The registry's attached profiler, or None (every seam's cheap
    gate). `PMDFC_PROF` is resolved once per registry at first use — a
    `telemetry.configure()` swap re-resolves."""
    reg = tele.get()
    if _S.registry is not reg:
        p = getattr(reg, "profile_sink", None)
        if p is None and profiler_enabled():
            p = Profiler(registry=reg)
            reg.profile_sink = p
        _S.registry = reg
        _S.prof = p
    return _S.prof


def fetch(program: str, phase: str, thunk, *, n_ops: int = 0,
          counts=None, n_shards: int = 0, t_launch_ns: int = 0,
          ring: bool = False, events=None):
    """THE sanctioned sync point: run `thunk` (the blocking fetch) and
    attribute the launch. `events` (the launch's start/end pair, from
    `launch_begin`/`launch_end`, or anything with `start.elapsed_time(
    end)`) gives `device_us`; without it the thunk's host time does.
    Passthrough when no profiler is attached or the tracing tier is off.
    `ring=True` additionally rings a `device` span record (src=prof) so
    SLO stage attribution and tracetool timelines see the fetch window."""
    p = active()
    if p is None or not tele.enabled():
        out = thunk()
        release(events)
        return out
    t0 = time.monotonic_ns()
    out = thunk()
    t1 = time.monotonic_ns()
    dev_us = (t1 - t0) / 1e3 if events is None else elapsed_us(events)
    p.note_launch(program, phase, dev_us,
                  dispatch_us=max(0.0, (t0 - t_launch_ns) / 1e3)
                  if t_launch_ns else 0.0,
                  n_ops=n_ops, counts=counts, n_shards=n_shards)
    if ring:
        tele.record_tree_span("prof", "device", 0, 0, t0, t1,
                              program=program, phase=phase,
                              ops=int(n_ops))
    return out


def block_ready(x):
    """The ONE sanctioned device sync outside `fetch` thunks: warmup and
    teardown syncs with nothing worth attributing, and the waits that end
    a timed step or cut a consistent snapshot. CUDA tensors and CUDA
    `torch.device`s (alone or in a tuple/list) synchronize their devices;
    CPU ones need nothing. Returns `x`."""
    import torch

    todo = [x]
    seen = set()
    while todo:
        t = todo.pop()
        if isinstance(t, (tuple, list)):
            todo.extend(t)
            continue
        dev = t.device if isinstance(t, torch.Tensor) else t
        if isinstance(dev, torch.device) and dev.type == "cuda" \
                and dev not in seen:
            seen.add(dev)
            torch.cuda.synchronize(dev)
    return x


def cost_probe(program: str, width: int, nbytes=None,
               flops: float = 0.0) -> None:
    """Static cost of a (program, padded width) signature at its first
    call: `nbytes` (an int, or a callable computing one only then) sets
    `cost.<program>.{flops,bytes}`; None sets no gauge. A no-op when no
    profiler is attached or cost capture is off."""
    p = active()
    if p is None or not p.config.cost_capture:
        return
    p.note_cost(program, width, nbytes, flops)


def capture(duration_ms: int) -> dict | None:
    p = active()
    return p.start_capture(duration_ms) if p is not None else None
