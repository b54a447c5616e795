"""Runtime lock sanitizer — the dynamic complement of `tools/analyze`.

The static suite (`python -m tools.analyze`) proves what it can read:
declared guards, lexical nesting, resolved call edges. This module
covers the part static analysis deliberately under-approximates —
unresolvable call targets, data-dependent paths, real scheduling — by
swapping instrumented wrappers in for the serving plane's locks when
`PMDFC_SAN=on` (or `strict`; see below). Off (the default), the
factories return plain `threading` primitives: zero per-acquire cost,
byte-identical behavior.

What the instrumented wrappers check, per acquisition, against the
DECLARED hierarchy below:

- **Order inversions.** Each thread carries its held-lock set. Acquiring
  a ranked lock while holding one of equal or greater rank is an
  inversion against the hierarchy — the AB/BA half of a potential
  deadlock, reported on the FIRST occurrence instead of the one run in a
  thousand where both halves interleave.
- **Self-deadlock.** Re-acquiring a held non-reentrant `Lock` from the
  same thread can only block forever; the sanitizer reports and raises
  `RuntimeError` instead of hanging the suite.
- **Long holds.** Locks on the flush/reply path (`HOLD_WATCH`) must
  never be held across slow work — one stalled holder convoys every
  live connection. Holds beyond `PMDFC_SAN_HOLD_MS` (default 200) are
  reported with the measured duration. Condition waits do not count as
  holding (the wait releases the lock).

Reports land in three places: the in-process `violations()` list (what
the drills assert empty; appended synchronously), a `sanitizer`
telemetry scope (`inversions` / `long_holds` / `reacquires` counters),
and the flight recorder (`tele.rung("sanitizer_violation", ...)` — so a
soak that trips the sanitizer leaves an attributable dump like any
other ladder rung). The telemetry/rung half is deferred to a thread
that holds NO application locks (the queue is process-wide: a violator
parked in a cv wait is drained by the next idle releaser) — a rung can
write a flight dump, and that IO must not run inside the critical
sections the sanitizer is timing. `PMDFC_SAN=strict` additionally installs an atexit check that
prints outstanding violations and exits the process with code 70 — the
form the agenda's sanitizer-enabled soak steps run under.

THE LOCK HIERARCHY — ranks grow inward: while holding a lock of rank R,
only locks with rank STRICTLY GREATER than R may be acquired. The table
is the single source of truth shared with the static pass
(`tools/analyze/lockorder.py` imports it), so a refactor that reorders
an acquisition fails BOTH gates with the same vocabulary. Unranked
locks participate in hold/re-acquire checks only.
"""

from __future__ import annotations

import atexit
import os
import threading
import time

from pmdfc_tpu_torch.config import sanitizer_enabled, sanitizer_strict

# lock id ("Class.attr", matching the static model's lock_id) -> rank.
# Outermost tiers first; gaps leave room for new locks without renumbering.
HIERARCHY = {
    # closed-loop controller (outermost of all: a tick walks knobs on
    # the group/migrator/server/KV tiers while held — every knob hook's
    # lock must rank strictly inside)
    "AutotuneController._lock": 8,
    # group/client orchestration tier (outermost: fans out to endpoints)
    "ReplicaGroup._maps_lock": 10,
    # ring/_dead swap slot: pure reference swaps, never held across I/O
    # or another acquisition — it only needs to sit outside the repair
    # lock so membership bookkeeping (breakers/_prev_closes growth)
    # can follow a ring swap in one call chain
    "ReplicaGroup._ring_lock": 11,
    "ReplicaGroup._repair_lock": 12,
    # migration transition slot (cluster/migrate.py): batch pops and
    # counter updates only — endpoint I/O happens strictly outside
    "Migrator._lock": 13,
    # SLO watchdog: holds its window state while reading registry
    # metrics (inner telemetry locks), never the reverse
    "SloWatchdog._lock": 15,
    "ReconnectingClient._lock": 20,
    # wire serving tier
    "NetServer.op_lock": 30,
    "NetServer._push_cycle_lock": 32,
    "NetServer._flush_cv": 35,
    # per-tenant admission bucket (runtime/qos.py): refill/take and the
    # live rate knob only, never held across another acquisition — it
    # ranks inside the flush cv because edge admission runs on reader
    # threads and the rate knob may be walked from a controller already
    # holding outer tiers
    "TokenBucket._lock": 37,
    "TcpBackend._lock": 40,
    "RemotePool._lock": 40,
    "PoolServer._op_lock": 42,
    # pipeline-window admission gate (live-resizable): acquired and
    # released within one gate call, never across another acquisition
    "_WindowGate._cv": 43,
    "TcpBackend._infl_lock": 45,
    "TcpBackend._out_cv": 48,
    "_BaseServer._lock": 50,
    "_ConnState.out_cv": 55,
    # device serving tier
    # one bloom push cycle (port only): takes _bf_lock and, through
    # packed_bloom, KV._lock while held
    "KVServer._bf_push_lock": 58,
    "KVServer._bf_lock": 60,
    "KV._lock": 65,
    "ShardedKV._lock": 65,
    "Engine._call_lock": 70,
    "Engine._slice_lock": 72,
    # the engine library's first load (port only): held across the g++
    # build, takes nothing ranked
    "engine._lib_lock": 75,
    # leaf bookkeeping (never calls out while held)
    "FaultInjector._lock": 80,
    "ChaosProxy._lock": 80,
    "CircuitBreaker._lock": 80,
    # containment tier (rungs 7-9): pure set/deque bookkeeping — the
    # fault seam's armed-fault tables, the quarantine invalidation
    # journals, and the poison-fingerprint ring (reader threads probe
    # it at staging, the flush loop notes culprits); none acquires
    # anything but its own telemetry counters while held
    "FaultPlan._lock": 80,
    "ShardQuarantine._lock": 80,
    "NetServer._poison_lock": 80,
    "CleanCacheClient._bloom_lock": 80,
    "DirectoryCache._lock": 80,
    "NetServer._dir_cache_lock": 80,
    # live knob slots (autotune): scalar read/write only, never held
    # across a call — the flush loop / get() read them per cycle/op
    "NetServer._knob_lock": 80,
    "ReplicaGroup._knob_lock": 80,
    "IntegrityBackend._lock": 80,
    "LocalBackend._lock": 80,
    "Timers._lock": 80,
    "CleanCacheClient._ctr_lock": 85,
    # telemetry tier (innermost: every tier bumps counters while locked;
    # _BOOT_LOCK sits above the metric locks because the lazy `get()`
    # boot constructs the registry — and its rung scope — while held)
    "telemetry._BOOT_LOCK": 87,
    "Scope._l": 88,
    "Registry._l": 89,
    "Counter._l": 90,
    "Gauge._l": 90,
    "Histogram._l": 90,
}

# Locks whose holds must stay short: the flush loop and the per-conn
# reply path convoy EVERY live connection behind a slow holder. The KV/
# engine locks are deliberately absent — they legitimately hold across
# device dispatches (seconds, on a first-compile flush).
HOLD_WATCH = {
    "NetServer._flush_cv",
    "_ConnState.out_cv",
    "_BaseServer._lock",
    "TcpBackend._infl_lock",
    "TcpBackend._out_cv",
}


class _Tls(threading.local):
    def __init__(self):
        self.held = []     # [(name, rank|None, lock_obj_id)]


_TLS = _Tls()

_LOCK = threading.Lock()  # guarded-by: _VIOLATIONS, _PENDING
_VIOLATIONS: list[dict] = []
# violations awaiting telemetry emission — process-wide, not
# thread-local: the recording thread may park in a cv wait (or never
# release again) while holding the record, so ANY thread that reaches a
# lock-free point drains the queue
_PENDING: list[dict] = []
_EXIT_INSTALLED = False


def _hold_ms() -> float:
    try:
        return float(os.environ.get("PMDFC_SAN_HOLD_MS", "200"))
    except ValueError:
        return 200.0


class _State:
    """Resolved-once runtime switches (tests flip them via configure)."""

    def __init__(self):
        self.on = sanitizer_enabled()
        self.strict = sanitizer_strict()
        self.hold_ms = _hold_ms()


_STATE = _State()


def configure(on: bool | None = None, strict: bool | None = None,
              hold_ms: float | None = None) -> None:
    """Override the env resolution (tests/drills). Only affects locks
    constructed AFTER the call — existing instances keep whatever
    primitive they were built with."""
    if on is not None:
        _STATE.on = bool(on)
    if strict is not None:
        _STATE.strict = bool(strict)
    if hold_ms is not None:
        _STATE.hold_ms = float(hold_ms)


def enabled() -> bool:
    return _STATE.on


def violations() -> list[dict]:
    with _LOCK:
        return list(_VIOLATIONS)


def reset() -> None:
    with _LOCK:
        _VIOLATIONS.clear()
        _PENDING.clear()


def _report(kind: str, **detail) -> None:
    rec = {"kind": kind, "thread": threading.current_thread().name,
           **detail}
    with _LOCK:
        _VIOLATIONS.append(rec)
        _PENDING.append(rec)
    # telemetry emission is DEFERRED to a thread that holds no
    # application locks: a rung may write a flight dump, and that IO
    # must never run inside the very critical sections (flush loop,
    # per-conn reply path) the sanitizer is timing — it would convoy
    # live connections and then self-report its own dump as a long
    # hold. The flush happens in `release()` AFTER the wrapped
    # primitive is physically dropped (the held-set alone is not
    # enough: during a release the bookkeeping runs while the inner
    # lock is still owned). `violations()` stays synchronous either
    # way.


def _flush_pending() -> None:
    with _LOCK:
        pending, _PENDING[:] = list(_PENDING), []
    # the shared (unique=False) scope survives registry swaps:
    # violations are rare, so re-resolving it per report costs nothing
    try:
        from pmdfc_tpu_torch.runtime import telemetry as tele

        scope = tele.scope("sanitizer", {
            "inversions": 0, "long_holds": 0, "reacquires": 0},
            unique=False)
        for rec in pending:
            kind = rec["kind"]
            scope.inc({"inversion": "inversions",
                       "long_hold": "long_holds",
                       "reacquire": "reacquires"}.get(kind, kind))
            # the record's own `kind` ("inversion"/...) must not ride
            # into the rung kwargs verbatim: it would overwrite the
            # flight-recorder ring tag (`kind: "rung"`) and mislabel
            # the dump record every consumer classifies by
            detail = dict(rec)
            detail["violation"] = detail.pop("kind")
            tele.rung("sanitizer_violation", **detail)
    except Exception:  # noqa: BLE001 — reporting must never take down
        pass           # the serving path it watches


def _exit_check() -> None:
    v = violations()
    if not v:
        return
    # the atexit thread holds no application locks: emit whatever the
    # violating threads (possibly still parked in waits) never flushed,
    # so the flight dump exists alongside the exit-70 report
    _flush_pending()
    import sys

    print(f"[sanitizer] {len(v)} violation(s):", file=sys.stderr)
    for rec in v[:50]:
        print(f"[sanitizer]   {rec}", file=sys.stderr)
    sys.stderr.flush()
    # atexit cannot change the interpreter's exit status; under strict
    # mode a dirty soak must fail its agenda step, so hard-exit 70
    os._exit(70)


def _maybe_install_exit() -> None:
    global _EXIT_INSTALLED
    if _STATE.strict and not _EXIT_INSTALLED:
        _EXIT_INSTALLED = True
        atexit.register(_exit_check)


def _on_acquired(name: str, rank, obj_id: int, reentrant: bool) -> None:
    held = _TLS.held
    for hname, hrank, hid in held:
        if hid == obj_id:
            if reentrant:
                break  # RLock recursion: tracked once, no check
            _report("reacquire", lock=name)
            raise RuntimeError(
                f"sanitizer: non-reentrant lock {name!r} re-acquired by "
                f"its holding thread (certain deadlock)")
        if rank is not None and hrank is not None and hrank >= rank:
            _report("inversion", acquired=name, rank=rank,
                    while_holding=hname, held_rank=hrank)
    held.append((name, rank, obj_id))


def _on_released(name: str, obj_id: int, t_acquired: float) -> bool:
    held = _TLS.held
    for i in range(len(held) - 1, -1, -1):
        if held[i][2] == obj_id:
            del held[i]
            break
    if name in HOLD_WATCH and t_acquired:
        dt_ms = (time.monotonic() - t_acquired) * 1e3
        if dt_ms > _STATE.hold_ms:
            _report("long_hold", lock=name, held_ms=round(dt_ms, 1),
                    limit_ms=_STATE.hold_ms)
    # flush-due: the CALLER flushes, after the wrapped primitive is
    # actually released — at this point the inner lock is still owned.
    # The queue is process-wide, so this thread may be draining a
    # violation a parked (cv-waiting) thread recorded.
    if held:
        return False
    with _LOCK:
        return bool(_PENDING)


class _SanBase:
    """Shared acquire/release bookkeeping over a wrapped primitive."""

    _REENTRANT = False

    def __init__(self, name: str, inner):
        self._name = name
        self._rank = HIERARCHY.get(name)
        self._inner = inner
        self._t_acq = 0.0  # per-holder; safe: read only by the holder
        self._depth = 0    # RLock recursion depth (holder-only too)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def _note_acquired(self) -> None:
        if self._REENTRANT and self._depth > 0 \
                and any(h[2] == id(self) for h in _TLS.held):
            self._depth += 1
            return
        _on_acquired(self._name, self._rank, id(self), self._REENTRANT)
        self._depth = 1
        self._t_acq = time.monotonic()

    def release(self) -> None:
        flush_due = self._note_release()
        self._inner.release()
        if flush_due:
            _flush_pending()

    def _note_release(self) -> bool:
        if self._REENTRANT and self._depth > 1:
            self._depth -= 1
            return False
        self._depth = 0
        return _on_released(self._name, id(self), self._t_acq)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<San{type(self._inner).__name__} {self._name}>"


class SanLock(_SanBase):
    def __init__(self, name: str):
        super().__init__(name, threading.Lock())

    def acquire(self, blocking: bool = True, timeout: float = -1):
        # pre-check BEFORE the inner acquire: a BLOCKING acquire on a
        # self-held Lock would hang before any post-acquire check ran.
        # A non-blocking probe on a self-held lock cannot deadlock —
        # plain threading.Lock legally returns False there, so must we.
        if blocking and any(h[2] == id(self) for h in _TLS.held):
            _report("reacquire", lock=self._name)
            raise RuntimeError(
                f"sanitizer: non-reentrant lock {self._name!r} "
                f"re-acquired by its holding thread (certain deadlock)")
        return super().acquire(blocking, timeout)


class SanRLock(_SanBase):
    _REENTRANT = True

    def __init__(self, name: str):
        super().__init__(name, threading.RLock())


class SanCondition(_SanBase):
    """Condition wrapper: wait() releases the underlying lock, so the
    held-set drops the entry for the wait's duration and hold timing
    restarts on wake — a 0.2 s `wait()` tick is not a 0.2 s hold.

    Reentrant, like the wrapped primitive: `threading.Condition()`'s
    default lock is an RLock, so nested `with cv:` is legal and must
    not be reported (or worse, refused — a refusal after the inner
    acquire succeeded would leak a recursion level and wedge the
    condition for every other thread)."""

    _REENTRANT = True

    def __init__(self, name: str):
        super().__init__(name, threading.Condition())

    def _pre_wait(self) -> int:
        # Condition.wait releases ALL recursion levels of its RLock
        # (via _release_save), so drop the held-set entry outright and
        # remember the depth to restore on wake.
        depth, self._depth = self._depth, 1
        self._note_release()
        return depth

    def _post_wait(self, depth: int) -> None:
        _on_acquired(self._name, self._rank, id(self), True)
        self._depth = depth
        self._t_acq = time.monotonic()

    def wait(self, timeout: float | None = None):
        depth = self._pre_wait()
        try:
            return self._inner.wait(timeout)
        finally:
            self._post_wait(depth)

    def wait_for(self, predicate, timeout: float | None = None):
        depth = self._pre_wait()
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._post_wait(depth)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def lock(name: str):
    """`threading.Lock()` (sanitizer off) or a `SanLock` tracking `name`
    against the hierarchy. `name` must match the static model's lock id
    (`Class.attr`) so both passes speak the same vocabulary."""
    if not _STATE.on:
        return threading.Lock()
    _maybe_install_exit()
    return SanLock(name)


def rlock(name: str):
    if not _STATE.on:
        return threading.RLock()
    _maybe_install_exit()
    return SanRLock(name)


def condition(name: str):
    if not _STATE.on:
        return threading.Condition()
    _maybe_install_exit()
    return SanCondition(name)
