"""Failure detection, reconnect, and fault injection.

Reference: the tcp_style client carries real failure machinery ported from
OCFS2 o2net — idle timeout, keepalive, reconnect delay, and a shutdown/
reconnect state machine (`client/tcp_style/tcp.c:648-705`, `tcp.h:30-34`).
The RDMA client's only story is `rnr_retry_count 7` + "a miss is always
legal" (`client/rdpma.c:1656`) — which IS the fault model: a clean cache may
lose anything, so the client's job is to detect the dead server, degrade to
legal misses/drops, and re-attach when it returns. The vendored
`nvme/host/fault_inject.c` precedent motivates the injection hooks.

TPU-native pieces:
- `ReconnectingClient` — the o2net state machine as a Backend wrapper:
  ops flow through a live backend; any transport failure (engine timeout,
  closed engine, refused connection) flips the state to DOWN, converts the
  op to its legal degraded result (put → dropped, get → miss,
  invalidate → no-op False), and each subsequent op first attempts one
  bounded reconnect through the caller's factory (the `rdma_resolve_addr`
  analog). No exception ever escapes a page op — exactly the kernel
  client's contract.
- `FaultInjector` — serve-loop hooks for the two failure classes the
  reference tier exercises: completions dropped on the floor (clients must
  time out, not hang) and a stalled driver (submission queues fill; clients
  must surface backpressure as bounded drops). Armed per-batch with
  countdowns so tests are deterministic.
- `CircuitBreaker` — the per-endpoint health gate (closed → open →
  half-open with jittered, widening cooldown) that `client/replica.py`'s
  `ReplicaGroup` routes by: a replica that keeps timing out, corrupting
  frames, or failing digests is skipped entirely until a probe succeeds,
  so one sick server never taxes healthy traffic per-op. Attach one via
  `ReconnectingClient(breaker=...)` and op outcomes feed it.
- `ChaosProxy` — a seeded, deterministic NET-level injector: a frame-aware
  TCP proxy between client and server that can bit-flip payloads, truncate
  frames mid-write, duplicate deliveries, delay/reorder frames, and go
  half-open (swallow traffic on a live socket). Everything TCP itself
  would never do — but proxies, middleboxes, and buggy peers DO.
- Server restart + checkpoint restore is composed from existing pieces
  (`checkpoint.save/load` + a fresh `KVServer`) — see
  `tests/test_failure.py` for the kill → restore → reconnect drill, which
  measures the recovery path end to end.

THE INTEGRITY / DEGRADATION LADDER — every fault lands on exactly one rung,
and every rung degrades to a LEGAL clean-cache outcome (miss/drop), never
an exception out of a page op, never wrong bytes:

1. **Page checksum miss** (`kv.py` + `ops/pagepool.py`): bytes at rest no
   longer match their insert-time digest → the GET reports a first-class
   miss and bumps `corrupt_pages`. The page is never returned.
2. **Wire frame drop** (`runtime/net.py`): a frame failing its CRC32 (or a
   desynchronized reply stream) raises `ProtocolError`, the connection is
   dropped, the server bumps `bad_frames` — nothing from the bad frame is
   ever parsed or applied. On a PIPELINED connection the same rung covers
   the whole window: an unmatched/duplicated sequence id or an expired
   per-verb deadline drops the connection and fails every in-window verb
   with `ConnectionError` — a windowed failure is N simultaneous rung-2/3
   degradations, never a mis-routed reply.
3. **Reconnect with backoff** (`ReconnectingClient`): the dropped
   connection degrades ops to misses/drops while reconnect attempts space
   out exponentially with seeded jitter (`reconnect_backoffs` counts the
   widenings); success resets the delay and replays the invalidation
   journal before any op flows. Concurrent threads sharing one wrapped
   pipelined backend all land here together when its window fails: each
   thread's op independently degrades (dropped put / missed get /
   journaled invalidate) and the single-flight reconnect serves them all.
4. **Checkpoint restore** (`checkpoint.py`): a dead server restarts from
   the last durable snapshot CHAIN (full + incremental deltas); a
   torn/corrupt member raises `CheckpointCorruptError`, a gapped or
   out-of-order chain raises `SnapshotChainError` — both REJECTED, so
   restart serves the previous durable state (or cold), never partial
   state. The write-ahead journal (`runtime/journal.py`) narrows the
   loss window to the `JournalConfig(rpo_ops, rpo_ms)` bound: a torn
   journal TAIL truncates cleanly (the expected kill -9 artifact, bytes
   counted), while a corrupt record in earlier history is
   `JournalCorruptError` — refused, never skipped. A sync that outruns
   the RPO window fires the `journal_stall` flight rung.
5. **Warm restart** (`runtime/journal.warm_restart`): the restarted
   member serves restored rows immediately in a `recovering` state —
   not-yet-caught-up misses attribute to the `miss_recovering` cause
   lane (so `misses == Σ causes` stays exact mid-recovery) until ring
   migration + anti-entropy drain and the replica tier flips
   `mark_recovered` (`MSG_RECOVERY`).
6. **Replica-set exhausted** (`client/replica.py`): when every replica
   of a key's set sits behind an OPEN breaker, the group load-sheds to
   the legal clean-cache outcome (GET → miss, PUT → drop, counted in
   `load_shed_*`) — still never an exception, still never wrong bytes.
7. **NACK** (`runtime/net.py`, negotiated): a fused-phase failure is
   BISECTED to the culpable op(s); each culprit is answered `MSG_NACK`
   (an explicit, cause-carrying legal miss/drop) instead of rung-3
   dropping every involved connection, its key digest enters the
   staging-time poison-fingerprint ring (a resubmit is refused before
   it ever reaches the device), and every healthy op in the batch
   completes normally on a live connection. Non-negotiated peers keep
   exact rung-3 semantics — but only for the culprit's connection.
8. **Shard quarantine** (`ShardQuarantine` + `parallel/plane.py`): a
   shard whose program keeps failing (shard-attributed via
   `ShardFault`) trips its shard-scoped `CircuitBreaker`; its routed
   GETs degrade to `miss_quarantined` misses HOST-SIDE (no device
   dispatch), PUTs drop acked, invalidations journal for replay at
   re-admission, and healthy shards keep serving. Half-open probes
   re-admit the shard when its program heals (`shard_quarantine` rung
   on both transitions).
9. **Deadline shed** (`runtime/net.py`): a staged op whose negotiated
   end-to-end deadline budget expired is answered before device
   dispatch (`miss_deadline` cause lane) — expired work never burns a
   flush slot, and the client tiers (`ReplicaGroup`,
   `ReconnectingClient`) stop retrying dead work.
"""

from __future__ import annotations

import collections
import random
import socket
import struct
import threading
import time

import numpy as np

from pmdfc_tpu_torch.runtime import sanitizer as san
from pmdfc_tpu_torch.runtime import telemetry as tele


class FaultInjector:
    """Batch-granular fault hooks for `KVServer.serve_batch`.

    Arm with `drop_next(n)` (the next n batches complete NOTHING — requests
    vanish like lost packets) or `stall_next(n, seconds)` (the driver sleeps
    before serving, filling submission queues upstream). Thread-safe.
    """

    def __init__(self):
        # guarded-by: _drop_left, _stall_left, stall_s, stats
        self._lock = san.lock("FaultInjector._lock")
        self._drop_left = 0
        self._stall_left = 0
        self.stall_s = 0.0
        self.stats = {"dropped_batches": 0, "stalled_batches": 0}

    def drop_next(self, n: int = 1) -> None:
        with self._lock:
            self._drop_left += n

    def stall_next(self, n: int = 1, seconds: float = 0.05) -> None:
        with self._lock:
            self._stall_left += n
            self.stall_s = seconds

    def on_batch(self, reqs) -> str | None:
        """Called by the serve loop; returns "drop" to swallow the batch."""
        with self._lock:
            if self._drop_left > 0:
                self._drop_left -= 1
                self.stats["dropped_batches"] += 1
                return "drop"
            stall = self._stall_left > 0
            if stall:
                self._stall_left -= 1
                self.stats["stalled_batches"] += 1
            stall_s = self.stall_s
        if stall:
            time.sleep(stall_s)
        return None


class ChaosProxy:
    """Seeded, deterministic, frame-aware TCP chaos injector.

    Sits between a `TcpBackend` (or `RemotePool`) and its server, parsing
    the messenger's framing so faults land on WHOLE protocol frames — the
    in-flight loss/reorder class RDMAbox shows remote-paging stacks live
    or die on. Faults:

    - ``flip``      — XOR one bit of the frame (payload if present, header
                      otherwise) and forward it: the wire-CRC rung.
    - ``truncate``  — forward a prefix of the frame, then kill both sides:
                      the torn-frame / dead-peer rung.
    - ``duplicate`` — forward the frame twice: a desynchronized
                      request/reply stream the client must detect.
    - ``delay``     — sleep `delay_s` before forwarding (in-order lag).
    - ``reorder``   — hold the frame, wait briefly for the NEXT frame in
                      the same direction, forward that one first. On a
                      strict request/reply channel no second frame can
                      arrive, so the hold degrades to a bounded delay.
    - ``half_open`` — from this frame on, swallow this direction's
                      traffic while both sockets stay open: the
                      peer-vanished-without-FIN rung (idle timeouts and
                      keepalives are the only way out).

    Two trigger modes, combinable: `arm(fault, n)` fires the fault on the
    next n frames (deterministic drills), and `rates={fault: p}` draws
    per-frame from a SEEDED rng (deterministic soak schedules — same
    seed + same traffic ⇒ same fault sequence). Frames are parsed but
    never validated here: the proxy corrupts; the endpoints must detect.
    """

    _FAULTS = ("flip", "truncate", "duplicate", "delay", "reorder",
               "half_open")

    def __init__(self, upstream_host: str, upstream_port: int,
                 host: str = "127.0.0.1", port: int = 0, seed: int = 0,
                 rates: dict | None = None, delay_s: float = 0.05,
                 reorder_wait_s: float = 0.1):
        from pmdfc_tpu_torch.runtime import net as net_mod

        self._net = net_mod
        self.upstream = (upstream_host, upstream_port)
        self.delay_s = delay_s
        self.reorder_wait_s = reorder_wait_s
        self.rates = dict(rates or {})
        bad = set(self.rates) - set(self._FAULTS)
        if bad:
            raise ValueError(f"unknown chaos faults {sorted(bad)}")
        self._rng = random.Random(seed)
        # guarded-by: _armed, _conns
        self._lock = san.lock("ChaosProxy._lock")
        self._armed: collections.Counter = collections.Counter()
        self.stats: collections.Counter = collections.Counter()
        self._stop = threading.Event()
        self._conns: list[socket.socket] = []
        self._half_open: set[tuple] = set()
        self._lsock = socket.create_server((host, port))
        self.host, self.port = self._lsock.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="chaos-accept")
        self._accept_thread.start()

    # -- arming --

    def arm(self, fault: str, n: int = 1) -> None:
        if fault not in self._FAULTS:
            raise ValueError(f"unknown chaos fault {fault!r}")
        with self._lock:
            self._armed[fault] += n

    def flip_next(self, n: int = 1) -> None:
        self.arm("flip", n)

    def truncate_next(self, n: int = 1) -> None:
        self.arm("truncate", n)

    def dup_next(self, n: int = 1) -> None:
        self.arm("duplicate", n)

    def delay_next(self, n: int = 1, seconds: float | None = None) -> None:
        if seconds is not None:
            self.delay_s = seconds
        self.arm("delay", n)

    def reorder_next(self, n: int = 1) -> None:
        self.arm("reorder", n)

    def half_open_next(self, n: int = 1) -> None:
        self.arm("half_open", n)

    def _draw(self) -> str | None:
        """One fault decision per forwarded frame: armed counters first
        (deterministic drills), then the seeded per-frame rates."""
        with self._lock:
            for f in self._FAULTS:
                if self._armed[f] > 0:
                    self._armed[f] -= 1
                    return f
            for f in self._FAULTS:
                p = self.rates.get(f, 0.0)
                if p > 0 and self._rng.random() < p:
                    return f
        return None

    # -- plumbing --

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            try:
                up = socket.create_connection(self.upstream, timeout=10)
            except OSError:
                conn.close()
                continue
            for s in (conn, up):
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns += [conn, up]
            for src, dst, name in ((conn, up, "c2s"), (up, conn, "s2c")):
                threading.Thread(
                    target=self._pump, args=(src, dst, name),
                    daemon=True, name=f"chaos-{name}",
                ).start()

    class _FrameReader:
        """Buffered frame reader: partial bytes survive a timed-out read
        (the reorder hold), so a timeout can never desynchronize the
        stream — the next read resumes exactly where this one stopped.
        Returns a frame (bytes), None on EOF/error, or the `TIMEOUT`
        sentinel when `timeout_s` elapsed mid-frame."""

        TIMEOUT = object()

        def __init__(self, sock: socket.socket, hdr_struct):
            self._sock = sock
            self._hdr = hdr_struct
            self._buf = bytearray()

        def _fill(self, n: int, deadline: float | None):
            while len(self._buf) < n:
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return self.TIMEOUT
                try:
                    self._sock.settimeout(
                        left if deadline is not None else None)
                    chunk = self._sock.recv(n - len(self._buf))
                except socket.timeout:
                    return self.TIMEOUT
                except OSError:
                    return None
                if not chunk:
                    return None
                self._buf += chunk
            return True

        def read_frame(self, timeout_s: float | None = None):
            deadline = (time.monotonic() + timeout_s
                        if timeout_s is not None else None)
            hn = self._hdr.size
            got = self._fill(hn, deadline)
            if got is not True:
                return got
            try:
                dlen = self._hdr.unpack(bytes(self._buf[:hn]))[6]
            except struct.error:
                dlen = 0
            need = hn + (dlen if 0 < dlen <= (1 << 30) else 0)
            got = self._fill(need, deadline)
            if got is not True:
                return got
            frame = bytes(self._buf[:need])
            del self._buf[:need]
            return frame

    def _kill_pair(self, a: socket.socket, b: socket.socket) -> None:
        for s in (a, b):
            # shutdown BEFORE close: the peer pump thread is usually
            # blocked in recv() on one of these sockets, and on Linux a
            # bare close() from another thread defers the real teardown
            # until that syscall returns — no FIN is sent, so the remote
            # endpoint would sit out its full op timeout instead of
            # seeing the connection die. shutdown() tears the connection
            # down immediately regardless of in-flight syscalls.
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def _pump(self, src: socket.socket, dst: socket.socket,
              name: str) -> None:
        hdr_n = self._net._HDR.size
        reader = self._FrameReader(src, self._net._HDR)
        while not self._stop.is_set():
            frame = reader.read_frame()
            if frame is None or frame is self._FrameReader.TIMEOUT:
                self._kill_pair(src, dst)
                return
            if (id(src), id(dst)) in self._half_open:
                self.stats["swallowed_frames"] += 1
                continue
            fault = self._draw()
            try:
                if fault == "flip":
                    mut = bytearray(frame)
                    # flip inside the payload when there is one (the CRC
                    # rung), else in the header (the bad-magic/desync rung)
                    lo = hdr_n if len(frame) > hdr_n else 0
                    pos = self._rng.randrange(lo, len(frame))
                    mut[pos] ^= 1 << self._rng.randrange(8)
                    dst.sendall(bytes(mut))
                    self.stats["flipped_frames"] += 1
                elif fault == "truncate":
                    cut = max(1, self._rng.randrange(1, max(2, len(frame))))
                    dst.sendall(frame[:cut])
                    self.stats["truncated_frames"] += 1
                    self._kill_pair(src, dst)
                    return
                elif fault == "duplicate":
                    dst.sendall(frame + frame)
                    self.stats["duplicated_frames"] += 1
                elif fault == "delay":
                    time.sleep(self.delay_s)
                    dst.sendall(frame)
                    self.stats["delayed_frames"] += 1
                elif fault == "reorder":
                    # hold the frame, wait briefly for the NEXT one; a
                    # timeout keeps any partial bytes buffered in the
                    # reader, so the stream can never desynchronize here
                    nxt = reader.read_frame(timeout_s=self.reorder_wait_s)
                    if nxt is None:
                        dst.sendall(frame)
                        self._kill_pair(src, dst)
                        return
                    if nxt is self._FrameReader.TIMEOUT:
                        dst.sendall(frame)  # nothing to swap: bounded delay
                        self.stats["delayed_frames"] += 1
                    else:
                        dst.sendall(nxt + frame)
                        self.stats["reordered_frames"] += 1
                elif fault == "half_open":
                    self._half_open.add((id(src), id(dst)))
                    self.stats["half_open_drops"] += 1
                    self.stats["swallowed_frames"] += 1
                else:
                    dst.sendall(frame)
                    self.stats["forwarded_frames"] += 1
            except OSError:
                self._kill_pair(src, dst)
                return

    def close(self) -> None:
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            # same shutdown-first discipline as _kill_pair: pump threads
            # blocked in recv() must wake NOW, not at their op timeout
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def __enter__(self) -> "ChaosProxy":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_TRANSPORT_ERRORS = (TimeoutError, RuntimeError, MemoryError,
                     ConnectionError, OSError, ValueError, struct.error)


class CircuitBreaker:
    """Per-endpoint health gate: closed → open → half-open.

    The replica group's routing signal (`client/replica.py`): while a
    breaker is OPEN its endpoint is skipped entirely — no connect
    attempt, no timeout wait — so one sick server costs healthy traffic
    nothing per-op. Fed by the three failure classes the integrity
    ladder distinguishes: transport timeouts, wire `bad_frames`
    (`ProtocolError`), and end-to-end digest mismatches.

    - CLOSED: ops flow; `breaker_failures` CONSECUTIVE failures open it
      (any success resets the streak — a clean-cache miss is a success).
    - OPEN: `allow()` returns False until a jittered cooldown elapses,
      then the breaker half-opens.
    - HALF_OPEN: up to `half_open_probes` ops may flow. One success
      closes (cooldown resets); one failure re-opens with the cooldown
      widened by `backoff` (capped at `max_cooldown_s`) — the same
      thundering-herd discipline as `ReconnectingClient`'s reconnect
      spacing, and the seeded jitter keeps drills reproducible.

    `allow()` CONSUMES a half-open probe slot; `ready()` is the
    non-consuming routing peek (may transition OPEN → HALF_OPEN when the
    cooldown has elapsed, never spends a probe). Thread-safe.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failures_to_open: int = 3,
                 cooldown_s: float = 0.5, max_cooldown_s: float = 10.0,
                 backoff: float = 2.0, jitter: float = 0.25,
                 half_open_probes: int = 1, seed: int = 0,
                 name: str | None = None):
        self.failures_to_open = failures_to_open
        self.cooldown_s = cooldown_s
        self.max_cooldown_s = max(max_cooldown_s, cooldown_s)
        self.backoff = backoff
        self.jitter = jitter
        self.half_open_probes = half_open_probes
        self._rng = random.Random(seed)
        # guarded-by: _state, _streak, _cur_cooldown, _open_until,
        # guarded-by: _probes_left, _down_since
        self._lock = san.lock("CircuitBreaker._lock")
        self._state = self.CLOSED
        self._streak = 0
        self._cur_cooldown = cooldown_s
        self._open_until = 0.0
        self._probes_left = 0
        # monotonic stamp of the first departure from CLOSED in the
        # current outage (None while closed): survives open -> half_open
        # -> reopen cycles, so `down_for()` measures the whole outage —
        # the latch the membership tier's auto-replacement keys on
        self._down_since: float | None = None
        # registry-backed stats (same mapping reads the old dict served:
        # `br.stats["closes"]`, `dict(br.stats)`); `name` is the endpoint
        # identity flight-recorder rungs attribute opens to
        self.stats = tele.scope("breaker", {
            "opens": 0, "reopens": 0, "closes": 0, "probes": 0,
            "shed_ops": 0, "timeouts": 0, "bad_frames": 0,
            "digest_mismatches": 0, "forced_opens": 0,
        })
        self.name = name if name is not None else self.stats.prefix

    # -- transitions (all called with the lock held) --

    def _open_locked(self, reopen: bool) -> None:
        self._state = self.OPEN
        self._streak = 0
        if self._down_since is None:
            self._down_since = time.monotonic()
        delay = self._cur_cooldown * (1.0 + self.jitter * self._rng.random())
        self._open_until = time.monotonic() + delay
        self._cur_cooldown = min(self.max_cooldown_s,
                                 self._cur_cooldown * self.backoff)
        self.stats.inc("reopens" if reopen else "opens")

    def _maybe_half_open_locked(self) -> None:
        if self._state == self.OPEN \
                and time.monotonic() >= self._open_until:
            self._state = self.HALF_OPEN
            self._probes_left = self.half_open_probes

    # -- gate --

    def allow(self) -> bool:
        """May ONE op flow now? Consumes a half-open probe slot."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and self._probes_left > 0:
                self._probes_left -= 1
                self.stats.inc("probes")
                return True
            self.stats.inc("shed_ops")
            return False

    def ready(self) -> bool:
        """Non-consuming peek: would `allow()` grant an op right now?"""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return True
            return self._state == self.HALF_OPEN and self._probes_left > 0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def down_for(self) -> float:
        """Seconds this breaker has been continuously out of CLOSED
        (0.0 while closed). Half-open probe cycles do NOT reset it —
        only a recorded success does — so a breaker that keeps latching
        open reads as one long outage: the signal breaker-driven
        auto-replacement (`ReplicaGroup`) triggers on."""
        with self._lock:
            if self._down_since is None:
                return 0.0
            return time.monotonic() - self._down_since

    def record_success(self) -> None:
        with self._lock:
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self._cur_cooldown = self.cooldown_s
                self.stats.inc("closes")
            self._streak = 0
            self._down_since = None

    def record_failure(self, kind: str = "timeout") -> None:
        """`kind` ∈ {"timeout", "bad_frame", "digest"} — the ladder's
        three endpoint-health signals."""
        key = {"timeout": "timeouts", "bad_frame": "bad_frames",
               "digest": "digest_mismatches"}.get(kind)
        if key is None:
            raise ValueError(f"unknown failure kind {kind!r}")
        opened = None
        with self._lock:
            self._maybe_half_open_locked()
            self.stats.inc(key)
            if self._state == self.HALF_OPEN:
                self._open_locked(reopen=True)
                opened = "reopen"
            elif self._state == self.CLOSED:
                self._streak += 1
                if self._streak >= self.failures_to_open:
                    self._open_locked(reopen=False)
                    opened = "open"
            # already OPEN: a straggling failure changes nothing
        if opened is not None:
            # outside the lock: the rung may write a flight dump, and IO
            # must never ride inside the breaker's critical section
            tele.rung("breaker_open", endpoint=self.name, kind=kind,
                      reopen=opened == "reopen",
                      cooldown_s=round(self._cur_cooldown, 4))

    def force_open(self, cooldown_s: float | None = None) -> None:
        """Administrative open — the membership tier's quarantine/retire
        signal (`ReplicaGroup.replace_endpoint` quarantines a suspect
        member for the transition's duration; `_retire_slot` opens a
        left member forever). `cooldown_s=None` never half-opens: the
        endpoint is permanently out of rotation (`ready()`/`allow()`
        stay False). A finite cooldown behaves like a normal open of
        that width — half-open probes resume after it, so a mistaken
        quarantine self-heals through the ordinary state machine."""
        with self._lock:
            self._state = self.OPEN
            self._streak = 0
            if self._down_since is None:
                self._down_since = time.monotonic()
            self._open_until = (float("inf") if cooldown_s is None
                                else time.monotonic() + cooldown_s)
            self.stats.inc("forced_opens")
        tele.rung("breaker_open", endpoint=self.name, kind="forced",
                  reopen=False,
                  cooldown_s=(-1.0 if cooldown_s is None
                              else round(cooldown_s, 4)))


class ReconnectingClient:
    """Backend wrapper that degrades failures to legal clean-cache results
    and re-attaches when the server returns.

    `factory` builds a fresh backend against the CURRENT server (raising
    while the server is down — the refused-connection analog). States:
    UP (ops flow) → DOWN (op failed; backend discarded) → one bounded
    reconnect attempt per op, spaced by EXPONENTIAL BACKOFF with seeded
    jitter: the first retry comes after `retry_delay_s`, each failed
    attempt multiplies the spacing by `backoff` (capped at
    `max_retry_delay_s`, `reconnect_backoffs` counts the widenings), and
    a successful reconnect resets it. The o2net reconnect delay
    (`tcp.c:648-705`) is the constant-delay ancestor; backoff+jitter is
    what keeps a THUNDERING HERD of clients from hammering a server that
    is struggling back up (every client re-attaching at the same constant
    period re-kills it), and the seeded jitter de-synchronizes clients
    that died at the same instant while staying reproducible in drills.
    """

    def __init__(self, factory, page_words: int,
                 retry_delay_s: float = 0.05,
                 max_retry_delay_s: float = 2.0,
                 backoff: float = 2.0,
                 jitter: float = 0.25,
                 seed: int = 0,
                 inval_journal_cap: int = 1 << 14,
                 breaker: CircuitBreaker | None = None):
        self._factory = factory
        # Optional health feedback sink (`ReplicaGroup` attaches one per
        # endpoint): op successes/failures feed the breaker so the group
        # can route around this endpoint without per-op penalty. A
        # half-open probe also bypasses the reconnect backoff spacing
        # (`_ensure(force=...)`) — the breaker's cooldown IS the spacing
        # then, and a probe that merely hit the local delay gate would
        # re-open the breaker against a healthy server.
        self.breaker = breaker
        self.page_words = page_words
        self.retry_delay_s = retry_delay_s
        self.max_retry_delay_s = max(max_retry_delay_s, retry_delay_s)
        self.backoff = backoff
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._cur_delay = retry_delay_s
        self._be = None
        self._last_attempt = 0.0
        self._connecting = False
        # desired pipeline window (autotune hook, None = factory
        # default): re-applied to every reconnect's fresh backend so a
        # live-set survives the degrade path
        self._want_window: int | None = None
        # guarded-by: _be, _last_attempt, _connecting, _cur_delay,
        # guarded-by: _inval_journal, _want_window
        self._lock = san.lock("ReconnectingClient._lock")
        # Invalidation journal, replayed after every reconnect: a server
        # restored from a snapshot resurrects entries whose invalidations
        # landed AFTER the snapshot (and ones that failed during downtime) —
        # serving those would be stale data, which clean-cache does NOT
        # make legal. Re-invalidating an absent key is a no-op, so replay
        # is idempotent; the journal is bounded (older invalidations are
        # covered by any snapshot they preceded).
        self._inval_journal: collections.deque = collections.deque(
            maxlen=inval_journal_cap
        )
        # registry-backed (runtime/telemetry.py): stats() reads this
        # scope, the text exporter/teledump render it, and the deprecated
        # `counters` alias below snapshots it
        self._stats = tele.scope("reconnecting", {
            "disconnects": 0, "reconnects": 0, "dropped_puts": 0,
            "missed_gets": 0, "failed_invalidates": 0,
            "replayed_invalidates": 0, "reconnect_backoffs": 0,
            "dropped_extent_puts": 0,
            # miss-cause split of missed_gets (the taxonomy's client
            # rungs): breaker-gated vs plain transport-down degradation;
            # `missed_gets == breaker_open + disconnected` always
            "missed_gets_breaker_open": 0,
            "missed_gets_disconnected": 0,
        })

    # (the `counters` one-release deprecation shim promised for removal
    # in PR 5 is gone — `stats()` is the only counter surface)

    # -- breaker feedback --

    def _op_ok(self) -> None:
        if self.breaker is not None:
            self.breaker.record_success()

    def _op_failed(self, exc: BaseException | None = None) -> None:
        if self.breaker is None:
            return
        from pmdfc_tpu_torch.runtime.net import ProtocolError

        kind = "bad_frame" if isinstance(exc, ProtocolError) else "timeout"
        self.breaker.record_failure(kind)

    def _probe_forced(self) -> bool:
        """A half-open breaker probe must actually try the reconnect —
        see the `breaker` note in `__init__`."""
        return (self.breaker is not None
                and self.breaker.state == CircuitBreaker.HALF_OPEN)

    def _miss_gets(self, n: int) -> None:
        """One degraded GET's miss accounting, cause attached: a
        non-closed breaker marks the endpoint gated (the taxonomy's
        `breaker-open` rung), anything else is a plain transport-down
        degradation."""
        self._stats.inc("missed_gets", n)
        if self.breaker is not None \
                and self.breaker.state != CircuitBreaker.CLOSED:
            self._stats.inc("missed_gets_breaker_open", n)
        else:
            self._stats.inc("missed_gets_disconnected", n)

    # -- state machine --

    def _mark_down(self) -> None:
        with self._lock:
            if self._be is not None:
                self._stats.inc("disconnects")
                be, self._be = self._be, None
                try:
                    # quarantine, don't free: the dead backend's staging
                    # slice may still be referenced by queued requests — a
                    # late completion into a REUSED slice would corrupt the
                    # new owner's pages (see EngineBackend.abandon)
                    if hasattr(be, "abandon"):
                        be.abandon()
                    be.close()
                except Exception:  # noqa: BLE001 — dying backend, best effort
                    pass

    def _ensure(self, force: bool = False):
        """Current backend, or one bounded reconnect attempt, or None.

        Connect + journal replay are blocking I/O and run OUTSIDE the lock
        (a reconnect must not stall concurrent ops — they degrade to legal
        drops/misses instead); `_connecting` keeps it single-flight.
        `force` skips the backoff spacing (never the single-flight gate):
        a breaker half-open probe already waited its own cooldown.
        """
        with self._lock:
            if self._be is not None:
                return self._be
            now = time.monotonic()
            if self._connecting or (not force and
                                    now - self._last_attempt < self._cur_delay):
                return None
            self._last_attempt = now
            self._connecting = True
            journal = list(self._inval_journal)
        be = None
        replayed = 0
        try:
            try:
                be = self._factory()
            except _TRANSPORT_ERRORS:
                return None
            # re-apply the live-set pipeline window (autotune): the
            # factory builds with its own default, and a knob the
            # controller walked must survive the reconnect
            with self._lock:
                want_win = self._want_window
            if want_win is not None and hasattr(be, "set_window"):
                be.set_window(want_win)
            # replay journaled invalidations BEFORE any op flows: a restored
            # snapshot may have resurrected entries we invalidated
            if journal:
                ks = np.array(journal, np.uint32)
                try:
                    for lo in range(0, len(ks), 1024):
                        be.invalidate(ks[lo : lo + 1024])
                    replayed = len(ks)
                except _TRANSPORT_ERRORS:
                    try:
                        be.close()
                    except Exception:  # noqa: BLE001
                        pass
                    be = None
                    return None
            return be
        finally:
            with self._lock:
                self._connecting = False
                if be is not None:
                    self._stats.inc("reconnects")
                    self._stats.inc("replayed_invalidates", replayed)
                    for _ in range(replayed):
                        # drop exactly what we replayed; entries journaled
                        # DURING the replay stay for the next cycle
                        if self._inval_journal:
                            self._inval_journal.popleft()
                    self._be = be
                    self._cur_delay = self.retry_delay_s  # backoff resets
                else:
                    # failed attempt: widen the retry spacing (capped),
                    # jittered so same-instant clients desynchronize
                    widened = min(self.max_retry_delay_s,
                                  max(self._cur_delay, 1e-3) * self.backoff)
                    self._cur_delay = widened * (
                        1.0 + self.jitter * self._rng.random())
                    self._stats.inc("reconnect_backoffs")

    @property
    def connected(self) -> bool:
        with self._lock:
            return self._be is not None

    def set_window(self, n: int) -> int:
        """Degrade-safe live pipeline-window set (the autotune hook):
        applies to the attached backend now when one is up, and is
        re-applied to every future reconnect's fresh backend (`_ensure`
        sets it before the journal replay). Never raises — a set that
        races a disconnect simply waits for the next reconnect."""
        n = max(1, int(n))
        with self._lock:
            self._want_window = n
            be = self._be
        if be is not None and hasattr(be, "set_window"):
            try:
                be.set_window(n)
            except _TRANSPORT_ERRORS:
                pass  # the reconnect path re-applies it
        return n

    @property
    def window(self) -> int | None:
        """The live pipeline window: the wrapped backend's when one is
        attached, else the pending live-set value (None = the factory's
        own default, untouched)."""
        with self._lock:
            be, want = self._be, self._want_window
        w = getattr(be, "window", None) if be is not None else None
        return w if w is not None else want

    # -- Backend protocol: no exception escapes a page op --

    def put(self, keys: np.ndarray, pages: np.ndarray) -> None:
        be = self._ensure(force=self._probe_forced())
        if be is None:
            self._op_failed()
            self._stats.inc("dropped_puts", len(keys))
            return
        try:
            be.put(keys, pages)
            self._op_ok()
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            self._stats.inc("dropped_puts", len(keys))

    def get(self, keys: np.ndarray):
        miss = (np.zeros((len(keys), self.page_words), np.uint32),
                np.zeros(len(keys), bool))
        be = self._ensure(force=self._probe_forced())
        if be is None:
            self._op_failed()
            self._miss_gets(len(keys))
            return miss
        try:
            out = be.get(keys)
            self._op_ok()
            return out
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            self._miss_gets(len(keys))
            return miss

    def invalidate(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.uint32)
        with self._lock:
            self._inval_journal.extend(map(tuple, keys))
        be = self._ensure(force=self._probe_forced())
        if be is None:
            self._op_failed()
            self._stats.inc("failed_invalidates", len(keys))
            return np.zeros(len(keys), bool)
        try:
            out = be.invalidate(keys)
            self._op_ok()
            return out
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            self._stats.inc("failed_invalidates", len(keys))
            return np.zeros(len(keys), bool)

    def insert_extent(self, key, value, length: int) -> int:
        """Degrade-to-legal: a failed registration indexes NOTHING, so the
        whole run is reported uncovered (clean-cache: later probes miss,
        callers may re-register) — never an exception."""
        be = self._ensure(force=self._probe_forced())
        if be is None:
            self._op_failed()
            self._stats.inc("dropped_extent_puts")
            return length
        try:
            out = be.insert_extent(key, value, length)
            self._op_ok()
            return out
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            self._stats.inc("dropped_extent_puts")
            return length

    def get_extent(self, keys: np.ndarray):
        miss = (np.zeros((len(keys), 2), np.uint32),
                np.zeros(len(keys), bool))
        be = self._ensure(force=self._probe_forced())
        if be is None:
            self._op_failed()
            self._miss_gets(len(keys))
            return miss
        try:
            out = be.get_extent(keys)
            self._op_ok()
            return out
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            self._miss_gets(len(keys))
            return miss

    def packed_bloom(self) -> np.ndarray | None:
        be = self._ensure(force=self._probe_forced())
        if be is None:
            self._op_failed()
            return None
        try:
            packed = be.packed_bloom()
            self._op_ok()
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            return None
        # forward the pull-snapshot stamp (see TcpBackend.packed_bloom):
        # the sink keys its one-clock-domain fix on this attribute, and a
        # wrapper that swallowed it would silently reintroduce the
        # pull-freezes-push bug on the reconnect path
        if hasattr(be, "bloom_pull_t_snap"):
            self.bloom_pull_t_snap = be.bloom_pull_t_snap
        return packed

    def dir_refresh(self) -> bool:
        """Forward the one-sided directory refresh when the live
        transport negotiated it; False otherwise (a degraded or
        directory-less client simply keeps the verb path). Never
        raises — same degrade contract as every page op."""
        be = self._ensure(force=self._probe_forced())
        fn = getattr(be, "dir_refresh", None) if be is not None else None
        if fn is None:
            return False
        try:
            out = bool(fn())
            self._op_ok()
            return out
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            return False

    def ring_note(self, epoch: int, members: int = 0):
        """Forward a membership-transition notice (`MSG_RINGNOTE`) when
        the live transport negotiated the elastic capability; returns
        the server's new directory epoch, or None (degraded /
        non-elastic — the fast lane's own stale validation is the
        backstop). Never raises, like every page op."""
        be = self._ensure(force=self._probe_forced())
        fn = getattr(be, "ring_note", None) if be is not None else None
        if fn is None:
            return None
        try:
            out = fn(epoch, members)
            self._op_ok()
            return out
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            return None

    @property
    def replica_lanes(self) -> int:
        """The LIVE transport's negotiated device-replica lane count
        (1 while degraded or against a 1-D server) — the capability a
        ReplicaGroup reads to delegate its fan-out to the fused plane."""
        with self._lock:
            be = self._be
        return int(getattr(be, "replica_lanes", 1) or 1) \
            if be is not None else 1

    def replica_repair(self) -> int:
        """Forward a device-side replica anti-entropy pass when the live
        transport negotiated the capability; 0 otherwise. Never raises,
        like every page op."""
        be = self._ensure(force=self._probe_forced())
        fn = getattr(be, "replica_repair", None) if be is not None else None
        if fn is None:
            return 0
        try:
            out = int(fn())
            self._op_ok()
            return out
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            return 0

    def recovery_info(self) -> dict:
        """Forward the warm-restart status query (`MSG_RECOVERY`).
        Degraded answers `{"recovering": false}` — an unreachable server
        is the breaker's problem, not the recovery state machine's.
        Never raises, like every page op."""
        be = self._ensure(force=self._probe_forced())
        fn = getattr(be, "recovery_info", None) if be is not None else None
        if fn is None:
            return {"recovering": False}
        try:
            out = fn()
            self._op_ok()
            return out
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            return {"recovering": False}

    def mark_recovered(self) -> bool:
        """Forward the idempotent leave-recovering flip (`MSG_RECOVERY`
        subcmd 1); False while degraded (the repair tier retries on its
        own cadence). Never raises, like every page op."""
        be = self._ensure(force=self._probe_forced())
        fn = getattr(be, "mark_recovered", None) if be is not None else None
        if fn is None:
            return False
        try:
            out = bool(fn())
            self._op_ok()
            return out
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            return False

    def handoff(self, keys: np.ndarray, pages: np.ndarray) -> None:
        """Migration handoff write: rides `MSG_HANDOFF` when negotiated
        (server-attributable as `handoff_pages`), a plain put
        otherwise. Degrades exactly like `put`: a handoff dropped on a
        down endpoint leaves the key a LEGAL miss on that new owner
        (clean-cache contract) until anti-entropy repair or a fresh put
        re-places it — counted in `dropped_puts`, never silent."""
        be = self._ensure(force=self._probe_forced())
        if be is None:
            self._op_failed()
            self._stats.inc("dropped_puts", len(keys))
            return
        fn = getattr(be, "handoff", None) or be.put
        try:
            fn(keys, pages)
            self._op_ok()
        except _TRANSPORT_ERRORS as e:
            self._op_failed(e)
            self._mark_down()
            self._stats.inc("dropped_puts", len(keys))

    def close(self) -> None:
        """Graceful teardown: the last op completed, so no request of ours
        is in flight — the slice can return to the free list directly
        (unlike `_mark_down`, which must quarantine)."""
        with self._lock:
            be, self._be = self._be, None
        if be is not None:
            try:
                be.close()
            except Exception:  # noqa: BLE001
                pass

    def stats(self) -> dict:
        """The uniform backend stats surface."""
        with self._lock:
            be = self._be
        out = dict(self._stats, connected=be is not None)
        if be is not None and hasattr(be, "pipelined"):
            # which wire protocol the LIVE connection negotiated —
            # benches and monitors assert the mode they think they run
            out["pipelined"] = bool(be.pipelined)
        if self.breaker is not None:
            out["breaker"] = self.breaker.state
        return out


class ShardFault(RuntimeError):
    """A device/program failure attributable to ONE shard's failure
    domain. `parallel/plane.py` raises (or re-raises) these so the
    quarantine tier can charge the right shard-scoped breaker; failures
    WITHOUT a `.shard` stay generic and fall through to the net tier's
    op-granular poison bisection instead."""

    def __init__(self, shard: int, msg: str = ""):
        super().__init__(msg or f"injected fault on shard {int(shard)}")
        self.shard = int(shard)


class FaultPlan:
    """Deterministic device-fault injection seam for containment drills.

    The chaos counterpart of `FaultInjector`, one layer lower: instead
    of dropping whole batches at the server loop, a `FaultPlan` makes
    the DEVICE LAUNCH itself fail for chosen ops — the exact failure
    shape rungs 7–9 of the ladder exist to contain. Three triggers, all
    reproducible (no randomness):

    - `poison_keys(keys)`: any launch whose key batch contains one of
      these [hi, lo] keys raises `RuntimeError` — the poison-op shape
      `_serve_coalesced`'s bisection must isolate.
    - `fail_shard(k)`: any launch routed to shard k raises
      `ShardFault(k)` — the shard-down shape `ShardQuarantine` trips
      on. `heal_shard(k)` clears it (half-open probes then re-admit).
    - `raise_on_op(n)`: the n-th `check()`-ed launch from now raises
      once — the transient one-shot fault shape.

    Wire it via `FaultyBackend` (single-device backends) or
    `PlaneBackend(fault_plan=...)` (mesh). Thread-safe; `check()` is
    called on serve paths, so it does no IO and holds its lock only for
    set lookups."""

    def __init__(self) -> None:
        # guarded-by: _poison, _dead_shards, _countdown
        self._lock = san.lock("FaultPlan._lock")
        self._poison: set[tuple[int, int]] = set()
        self._dead_shards: set[int] = set()
        self._countdown = 0
        self.stats = tele.scope("faultplan", {
            "checks": 0, "poison_raises": 0, "shard_raises": 0,
            "countdown_raises": 0,
        })

    # -- arming --

    def poison_keys(self, keys) -> None:
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        with self._lock:
            for hi, lo in keys:
                self._poison.add((int(hi), int(lo)))

    def clear_poison(self) -> None:
        with self._lock:
            self._poison.clear()

    def fail_shard(self, shard: int) -> None:
        with self._lock:
            self._dead_shards.add(int(shard))

    def heal_shard(self, shard: int) -> None:
        with self._lock:
            self._dead_shards.discard(int(shard))

    def raise_on_op(self, n: int) -> None:
        """The n-th checked launch from now (1 = the very next) fails."""
        with self._lock:
            self._countdown = max(1, int(n))

    # -- the seam --

    def check(self, phase: str, keys=None, shards=None) -> None:
        """Raise iff this launch intersects an armed fault. `keys` is
        the launch's key batch ([b, 2] or None), `shards` the shard ids
        it routes to (iterable or None)."""
        with self._lock:
            self.stats.inc("checks")
            if self._countdown > 0:
                self._countdown -= 1
                if self._countdown == 0:
                    self.stats.inc("countdown_raises")
                    raise RuntimeError(
                        f"injected one-shot fault ({phase})")
            hit_shard = None
            if shards is not None and self._dead_shards:
                for s in shards:
                    if int(s) in self._dead_shards:
                        hit_shard = int(s)
                        break
            hit_key = None
            if keys is not None and self._poison:
                kk = np.asarray(keys, np.uint32).reshape(-1, 2)
                for hi, lo in kk:
                    if (int(hi), int(lo)) in self._poison:
                        hit_key = (int(hi), int(lo))
                        break
        # raises happen outside the lock (messages may format keys)
        if hit_shard is not None:
            self.stats.inc("shard_raises")
            raise ShardFault(hit_shard, f"injected fault on shard "
                                        f"{hit_shard} ({phase})")
        if hit_key is not None:
            self.stats.inc("poison_raises")
            raise RuntimeError(f"injected poison op "
                               f"{hit_key[0]:#x}:{hit_key[1]:#x} ({phase})")


#: backend method name -> the fused-phase name `FaultPlan.check` sees
#: (mirrors `_serve_coalesced`'s phase order so drills can arm per-phase)
_FAULTY_PHASES = {
    "put": "put", "handoff": "put", "insert_extent": "ins_ext",
    "invalidate": "del", "get_extent": "get_ext",
    "get": "get", "get_fused": "get",
}


class FaultyBackend:
    """Transparent Backend wrapper that routes every serve call through
    a `FaultPlan` — the single-device counterpart of
    `PlaneBackend(fault_plan=...)`. Attribute access forwards to the
    inner backend, so negotiated capabilities (`get_fused`,
    `routes_per_shard`, `fast_get`, ...) appear exactly iff the inner
    backend has them."""

    def __init__(self, inner, plan: FaultPlan):
        # object.__setattr__-free: plain attrs, __getattr__ only fires
        # for names NOT found on the instance
        self._inner = inner
        self._plan = plan

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        phase = _FAULTY_PHASES.get(name)
        if phase is None or not callable(attr):
            return attr
        plan = self._plan

        def _checked(*a, **kw):
            keys = a[0] if a else kw.get("keys")
            plan.check(phase, keys=keys)
            return attr(*a, **kw)
        return _checked


class ShardQuarantine:
    """Per-shard failure domains for the mesh plane — rung 8.

    One shard-scoped `CircuitBreaker` per shard: `ShardFault`s charge
    the faulted shard's breaker, and once it opens, `PlaneBackend`
    masks that shard's rows out of every launch HOST-SIDE (the keys
    become INVALID rows, which match nothing on device) so a sick
    shard's program is never even dispatched while healthy shards keep
    serving. Blocked GETs are accounted to the `miss_quarantined`
    cause lane on the quarantined shard's own stats row; blocked PUTs
    drop acked; blocked invalidations JOURNAL here and replay at
    re-admission, so a quarantined shard can never serve a stale page
    it was told to forget.

    Re-admission is the breaker's half-open machinery: `gate()` lets
    one probe launch through per probe slot, and the launch outcome
    (reported via `note_success` / `note_failure`) closes or re-opens
    the breaker. `shard_quarantine` rungs fire on both transitions —
    trip and re-admit — with the journal depth at that moment.
    Thread-safe; journals are bounded (oldest invalidations drop first,
    which is safe only because re-admission replays BEFORE the shard
    serves, and a dropped journal entry widens the replay to a full
    `drop_journal` miss report, never a stale serve)."""

    JOURNAL_CAP = 1 << 14

    def __init__(self, n_shards: int, failures_to_open: int = 3,
                 cooldown_s: float = 0.5, max_cooldown_s: float = 10.0,
                 backoff: float = 2.0, seed: int = 0,
                 prefix: str = "mesh"):
        self.n_shards = int(n_shards)
        self.breakers = [
            CircuitBreaker(failures_to_open=failures_to_open,
                           cooldown_s=cooldown_s,
                           max_cooldown_s=max_cooldown_s,
                           backoff=backoff, seed=seed + i,
                           name=f"{prefix}.shard{i}")
            for i in range(self.n_shards)
        ]
        # guarded-by: _journals, _overflowed
        self._lock = san.lock("ShardQuarantine._lock")
        self._journals: dict[int, collections.deque] = {}
        self._overflowed: set[int] = set()
        self.stats = tele.scope("quarantine", {
            "trips": 0, "readmits": 0, "quarantined_gets": 0,
            "dropped_puts": 0, "journaled_invals": 0,
            "replayed_invals": 0, "journal_overflows": 0, "probes": 0,
        })

    # -- gate --

    def quarantined(self) -> list[int]:
        """Shard ids currently behind a non-CLOSED breaker (monitor
        surface — does not consume probes)."""
        return [i for i, br in enumerate(self.breakers)
                if br.state != CircuitBreaker.CLOSED]

    def gate(self, shards: np.ndarray) -> tuple[np.ndarray, list[int]]:
        """Admission decision for one launch routed to `shards` (one
        shard id per row). Returns `(blocked, probing)`: `blocked` is a
        bool mask of rows that must NOT reach the device, `probing`
        lists shards granted a half-open probe by THIS launch — report
        the launch outcome for them via `note_success`/`note_failure`
        or the probe is wasted."""
        shards = np.asarray(shards).reshape(-1)
        blocked_ids, probing = [], []
        for s in np.unique(shards):
            br = self.breakers[int(s)]
            if br.state == CircuitBreaker.CLOSED:
                continue
            if br.allow():
                probing.append(int(s))
                self.stats.inc("probes")
            else:
                blocked_ids.append(int(s))
        if not blocked_ids:
            return np.zeros(shards.shape, bool), probing
        return np.isin(shards, np.asarray(blocked_ids)), probing

    # -- outcome feedback --

    def note_failure(self, shard: int, kind: str = "timeout") -> bool:
        """Charge `shard`'s breaker with a launch failure. Returns True
        iff this failure TRIPPED the breaker (CLOSED/HALF_OPEN → OPEN):
        the caller's cue that the shard just entered quarantine."""
        br = self.breakers[int(shard) % self.n_shards]
        before = br.state
        br.record_failure(kind)
        tripped = (before != CircuitBreaker.OPEN
                   and br.state == CircuitBreaker.OPEN)
        if tripped:
            self.stats.inc("trips")
            with self._lock:
                depth = len(self._journals.get(int(shard), ()))
            tele.rung("shard_quarantine", shard=int(shard), event="trip",
                      kind=kind, journal=depth)
        return tripped

    def note_success(self, shard: int) -> bool:
        """Report a healthy launch for `shard` (typically a half-open
        probe that completed). Returns True iff the shard was just
        RE-ADMITTED (breaker closed from a non-closed state) — the
        caller must then `drain_journal()` and replay the pending
        invalidations BEFORE serving from the shard."""
        br = self.breakers[int(shard) % self.n_shards]
        before = br.state
        br.record_success()
        readmitted = before != CircuitBreaker.CLOSED
        if readmitted:
            self.stats.inc("readmits")
            with self._lock:
                depth = len(self._journals.get(int(shard), ()))
            tele.rung("shard_quarantine", shard=int(shard),
                      event="readmit", journal=depth)
        return readmitted

    # -- invalidation journal --

    def journal_invalidations(self, shard: int, keys: np.ndarray) -> None:
        """Record invalidations a quarantined shard could not serve —
        they replay at re-admission so the shard never resurrects a
        page it was told to forget."""
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        if keys.size == 0:
            return
        with self._lock:
            dq = self._journals.setdefault(
                int(shard), collections.deque(maxlen=self.JOURNAL_CAP))
            overflow = len(dq) + len(keys) > self.JOURNAL_CAP
            if overflow:
                self._overflowed.add(int(shard))
                self.stats.inc("journal_overflows")
            for row in keys:
                dq.append((int(row[0]), int(row[1])))
            self.stats.inc("journaled_invals", len(keys))

    def drain_journal(self, shard: int) -> tuple[np.ndarray, bool]:
        """Pop every journaled invalidation for `shard`. Returns
        `(keys [n, 2] uint32, overflowed)` — when `overflowed` is True
        the journal dropped entries while quarantined and the caller
        must treat the shard's replay as PARTIAL (flush wider or flag
        it); entries that ARE returned replay exactly."""
        with self._lock:
            dq = self._journals.pop(int(shard), None)
            overflowed = int(shard) in self._overflowed
            self._overflowed.discard(int(shard))
        if not dq:
            return np.zeros((0, 2), np.uint32), overflowed
        out = np.asarray(list(dq), np.uint32).reshape(-1, 2)
        self.stats.inc("replayed_invals", len(out))
        return out, overflowed

    def report(self) -> dict:
        """Monitor surface: breaker states + journal depths per shard."""
        with self._lock:
            depths = {s: len(dq) for s, dq in self._journals.items()}
        return {
            "quarantined": self.quarantined(),
            "states": [br.state for br in self.breakers],
            "journal_depths": depths,
            "stats": dict(self.stats),
        }
