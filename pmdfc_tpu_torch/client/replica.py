"""Replicated remote-memory group — availability on top of the ladder
(twin of `pmdfc_tpu/client/replica.py`: a host-side client, the same
code over this package's transports).

The reference serves every client from a SINGLE memory server
(`server/rdma_svr.cpp`): one server death loses every cached page and
stalls every client on reconnect. `ReplicaGroup` removes that single
point of failure by fronting N independent servers (each one typically a
`TcpBackend` wrapped in `runtime.failure.ReconnectingClient`) behind the
same batched Backend surface every other client layer speaks:

- **Consistent-hash placement ring.** Each key's replica set is the
  first `rf` distinct members clockwise from its hashed position on a
  virtual-node ring (`cluster/ring.py`), so membership can CHANGE while
  serving: a join/leave/replace moves only ~1/N of the key space, live
  migration (`cluster/migrate.py`) streams exactly those pages to their
  new owners through the digest-verified repair path, and a dual-read
  window (old + new owners, first valid answer wins) keeps in-flight
  keys mid-move at worst a legal `miss_routed` miss. `PMDFC_RING=off`
  falls back to the original static `hash % N` map — placement then
  never moves (a rejoined server owns exactly the keys it owned before
  it died), and membership is immutable.
- **Health-gated routing.** Every endpoint sits behind a
  `CircuitBreaker` (closed → open → half-open, jittered widening
  cooldown) fed by timeouts, wire `bad_frames`, and end-to-end digest
  mismatches. An OPEN endpoint is skipped without a connect attempt —
  one sick server costs healthy traffic nothing per-op. (HiStore's
  health/latency-routed reads are the motivating design.)
- **Hedged GETs.** A GET goes primary-first; if the primary hasn't
  answered within `hedge_ms`, the same sub-batch fires at the next live
  member and the first usable answer wins (per key: first HIT wins; a
  miss only stands once every fired request for that key answered).
  Tail latency from one slow replica is bounded by the hedge deadline,
  not the op timeout. (RDMAbox: remote-paging stacks live or die on
  in-flight loss — a hedge is a purchased retransmit.)
- **Failover.** Keys still missing after the primary (down, cold, or
  evicted) retry on the remaining live members of their set — clean
  cache makes the retry safe (a miss anywhere is legal) and cheap
  (bounded by rf).
- **Bloom-guided anti-entropy repair.** When an endpoint's breaker
  closes after having been open (a dead replica rejoined), a background
  thread pulls the rejoined server's packed bloom mirror (the existing
  `MSG_BFPULL` wire verb) and walks the group's bounded put-journal:
  keys the rejoined replica OWNS but its filter lacks are fetched from a
  surviving member, digest-verified, and re-replicated at a bounded rate
  (`repair_batch` pages per `repair_interval_s` tick) — the cold
  replica refills without a stop-the-world copy.
- **Load-shedding.** When every member of a key's set is open, the op
  degrades to the clean-cache legal outcome (GET → miss, PUT → drop) —
  never an exception, never wrong bytes: the PR-1 ladder invariant,
  extended with a fifth rung ("replica-set exhausted → legal miss").

Pipelined endpoints: when the TCP tier runs the windowed protocol
(`TcpBackend(pipeline=True)`, the default), the group's concurrent
sub-batches to one endpoint — a hedge racing a fan-out PUT racing a
repair GET — share that endpoint's connection window instead of
convoying; an in-window failure fails them all at once, which the
breaker sees as the SAME single-endpoint incident (one streak, not a
per-op penalty), and every affected op degrades through its
`ReconnectingClient` exactly as on the lockstep wire.

End-to-end integrity is group-owned: a bounded digest map (same
discipline as `IntegrityBackend`) records every put's digest and
verifies every served page regardless of WHICH replica served it — a
mismatch degrades to a miss, bumps `corrupt_pages`, and feeds the
serving endpoint's breaker.

**Fused-plane delegation** (the 2-D serving mesh, `parallel/shard.py`):
an endpoint advertising `replica_lanes >= rf` (negotiated via the wire
REPLICA capability) replicates device-side — a key whose PRIMARY member
is fused collapses its fan-out to that one endpoint (one wire verb,
one device launch writing rf lanes, `fused_delegated` counter), host
hedging/failover stand down for it (the device lanes ARE the hedge),
and the shared repair cadence fires the device-side anti-entropy pass
(`MSG_RREPAIR`) every `device_repair_ticks`. The ring/migration layer
stays host-side: device lanes replicate WITHIN a server, the ring
replicates ACROSS servers — `ReplicaConfig.fused_plane=False` opts out
entirely. **Breaker-driven auto-replacement**: with a `spare_factory`
and `auto_replace_after_s > 0`, a member whose breaker stays latched
out of CLOSED past the threshold is swapped for a fresh spare through
the normal replace_endpoint transition on the repair cadence — the
ring's replace() path under REAL failure.

In this package the delegation is reached through a `NetServer` that
fronts a 2-D plane (`parallel.plane.PlaneBackend` over a `ShardedKV` on
a `make_mesh2d` grid): the server advertises the plane's lane count in
HOLA, the `TcpBackend` negotiates `replica_lanes > 1`, and keys whose
primary is that endpoint take the fused path above. Endpoints over a
single `KV` or a 1-D plane keep `replica_lanes = 1` and the host fan-out,
hedging and failover paths (`tests/test_torch_mesh2d.py` drives both).
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from pmdfc_tpu_torch.cluster.migrate import Migrator
from pmdfc_tpu_torch.cluster.ring import HashRing, moved_mask
from pmdfc_tpu_torch.config import ReplicaConfig, RingConfig, ring_enabled
from pmdfc_tpu_torch.ops.pagepool import page_digest_np
from pmdfc_tpu_torch.runtime.journal import KeyJournal
from pmdfc_tpu_torch.runtime import sanitizer as san
from pmdfc_tpu_torch.runtime import telemetry as tele
from pmdfc_tpu_torch.runtime.failure import _TRANSPORT_ERRORS, CircuitBreaker
from pmdfc_tpu_torch.utils.hashing_np import hash_u64_np, query_packed_np

# replica-set hashing is salted away from the bloom/index seeds so the
# replica map stays independent of every other placement decision
_MAP_SEED = 0x5EC0_11D5

# transport-failure sentinel for `_call`: a PUT legitimately returns None
# and `packed_bloom` legitimately returns None (bloomless server), so
# failure needs its own identity or success and failure conflate
_FAILED = object()

# breaker cooldown for an endpoint quarantined by a membership change
# (replace of a live-but-suspect server): long enough that no serving
# traffic routes there while the transition drains, short enough that a
# mistaken quarantine self-heals
QUARANTINE_S = 3600.0


class ReplicaGroup:
    """N-endpoint replicated Backend: fan-out PUTs, hedged/failover GETs,
    breaker-gated routing, bloom-guided anti-entropy repair.

    `endpoints` is a list of Backend-protocol objects, one per server —
    typically `ReconnectingClient`-wrapped `TcpBackend`s (recommended:
    the wrapper journals invalidations across downtime and feeds the
    breaker from inside the degrade path). Endpoints exposing a
    `breaker` attribute get this group's breaker attached; bare backends
    (whose ops raise on failure) are fed by the group itself.

    One-sided fast path: endpoints whose `TcpBackend` carries a warm
    directory (`directory=True` + `dir_refresh`, see `runtime/net.py`)
    serve hot GETs from the server's reader-side fast lane INSIDE the
    normal primary attempt — the fast answer lands well before
    `hedge_ms`, so the group prefers the fast path before ever firing a
    hedge, and a stale-validated lane falls back to the verb path
    within the same attempt (the ladder is fast-lane → verb → hedge →
    failover → legal miss). `dir_refresh()` fans the refresh out to
    every endpoint that supports it.
    """

    def __init__(self, endpoints, page_words: int,
                 cfg: ReplicaConfig | None = None, seed: int = 0,
                 spare_factory=None):
        self.cfg = cfg or ReplicaConfig(n_replicas=len(endpoints),
                                        rf=min(2, len(endpoints)))
        # breaker-driven auto-replacement (cfg.auto_replace_after_s):
        # called as spare_factory(failed_slot) -> fresh endpoint when a
        # member's breaker stays latched open past the threshold; the
        # swap goes through the normal replace_endpoint transition
        self.spare_factory = spare_factory
        self._ticks = 0  # repair-tick counter (device-repair cadence)
        if self.cfg.n_replicas != len(endpoints):
            raise ValueError(
                f"cfg.n_replicas={self.cfg.n_replicas} but "
                f"{len(endpoints)} endpoints were supplied")
        self.endpoints = list(endpoints)
        self.page_words = page_words
        self.n = len(endpoints)
        if self.cfg.deadline_ms:
            # stamp the group budget into endpoints that speak it (the
            # wire-frame half of the deadline: containment-negotiated
            # servers shed already-expired staged ops before dispatch);
            # an endpoint's own nonzero knob wins
            for ep in self.endpoints:
                if getattr(ep, "deadline_ms", None) == 0.0:
                    ep.deadline_ms = float(self.cfg.deadline_ms)
        self.breakers = [
            CircuitBreaker(
                failures_to_open=self.cfg.breaker_failures,
                cooldown_s=self.cfg.breaker_cooldown_s,
                max_cooldown_s=self.cfg.breaker_max_cooldown_s,
                backoff=self.cfg.breaker_backoff,
                jitter=self.cfg.breaker_jitter,
                half_open_probes=self.cfg.half_open_probes,
                seed=seed + i,
                # the flight-recorder identity breaker_open rungs carry
                name=f"replica{i}",
            )
            for i in range(self.n)
        ]
        # endpoints with a breaker slot feed it from inside their own
        # degrade path (ReconnectingClient); bare backends raise, so the
        # group classifies and feeds for them
        self._self_feed = []
        for ep, br in zip(self.endpoints, self.breakers):
            if hasattr(ep, "breaker"):
                ep.breaker = br
                self._self_feed.append(False)
            else:
                self._self_feed.append(True)
        # group-wide end-to-end digest map + repair candidate journal,
        # both bounded FIFO (same cap discipline as IntegrityBackend)
        self._digests: collections.OrderedDict = collections.OrderedDict()
        # the repair candidate universe — the shared KeyJournal from
        # runtime/journal.py (one home for both journals: repair
        # candidates here, the durability WAL server-side)
        self._journal = KeyJournal(self.cfg.put_journal_cap)
        # guarded-by: _digests, _journal
        self._maps_lock = san.lock("ReplicaGroup._maps_lock")
        # registry-backed group counters (same mapping reads as the old
        # dict); hedge OUTCOMES ride along with the fire count — won (a
        # hedged key was served by the hedge target), lost (the primary
        # answered after all), abandoned (a slow flight's answer was
        # discarded because every one of its keys hit elsewhere)
        self.counters = tele.scope("replica_group", {
            "puts": 0, "gets": 0, "invalidates": 0,
            "load_shed_gets": 0, "load_shed_puts": 0,
            "shed_put_replicas": 0, "hedges_fired": 0,
            "hedges_won": 0, "hedges_lost": 0, "hedges_abandoned": 0,
            "failover_gets": 0, "deadline_stops": 0,
            "corrupt_pages": 0,
            "repair_pages": 0, "repair_rounds": 0,
            "repair_candidates": 0, "repair_dropped": 0,
            # group-level miss-cause taxonomy (the client half of the
            # ladder's vocabulary): every key a get() reports unfound
            # carries exactly one cause, `misses == Σ miss_*` —
            #   miss_replica_exhausted  rung 5: every member gated open
            #   miss_digest             the group digest gate refused it
            #   miss_routed             the key's owner set is mid-move
            #                           (an active ring transition) and
            #                           neither epoch's owners had it —
            #                           the migration window's legal dip
            #   miss_remote             the fleet answered, and missed
            #                           (the SERVER-side split of that
            #                           miss lives in the server's own
            #                           miss_cold/evicted/... counters)
            "misses": 0, "miss_replica_exhausted": 0,
            "miss_digest": 0, "miss_routed": 0, "miss_remote": 0,
            # fused-plane delegation + its repair/replacement riders:
            # keys whose fan-out collapsed onto a device-replicated
            # primary, rows re-synced by delegated device repair passes,
            # and breaker-driven automatic member replacements
            "fused_delegated": 0, "device_repair_rows": 0,
            "auto_replacements": 0,
            # warm-restart riders: rejoined endpoints flipped out of
            # their recovering serving state once their repair queue
            # drained (the MSG_RECOVERY mark, idempotent server-side)
            "recoveries_completed": 0,
        })
        # live-settable hedge deadline (the autotune controller's hook
        # on the repair cadence): get() reads it per op, so a set lands
        # on the very next group GET. Seeded from the config — with no
        # controller it never moves (the conformance contract).
        # guarded-by: _hedge_ms
        self._knob_lock = san.lock("ReplicaGroup._knob_lock")
        self._hedge_ms = float(self.cfg.hedge_ms)
        # end-to-end GET budget (seconds, 0 = none): past it, remaining
        # keys take the legal miss instead of firing another failover
        # round at work the caller has already given up on
        self._deadline_s = float(self.cfg.deadline_ms) / 1e3
        # headroom over the initial fleet: elastic joins add endpoints
        # without rebuilding the pool (fan-out merely queues past 2x)
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * self.n + 4),
            thread_name_prefix="replica")
        # -- elastic membership (consistent-hash ring + live migration):
        # `PMDFC_RING=off` (env wins over cfg.ring.enabled) falls back to
        # the static murmur map above and FREEZES membership — the
        # conformance mode `tests/test_elastic.py` pins verb-for-verb.
        rcfg = self.cfg.ring or RingConfig()
        self._ring_on = ring_enabled(default=rcfg.enabled)
        # retired endpoint slots (left/replaced members whose transition
        # drained): slots are never reused, so ring member ids stay
        # stable endpoint indexes for the whole group lifetime
        # guarded-by: ring, _dead
        self._ring_lock = san.lock("ReplicaGroup._ring_lock")
        self.ring: HashRing | None = None
        self._dead: set[int] = set()
        self.migrator: Migrator | None = None
        if self._ring_on:
            self.ring = HashRing(range(self.n), vnodes=rcfg.vnodes,
                                 seed=rcfg.seed)
            self.migrator = Migrator(self, rcfg)
            self.migrator.scope.set("ring_epoch", self.ring.epoch)
            self.migrator.scope.set("ring_members", self.n)
        # anti-entropy bookkeeping: rejoin detection rides the breaker's
        # monotonic `closes` counter (a state snapshot would miss an
        # open→closed flip between two ticks) + pending repair queues
        self._prev_closes = [br.stats["closes"] for br in self.breakers]
        self._repair_pending: dict[int, collections.deque] = {}
        # guards _repair_pending/_prev_closes: the background repair
        # thread, manual repair_tick() drivers, and stats() all touch
        # them (short critical sections only — never held across I/O)
        # guarded-by: _repair_pending, _prev_closes
        self._repair_lock = san.lock("ReplicaGroup._repair_lock")
        self._closed = False
        self._stop = threading.Event()
        self._repair_thread: threading.Thread | None = None
        if self.cfg.repair_interval_s > 0:
            self._repair_thread = threading.Thread(
                target=self._repair_loop, daemon=True,
                name="replica-repair")
            self._repair_thread.start()

    # -- key → replica set --

    # migrate.py reaches the transport-failure sentinel through the
    # group (importing it from here would be a cycle)
    _FAILED_SENTINEL = _FAILED

    def _window(self):
        """(old_ring, new_ring) while a migration transition is active
        — the dual-read window — else None."""
        if self.migrator is None:
            return None
        return self.migrator.rings()

    def _resolve(self, keys: np.ndarray, win) -> np.ndarray:
        """[B, R] endpoint slots per key, primary first. Static map when
        the ring is off; ring owners otherwise. Under an active
        transition `win`, the row is the union of the NEW epoch's
        owners followed by the OLD epoch's (dual-read: new placement
        preferred, first valid answer wins; duplicate slots collapse to
        the row's primary, which the queried-mask dedup then skips)."""
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        if not self._ring_on:
            h = hash_u64_np(keys[:, 0], keys[:, 1], seed=_MAP_SEED)
            primary = (h % np.uint32(self.n)).astype(np.int64)
            return (primary[:, None] + np.arange(self.cfg.rf)) % self.n
        if win is None:
            with self._ring_lock:
                ring = self.ring
            return ring.owners_np(keys, self.cfg.rf)
        old_r, new_r = win
        both = np.concatenate([new_r.owners_np(keys, self.cfg.rf),
                               old_r.owners_np(keys, self.cfg.rf)],
                              axis=1)
        # row-wise dedup keep-first: a duplicate slot is replaced by the
        # row's primary — downstream rank/fire logic skips an
        # already-queried endpoint, so repeats cost nothing
        for j in range(1, both.shape[1]):
            dup = (both[:, :j] == both[:, j:j + 1]).any(axis=1)
            both[dup, j] = both[dup, 0]
        return both

    def _members(self, keys: np.ndarray) -> np.ndarray:
        """[B, R] endpoint slots per key under the CURRENT placement
        (including the dual-read union mid-transition)."""
        return self._resolve(keys, self._window())

    def _lanes(self, e: int) -> int:
        """Endpoint e's negotiated device-replica lane count (1 = no
        fused plane behind it / degraded)."""
        return int(getattr(self.endpoints[e], "replica_lanes", 1) or 1)

    def _effective_members(self, members: np.ndarray) -> np.ndarray:
        """Fused-plane delegation: collapse a key's fan-out row to its
        PRIMARY member when that member advertises a device-replica
        plane with >= rf lanes — the server replicates rf ways in one
        device launch, so the host's rf TCP loops would only duplicate
        it. Collapsed slots repeat the primary (the queried-mask dedup
        then skips them, the same discipline as the dual-read union).
        Never applied inside a migration window: dual reads must still
        walk both epochs' owners."""
        if not self.cfg.fused_plane or members.shape[1] <= 1:
            return members
        lanes = np.array([self._lanes(e) for e in range(self.n)],
                         np.int64)
        if (lanes < self.cfg.rf).all():
            return members
        prim = members[:, 0]
        fused = lanes[prim] >= self.cfg.rf
        if not fused.any():
            return members
        eff = members.copy()
        eff[fused, 1:] = prim[fused, None]
        self._bump("fused_delegated", int(fused.sum()))
        return eff

    def _bump(self, key: str, n: int = 1) -> None:
        self.counters.inc(key, int(n))

    def _submit(self, fn, *args):
        """Pool submit that degrades instead of raising when the group
        is being closed under an in-flight op (no exception may escape a
        page op — the ladder contract)."""
        try:
            return self._pool.submit(fn, *args)
        except RuntimeError:  # pool shut down mid-op
            return None

    # -- endpoint calls (group-side breaker feeding for bare backends) --

    def _call(self, e: int, fn, *args):
        """Invoke an endpoint op; returns the result, or the `_FAILED`
        sentinel on transport failure (a PUT's successful None must stay
        distinguishable from a failure). Feeds the breaker only for
        endpoints without their own internal feed (double-counting would
        halve the open threshold)."""
        try:
            out = fn(*args)
        except _TRANSPORT_ERRORS as exc:
            if self._self_feed[e]:
                from pmdfc_tpu_torch.runtime.net import ProtocolError

                kind = ("bad_frame" if isinstance(exc, ProtocolError)
                        else "timeout")
                self.breakers[e].record_failure(kind)
            return _FAILED
        if self._self_feed[e]:
            self.breakers[e].record_success()
        return out

    # -- digest gate --

    def _record_digests(self, keys: np.ndarray, pages: np.ndarray) -> None:
        digs = page_digest_np(pages)
        with self._maps_lock:
            for k, d in zip(keys, digs):
                kk = (int(k[0]), int(k[1]))
                self._digests.pop(kk, None)
                self._digests[kk] = int(d)
                self._journal.note(kk)
            while len(self._digests) > self.cfg.digest_cap:
                self._digests.popitem(last=False)

    def _verify(self, keys: np.ndarray, out: np.ndarray,
                found: np.ndarray, src: np.ndarray) -> None:
        """In-place digest gate over the merged result: a mismatch is a
        miss + a digest-failure vote against the replica that served it
        (`src[i]` = endpoint index, -1 = unserved). Pages this group
        never put pass through unverified (peers may legally serve
        another client's pages)."""
        if not found.any():
            return
        digs = page_digest_np(out)
        with self._maps_lock:
            want = [self._digests.get((int(k[0]), int(k[1])))
                    for k in keys]
        for i, w in enumerate(want):
            if not found[i] or w is None:
                continue
            if int(digs[i]) != w:
                found[i] = False
                out[i] = 0
                self._bump("corrupt_pages")
                # rung 1, group-attributed: WHICH replica served the
                # corrupt/stale bytes (the breaker vote rides along)
                tele.rung("digest_mismatch", source="replica_group",
                          endpoint=int(src[i]),
                          key=[int(keys[i][0]), int(keys[i][1])])
                if 0 <= src[i] < self.n:
                    self.breakers[src[i]].record_failure("digest")

    # -- Backend protocol: no exception escapes a page op --

    def put(self, keys: np.ndarray, pages: np.ndarray) -> None:
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        pages = np.asarray(pages, np.uint32)
        self._bump("puts", len(keys))
        win = self._window()
        members = self._resolve(keys, win)
        if win is None:
            # fused-plane delegation: one wire put, rf device lanes
            members = self._effective_members(members)
        futs = {}
        covered = np.zeros(len(keys), bool)
        for e in range(self.n):
            mask = (members == e).any(axis=1)
            if not mask.any():
                continue
            if not self.breakers[e].allow():
                self._bump("shed_put_replicas", int(mask.sum()))
                continue
            f = self._submit(self._call, e, self.endpoints[e].put,
                             keys[mask], pages[mask])
            if f is not None:
                futs[f] = mask
        for f, mask in futs.items():
            # coverage counts at COMPLETION, not submit: a put whose
            # every replica died mid-flight is a rung-5 drop and must
            # show in load_shed_puts, not vanish into the ether
            if f.result() is not _FAILED:
                covered |= mask
        nshed = int((~covered).sum())
        self._bump("load_shed_puts", nshed)
        if nshed:
            tele.rung("replica_exhausted", op="put", keys=nshed,
                      open_endpoints=[
                          i for i in range(self.n)
                          if self.breakers[i].state != CircuitBreaker.CLOSED
                      ])
        # digests record after the fan-out returns, dropped replicas
        # included — if a shed/down replica later serves the PRE-drop
        # version, that is exactly the stale-resurrection case the
        # digest gate must catch (IntegrityBackend discipline)
        self._record_digests(keys, pages)

    def _attempt(self, e: int, fn, keys, trace: int, parent: int,
                 hedge: bool, rnd: int):
        """One endpoint flight under its attempt span (runs on a pool
        worker): the span parents to the group op explicitly (the
        worker thread holds no ambient context), and the endpoint's own
        wire span then nests under it via the worker's ambient stack —
        the hedge level of the client→hedge→wire trace."""
        sp = tele.span_begin("group", "attempt", trace=trace,
                             parent=parent, endpoint=int(e),
                             hedge=bool(hedge), round=rnd)
        # close-in-finally: _call only swallows transport errors, and a
        # NON-transport exception leaking the span would leave a dead
        # ambient node on this REUSED pool worker — every later wire
        # span on the worker would mis-parent under it
        ok = False
        try:
            out = self._call(e, fn, keys)
            ok = out is not _FAILED
            return out
        finally:
            tele.span_end(sp, ok=ok)

    def get(self, keys: np.ndarray):
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        B = len(keys)
        self._bump("gets", B)
        tid = tele.mint_trace() if tele.enabled() else 0
        # non-ambient: children (the attempt spans) parent to it
        # EXPLICITLY via gsid, and nothing else in this thread should
        # nest under a group op — so an exception unwinding out of the
        # op can never leave a dead node on the caller's span stack
        gspan = tele.span_begin("group", "get", trace=tid, keys=B,
                                ambient=False)
        t_op = time.perf_counter()
        out = np.zeros((B, self.page_words), np.uint32)
        found = np.zeros(B, bool)
        src = np.full(B, -1, np.int64)
        # snapshot the dual-read window ONCE per op: member resolution
        # and the miss_routed attribution below must see the same
        # transition (a settle racing mid-op would fork them)
        win = self._window()
        members = self._resolve(keys, win)
        if win is None:
            # fused-plane delegation: the primary's device lanes ARE the
            # hedge targets (first validated lane wins on-device), so
            # host hedging/failover stand down for fused keys
            members = self._effective_members(members)
        ready = np.array([br.ready() for br in self.breakers], bool)
        mr = ready[members]                       # [B, rf]
        rank = np.cumsum(mr, axis=1) - 1          # rank among ready members

        def target_for_round(r: int) -> np.ndarray:
            sel = mr & (rank == r)
            t = np.full(B, -1, np.int64)
            ii, jj = np.nonzero(sel)
            t[ii] = members[ii, jj]
            return t

        t0 = target_for_round(r=0)
        shed = int((t0 < 0).sum())
        self._bump("load_shed_gets", shed)
        if shed:
            # rung 5: every member of these keys' sets is gated — the
            # legal miss, attributed to the concrete open endpoints
            # range(len(ready)), not self.n: a concurrent join may have
            # grown the fleet since `ready` was sampled
            tele.rung("replica_exhausted", op="get", trace=tid, keys=shed,
                      open_endpoints=[i for i in range(len(ready))
                                      if not ready[i]])

        queried = np.zeros((B, self.n), bool)
        gsid = gspan.sid if gspan is not None else 0

        def fire(target: np.ndarray, want: np.ndarray,
                 hedge: bool = False, rnd: int = 0) -> dict:
            """Submit one batched GET per target endpoint for `want`
            keys; returns {future: (endpoint, key_indexes)}. Each
            flight runs under an attempt span (`hedge` marks the
            hedged round — the hedge node of the trace tree)."""
            fired = {}
            for e in set(target[want]):
                if e < 0:
                    continue
                idx = np.nonzero(want & (target == e)
                                 & ~queried[:, e])[0]
                if len(idx) == 0 or not self.breakers[e].allow():
                    continue
                f = self._submit(self._attempt, e, self.endpoints[e].get,
                                 keys[idx], tid, gsid, hedge, rnd)
                if f is None:
                    continue
                queried[idx, e] = True
                fired[f] = (e, idx)
            return fired

        def merge(f, e: int, idx: np.ndarray) -> None:
            res = f.result()
            if res is _FAILED or res is None:
                return
            got, ok = res
            fresh = np.asarray(ok, bool) & ~found[idx]
            take = idx[fresh]
            if len(take):
                out[take] = np.asarray(got, np.uint32)[fresh]
                found[take] = True
                src[take] = e

        # round 0: primary-first, with a hedge to the next live member
        # for whatever the primary hasn't answered by the deadline
        in_flight = fire(t0, t0 >= 0)
        hedge_s = self.hedge_ms_live() / 1e3
        if self._deadline_s:
            # the hedge never waits past the op budget: an expired op's
            # hedge would be dead work the server-side sweep sheds anyway
            hedge_s = min(hedge_s, max(
                self._deadline_s - (time.perf_counter() - t_op), 0.0))
        hedged = np.zeros(B, bool)
        ht = np.full(B, -1, np.int64)  # per-key hedge target (outcome attr)
        hedge_futs: set = set()
        if in_flight and hedge_s > 0:
            done, pending = wait(in_flight, timeout=hedge_s)
            for f in done:
                merge(f, *in_flight.pop(f))
            if pending:
                slow = np.zeros(B, bool)
                for f in pending:
                    slow[in_flight[f][1]] = True
                t1 = target_for_round(r=1)
                hedges = fire(t1, slow & (t1 >= 0), hedge=True, rnd=1)
                if hedges:
                    self._bump("hedges_fired", len(hedges))
                    hedge_futs = set(hedges)
                    for _f, (e, idx) in hedges.items():
                        hedged[idx] = True
                        ht[idx] = e
                in_flight.update(hedges)
        # per-key: first HIT wins; a miss only stands once every fired
        # request covering the key has answered. A flight whose keys all
        # hit elsewhere is ABANDONED (its answer can't change anything)
        # — that is what bounds a hedged GET's tail by the hedge deadline
        # plus the fast replica's round trip, not the slow primary.
        while in_flight:
            for f in list(in_flight):
                if found[in_flight[f][1]].all():
                    del in_flight[f]  # result discarded, op self-completes
                    # only a discarded HEDGE flight counts as abandoned —
                    # a slow primary whose keys the hedge served is the
                    # hedges_won case, not an abandonment
                    if f in hedge_futs:
                        self._bump("hedges_abandoned")
            if not in_flight:
                break
            done, _ = wait(in_flight, return_when=FIRST_COMPLETED)
            for f in done:
                merge(f, *in_flight.pop(f))
        if hedged.any():
            # hedge outcomes, per hedged key: the hedge target served it
            # (won), the slow primary still beat it (lost), or neither
            # answered with a hit (neither counter moves)
            self._bump("hedges_won", int((hedged & found
                                          & (src == ht)).sum()))
            self._bump("hedges_lost", int((hedged & found
                                           & (src == t0)).sum()))

        # failover rounds: keys still missing retry the remaining live
        # members of their set (bounded by the row width — rf, or 2*rf
        # inside a dual-read window; a miss anywhere is legal)
        for r in range(1, members.shape[1]):
            if (self._deadline_s
                    and time.perf_counter() - t_op >= self._deadline_s):
                # budget exhausted: stop retrying dead work — the keys
                # still missing take the legal miss below
                self._bump("deadline_stops")
                break
            tr = target_for_round(r)
            retry = (~found & (tr >= 0)
                     & ~queried[np.arange(B), np.maximum(tr, 0)])
            if not retry.any():
                continue
            self._bump("failover_gets", int(retry.sum()))
            flight = fire(tr, retry, rnd=r)
            for f, (e, idx) in flight.items():
                merge(f, e, idx)

        pre_verify = found.copy()
        self._verify(keys, out, found, src)
        # group miss-cause accounting: shed keys were never queried
        # (rung 5), digest flips WERE served and refused, keys whose
        # owner set is mid-move in the op's dual-read window are routing
        # casualties (`miss_routed` — the migration dip's attributable
        # lane), the rest are honest remote misses. Disjoint by
        # construction (precedence shed > digest > routed), so
        # `misses == Σ miss_*` holds per op and forever.
        shed_mask = t0 < 0
        flip_mask = pre_verify & ~found
        routed_mask = np.zeros(B, bool)
        if win is not None:
            routed_mask = (~found & ~shed_mask & ~flip_mask
                           & moved_mask(win[0], win[1], keys,
                                        self.cfg.rf))
        flips = int(flip_mask.sum())
        routed = int(routed_mask.sum())
        miss_total = int((~found).sum())
        self._bump("misses", miss_total)
        self._bump("miss_replica_exhausted", shed)
        self._bump("miss_digest", flips)
        self._bump("miss_routed", routed)
        self._bump("miss_remote", miss_total - shed - flips - routed)
        if gspan is not None:
            tele.span_end(gspan, ok=True, hits=int(found.sum()),
                          shed=shed, hedged=int(hedged.sum()))
        else:
            tele.record_span(
                "group", "get", tid, True,
                dur_us=(time.perf_counter() - t_op) * 1e6, keys=B,
                hits=int(found.sum()), shed=shed, hedged=int(hedged.sum()))
        return out, found

    def invalidate(self, keys: np.ndarray) -> np.ndarray:
        """Fan the tombstone to EVERY live member, breaker state
        ignored: a `ReconnectingClient` endpoint journals the
        invalidation even while down and replays it on reconnect —
        gating on the breaker would lose the tombstone and let a
        sick-but-alive replica serve stale bytes later (stale is NOT a
        legal miss). Under the RING the fan-out is fleet-wide, not
        owner-set-wide: membership churn leaves copies on EX-owners
        (ownership moved away without deleting), the invalidate pops
        the digest that would otherwise refuse them, and a later
        transition can hand ownership BACK to such a member — an
        owner-set tombstone would let it serve the invalidated page as
        a hit. (The static map never moves ownership, so its legacy
        owner-set fan-out stays transcript-identical.)"""
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        self._bump("invalidates", len(keys))
        with self._maps_lock:
            for k in keys:
                kk = (int(k[0]), int(k[1]))
                self._digests.pop(kk, None)
                self._journal.discard(kk)
        hit = np.zeros(len(keys), bool)
        futs = {}
        if self._ring_on:
            for e in range(self.n):
                if e in self._dead:
                    continue
                f = self._submit(self._call, e,
                                 self.endpoints[e].invalidate, keys)
                if f is not None:
                    futs[f] = np.ones(len(keys), bool)
        else:
            members = self._members(keys)
            for e in range(self.n):
                mask = (members == e).any(axis=1)
                if mask.any():
                    f = self._submit(self._call, e,
                                     self.endpoints[e].invalidate,
                                     keys[mask])
                    if f is not None:
                        futs[f] = mask
        for f, mask in futs.items():
            res = f.result()
            if res is not _FAILED and res is not None:
                hit[mask] |= np.asarray(res, bool)
        return hit

    def packed_bloom(self) -> np.ndarray | None:
        """Union view is not meaningful across replicas; serve the first
        live member's filter (callers wanting per-replica filters go
        through `endpoints[i]` directly, as repair does)."""
        for e in range(self.n):
            if not self.breakers[e].ready():
                continue
            packed = self._call(e, self.endpoints[e].packed_bloom)
            if packed is not _FAILED and packed is not None:
                return packed
        return None

    def dir_refresh(self) -> int:
        """Fan the one-sided directory refresh out to every ready
        endpoint that supports it (ReconnectingClient forwards to its
        live TcpBackend). Returns how many endpoints refreshed — 0 is
        normal for directory-less fleets; the verb path keeps serving."""
        n = 0
        for e in range(self.n):
            if not self.breakers[e].ready():
                continue
            fn = getattr(self.endpoints[e], "dir_refresh", None)
            if fn is None:
                continue
            if self._call(e, fn) is True:
                n += 1
        return n

    # -- live knobs (autotune hooks on the repair cadence) --

    def hedge_ms_live(self) -> float:
        """The hedge deadline GETs fire with right now (the live knob;
        equals `cfg.hedge_ms` until a controller moves it)."""
        with self._knob_lock:
            return self._hedge_ms

    def set_hedge_ms(self, v: float) -> float:
        """Live-set the hedge deadline (clamped non-negative; 0
        disables hedging, the config's own semantics). The controller
        clamps to its envelope before calling — this hook only refuses
        the nonsensical."""
        with self._knob_lock:
            self._hedge_ms = max(0.0, float(v))
            return self._hedge_ms

    def set_migrate_rate(self, pages_per_s: float | None) -> float | None:
        """Live migration-rate bound forward (`Migrator.set_rate`):
        None restores the static `RingConfig.migrate_pages_per_s` — the
        PMDFC_AUTOTUNE=off conformance point. Returns the applied rate,
        or None when no ring/migrator is live (static placement)."""
        if self.migrator is None:
            return None
        return self.migrator.set_rate(pages_per_s)

    # -- elastic membership (ring transitions + live migration) --

    def _require_ring(self) -> None:
        if not self._ring_on:
            raise RuntimeError(
                "membership is static without the placement ring "
                "(PMDFC_RING=off / RingConfig(enabled=False))")
        if self._closed:
            raise RuntimeError("group is closed")

    def _journal_keys(self) -> np.ndarray:
        with self._maps_lock:
            return self._journal.keys_array()

    def _transition(self, kind: str, new_ring: HashRing,
                    retire=()) -> int:
        """Swap placement to `new_ring` and open the migration window.
        The migrator claims the (old, new) pair FIRST — resolution
        prefers the window while it is active, so the `self.ring` swap
        afterwards is never observable out of order. Returns the moved
        backlog size."""
        with self._ring_lock:
            old_ring = self.ring
        lag = self.migrator.start(kind, old_ring, new_ring,
                                  self._journal_keys(), retire)
        with self._ring_lock:
            self.ring = new_ring
        self.migrator.scope.set("ring_epoch", new_ring.epoch)
        self.migrator.scope.set("ring_members", len(new_ring.members))
        # membership invalidates the one-sided fast lane fleet-wide:
        # every endpoint that can, bumps its server's directory epoch so
        # cached client mirrors go stale and fall back to the verb path
        # until their next refresh (MSG_RINGNOTE, net.py verb 22)
        self._ring_note_all(new_ring)
        return lag

    def _ring_note_all(self, ring: HashRing) -> None:
        # one round-trip WIDE, not members deep: the notices fan out on
        # the op pool like a put (a membership op must not stall
        # members x op_timeout behind slow endpoints)
        futs = []
        for e in ring.members:
            if e in self._dead or not self.breakers[e].ready():
                continue
            fn = getattr(self.endpoints[e], "ring_note", None)
            if fn is None:
                continue
            f = self._submit(self._call, e, fn, ring.epoch,
                             len(ring.members))
            if f is not None:
                futs.append(f)
        for f in futs:
            f.result()

    def _refuse_mid_transition(self) -> None:
        # best-effort early refusal: Migrator.start() is the atomic
        # claim, but failing BEFORE registering a slot / touching a
        # breaker keeps a rejected membership op side-effect-free
        if self.migrator.active():
            raise RuntimeError("a membership transition is already "
                               "draining — settle before the next "
                               "change (drain_migration())")

    def add_endpoint(self, endpoint, seed: int = 0) -> int:
        """Grow the fleet: register `endpoint` in a fresh slot, join it
        to the ring (epoch + 1), and start streaming its owed ~1/N of
        the key space. Returns the new slot id. Serving continues
        throughout — reads dual-resolve until migration drains."""
        self._require_ring()
        self._refuse_mid_transition()
        slot = self._register_endpoint(endpoint, seed)
        try:
            with self._ring_lock:
                new_ring = self.ring.join(slot)
            self._transition("join", new_ring)
        except Exception:
            # a lost claim race (another membership op slipped between
            # the early refusal and Migrator.start) must not leave the
            # just-registered endpoint as a live-but-ringless zombie
            # slot — retire it (dead set, breaker force-open, endpoint
            # closed) so a retry registers a FRESH slot instead of
            # accumulating dead ones
            self._retire_slot(slot)
            raise
        return slot

    def remove_endpoint(self, slot: int) -> int:
        """Shrink the fleet: take `slot` off the ring (epoch + 1) and
        stream the key ranges it owed to their new owners — the
        leaving endpoint keeps serving dual-reads as an OLD owner until
        the window drains, then retires (breaker force-opened, endpoint
        closed, slot dead). Returns the moved backlog size."""
        self._require_ring()
        self._refuse_mid_transition()
        with self._ring_lock:
            new_ring = self.ring.leave(slot)
        return self._transition("leave", new_ring, retire=(slot,))

    def replace_endpoint(self, slot: int, endpoint, seed: int = 0,
                         quarantine: bool = True) -> int:
        """Swap a (typically failing) member for a fresh endpoint in
        ONE epoch bump. `quarantine` force-opens the old slot's breaker
        AFTER the transition is claimed (a rejected replace must leave
        the still-serving member untouched) so no serving traffic
        routes there while the window drains — migration still reads
        surviving old owners, and a crashed old member simply fails its
        source attempts and the keys retry elsewhere. Returns the new
        slot id."""
        self._require_ring()
        self._refuse_mid_transition()
        new_slot = self._register_endpoint(endpoint, seed)
        try:
            with self._ring_lock:
                new_ring = self.ring.replace(slot, new_slot)
            self._transition("replace", new_ring, retire=(slot,))
        except Exception:
            # lost claim race / bad slot: retire the just-registered
            # spare so it can't linger as a zombie slot (see
            # add_endpoint; the auto-replace loop retries with a fresh
            # spare on a later tick, after the winner's window drains)
            self._retire_slot(new_slot)
            raise
        if quarantine:
            self.breakers[slot].force_open(QUARANTINE_S)
        return new_slot

    def _register_endpoint(self, endpoint, seed: int = 0) -> int:
        """Append a new endpoint slot (breaker, feed mode, repair
        bookkeeping) — slots are append-only so ring member ids stay
        stable endpoint indexes forever."""
        br = CircuitBreaker(
            failures_to_open=self.cfg.breaker_failures,
            cooldown_s=self.cfg.breaker_cooldown_s,
            max_cooldown_s=self.cfg.breaker_max_cooldown_s,
            backoff=self.cfg.breaker_backoff,
            jitter=self.cfg.breaker_jitter,
            half_open_probes=self.cfg.half_open_probes,
            seed=seed + len(self.endpoints),
            name=f"replica{len(self.endpoints)}")
        if hasattr(endpoint, "breaker"):
            endpoint.breaker = br
            feed = False
        else:
            feed = True
        # repair bookkeeping grows under its lock: repair_tick iterates
        # breakers/_prev_closes in lockstep inside the same lock, so the
        # two lists may never disagree in length
        with self._repair_lock:
            slot = len(self.endpoints)
            self.endpoints.append(endpoint)
            self.breakers.append(br)
            self._self_feed.append(feed)
            self._prev_closes.append(br.stats["closes"])
            self.n = len(self.endpoints)
        return slot

    def _retire_slot(self, slot: int) -> None:
        """A left/replaced member's transition drained: stop routing
        forever (forced-open breaker + dead set) and close the
        endpoint. Called by the migrator at settle time."""
        with self._ring_lock:
            self._dead.add(slot)
        self.breakers[slot].force_open()
        with self._repair_lock:
            self._repair_pending.pop(slot, None)
        try:
            self.endpoints[slot].close()
        except Exception:  # noqa: BLE001 — teardown best effort
            pass

    def drain_migration(self, deadline_s: float = 30.0) -> bool:
        """Tick migration until the dual-read window closes (bounded);
        drills and orderly scale-downs call this between transitions."""
        if self.migrator is None:
            return True
        return self.migrator.drain(deadline_s)

    # -- anti-entropy repair --

    def _repair_loop(self) -> None:
        while not self._stop.wait(self.cfg.repair_interval_s):
            try:
                self.repair_tick()
            except Exception:  # noqa: BLE001 — repair must outlive any
                pass           # single bad cycle (it is best-effort)

    def repair_tick(self) -> int:
        """One bounded repair round; public so drills and the soak bench
        can drive repair deterministically (no sleeping on the thread) —
        safe to call concurrently with the background thread (worst case
        a rejoin is scheduled twice; re-replicating a page the replica
        already holds is idempotent). Returns pages re-replicated this
        tick (live-migration moves included: repair and migration share
        one cadence and one rate discipline)."""
        moved = 0
        if self.migrator is not None:
            moved += self.migrator.tick()
        self._maybe_auto_replace()
        # delegated device-side anti-entropy: fused endpoints compare-
        # and-copy across their own replica lanes on this cadence (one
        # wire verb, one collective program — no per-key host loop)
        self._ticks += 1
        every = self.cfg.device_repair_ticks
        if every > 0 and self._ticks % every == 0:
            for e in range(self.n):
                if e in self._dead or not self.breakers[e].ready() \
                        or self._lanes(e) <= 1:
                    continue
                fn = getattr(self.endpoints[e], "replica_repair", None)
                if fn is None:
                    continue
                out = self._call(e, fn)
                if out is not _FAILED and out:
                    self._bump("device_repair_rows", int(out))
                    moved += int(out)
        to_schedule = []
        with self._repair_lock:
            for i, br in enumerate(self.breakers):
                closes = br.stats["closes"]
                if (closes > self._prev_closes[i]
                        and br.state == CircuitBreaker.CLOSED
                        and i not in self._dead):
                    to_schedule.append(i)
                self._prev_closes[i] = closes
            pending = list(self._repair_pending)
        for i in to_schedule:
            self._schedule_repair(i)
            if i not in pending:
                pending.append(i)
        for i in pending:
            moved += self._repair_step(i)
        # rejoin catch-up complete: an endpoint whose repair queue just
        # DRAINED leaves its recovering serving state (idempotent wire
        # verb — endpoints that never were recovering answer False).
        # From here on its cold misses are honest `miss_cold` again.
        with self._repair_lock:
            drained = [i for i in pending
                       if i not in self._repair_pending
                       and i not in self._dead]
        for i in drained:
            fn = getattr(self.endpoints[i], "mark_recovered", None)
            if fn is None or not self.breakers[i].ready():
                continue
            out = self._call(i, fn)
            if out is not _FAILED and out:
                self._bump("recoveries_completed")
        return moved

    def _maybe_auto_replace(self) -> None:
        """Breaker-driven auto-replacement (ROADMAP item 2's leftover:
        the ring's replace() path under REAL failure). A member whose
        breaker has been latched out of CLOSED for
        `cfg.auto_replace_after_s` is swapped for a freshly built spare
        (`spare_factory(failed_slot)`) through the normal
        replace_endpoint transition — quarantine, dual-read window,
        migration of the owed ranges, retire. One replacement per tick:
        a correlated outage must drain each transition before the next
        membership change (the refuse-mid-transition rule)."""
        if (self.spare_factory is None or not self._ring_on
                or self.cfg.auto_replace_after_s <= 0 or self._closed
                or self.migrator.active()):
            return
        for i in range(self.n):
            if i in self._dead:
                continue
            if self.breakers[i].down_for() < self.cfg.auto_replace_after_s:
                continue
            try:
                spare = self.spare_factory(i)
            except Exception:  # noqa: BLE001 — no spare available now;
                return         # the latch persists, next tick retries
            try:
                slot = self.replace_endpoint(i, spare)
            except RuntimeError:
                # lost a race with a concurrent membership op:
                # replace_endpoint retired the registered spare (slot
                # dead, endpoint closed) — retry after the winner's
                # window drains, with a fresh spare
                return
            self._bump("auto_replacements")
            tele.rung("membership_change", source="replica_group",
                      kind="auto_replace", failed_slot=i, new_slot=slot)
            return

    def _schedule_repair(self, e: int) -> None:
        """A rejoined endpoint: pull its packed bloom mirror and queue
        every journaled key it owns but its filter lacks."""
        with self._maps_lock:
            journal = self._journal.keys_array()
        if len(journal) == 0:
            return
        owned = (self._members(journal) == e).any(axis=1)
        cand = journal[owned]
        if len(cand) == 0:
            return
        packed = (None if self.cfg.bloom_hashes is None
                  else self._call(e, self.endpoints[e].packed_bloom))
        if packed is _FAILED:
            return  # not actually back; the breaker will re-open
        if packed is None:
            if not getattr(self.endpoints[e], "connected", True):
                return  # not actually back; the breaker will re-open
            # bloomless server (or bloom guiding disabled): repair every
            # candidate (a PUT the replica already holds is idempotent)
            need = cand
        else:
            present = query_packed_np(
                np.asarray(packed, np.uint32), cand,
                num_hashes=self.cfg.bloom_hashes)
            need = cand[~present]
        if len(need) == 0:
            return
        self._bump("repair_rounds")
        self._bump("repair_candidates", len(need))
        with self._repair_lock:
            q = self._repair_pending.setdefault(e, collections.deque())
            q.extend(map(tuple, need))

    def _repair_step(self, e: int) -> int:
        """Re-replicate up to `repair_batch` pages to endpoint `e` from
        surviving members — the rate bound that keeps repair off the
        serving path's tail. Keys whose every survivor attempt FAILED
        (transport error, breaker not ready) are re-queued for the next
        tick; only a completed answer — hit (repaired) or miss (the
        survivor really lacks it) — retires a key."""
        if e in self._dead:
            # retired slot (left/replaced member): its queue is garbage
            with self._repair_lock:
                q = self._repair_pending.pop(e, None)
            if q:
                self._bump("repair_dropped", len(q))
            return 0
        with self._repair_lock:
            q = self._repair_pending.get(e)
            if not q:
                self._repair_pending.pop(e, None)
                return 0
            batch = [q.popleft() for _ in range(min(self.cfg.repair_batch,
                                                    len(q)))]
        keys = np.array(batch, np.uint32).reshape(-1, 2)
        # ownership gate (journal-growth fix): a ring transition since
        # these keys were queued may have moved them off this endpoint —
        # repairing them here would re-replicate to a NON-owner and the
        # old code retried such keys forever. Dropped, not retried:
        # their current owners are repaired through their own queues.
        owned = (self._members(keys) == e).any(axis=1)
        if not owned.all():
            self._bump("repair_dropped", int((~owned).sum()))
            keys = keys[owned]
        if len(keys) == 0:
            with self._repair_lock:
                if not self._repair_pending.get(e):
                    self._repair_pending.pop(e, None)
            return 0
        members = self._members(keys)
        answered = np.zeros(len(keys), bool)
        moved = 0
        for s in range(self.n):
            if s == e or not self.breakers[s].ready():
                continue
            mask = (members == s).any(axis=1)
            if not mask.any():
                continue
            res = self._call(s, self.endpoints[s].get, keys[mask])
            if res is _FAILED or res is None:
                continue
            answered[mask] = True
            got, ok = res
            ok = np.asarray(ok, bool).copy()
            got = np.asarray(got, np.uint32)
            if ok.any():
                # digest-verify BEFORE re-replicating: repair must never
                # launder a corrupt/stale page into the rejoined replica
                kk = keys[mask]
                osrc = np.full(len(kk), s, np.int64)
                buf = got.copy()
                self._verify(kk, buf, ok, osrc)
            if ok.any():
                self._call(e, self.endpoints[e].put, kk[ok], buf[ok])
                moved += int(ok.sum())
            # served keys need no second survivor; drop them from the
            # remaining members scan
            members[mask] = np.where(ok[:, None], -1, members[mask])
        retry = ~answered
        with self._repair_lock:
            if retry.any():
                q = self._repair_pending.setdefault(e, collections.deque())
                q.extend(map(tuple, keys[retry]))
            elif not self._repair_pending.get(e):
                self._repair_pending.pop(e, None)
        self._bump("repair_pages", moved)
        return moved

    # -- stats / lifecycle --

    def stats(self) -> dict:
        eps = []
        for i, (ep, br) in enumerate(zip(self.endpoints, self.breakers)):
            d = {"breaker": br.state, "breaker_stats": dict(br.stats)}
            if i in self._dead:
                eps.append(dict(d, retired=True))
                continue
            fn = getattr(ep, "stats", None)
            # a bare TcpBackend's stats() is a wire roundtrip — against
            # a non-closed endpoint that is up to op_timeout_s of stall
            # per replica inside a MONITORING call, so skip it (wrapped
            # endpoints' stats() are local snapshots and always safe)
            if fn is not None and (br.state == CircuitBreaker.CLOSED
                                   or not self._self_feed[i]):
                try:
                    d.update(fn())
                except _TRANSPORT_ERRORS:
                    d["stats_unreachable"] = True
            eps.append(d)
        group = dict(self.counters)
        with self._repair_lock:
            group["repair_backlog"] = sum(
                len(q) for q in self._repair_pending.values())
        out = {"group": group, "endpoints": eps}
        if self._ring_on:
            with self._ring_lock:
                ring = self.ring
            out["ring"] = ring.describe()
            out["migration"] = self.migrator.stats()
        return out

    def close(self, close_endpoints: bool = True) -> None:
        """Idempotent teardown, `CleanCacheClient.close` parity: signal
        and JOIN the repair thread (a daemon alone would keep touching
        endpoints through teardown). A timed-out join KEEPS the thread
        handle so a later close() can re-join, but teardown CONTINUES
        regardless — pool and endpoints must not leak behind a repair
        step stuck in a slow wire call (closing the endpoints below is
        also what unwedges that call)."""
        self._stop.set()
        t = self._repair_thread
        if t is not None:
            t.join(timeout=5)
            if not t.is_alive():
                self._repair_thread = None
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=True)
        if close_endpoints:
            for ep in self.endpoints:
                try:
                    ep.close()
                except Exception:  # noqa: BLE001 — teardown best effort
                    pass

    def __enter__(self) -> "ReplicaGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
