"""Live page migration — how keys reach their new owners under load.

On a ring transition (`HashRing.join/leave/replace`) only ~1/N of the
key space changes owners; this engine streams exactly those pages to
the members that now owe them, while the fleet keeps serving:

- **Candidate universe.** The group's bounded put-journal (the same
  universe anti-entropy repair walks): every journaled key whose owner
  set differs between the old and new ring epochs is a migration
  candidate, paired with the NEW owners that need it.
- **Digest-verified streaming.** Pages are fetched from an old owner
  and verified through the group's digest gate BEFORE re-replication —
  migration must never launder a corrupt page into a new owner (the
  repair path's discipline, reused verbatim). Writes ride the wire's
  `MSG_HANDOFF` verb when the endpoint negotiated it (server-side
  attributable as `handoff_pages`), falling back to plain puts.
- **Rate bound.** A token bucket (`migrate_pages_per_s`, burst
  `migrate_burst`) caps how many pages each `tick()` may move, so a
  5-server join cannot convoy the serving path's tail behind a bulk
  copy. Batches ride the pipelined connection like any fan-out.
- **Dual-read window.** While a transition is ACTIVE the group resolves
  GETs against BOTH epochs (new owners first, old owners after — first
  valid answer wins) and PUT/INVALIDATE fan out to the union, so an
  in-flight key mid-move degrades to a legal `miss_routed` miss —
  never wrong bytes, never a lost tombstone. The window closes when
  the backlog drains.
- **Observability.** Progress lands in a registry scope (`migration.*`
  counters + lag/active gauges) that the series collector windows like
  every other metric — teletop and a flight dump's series tail show
  the transition trajectory — and every transition boundary fires a
  flight-recorder `membership_change` / `membership_settled` event.
  `tools/check_teledump.py` pins `moved_pages == Σ per-transition-kind
  moves` and the lag gauge shape on any document carrying the scope.

The engine is driven by `ReplicaGroup.repair_tick()` (background repair
thread or manual drill ticks) — one cadence, one rate discipline for
both repair and migration.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from pmdfc_tpu_torch.cluster.ring import HashRing, moved_mask
from pmdfc_tpu_torch.config import RingConfig
from pmdfc_tpu_torch.runtime import sanitizer as san
from pmdfc_tpu_torch.runtime import telemetry as tele

# transition kinds — the per-kind moved counters check_teledump sums
KINDS = ("join", "leave", "replace")


class TokenBucket:
    """Pages-per-second rate bound with a burst allowance. `take(n)`
    grants up to n tokens immediately (never blocks — the caller's tick
    cadence IS the wait). rate 0 = unbounded."""

    def __init__(self, rate: float, burst: int):
        self.rate = float(rate)
        self.burst = max(1, int(burst))
        self._level = float(self.burst)
        self._t = time.monotonic()

    def take(self, n: int) -> int:
        if self.rate <= 0:
            return n
        now = time.monotonic()
        self._level = min(self.burst,
                          self._level + (now - self._t) * self.rate)
        self._t = now
        grant = int(min(n, self._level))
        self._level -= grant
        return grant

    def set_rate(self, rate: float) -> None:
        """Re-rate the bucket live (autotune): the accumulated level and
        burst ceiling stand — only the refill speed changes, so a
        rate walk never mints a burst of back-tokens."""
        if self.rate > 0:
            # settle accrual at the OLD rate up to now, so the new rate
            # applies only forward
            now = time.monotonic()
            self._level = min(self.burst,
                              self._level + (now - self._t) * self.rate)
            self._t = now
        self.rate = float(rate)


class Transition:
    """One in-flight membership change: the (old, new) epoch pair, the
    moved-key backlog, and the slots to retire once it drains."""

    __slots__ = ("kind", "old_ring", "new_ring", "pending", "retire",
                 "moved", "dropped", "inflight", "t0")

    def __init__(self, kind: str, old_ring: HashRing, new_ring: HashRing,
                 retire=()):
        self.kind = kind
        self.old_ring = old_ring
        self.new_ring = new_ring
        # deque of (key_tuple, needs_tuple, tries)
        self.pending: collections.deque = collections.deque()
        self.retire = tuple(retire)
        self.moved = 0
        self.dropped = 0
        # batches popped but still being moved: the settle gate — a
        # concurrent tick seeing an empty deque must NOT close the
        # window while another tick's batch is mid-wire (its requeues
        # would be orphaned and its sources retired under it)
        self.inflight = 0
        self.t0 = time.monotonic()


class Migrator:
    """Owns the active transition and the rate bucket; every data-path
    call (fetch, verify, write) goes THROUGH the group so breaker
    gating, digest verification, and failure accounting stay in one
    place. Lock discipline: `_lock` guards only the transition slot and
    counters — never held across endpoint I/O (rank 13, between the
    group's repair lock and the wire tier)."""

    def __init__(self, group, cfg: RingConfig | None = None):
        self.group = group
        self.cfg = cfg or RingConfig()
        # guarded-by: _t, _bucket
        self._lock = san.lock("Migrator._lock")
        self._t: Transition | None = None
        self._bucket = TokenBucket(self.cfg.migrate_pages_per_s,
                                   self.cfg.migrate_burst)
        self.scope = tele.scope("migration", {
            "transitions": 0, "moved_pages": 0,
            "moved_join": 0, "moved_leave": 0, "moved_replace": 0,
            "migrate_rounds": 0, "dropped_keys": 0, "candidate_keys": 0,
        })
        self.scope.set("lag", 0)
        self.scope.set("active", 0)
        self.scope.set("ring_epoch", 0)
        self.scope.set("migrate_rate", self.cfg.migrate_pages_per_s)

    # -- live rate bound (the autotune hook; PR-12's deferred
    # adaptive migration rate) --

    def rate(self) -> float:
        """The pages-per-second bound currently live (0 = unbounded)."""
        with self._lock:
            return self._bucket.rate

    def set_rate(self, pages_per_s: float | None) -> float:
        """Live-set the migration rate bound. None restores the static
        `RingConfig.migrate_pages_per_s` — with no controller attached
        (or PMDFC_AUTOTUNE=off) this is never called, and the bucket
        behaves exactly as the static config (conformance-pinned)."""
        with self._lock:
            r = self.cfg.migrate_pages_per_s if pages_per_s is None \
                else max(0.0, float(pages_per_s))
            self._bucket.set_rate(r)
            self.scope.set("migrate_rate", r)
            return r

    # -- window surface (read by the group's routing path) --

    def rings(self):
        """(old_ring, new_ring) while a transition is active, else None
        — the dual-read window predicate."""
        with self._lock:
            t = self._t
            return (t.old_ring, t.new_ring) if t is not None else None

    def active(self) -> bool:
        with self._lock:
            return self._t is not None

    def lag(self) -> int:
        with self._lock:
            return len(self._t.pending) if self._t is not None else 0

    # -- transition lifecycle --

    def start(self, kind: str, old_ring: HashRing, new_ring: HashRing,
              candidates: np.ndarray, retire=()) -> int:
        """Open a transition: diff the rings over the candidate keys,
        queue every moved key with the new owners that owe it. Returns
        the backlog size. One transition at a time — a second
        membership change while one drains raises (the drill/serving
        contract: settle, then move again)."""
        if kind not in KINDS:
            raise ValueError(f"unknown transition kind {kind!r}")
        g = self.group
        t = Transition(kind, old_ring, new_ring, retire)
        if len(candidates):
            keys = np.asarray(candidates, np.uint32).reshape(-1, 2)
            rf = g.cfg.rf
            moved = moved_mask(old_ring, new_ring, keys, rf)
            mk = keys[moved]
            if len(mk):
                old_own = old_ring.owners_np(mk, rf)
                new_own = new_ring.owners_np(mk, rf)
                for i, k in enumerate(mk):
                    needs = tuple(
                        int(d) for d in new_own[i]
                        if d not in old_own[i])
                    if needs:
                        t.pending.append(
                            ((int(k[0]), int(k[1])), needs, 0))
        with self._lock:
            if self._t is not None:
                raise RuntimeError(
                    "a membership transition is already draining "
                    f"(epoch {self._t.new_ring.epoch})")
            self._t = t
            lag = len(t.pending)
            self.scope.inc("transitions")
            self.scope.inc("candidate_keys", lag)
            self.scope.set("lag", lag)
            self.scope.set("active", 1)
            self.scope.set("ring_epoch", new_ring.epoch)
        # rung OUTSIDE the lock (breaker/rung discipline: the flight
        # recorder may write a dump, and IO never rides a critical
        # section) — the transition boundary event teletop/flight dumps
        # key the trajectory on
        tele.rung("membership_change", kind=kind,
                  epoch=new_ring.epoch, members=list(new_ring.members),
                  moved_keys=lag, retire=list(t.retire))
        return lag

    def tick(self) -> int:
        """One bounded migration round: move up to the token bucket's
        grant, re-queue all-sources-failed keys (bounded retries),
        close the window when the backlog drains. Returns pages moved.
        Safe to call from the repair thread and manual drivers
        concurrently — the batch is popped under the lock, and moving a
        page twice is idempotent."""
        with self._lock:
            t = self._t
            if t is None:
                return 0
            budget = self._bucket.take(
                min(self.cfg.migrate_batch, len(t.pending)))
            batch = [t.pending.popleft() for _ in range(budget)]
            if batch:
                t.inflight += 1
        if not batch:
            # starved by the rate bound (pending non-empty) or drained
            self._maybe_settle()
            return 0
        self.scope.inc("migrate_rounds")
        try:
            moved = self._move(t, batch)
        finally:
            with self._lock:
                t.inflight -= 1
        self._maybe_settle()
        return moved

    def drain(self, deadline_s: float = 30.0) -> bool:
        """Tick until the window closes (drill/shutdown helper) —
        bounded, never raises on a stuck source (keys drop to legal
        misses after their retries)."""
        end = time.monotonic() + deadline_s
        while self.active() and time.monotonic() < end:
            if self.tick() == 0 and self.active():
                time.sleep(0.005)  # rate-starved: wait for tokens
        return not self.active()

    # -- internals --

    def _move(self, t: Transition, batch: list) -> int:
        """Fetch one batch from old owners, digest-verify, hand off to
        the new owners that owe each key. The group's `_call` does the
        breaker bookkeeping; `_verify` the digest gate."""
        g = self.group
        keys = np.array([b[0] for b in batch], np.uint32).reshape(-1, 2)
        rf = g.cfg.rf
        sources = t.old_ring.owners_np(keys, rf)
        out = np.zeros((len(keys), g.page_words), np.uint32)
        found = np.zeros(len(keys), bool)
        src = np.full(len(keys), -1, np.int64)
        answered = np.zeros(len(keys), bool)
        for s in set(sources.ravel().tolist()):
            need = ~found & (sources == s).any(axis=1)
            if not need.any() or not g.breakers[s].ready():
                continue
            res = g._call(s, g.endpoints[s].get, keys[need])
            if res is g._FAILED_SENTINEL or res is None:
                continue
            answered[need] = True
            got, ok = res
            ok = np.asarray(ok, bool)
            idx = np.nonzero(need)[0][ok]
            out[idx] = np.asarray(got, np.uint32)[ok]
            found[idx] = True
            src[idx] = s
        # the digest gate: a corrupt source page must not be laundered
        # into the new owner (flips degrade to unanswered -> retried,
        # so the next tick can re-fetch from a different old owner)
        pre_verify = found.copy()
        g._verify(keys, out, found, src)
        answered[pre_verify & ~found] = False
        moved = 0
        delivered: list[set] = [set() for _ in batch]
        by_dest: dict[int, list[int]] = {}
        for i, (_, needs, _) in enumerate(batch):
            if not found[i]:
                continue
            for d in needs:
                by_dest.setdefault(d, []).append(i)
        for d, idx in by_dest.items():
            if not g.breakers[d].ready():
                continue  # undelivered: requeued below, never silent
            ii = np.asarray(idx)
            fn = getattr(g.endpoints[d], "handoff", None) \
                or g.endpoints[d].put
            res = g._call(d, fn, keys[ii], out[ii])
            if res is not g._FAILED_SENTINEL:
                moved += len(ii)
                for i in idx:
                    delivered[i].add(d)
        # tombstone-race replay: a key invalidated BETWEEN our source
        # fetch and the handoff write must not be resurrected on a new
        # owner (invalidate pops the digest map FIRST, then fans out —
        # so any tombstone whose fan-out could precede our write is
        # visible as a missing digest here, and replaying the delete to
        # the dests we just wrote closes the window; a digest merely
        # cap-evicted mid-move costs at worst a spurious legal miss,
        # which the clean-cache contract allows — stale bytes are not)
        gone: set = set()
        hit_keys = [i for i in range(len(batch)) if found[i]]
        if hit_keys:
            with g._maps_lock:
                for i in hit_keys:
                    if batch[i][0] not in g._digests:
                        gone.add(i)
        if gone:
            by_dest_gone: dict[int, list[int]] = {}
            for i in gone:
                for d in delivered[i]:
                    by_dest_gone.setdefault(d, []).append(i)
            for d, idx in by_dest_gone.items():
                g._call(d, g.endpoints[d].invalidate,
                        keys[np.asarray(idx)])
        requeue, dropped = [], 0
        for i, (k, needs, tries) in enumerate(batch):
            if i in gone:
                continue  # tombstoned mid-move: retired, nothing owed
            if found[i]:
                # fetched and verified, but some new owner did not take
                # the write (breaker gated / transport failure): those
                # dests stay owed — bounded retries, never silent
                remaining = tuple(d for d in needs
                                  if d not in delivered[i])
                if not remaining:
                    continue
                needs = remaining
            elif answered[i]:
                continue  # the source really lacks it (a legal miss)
            if tries + 1 > self.cfg.migrate_retries:
                dropped += 1
            else:
                requeue.append((k, needs, tries + 1))
        with self._lock:
            t.pending.extend(requeue)
            t.moved += moved
            t.dropped += dropped
            self.scope.set("lag", len(t.pending))
            self.scope.inc("moved_pages", moved)
            self.scope.inc(f"moved_{t.kind}", moved)
            self.scope.inc("dropped_keys", dropped)
        return moved

    def _maybe_settle(self) -> None:
        with self._lock:
            t = self._t
            if t is None or t.pending or t.inflight:
                return
            self._t = None
            self.scope.set("lag", 0)
            self.scope.set("active", 0)
        # window closed: retire slots OUTSIDE the lock (retiring closes
        # endpoints = I/O), then the settle event
        for slot in t.retire:
            self.group._retire_slot(slot)
        tele.rung("membership_settled", kind=t.kind,
                  epoch=t.new_ring.epoch, moved_pages=t.moved,
                  dropped_keys=t.dropped,
                  secs=round(time.monotonic() - t.t0, 3))

    def stats(self) -> dict:
        with self._lock:
            t = self._t
            d = dict(self.scope)
            d["active"] = t is not None
            d["lag"] = len(t.pending) if t is not None else 0
            if t is not None:
                d["epoch"] = t.new_ring.epoch
                d["kind"] = t.kind
        return d
