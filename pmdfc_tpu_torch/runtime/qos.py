"""Multi-tenant QoS control plane: namespaces, weighted-fair flush
scheduling, and overload shedding (`NetServer(qos=QosConfig(...))`).

The reference served every client through one request plane with
multi-queue, CPU-pinned pollers (`server/rdma_svr.h:16-19`); at the
"millions of users" scale the ROADMAP targets, that plane must also be
FAIR — one antagonist tenant must not be able to blow every compliant
tenant's SLO, and a 10× rated fan-in must degrade gracefully instead of
drowning the coalesced flush loop. Three mechanisms, all host-side and
dispatch-free:

**Namespaces.** Tenancy is carved out of the longkey space, not the
wire format: a key's tenant id is the top `QosConfig.tenant_bits` bits
of its hi (oid) word. Clients tag at the edge (`tag_oids`), the server
resolves ONCE per staged op (`QosPlane.resolve`), and untagged traffic
(tenant-prefix 0, i.e. every pre-QoS transcript) lands in the default
tenant bit-preserved. Zero new wire bytes; `PMDFC_QOS=off` therefore
needs no capability handshake to stand down.

**Weighted-fair scheduling.** The single staging FIFO becomes
per-tenant lanes drained by deficit round robin: each visit credits a
lane `weight * quantum_ops` page-units of deficit and serves whole
staged ops against it (an op costs its page count), so long-run device
batch composition is proportional to declared weights while the fused
flush discipline (one device batch per phase, PR 4) is untouched. Lane
state shares the server's flush condition variable — the same lock that
guarded the FIFO it replaces, so the scheduler adds no lock-order
edges on the staging path.

**Shedding.** Two rungs, both attributed to the `miss_shed` cause lane
(shed GETs answer all-miss, shed PUTs ack-and-drop; `misses == Σ
causes` stays bit-exact on every stats surface via the KV host-stats
overlay, `KV.account_shed`): per-tenant token buckets refuse ops at
admission BEFORE they stage (`shed_edge`), and when staging depth still
crosses `shed_threshold` the ladder drops the newest sheddable ops from
the lowest-priority non-empty lane (`shed_ladder`) — the flush loop
never sees the overload it is too late to fix.

Per-tenant telemetry rides one scope per lane
(`<srv>.qos.t<tid>.{ops,staged,shed_edge,shed_ladder,shed_gets,
shed_puts}` + `weight`/`rate` gauges); `tools/check_teledump.py
check_qos` pins the lane invariants and `runtime/autotune.py
bind_qos` walks the rate knobs inside each tenant's declared envelope.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from pmdfc_tpu_torch.config import QosConfig, TenantConfig
from pmdfc_tpu_torch.runtime import sanitizer as san
from pmdfc_tpu_torch.runtime import telemetry as tele

__all__ = ["TokenBucket", "QosPlane", "tag_oids", "tenant_of"]


def tag_oids(oids, tid: int, tenant_bits: int) -> np.ndarray:
    """Client-edge namespace tagging: place `tid` in the top
    `tenant_bits` bits of the oid word(s), preserving the low bits.
    Tagging with tid 0 clears the prefix — i.e. the default tenant IS
    the untagged namespace, so a tid-0 client is bit-identical to a
    pre-QoS client."""
    if not (1 <= tenant_bits <= 16):
        raise ValueError("tenant_bits must be in [1, 16]")
    if not (0 <= tid < (1 << tenant_bits)):
        raise ValueError(f"tid {tid} does not fit in {tenant_bits} bits")
    oids = np.asarray(oids, np.uint32)
    shift = 32 - tenant_bits
    low = np.uint32((1 << shift) - 1)
    return ((oids & low) | np.uint32(tid << shift)).astype(np.uint32)


def tenant_of(oids, tenant_bits: int):
    """Tenant id(s) carried in the top `tenant_bits` bits of the oid
    word(s) — the inverse of `tag_oids` (scalar in, int out; array in,
    array out)."""
    shift = 32 - tenant_bits
    if np.isscalar(oids) or getattr(oids, "ndim", 1) == 0:
        return int(oids) >> shift
    return (np.asarray(oids, np.uint32) >> np.uint32(shift)).astype(
        np.uint32)


class TokenBucket:
    """Continuous-refill token bucket for per-tenant edge admission.

    `rate` tokens/second refill up to `burst`; `take(n)` is
    all-or-nothing (a half-admitted verb would need a partial reply the
    wire has no shape for). Rate 0 = unlimited — the Migrator's
    rate-bound precedent: zero is operator intent, not "off by
    accident" — and `set_rate` is the autotune controller's live knob
    (picked up by the very next `take`)."""

    def __init__(self, rate: float, burst: int):
        # guarded-by: _rate, _tokens, _t_last
        self._lock = san.lock("TokenBucket._lock")
        self._rate = max(0.0, float(rate))
        self._burst = float(max(1, burst))
        self._tokens = self._burst
        self._t_last = time.monotonic()

    def take(self, n: int = 1) -> bool:
        with self._lock:
            if self._rate <= 0:
                return True
            now = time.monotonic()
            self._tokens = min(
                self._burst,
                self._tokens + (now - self._t_last) * self._rate)
            self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def rate(self) -> float:
        with self._lock:
            return self._rate

    def set_rate(self, v: float) -> float:
        with self._lock:
            self._rate = max(0.0, float(v))
            return self._rate


class _Lane:
    """One tenant's staging lane. Queue + deficit are guarded by the
    OWNING server's flush cv (see QosPlane); the bucket carries its own
    lock because admission runs on reader threads before staging."""

    __slots__ = ("cfg", "q", "deficit", "bucket", "scope")

    def __init__(self, cfg: TenantConfig, scope):
        self.cfg = cfg
        self.q: collections.deque = collections.deque()
        self.deficit = 0
        self.bucket = TokenBucket(cfg.rate_ops_per_s, cfg.burst_ops)
        self.scope = scope


class QosPlane:
    """Server-side tenant plane: the lane registry behind
    `NetServer(qos=...)`.

    LOCKING: every lane-structure method (`stage`, `drain`,
    `shed_overflow`, `depth`) MUST be called holding the server's
    `_flush_cv` — lane queues/deficits/cursor deliberately have no lock
    of their own, they are the staging queue's replacement and inherit
    its guard (documented here because the guard lives in another
    object). `resolve`, `admit`, the note_* counters, and the rate
    knobs are lock-free or self-locking and safe from reader threads.
    """

    def __init__(self, cfg: QosConfig, prefix: str):
        self.cfg = cfg
        tenants = {tc.tid: tc for tc in cfg.tenants}
        if 0 not in tenants:
            # the default tenant always exists: unregistered prefixes
            # and untagged traffic must resolve somewhere
            tenants[0] = TenantConfig(tid=0)
        self.tenants = tenants
        self._shift = 32 - cfg.tenant_bits
        # per-tenant telemetry: one scope per lane, named by tid under
        # the owning server's prefix (unique=False — the tid IS the
        # instance). Scopes exist IFF the plane is on: PMDFC_QOS=off
        # never constructs a QosPlane, so off registers nothing (the
        # PMDFC_AUTOTUNE scope-iff-enabled precedent).
        self._lanes: dict[int, _Lane] = {}
        for tid, tc in sorted(tenants.items()):
            scope = tele.scope(
                f"{prefix}.qos.t{tid}",
                {"ops": 0, "staged": 0, "shed_edge": 0,
                 "shed_ladder": 0, "shed_gets": 0, "shed_puts": 0},
                unique=False)
            scope.set("weight", tc.weight)
            scope.set("rate", tc.rate_ops_per_s)
            scope.set("priority", tc.priority)
            self._lanes[tid] = _Lane(tc, scope)
        # DRR visit order (deterministic: by tid) and the persistent
        # round cursor; shed order is lowest priority first, ties
        # broken toward the higher tid (deterministic, and the default
        # tenant 0 is sacrificed last among equals)
        # guarded-by (NetServer._flush_cv): _rr, _cursor, _depth,
        # guarded-by (NetServer._flush_cv): lane .q and .deficit
        self._rr = sorted(self._lanes)
        self._cursor = 0
        self._depth = 0
        self._shed_order = sorted(
            self._lanes, key=lambda t: (self._lanes[t].cfg.priority, -t))

    # -- namespace resolution + edge admission (reader threads) --

    def resolve(self, keys: np.ndarray | None) -> int:
        """Tenant id of one staged op, resolved ONCE at decode time
        from the first key's oid prefix (every key in a verb shares its
        client's tenant tag — clients tag whole batches). Aux verbs
        (no keys) and unregistered prefixes land in the default
        tenant."""
        if keys is None or keys.size < 2:
            return 0
        hi = int(keys.reshape(-1, 2)[0, 0])
        tid = hi >> self._shift
        return tid if tid in self._lanes else 0

    def admit(self, tid: int, count: int) -> bool:
        """Token-bucket edge admission of one verb (`count` pages);
        False = shed at the edge before staging."""
        return self._lanes[tid].bucket.take(max(1, int(count)))

    # -- per-tenant accounting (any thread; counters self-lock) --

    def note_arrival(self, tid: int, staged: bool) -> None:
        """Count one verb at the staging edge: every op either stages
        or is edge-shed (`ops == staged + shed_edge`, the conservation
        pin check_qos enforces)."""
        sc = self._lanes[tid].scope
        sc.inc("ops")
        sc.inc("staged" if staged else "shed_edge")

    def note_shed_verbs(self, tid: int, gets: int, puts: int,
                        ladder: bool = False) -> None:
        """Per-verb decomposition of a shed (`shed_edge + shed_ladder
        == shed_gets + shed_puts`); `ladder=True` additionally counts
        the op as ladder-shed (it already counted as staged)."""
        sc = self._lanes[tid].scope
        if ladder:
            sc.inc("shed_ladder", gets + puts)
        if gets:
            sc.inc("shed_gets", gets)
        if puts:
            sc.inc("shed_puts", puts)

    # -- lane structure (call ONLY under NetServer._flush_cv) --

    def depth(self) -> int:
        return self._depth

    def stage(self, op) -> None:
        self._lanes[op.tid].q.append(op)
        self._depth += 1

    def drain(self, n: int) -> list:
        """Deficit-round-robin drain of up to `n` staged ops into the
        fused batch. Each visit to a non-empty lane credits
        `weight * quantum_ops` page-units; ops are served whole (cost =
        page count, so fairness is measured in device work, not verb
        count) and the deficit may borrow negative — it repays across
        rounds, which is what makes long-run shares proportional to
        weights. An emptied lane forfeits its residue (classic DRR:
        idle lanes bank nothing)."""
        out: list = []
        order = self._rr
        nl = len(order)
        while len(out) < n and self._depth > 0:
            lane = self._lanes[order[self._cursor]]
            self._cursor = (self._cursor + 1) % nl
            if not lane.q:
                lane.deficit = 0
                continue
            lane.deficit += lane.cfg.weight * self.cfg.quantum_ops
            while lane.q and lane.deficit > 0 and len(out) < n:
                op = lane.q.popleft()
                self._depth -= 1
                lane.deficit -= max(1, op.count)
                out.append(op)
            if not lane.q:
                lane.deficit = 0
        return out

    def shed_overflow(self, sheddable) -> list:
        """The shed ladder: when staging depth sits at/over the
        threshold, pop sheddable staged ops — NEWEST first, from the
        lowest-priority non-empty lane up — until depth is back under
        the threshold (capped at `shed_batch` per pass). Newest-first
        because the youngest op has waited least: dropping it frees
        the same depth while wasting the least already-paid queue
        time. Returns the victims; the caller answers + attributes
        them OUTSIDE the cv (replies must never be sent under a
        HOLD_WATCH lock)."""
        need = self._depth - self.cfg.shed_threshold + 1
        if need <= 0:
            return []
        need = min(need, self.cfg.shed_batch)
        victims: list = []
        for tid in self._shed_order:
            lane = self._lanes[tid]
            if not lane.q:
                continue
            kept: collections.deque = collections.deque()
            while lane.q and need > 0:
                op = lane.q.pop()
                if sheddable(op):
                    victims.append(op)
                    self._depth -= 1
                    need -= 1
                else:
                    kept.appendleft(op)
            while lane.q:
                kept.appendleft(lane.q.pop())
            lane.q = kept
            if need <= 0:
                break
        return victims

    # -- live rate knobs (autotune hooks; bucket self-locks) --

    def rate(self, tid: int) -> float:
        return self._lanes[tid].bucket.rate()

    def set_rate(self, tid: int, v: float) -> float:
        applied = self._lanes[tid].bucket.set_rate(v)
        self._lanes[tid].scope.set("rate", applied)
        return applied

    def scope(self, tid: int):
        """The tenant's telemetry scope (tests + teletop)."""
        return self._lanes[tid].scope

    def tenant(self, tid: int) -> TenantConfig:
        """The tenant's declared config (autotune envelope source)."""
        return self._lanes[tid].cfg

    def tids(self) -> list[int]:
        return list(self._rr)
