"""Sharded serving plane — the partitioned KV behind the NetServer (twin of
`pmdfc_tpu/parallel/plane.py`).

The reference JULEE server dispatches each request to a per-NUMA-node
queue picked by `GetNodeID(key)` (`server/NuMA_KV.cpp:136-151`). Here ONE
coalesced `NetServer` flush loop drives a `ShardedKV` through its plane
verbs (`ShardedKV.plane_*`):

- **Routing is host-side and loss-free** (`partitioning.ShardRouter`):
  the flush loop bins each fused batch by owning shard while it already
  touches every request; there is no a2a bucket-overflow class.
- **Pads are per shard** up the pow2 ladder, so a skewed flush pays only
  its own shard's pad waste (`routes_per_shard` tells the NetServer to
  skip its global pad).
- **Lean GETs write no stats leaf**: each shard's stats delta is folded
  into the plane's host stats (`ShardedKV._plane_stats`).
- **Results come back to the host once per phase**, and GET replies ship
  straight out of the routed buffer (`PlaneGets.hit_rows`).

Telemetry stays per-shard attributable: `shard{i}_ops` counters and
`phase_*_us_s{i}` histogram families on the shared `mesh` scope, and a
phase failure fires a flight-recorder rung naming the shards whose routed
ops were in it. Containment: per-shard quarantine (`failure.
ShardQuarantine`) and the deterministic device-fault seam
(`failure.FaultPlan`).

`make_serving_backend` is the kill-switch seam: `PMDFC_MESH=off` returns
the single-device path (`DirectBackend` over `kv.KV`).

2-D planes (`MeshConfig.replica_axis > 1`, `PMDFC_MESH2D` kill switch):
every mutating phase writes every lane, GETs are hedged replica reads
with per-lane `mesh.replica{r}_served/digest_refused/repaired`
attribution, and `replica_repair()` is what the wire exposes as
`MSG_RREPAIR`. `replica_lanes` is the capability the NetServer advertises
in HOLA, so a host `ReplicaGroup` can delegate its fan-out to the plane.

Device time (`runtime/profiler.py`): each fetched phase is attributed as
`plane.<phase>`, split over the shards by the routed counts as in JAX.
Its `device_us` is the handle's CUDA event window (the first shard's
start event to the last shard's end event, `ShardedKV` records it when
every shard is on one CUDA device); without a pair it is the fetch's
host time, as JAX measures it.
"""

from __future__ import annotations

import time

import numpy as np

from pmdfc_tpu_torch.config import (ContainmentConfig, KVConfig, MeshConfig,
                                    containment_enabled, mesh2d_enabled,
                                    mesh_enabled)
from pmdfc_tpu_torch.parallel.shard import (ShardedKV, _local_devices,
                                            make_mesh, make_mesh2d)
from pmdfc_tpu_torch.runtime import profiler
from pmdfc_tpu_torch.runtime import telemetry as tele
from pmdfc_tpu_torch.runtime.failure import ShardFault, ShardQuarantine
from pmdfc_tpu_torch.utils.keys import INVALID_WORD

_PHASES = ("put", "get", "del", "ins_ext", "get_ext")


class PlaneBackend:
    """Backend surface (`put/get/invalidate/...`) over a `ShardedKV`'s
    plane verbs — what the coalesced `NetServer` fronts in mesh mode. The
    flush loop calls one verb per phase; each verb launches the routed
    per-shard programs and fetches their `PlaneHandle`. `ShardedKV._lock`
    is the single serializer."""

    # the NetServer reads this: routing pads per shard, so the wire
    # tier's global pow2 pad would only inflate the routed width
    routes_per_shard = True

    def __init__(self, skv, containment: ContainmentConfig | None = None,
                 fault_plan=None):
        self.skv = skv
        self.n_shards = skv.n_shards
        # the grid's first device: a serving thread enters it
        # (`runtime/net.py`); each shard's program enters its own
        self.device = skv.device
        cc = (containment if containment is not None
              else ContainmentConfig(enabled=containment_enabled()))
        self.containment = cc
        self.fault_plan = fault_plan
        self.quarantine = (ShardQuarantine(
            skv.n_shards,
            failures_to_open=cc.quarantine_failures,
            cooldown_s=cc.quarantine_cooldown_s,
            max_cooldown_s=cc.quarantine_max_cooldown_s,
            backoff=cc.quarantine_backoff)
            if cc.enabled else None)
        # replica lanes of a 2-D plane (1 = a 1-D plane): the capability
        # the wire tier advertises
        self.replica_lanes = getattr(skv, "n_replicas", 1)
        self.page_words = skv.config.page_words
        # shared process scope: per-shard routed-op counters + per-shard
        # per-phase latency histogram families
        self._tele = tele.scope("mesh", unique=False)
        self._h_phase = {
            ph: self._tele.hist_family(f"phase_{ph}_us", self.n_shards)
            for ph in _PHASES
        }
        self._c_shard = tuple(self._tele.counter(f"shard{i}_ops")
                              for i in range(self.n_shards))
        self._c_lane = tuple(
            (self._tele.counter(f"replica{r}_served"),
             self._tele.counter(f"replica{r}_digest_refused"),
             self._tele.counter(f"replica{r}_repaired"))
            for r in range(self.replica_lanes)
        ) if self.replica_lanes > 1 else ()

    # -- per-shard attribution helpers --

    def _note(self, phase: str, counts, dur_us: float,
              t0_ns: int = 0, t1_ns: int = 0) -> None:
        if counts is None:
            # broadcast phase (extents): every shard ran the program
            counts = np.ones(self.n_shards, np.int64)
        hists = self._h_phase[phase]
        on = tele.enabled()
        for s in np.flatnonzero(np.asarray(counts)):
            s = int(s)
            self._c_shard[s].inc(int(counts[s]))
            if on and s < len(hists):
                hists[s].observe(dur_us)
            if on and t0_ns:
                # one shard-program tree node per involved shard
                sp = tele.span_begin("server", "shard_program",
                                     t0_ns=t0_ns, shard=s, phase=phase,
                                     ops=int(counts[s]))
                tele.span_end(sp, t1_ns=t1_ns or None)

    def _run(self, phase: str, handle):
        """Fetch one launched phase under its telemetry envelope; a
        failure rung names the shards whose routed ops were aboard."""
        prof = profiler.active() if tele.enabled() else None
        t0 = time.perf_counter()
        t0_ns = (time.monotonic_ns()
                 if (tele.enabled() or prof is not None) else 0)
        try:
            out = handle.fetch()
        except Exception as e:  # noqa: BLE001 — attribution, then re-raise
            shards = ([int(s) for s in
                       np.flatnonzero(np.asarray(handle.counts))]
                      if handle.counts is not None
                      else list(range(self.n_shards)))
            tele.rung("phase_failure", tier="mesh", phase=phase,
                      shards=shards, ops=handle.b, error=repr(e))
            raise
        dur_us = (time.perf_counter() - t0) * 1e6
        self._note(phase, handle.counts, dur_us, t0_ns,
                   time.monotonic_ns() if t0_ns else 0)
        ev = handle.events
        if prof is not None:
            # the device window: the handle's event pair when it has one
            # (the copy above waited for the stream), else the fetch's
            # host time; split over the shards by the routed counts
            t_l = handle.t_launch_ns
            prof.note_launch(
                f"plane.{phase}", phase,
                profiler.elapsed_us(ev) if ev is not None else dur_us,
                dispatch_us=(max(0.0, (t0_ns - t_l) / 1e3)
                             if t_l and t0_ns else 0.0),
                n_ops=handle.b, counts=handle.counts,
                n_shards=self.n_shards)
        else:
            profiler.release(ev)
        return out

    # -- containment front door (rung 8) --

    def _contained(self, phase: str, keys: np.ndarray, launch):
        """Run one routed launch through the containment front door: rows
        owned by quarantined shards are masked to INVALID on the host,
        the fault seam (`FaultPlan.check`) runs over what remains, and the
        outcome feeds the shard breakers. `launch(masked_keys) ->
        PlaneHandle`. -> `(out, blocked, shards)`, `blocked` None when
        every row flowed."""
        if self.quarantine is None and self.fault_plan is None:
            return self._run(phase, launch(keys)), None, None
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        shards = self.skv.node_of(keys)
        blocked, probing = (self.quarantine.gate(shards)
                            if self.quarantine is not None
                            else (np.zeros(len(keys), bool), []))
        if blocked.any():
            keys = keys.copy()
            keys[blocked] = INVALID_WORD
        try:
            if self.fault_plan is not None:
                self.fault_plan.check(
                    phase, keys=keys,
                    shards=np.unique(shards[~blocked]))
            out = self._run(phase, launch(keys))
        except ShardFault as e:
            if self.quarantine is not None:
                self.quarantine.note_failure(int(e.shard) % self.n_shards)
            raise
        for s in probing:
            if self.quarantine.note_success(s):
                self._replay_journal(s)
        return out, (blocked if blocked.any() else None), shards

    def _account_blocked(self, blocked: np.ndarray, shards: np.ndarray,
                         gets: bool = False) -> None:
        """Attribute quarantine-masked rows on the OWNING shard's stats
        row: GETs are `miss_quarantined` misses, PUTs acked drops."""
        for s in np.unique(shards[blocked]):
            n = int(np.count_nonzero(blocked & (shards == s)))
            self.skv.account_quarantined(n if gets else 0,
                                         0 if gets else n, shard=int(s))
        self.quarantine.stats.inc(
            "quarantined_gets" if gets else "dropped_puts",
            int(np.count_nonzero(blocked)))

    def _replay_journal(self, shard: int) -> None:
        """Re-admission barrier: replay the invalidations a shard missed
        while quarantined BEFORE it serves again."""
        ks, overflowed = self.quarantine.drain_journal(shard)
        if overflowed:
            tele.rung("shard_quarantine", shard=int(shard),
                      event="journal_overflow", replay=len(ks))
        for lo in range(0, len(ks), 1024):
            try:
                self.skv.plane_delete(ks[lo:lo + 1024]).fetch()
            except Exception:  # noqa: BLE001 — requeue, re-quarantine
                self.quarantine.journal_invalidations(shard, ks[lo:])
                self.quarantine.note_failure(shard)
                return

    # -- Backend surface --

    def put(self, keys: np.ndarray, pages: np.ndarray) -> None:
        _, blocked, shards = self._contained(
            "put", keys, lambda k: self.skv.plane_insert(k, pages))
        if blocked is not None:
            self._account_blocked(blocked, shards, gets=False)

    def _note_lanes(self, res) -> None:
        """Fold one GET phase's per-lane attribution into the
        `mesh.replica{r}_*` families (no-op on 1-D planes)."""
        if not self._c_lane or res.lane_served is None:
            return
        for r, (cs, cr, _) in enumerate(self._c_lane):
            cs.inc(int(res.lane_served[r]))
            cr.inc(int(res.lane_refused[r]))

    def get(self, keys: np.ndarray):
        """(pages[B, W], found[B]) — the portable Backend contract (the
        NetServer's hot path uses `get_fused` and never densifies)."""
        res = self.get_fused(keys)
        return res.dense(), res.found

    def get_fused(self, keys: np.ndarray):
        """`PlaneGets` for the wire tier: request-order found mask +
        per-reply-slice hit-row gathers out of the routed buffer.
        Quarantine-masked rows come back found=False, attributed to
        `miss_quarantined`. ("fused" is the host-side batching fusion:
        one routed phase for the coalesced batch; each shard's GET is the
        fused GET kernel where the config supports it.)"""
        res, blocked, shards = self._contained("get", keys,
                                               self.skv.plane_get)
        if blocked is not None:
            self._account_blocked(blocked, shards, gets=True)
        self._note_lanes(res)
        return res

    def replica_repair(self) -> int:
        """Anti-entropy compare-and-copy over the replica lanes
        (`ShardedKV.replica_repair`); rows repaired land on the per-lane
        `replica{r}_repaired` counters. 0 on 1-D planes."""
        if self.replica_lanes <= 1:
            return 0
        before = self.skv.replica_report()["repaired"]
        total = self.skv.replica_repair()
        after = self.skv.replica_report()["repaired"]
        for r, (_, _, cp) in enumerate(self._c_lane):
            cp.inc(int(after[r]) - int(before[r]))
        return total

    def invalidate(self, keys: np.ndarray) -> np.ndarray:
        out, blocked, shards = self._contained("del", keys,
                                               self.skv.plane_delete)
        if blocked is not None:
            # a quarantined shard must never resurrect a page it was told
            # to forget: journal the blocked invalidations for replay
            kk = np.asarray(keys, np.uint32).reshape(-1, 2)
            for s in np.unique(shards[blocked]):
                self.quarantine.journal_invalidations(
                    int(s), kk[blocked & (shards == s)])
        return out

    def insert_extent(self, key, value, length: int) -> int:
        prof = profiler.active() if tele.enabled() else None
        t0 = time.perf_counter()
        t0_ns = time.monotonic_ns() if tele.enabled() else 0
        _, uncovered = self.skv.insert_extent(key, value, length)
        dur_us = (time.perf_counter() - t0) * 1e6
        self._note("ins_ext", None, dur_us,
                   t0_ns, time.monotonic_ns() if t0_ns else 0)
        if prof is not None:
            # broadcast phase: every shard ran the program — the same
            # ones-vector `_note` uses (a host verb: host time)
            prof.note_launch("plane.ins_ext", "ins_ext", dur_us, n_ops=1,
                             counts=np.ones(self.n_shards, np.int64),
                             n_shards=self.n_shards)
        return uncovered

    def get_extent(self, keys: np.ndarray):
        return self._run("get_ext", self.skv.plane_get_extent(keys))

    def packed_bloom(self) -> np.ndarray | None:
        return self.skv.packed_bloom()

    # -- one-sided fast-path surface: the reader lane reads the per-shard
    # pools through the plane's locked view (the directory's shard column
    # addresses the owning shard) --

    def fast_view(self):
        return self.skv.fast_view()

    def directory_snapshot(self, max_entries: int = 1 << 20):
        return self.skv.directory_snapshot(max_entries=max_entries)

    def bump_dir_epoch(self) -> int:
        return self.skv.bump_dir_epoch()

    # balloon surface (per-shard stepping, the ShardedKV contract)
    def balloon_state(self) -> dict | None:
        return self.skv.balloon_state()

    def balloon_grow(self, rows: int) -> bool:
        return self.skv.balloon_grow(rows)

    def balloon_shrink(self, rows: int) -> bool:
        return self.skv.balloon_shrink(rows)

    # admission surface
    def admit_state(self) -> dict | None:
        return self.skv.admit_state()

    def set_admit_threshold(self, value: int) -> bool:
        return self.skv.set_admit_threshold(value)

    # host-overlay miss-cause accounting (ops the NetServer answered
    # without a device op: QoS sheds, deadline sheds)
    def account_shed(self, gets: int, puts: int = 0) -> None:
        self.skv.account_shed(gets, puts)

    def account_deadline(self, gets: int, puts: int = 0) -> None:
        self.skv.account_deadline(gets, puts)

    def account_quarantined(self, gets: int, puts: int = 0,
                            shard: int = 0) -> None:
        self.skv.account_quarantined(gets, puts, shard=shard)

    def stats(self) -> dict:
        """Summed KV counters plus the per-shard report — the MSG_STATS
        payload, so one wire pull shows key-space skew per shard."""
        out = dict(self.skv.stats())
        out["capacity"] = self.skv.capacity()
        out["shard_report"] = self.skv.shard_report()
        if self.quarantine is not None:
            out["quarantine"] = self.quarantine.report()
        rep = self.skv.replica_report()
        if rep is not None:
            out["replica"] = rep
        return out

    def warmup(self, max_width: int, kinds=("put", "get", "del")) -> int:
        return warm_plane(self.skv, max_width, kinds)

    def shard_report(self) -> dict:
        return self.skv.shard_report()


def warm_plane(skv, max_width: int, kinds=("put", "get", "del")) -> int:
    """Run a plane's per-shard pow2 ladder up to `max_width` PER SHARD with
    all-INVALID batches (the real programs, the GET kernel among them;
    they match nothing, place nothing, count nothing). Shared by
    `PlaneBackend.warmup` and `KVServer.warmup`. -> programs run.

    w-row batches, not w*n_shards: identical INVALID keys all hash to ONE
    shard, so a w-row batch is exactly one rung of the per-shard ladder."""
    vw = skv.config.page_words if skv.config.paged else 2
    w = skv._router.pad_floor
    n = 0
    while w <= max_width:
        keys = np.full((w, 2), INVALID_WORD, np.uint32)
        if "put" in kinds:
            skv.plane_insert(keys, np.zeros((w, vw), np.uint32)).fetch()
            n += 1
        if "del" in kinds:
            skv.plane_delete(keys).fetch()
            n += 1
        if "get" in kinds:
            # BOTH GET programs (read-only + counting) per rung
            skv.plane_warm_get(keys)
            n += 1
        w <<= 1
    return n


def build_plane_kv(config: KVConfig, mesh=None,
                   knobs: MeshConfig | None = None):
    """Resolve one mesh request into a `ShardedKV` — the resolution rule
    both serving drivers share (`make_serving_backend` and
    `KVServer(mesh=...)`).

    `mesh` may be a `MeshConfig`, a grid (`shard.Mesh`), an int shard
    count, True (every local GPU), or None (= `MeshConfig()` defaults);
    `knobs` supplies pad_floor/dispatch when `mesh` is a bare grid. An
    int count takes that many DISTINCT local GPUs (a grid that repeats a
    device is built from an explicit device list). `replica_axis > 1`
    builds the 2-D grid unless `PMDFC_MESH2D=off` forces one lane.
    Returns None when `PMDFC_MESH=off`."""
    if not mesh_enabled():
        return None
    mc = (knobs if knobs is not None
          else mesh if isinstance(mesh, MeshConfig) else MeshConfig())
    rep = mc.replica_axis if mesh2d_enabled() else 1
    if mesh is None or isinstance(mesh, MeshConfig):
        mesh = mc.n_shards if mc.n_shards is not None else True
    if mesh is True:
        devs = _local_devices()
        if rep > 1:
            if len(devs) // rep < 1:
                raise ValueError(
                    f"replica_axis={rep} exceeds the {len(devs)} "
                    "available devices")
            mesh = make_mesh2d(len(devs) // rep, rep,
                               devs[:len(devs) // rep * rep])
        else:
            mesh = make_mesh(devs)
    elif isinstance(mesh, int) and not isinstance(mesh, bool):
        devs = _local_devices()
        if mesh * rep > len(devs):
            raise ValueError(
                f"mesh n_shards={mesh} x replica_axis={rep} exceeds "
                f"the {len(devs)} available devices")
        mesh = (make_mesh2d(mesh, rep, devs[:mesh * rep])
                if rep > 1 else make_mesh(devs[:mesh]))
    return ShardedKV(config, mesh=mesh, dispatch=mc.dispatch,
                     plane_pad_floor=mc.pad_floor)


def make_serving_backend(config: KVConfig | None = None,
                         mesh_config: MeshConfig | None = None,
                         mesh=None,
                         containment: ContainmentConfig | None = None,
                         fault_plan=None, device="cuda"):
    """The serving plane's kill-switch seam.

    Mesh path (default): a `ShardedKV` over `mesh` (or a grid of
    `mesh_config.n_shards` local GPUs) behind a `PlaneBackend`.
    `PMDFC_MESH=off` falls back to the single-device serving path
    (`DirectBackend` over `kv.KV` on `device`)."""
    config = config or KVConfig()
    skv = build_plane_kv(
        config, mesh if mesh is not None else mesh_config,
        knobs=mesh_config)
    if skv is None:
        from pmdfc_tpu_torch.client.backends import DirectBackend
        from pmdfc_tpu_torch.kv import KV

        return DirectBackend(KV(config, device=device))
    return PlaneBackend(skv, containment=containment,
                        fault_plan=fault_plan)
