"""Typed configuration (twin of `pmdfc_tpu/config.py`, this slice's part).

The same frozen dataclasses with the same fields and defaults, so one
configuration reads the same in both packages. The environment
switches are the JAX package's, with the same env names and defaults:
`PMDFC_TIER` and `PMDFC_ADMIT` add or strip the tiered store and its
admission gate when `kv.init` builds a state (`kv._tier_cfg_at_init`;
after that the state's pool decides), and the serving plane's
`PMDFC_QOS`, `PMDFC_NET_PIPE`, `PMDFC_FASTPATH`, `PMDFC_RING`,
`PMDFC_MESH`, `PMDFC_MESH2D`, `PMDFC_PROF`, `PMDFC_TELEMETRY`,
`PMDFC_SAN`, `PMDFC_CONTAINMENT` and `PMDFC_AUTOTUNE`. One difference:
there is no `fused_get` switch: on CUDA a configuration that
`ops.fused.supports` accepts always runs the fused GET kernel, and one
it rejects runs the composed GET, as the JAX package composes it.
"""

from __future__ import annotations

import dataclasses
import enum
import os


class IndexKind(str, enum.Enum):
    """Pluggable index selection (ref `server/KV.cpp:63-79` -D matrix);
    all nine families are ported (`models.base.get_index_ops`)."""

    LINEAR = "linear"          # linear probing w/ FIFO cluster eviction (default)
    CCEH = "cceh"              # cacheline-conscious extendible hashing
    CUCKOO = "cuckoo"          # 2-hash cuckoo w/ path search
    CUCKOO_PROBING = "ccp"     # linear probing + second-chance cuckoo
    LEVEL = "level"            # two-level hashing
    PATH = "path"              # path hashing (binary-tree fallback cells)
    EXTENDIBLE = "extendible"  # classic LSB extendible hashing
    STATIC = "static"          # single fixed array
    HOTRING = "hotring"        # hotspot-aware ordered ring


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Shape/behavior of one index instance; `capacity` is the total
    number of (key, value) slots (ref `tablesize`,
    `server/rdma_svr.cpp:1272`). Field meanings as in the JAX package."""

    kind: IndexKind = IndexKind.LINEAR
    capacity: int = 1 << 16
    cluster_slots: int = 32
    segment_slots: int = 1024
    probe_window: int = 32
    split_headroom: int = 1
    max_splits_per_round: int = 64
    max_cuckoo_kicks: int = 8
    decay_every_gets: int = 1 << 20
    touch_sample_every: int = 1
    hot_lanes: int = 8

    def __post_init__(self) -> None:
        if self.capacity <= 0:
            raise ValueError("capacity must be positive")
        if self.cluster_slots & (self.cluster_slots - 1):
            raise ValueError("cluster_slots must be a power of two")
        if self.segment_slots & (self.segment_slots - 1):
            raise ValueError("segment_slots must be a power of two")
        if self.hot_lanes < 1:
            raise ValueError("hot_lanes must be >= 1 (the mirror cannot be "
                             "empty; shrink it rather than disabling)")


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    """Counting bloom filter (ref `server/rdma_svr.h:36-38`)."""

    num_bits: int = 1 << 20
    num_hashes: int = 4

    def __post_init__(self) -> None:
        if self.num_bits % 32:
            raise ValueError("num_bits must be a multiple of 32 (packed export)")


@dataclasses.dataclass(frozen=True)
class AdmitConfig:
    """TinyLFU-style admission gate on the tiered store's hot boundary
    (`tier.py`): a count-min frequency sketch with periodic halving plus
    a doorkeeper bloom, consulted by the promotion path. Attach via
    `TierConfig(admit=AdmitConfig(...))`."""

    # count-min width: counters per hash row (2 rows; estimate = min over
    # rows + the doorkeeper bit)
    sketch_width: int = 1 << 14
    # doorkeeper bloom bits: a key's first touch of an epoch sets them,
    # only already-doorkept touches count into the CM rows
    door_bits: int = 1 << 15
    # observed touches per aging epoch: then every CM counter halves and
    # the doorkeeper clears
    reset_ops: int = 1 << 14
    # least sketch estimate for a non-ghost candidate to get a hot slot
    # (live-settable: `KV.set_admit_threshold`)
    threshold: int = 2

    def __post_init__(self) -> None:
        if self.sketch_width < 64:
            raise ValueError("sketch_width must be >= 64")
        if self.door_bits < 64:
            raise ValueError("door_bits must be >= 64")
        if self.reset_ops < 1:
            raise ValueError("reset_ops must be >= 1")
        if self.threshold < 0:
            raise ValueError("threshold must be >= 0")


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Tiered page store (`tier.py`): hot/cold pools with LRFU-driven
    migration and dynamic cold-capacity ballooning. Attach via
    `KVConfig(tier=TierConfig(...))`."""

    # hot rows = index slots // hot_fraction (at least 16)
    hot_fraction: int = 8
    # cold GETs (counted on the row) before promotion; a ghost-ring hit
    # readmits on the first touch
    promote_touches: int = 2
    ghost_rows: int = 256
    # bound on migrations per GET batch
    max_promotes_per_batch: int = 64
    # hot-tier victim policy (lru | lfu | fifo); victims are min-metric rows
    hot_policy: str = "lru"
    # ballooning moves cold circulation in steps of this many rows
    balloon_step: int = 1024
    # initial circulating cold rows (None = fully materialized)
    cold_init_rows: int | None = None
    # grow when free cold rows would drop below this after a batch
    grow_free_rows: int = 64
    # auto-park a step when free cold rows exceed this (0 = disabled)
    shrink_free_rows: int = 0
    # TinyLFU admission gate on the hot boundary (None = no gate)
    admit: AdmitConfig | None = None

    def __post_init__(self) -> None:
        if self.hot_fraction < 2:
            raise ValueError("hot_fraction must be >= 2 (the hot tier "
                             "must be a strict minority of capacity)")
        if self.promote_touches < 1:
            raise ValueError("promote_touches must be >= 1")
        if self.ghost_rows < 1:
            raise ValueError("ghost_rows must be >= 1")
        if self.max_promotes_per_batch < 1:
            raise ValueError("max_promotes_per_batch must be >= 1")
        if self.balloon_step < 1:
            raise ValueError("balloon_step must be >= 1")
        if self.hot_policy not in ("lru", "lfu", "fifo"):
            raise ValueError(f"unknown hot_policy {self.hot_policy!r}")


@dataclasses.dataclass(frozen=True)
class KVConfig:
    """KV façade configuration (ref `server/KV.h` + `rdma_svr.cpp` getopt)."""

    index: IndexConfig = dataclasses.field(default_factory=IndexConfig)
    bloom: BloomConfig | None = dataclasses.field(default_factory=BloomConfig)
    # 4 KB pages stored as rows of u32 words (4096 / 4 = 1024).
    page_words: int = 1024
    # Store pages in a device page pool tied 1:1 to index slots; when False
    # the index stores caller-provided 64-bit values only.
    paged: bool = True
    # Extent-record ring size, the most covers one extent inserts, and the
    # probe heights of GetExtent (covers are at most 2**(height-1) pages).
    extent_capacity: int = 1024
    extent_max_covers: int = 64
    extent_max_height: int = 30
    # Tiered page store (hot/cold pools over one backing array); None =
    # the flat pool.
    tier: TierConfig | None = None
    # Bits of the evicted-key sketch that splits GET misses into
    # `miss_evicted` vs `miss_cold`.
    evicted_sketch_bits: int = 1 << 16

    def __post_init__(self) -> None:
        if self.evicted_sketch_bits < 64:
            raise ValueError("evicted_sketch_bits must be >= 64")


# ---------------------------------------------------------------------------
# the serving plane's switches and configs (`runtime/`)
# ---------------------------------------------------------------------------

def ring_enabled(default: bool = True) -> bool:
    """Resolve the `PMDFC_RING` kill switch for the consistent-hash
    placement ring (`cluster/ring.py`): `off` forces `ReplicaGroup` back
    to the static murmur key→replica-set map — verb-for-verb identical
    to the pre-ring tree (the conformance escape hatch; membership is
    then immutable and the elastic wire capability is never requested
    or acked). Resolved at construction time, like `PMDFC_NET_PIPE` — a
    group never changes placement discipline mid-life."""
    v = os.environ.get("PMDFC_RING", "").strip().lower()
    if v in ("off", "0", "false", "no"):
        return False
    if v in ("on", "1", "true", "yes"):
        return True
    return default


@dataclasses.dataclass(frozen=True)
class RingConfig:
    """Consistent-hash placement ring + live migration
    (`cluster/ring.py` / `cluster/migrate.py`).

    Each member owns `vnodes` virtual points on a u64 ring; a key's
    replica set is the first `rf` DISTINCT members clockwise from its
    hashed position, so a single join/leave moves only ~1/N of the key
    space (± vnode variance). Migration streams the moved key ranges to
    their new owners through the digest-verified repair path, bounded
    by a token bucket (`migrate_pages_per_s`, burst `migrate_burst`) in
    batches of `migrate_batch` pages per owner per tick.
    """

    enabled: bool = True
    vnodes: int = 64
    # ring placement seed — salted away from the bloom/index/replica-map
    # seeds so ring positions stay independent of every other hash
    seed: int = 0x51C0_C0DE
    # live migration: pages per rate-bucket second (0 = unbounded), the
    # bucket's burst allowance, pages per owner per tick, and how many
    # all-sources-failed retries a key gets before it is dropped to a
    # legal miss (the next put re-places it)
    migrate_pages_per_s: float = 16384.0
    migrate_burst: int = 1024
    migrate_batch: int = 128
    migrate_retries: int = 3

    def __post_init__(self) -> None:
        if self.vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        if self.migrate_pages_per_s < 0:
            raise ValueError("migrate_pages_per_s must be >= 0 "
                             "(0 = unbounded)")
        if self.migrate_burst < 1:
            raise ValueError("migrate_burst must be >= 1")
        if self.migrate_batch < 1:
            raise ValueError("migrate_batch must be >= 1")
        if self.migrate_retries < 0:
            raise ValueError("migrate_retries must be >= 0")


@dataclasses.dataclass(frozen=True)
class ReplicaConfig:
    """Replicated remote-memory group (`client/replica.py` `ReplicaGroup`).

    Fronts `n_replicas` independent servers; every key maps to a stable
    `rf`-member replica set. GETs are primary-first with a hedged second
    request after `hedge_ms`; every endpoint sits behind a circuit
    breaker (`runtime/failure.py` `CircuitBreaker`) so a sick server is
    routed around without per-op penalty; a rejoined replica is refilled
    by bloom-guided anti-entropy repair at a bounded rate.
    """

    n_replicas: int = 3
    # replication factor: PUT fan-out width / GET failover depth
    rf: int = 2
    # hedged GET: fire a second request at the next live replica when the
    # primary hasn't answered within this deadline (0 disables hedging)
    hedge_ms: float = 50.0
    # breaker: consecutive op failures (timeouts, bad frames, digest
    # mismatches) before the endpoint opens
    breaker_failures: int = 3
    # breaker cooldown before a half-open probe, widened by
    # `breaker_backoff` (capped) on every failed probe, jittered so
    # same-instant openings desynchronize
    breaker_cooldown_s: float = 0.5
    breaker_max_cooldown_s: float = 10.0
    breaker_backoff: float = 2.0
    breaker_jitter: float = 0.25
    half_open_probes: int = 1
    # anti-entropy repair: tick cadence (0 disables the background
    # thread; `ReplicaGroup.repair_tick()` still drives it manually) and
    # max pages re-replicated per endpoint per tick (the rate bound)
    repair_interval_s: float = 0.2
    repair_batch: int = 64
    # bounded FIFO of recently-put keys — the repair candidate universe
    put_journal_cap: int = 1 << 16
    # hash count of the SERVERS' bloom filters — MUST equal the servers'
    # BloomConfig.num_hashes (both default 4): repair queries pulled
    # packed mirrors host-side, and a mismatched hash count makes absent
    # keys read "present", silently skipping their repair. When unsure
    # (heterogeneous servers, tuned filters), set None to disable bloom
    # guiding — repair then re-replicates every candidate, which is
    # idempotent and safe, just more traffic.
    bloom_hashes: int | None = 4
    # bounded group-wide digest map (end-to-end verification, FIFO)
    digest_cap: int = 1 << 20
    # consistent-hash placement ring + live migration (None = defaults).
    # `PMDFC_RING=off` (env wins) or `RingConfig(enabled=False)` falls
    # back to the static murmur map — membership is then immutable.
    ring: "RingConfig | None" = None
    # breaker-driven auto-replacement (needs the ring AND a
    # `spare_factory` passed to ReplicaGroup): a member whose breaker
    # has been latched out of CLOSED for this long is replaced with a
    # freshly built spare on the repair cadence — the ring's replace()
    # path under REAL failure, not just drills. 0 disables.
    auto_replace_after_s: float = 0.0
    # device-side replica plane delegation: when an endpoint advertises
    # `replica_lanes >= rf` (a 2-D serving mesh behind it, negotiated
    # via the wire REPLICA_FLAG), a key's host fan-out collapses to its
    # primary member — replication then happens in ONE device launch
    # server-side instead of rf TCP round trips. False keeps the host
    # loops even against fused servers.
    fused_plane: bool = True
    # fused endpoints get a device-side anti-entropy pass (MSG_RREPAIR,
    # the compare-and-copy collective) every this-many repair ticks on
    # the shared repair cadence (0 disables)
    device_repair_ticks: int = 50
    # end-to-end GET budget: once this many milliseconds have elapsed
    # inside one group GET, no further failover round fires — the
    # remaining keys take the legal miss instead of retrying dead work
    # past the point where the caller has stopped waiting. Stamped into
    # the wire frame too (containment-negotiated endpoints shed
    # already-expired staged ops server-side). 0 disables.
    deadline_ms: float = 0.0

    def __post_init__(self) -> None:
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.auto_replace_after_s < 0:
            raise ValueError("auto_replace_after_s must be >= 0 "
                             "(0 = disabled)")
        if self.device_repair_ticks < 0:
            raise ValueError("device_repair_ticks must be >= 0 "
                             "(0 = disabled)")
        if not (1 <= self.rf <= self.n_replicas):
            raise ValueError("rf must be in [1, n_replicas]")
        if self.hedge_ms < 0:
            raise ValueError("hedge_ms must be >= 0")
        if self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0 (0 = disabled)")
        if self.breaker_failures < 1:
            raise ValueError("breaker_failures must be >= 1")
        if self.half_open_probes < 1:
            raise ValueError("half_open_probes must be >= 1")
        if self.repair_batch < 1:
            raise ValueError("repair_batch must be >= 1")
        if self.bloom_hashes is not None and self.bloom_hashes < 1:
            raise ValueError("bloom_hashes must be >= 1 or None "
                             "(None disables bloom-guided repair)")


@dataclasses.dataclass(frozen=True)
class JournalConfig:
    """Write-ahead journal (`runtime/journal.py`): bounded-RPO durability.

    Every mutation appends a CRC-framed record BEFORE the device flush
    acknowledges; fsync is batched so at most `rpo_ops` acknowledged
    operations or `rpo_ms` milliseconds of them can be lost to a
    `kill -9` (the RPO bound the recovery drills assert against).
    Segments rotate at `segment_bytes`; replay is idempotent under the
    cold-tier generation tags, so replaying a tail twice equals once.
    """

    # fsync after this many appended records ... (ops bound of the RPO)
    rpo_ops: int = 256
    # ... or once the oldest unsynced record is this old (time bound).
    rpo_ms: float = 50.0
    # rotate to a fresh segment file past this many bytes
    segment_bytes: int = 64 << 20
    # sync opportunistically on every append's bound check; False =
    # caller drives `Journal.sync()` (tests, single-threaded drills)
    auto_sync: bool = True

    def __post_init__(self) -> None:
        if self.rpo_ops < 1:
            raise ValueError("rpo_ops must be >= 1")
        if self.rpo_ms < 0:
            raise ValueError("rpo_ms must be >= 0")
        if self.segment_bytes < 4096:
            raise ValueError("segment_bytes must be >= 4096")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Request coalescer (ref batching: BATCH_SIZE 4 pages/verb, 8 queues,
    4 clients, `server/rdma_svr.h:16-19`). device batches are much deeper."""

    batch_size: int = 1024
    num_queues: int = 8
    # Adaptive flush: ship a partial batch after this many microseconds.
    batch_timeout_us: int = 200


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Unified telemetry layer (`runtime/telemetry.py`): process-wide
    metrics registry + per-op trace spans + degradation flight recorder.

    `enabled=False` (or `PMDFC_TELEMETRY=off`, which wins over code) turns
    the TRACING tier — span records, latency histograms, the event ring,
    and flight-recorder dumps — into no-ops. Plain counters/gauges keep
    counting either way: the `stats()` surfaces across the repo are
    registry-backed and must stay correct even with tracing killed.
    """

    enabled: bool = True
    # bounded ring of recent span/event records (the flight recorder's
    # working set; a dump captures its tail)
    ring_capacity: int = 4096
    # directory for rung-triggered JSON dumps. None (the default) keeps
    # the recorder ring-only — library code must not write files unless
    # asked. `PMDFC_TELEMETRY_DIR` supplies it from the environment.
    dump_dir: str | None = None
    # per-rung dump cooldown: a rung firing in a tight loop (every GET
    # against a downed replica set) must not write a dump per op
    dump_min_interval_s: float = 1.0
    # span/event records included in each dump (the ring tail)
    dump_records: int = 512
    # retained `flight_*.json` cap in dump_dir (oldest-first deletion;
    # 0 = unlimited). The cooldown limits write RATE; this bounds file
    # COUNT so a rung firing across a long soak can't fill the disk.
    dump_max_files: int = 64

    def __post_init__(self) -> None:
        if self.ring_capacity < 1:
            raise ValueError("ring_capacity must be >= 1")
        if self.dump_min_interval_s < 0:
            raise ValueError("dump_min_interval_s must be >= 0")
        if self.dump_records < 1:
            raise ValueError("dump_records must be >= 1")
        if self.dump_max_files < 0:
            raise ValueError("dump_max_files must be >= 0 (0 = unlimited)")


@dataclasses.dataclass(frozen=True)
class ProfilerConfig:
    """Device-time X-ray (`runtime/profiler.py`): per-program on-chip
    cost attribution threaded through the async-fetch seams.

    The profiler is OPT-IN (`PMDFC_PROF=on` or an explicit
    `profiler.install()`): with it off nothing attaches to the registry
    and telemetry snapshots stay byte-identical to the v2 schema. When
    attached it rides the TRACING tier — `PMDFC_TELEMETRY=off` silences
    the device lanes too, so the overhead story has exactly two states.
    """

    enabled: bool = True
    # launches accumulated per `shard_imbalance` gauge window (max/mean
    # device time across shards, recomputed every `imbalance_window`
    # attributed launches)
    imbalance_window: int = 8
    # set `cost.<program>.{flops,bytes}` at the first call of each
    # (program, padded width): the fused GET's own byte count at that
    # width (`ops.fused.fused_get_bytes`), FLOPs 0 (integer work);
    # programs without a byte count set no gauge
    cost_capture: bool = True
    # MSG_PROFILE bounded-trace discipline: duration cap, cooldown
    # between captures, and retained `prof_*` capture-dir count under
    # the flight recorder's dump dir (oldest-first deletion, like
    # `dump_max_files`)
    trace_max_ms: int = 2000
    trace_min_interval_s: float = 5.0
    trace_max_files: int = 8
    # phase x program x shard attribution rows retained (new keys past
    # the cap are dropped and counted, never grown unbounded)
    table_max_rows: int = 512

    def __post_init__(self) -> None:
        if self.imbalance_window < 1:
            raise ValueError("imbalance_window must be >= 1")
        if self.trace_max_ms < 1:
            raise ValueError("trace_max_ms must be >= 1")
        if self.trace_min_interval_s < 0:
            raise ValueError("trace_min_interval_s must be >= 0")
        if self.trace_max_files < 0:
            raise ValueError("trace_max_files must be >= 0 (0 = unlimited)")
        if self.table_max_rows < 1:
            raise ValueError("table_max_rows must be >= 1")


def profiler_enabled(default: bool = False) -> bool:
    """Resolve the `PMDFC_PROF` opt-in: `on` attaches the device-time
    profiler to the telemetry registry at the first instrumented fetch,
    `off` keeps every seam a plain passthrough (and snapshots
    byte-identical v2), and an unset/unknown value falls through to
    `default` (off — the X-ray is an opt-in diagnostic tier)."""
    v = os.environ.get("PMDFC_PROF", "").strip().lower()
    if v in ("off", "0", "false", "no"):
        return False
    if v in ("on", "1", "true", "yes"):
        return True
    return default


def telemetry_enabled(default: bool = True) -> bool:
    """Resolve the `PMDFC_TELEMETRY` kill switch: `off` disables the
    tracing tier (spans, histograms, ring, dumps), `on` forces it, and an
    unset/unknown value falls through to `default`."""
    v = os.environ.get("PMDFC_TELEMETRY", "").strip().lower()
    if v in ("off", "0", "false", "no"):
        return False
    if v in ("on", "1", "true", "yes"):
        return True
    return default


def sanitizer_enabled(default: bool = False) -> bool:
    """Resolve the `PMDFC_SAN` opt-in: `on`/`strict` swap the serving
    plane's locks for the instrumented wrappers
    (`runtime/sanitizer.py`), anything else falls through to `default`
    (plain `threading` primitives, zero overhead). Resolved at lock
    CONSTRUCTION time — flipping the env mid-process only affects
    instances built afterwards."""
    v = os.environ.get("PMDFC_SAN", "").strip().lower()
    if v in ("on", "1", "true", "yes", "strict"):
        return True
    if v in ("off", "0", "false", "no"):
        return False
    return default


def sanitizer_strict(default: bool = False) -> bool:
    """`PMDFC_SAN=strict`: on top of `on`, an atexit check fails the
    process (exit 70) if any violation was recorded — the form the
    agenda's sanitizer-enabled soak steps run under."""
    return os.environ.get("PMDFC_SAN", "").strip().lower() == "strict" \
        or default


def mesh_enabled(default: bool = True) -> bool:
    """Resolve the `PMDFC_MESH` kill switch: `off` forces the serving
    plane back to the single-device path (`DirectBackend` over `kv.KV`,
    the conformance escape hatch), `on` forces the sharded plane, and an
    unset/unknown value falls through to `default`. Resolved at
    construction time: a serving plane never changes topology mid-life."""
    v = os.environ.get("PMDFC_MESH", "").strip().lower()
    if v in ("off", "0", "false", "no"):
        return False
    if v in ("on", "1", "true", "yes"):
        return True
    return default


def mesh2d_enabled(default: bool = True) -> bool:
    """Resolve the `PMDFC_MESH2D` kill switch for the 2-D serving mesh
    (replica lanes fused into the plane, `parallel/shard.py`): `off`
    forces `MeshConfig.replica_axis` back to 1 — a 1-D mesh, the host
    `ReplicaGroup` replication path, zero 2-D programs launched (the
    conformance escape hatch `tests/test_mesh2d.py` pins) — and the
    wire tier neither requests nor acks the replica capability. `on`
    forces nothing by itself (`replica_axis` still picks the lane
    count). Resolved at construction time, like `PMDFC_MESH`."""
    v = os.environ.get("PMDFC_MESH2D", "").strip().lower()
    if v in ("off", "0", "false", "no"):
        return False
    if v in ("on", "1", "true", "yes"):
        return True
    return default


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sharded serving plane (`parallel/plane.py`): the partitioned KV
    behind the coalesced NetServer.

    `n_shards` picks how many devices the plane spans along the `kv`
    axis (None = every local device); per-shard table capacity is
    `KVConfig.index.capacity` (total capacity scales with the shard
    count, the `ShardedKV` convention). Request batches are routed on the
    host by `partitioning.ShardRouter` and each phase pads PER SHARD up
    the pow2 ladder from `pad_floor`, so a skewed flush pays only its own
    shard's pad waste.

    `replica_axis` > 1 makes the grid 2-D (`kv` x `replica`): every
    shard's state is replicated across that many lanes, PUT/DELETE/INSEXT
    write every lane in one call, GETs are hedged replica reads (the
    first digest-validated lane wins), and anti-entropy repair is a
    compare-and-copy over the lanes. Needs `n_shards * replica_axis`
    devices. `PMDFC_MESH2D=off` forces the lane count back to 1 (see
    `mesh2d_enabled`).

    `PMDFC_MESH=off` overrides everything back to the single-device
    serving path (see `mesh_enabled`)."""

    n_shards: int | None = None
    pad_floor: int = 8
    # dispatch mode of the non-plane host verbs (insert/get/delete):
    # a2a|broadcast
    dispatch: str = "a2a"
    # replica lanes along the second grid axis (1 = a 1-D grid)
    replica_axis: int = 1

    def __post_init__(self) -> None:
        if self.n_shards is not None and self.n_shards < 1:
            raise ValueError("n_shards must be >= 1 (or None = all)")
        if self.pad_floor < 1 or (self.pad_floor & (self.pad_floor - 1)):
            raise ValueError("pad_floor must be a positive power of two")
        if self.dispatch not in ("a2a", "broadcast"):
            raise ValueError(f"unknown dispatch {self.dispatch!r}")
        if self.replica_axis < 1:
            raise ValueError("replica_axis must be >= 1")


def autotune_enabled(default: bool = True) -> bool:
    """Resolve the `PMDFC_AUTOTUNE` kill switch for the closed-loop
    serving controller (`runtime/autotune.py`): `off` makes a
    constructed `AutotuneController` inert — no `ctl` telemetry scope,
    no decisions, every knob stays at its hand-tuned config value (the
    conformance contract `tests/test_autotune.py` pins, including the
    Migrator's static `migrate_pages_per_s` rate bound). Resolved at
    construction time, like every other switch — a controller never
    changes discipline mid-life; env wins over code."""
    v = os.environ.get("PMDFC_AUTOTUNE", "").strip().lower()
    if v in ("off", "0", "false", "no"):
        return False
    if v in ("on", "1", "true", "yes"):
        return True
    return default


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """Closed-loop serving controller (`runtime/autotune.py`): online
    AIMD-style adaptation of the live serving knobs — NetServer flush
    dwell + settle cutoff, TcpBackend pipeline window, ReplicaGroup
    hedge deadline, KV balloon stepping, Migrator rate bound — from the
    windowed series, with the SLO watchdog as safety governor.

    Every knob walk is clamped to the per-knob hard bounds declared
    here (the ENVELOPE): the controller can only move inside it, so the
    worst case is the hand-tuned default it started from. A governor
    event (SLO breach, sensor starvation) freezes the controller for
    `freeze_windows` evaluated rounds and reverts every knob to the
    last-known-good point. `PMDFC_AUTOTUNE=off` (env wins) makes a
    constructed controller fully inert.

    UNIT NOTE: every `*_windows` count here (hysteresis, starvation,
    freeze) is measured in EVALUATED ROUNDS — one `tick()` that
    consumed at least one new series window. A daemon ticking slower
    than the collector aggregates several series windows into one
    round; counting some thresholds in ticks and others in raw windows
    would make operator-tuned durations depend on the
    `interval_s`-to-collector-cadence ratio."""

    enabled: bool = True
    # daemon tick cadence (deterministic `tick()` ignores it)
    interval_s: float = 0.5
    # AIMD step discipline: additive-ish increase (step = max(unit,
    # cur * up_frac)), multiplicative decrease (cur * down_frac), a
    # deadband for target-tracking knobs (hedge), and hysteresis — a
    # knob moves only after this many CONSECUTIVE evaluated rounds
    # proposing the same direction (see the unit note above)
    up_frac: float = 0.25
    down_frac: float = 0.5
    deadband: float = 0.15
    hysteresis_windows: int = 2
    # governor: evaluated rounds held frozen after a revert; consecutive
    # zero-traffic rounds before the controller retreats to
    # last-known-good (no evidence = no authority to hold a tuned point)
    freeze_windows: int = 10
    starve_windows: int = 5
    # -- per-knob hard bounds (the walk envelope) --
    dwell_us_lo: float = 100.0
    dwell_us_hi: float = 20000.0
    # floor matches the flush loop's own settle clamp (`_flush_loop`
    # holds settle_s at >= 1e-4 s): a lower bound would let the
    # controller record decisions/gauges in a dead zone the loop
    # never acts on
    settle_us_lo: float = 100.0
    settle_us_hi: float = 2000.0
    window_lo: int = 4
    window_hi: int = 256
    hedge_ms_lo: float = 1.0
    hedge_ms_hi: float = 500.0
    migrate_pps_lo: float = 256.0
    migrate_pps_hi: float = 1048576.0
    # balloon stepping: net extents the controller may move from its
    # starting circulation (each step is one TierConfig.balloon_step of
    # rows), and the tick cadence of balloon decisions (each decision
    # polls backend stats = a device sync; never per controller tick)
    balloon_max_extents: int = 8
    balloon_every: int = 4
    # admission-threshold walk envelope (`AdmitConfig.threshold`, bound
    # when the serving backend exposes an admission gate); walked on the
    # balloon cadence — its sensors ride the same backend stats poll
    admit_lo: float = 1.0
    admit_hi: float = 64.0
    # -- sensor thresholds --
    # mean coalesced batch at/below this = dwell is pure latency tax
    light_batch: float = 2.0
    # staging-queue depth at/above this = fan-in pressure (fuse harder)
    deep_staging: int = 64
    # pipeline-window occupancy fractions: p95 above hi = widen, below
    # lo (with a calm staging queue) = narrow
    occ_hi_frac: float = 0.75
    occ_lo_frac: float = 0.25
    # hedge deadline tracks this multiple of the windowed wire GET p99
    hedge_p99_mult: float = 3.0
    # queue-wait p99 at/below this = serving is healthy enough to let
    # migration move faster; above = migration yields
    qwait_healthy_us: float = 5000.0
    # windowed (miss_evicted + miss_parked) / gets above this = capacity
    # pressure, balloon grows; window working-set below wset_shrink_frac
    # of capacity with zero pressure = balloon parks a step
    miss_pressure: float = 0.02
    wset_shrink_frac: float = 0.25
    # admission sensors (hot-tier hit-rate vs ghost-readmit rate, off
    # the same stats-delta series the balloon rule reads):
    # ghost_readmits/gets at/above this = the gate is TOO STRICT — the
    # ghost ring is doing the admissions the sketch refused — threshold
    # walks DOWN; demotions/gets at/above admit_churn_hi while the
    # ghost rate stays below half the strict mark = scan churn is
    # leaking through the gate — threshold walks UP
    admit_ghost_hi: float = 0.01
    admit_churn_hi: float = 0.02
    # per-tenant QoS rate knobs (`bind_qos`): fallback walk envelope for
    # a tenant that declares a rate but no explicit bounds —
    # [rate * qos_rate_lo_frac, rate * qos_rate_hi_frac] around the
    # declared `TenantConfig.rate_ops_per_s` (rate-0 tenants are never
    # bound: unlimited is operator intent, the Migrator precedent)
    qos_rate_lo_frac: float = 0.25
    qos_rate_hi_frac: float = 4.0
    # qos sensor: windowed per-tenant shed fraction (sheds/ops) at/above
    # this while the staging queue stays calm (< deep_staging) = the
    # bucket is stricter than the server needs — rate walks UP; staging
    # at/above deep_staging with the tenant still shedding = the fleet
    # is the bottleneck, not the bucket — rate walks DOWN
    qos_shed_hi: float = 0.05

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if not (0 < self.up_frac <= 1):
            raise ValueError("up_frac must be in (0, 1]")
        if not (0 < self.down_frac < 1):
            raise ValueError("down_frac must be in (0, 1)")
        if self.hysteresis_windows < 1:
            raise ValueError("hysteresis_windows must be >= 1")
        if self.freeze_windows < 1:
            raise ValueError("freeze_windows must be >= 1")
        if self.starve_windows < 1:
            raise ValueError("starve_windows must be >= 1")
        if self.balloon_max_extents < 0:
            raise ValueError("balloon_max_extents must be >= 0")
        if self.balloon_every < 1:
            raise ValueError("balloon_every must be >= 1")
        if self.admit_ghost_hi < 0 or self.admit_churn_hi < 0:
            raise ValueError("admission sensor thresholds must be >= 0")
        if not (0 < self.qos_rate_lo_frac <= 1):
            raise ValueError("qos_rate_lo_frac must be in (0, 1]")
        if self.qos_rate_hi_frac < 1:
            raise ValueError("qos_rate_hi_frac must be >= 1")
        if self.qos_shed_hi < 0:
            raise ValueError("qos_shed_hi must be >= 0")
        for lo, hi, name in (
                (self.dwell_us_lo, self.dwell_us_hi, "dwell_us"),
                (self.settle_us_lo, self.settle_us_hi, "settle_us"),
                (self.window_lo, self.window_hi, "window"),
                (self.hedge_ms_lo, self.hedge_ms_hi, "hedge_ms"),
                (self.migrate_pps_lo, self.migrate_pps_hi,
                 "migrate_pps"),
                (self.admit_lo, self.admit_hi, "admit")):
            if lo < 0 or hi < lo:
                raise ValueError(
                    f"{name} bounds invalid: need 0 <= lo <= hi, got "
                    f"[{lo}, {hi}]")


def net_pipe_enabled(default: bool = True) -> bool:
    """Resolve the `PMDFC_NET_PIPE` escape hatch: `off` forces the legacy
    lockstep wire protocol + serialized server (the compatibility mode the
    conformance test pins), `on` forces the pipelined/coalesced tier, and
    an unset/unknown value falls through to `default`. Resolved at
    construction time (a server/backend never changes mode mid-life)."""
    v = os.environ.get("PMDFC_NET_PIPE", "").strip().lower()
    if v in ("off", "0", "false", "no"):
        return False
    if v in ("on", "1", "true", "yes"):
        return True
    return default


def fastpath_enabled(default: bool = True) -> bool:
    """Resolve the `PMDFC_FASTPATH` kill switch for the one-sided client
    fast path (client-mirrored directory + direct validated row reads,
    `runtime/net.py` MSG_DIRPULL/MSG_DIRDELTA/MSG_FASTREAD): `off` forces
    the plain verb path on both sides — the server withholds the HOLA
    capability ack and the client never builds a directory cache, so the
    wire transcript is verb-for-verb identical to a tree without the fast
    path (the PR 4/PR 7 conformance pattern). Resolved at construction
    time, like `PMDFC_NET_PIPE`."""
    v = os.environ.get("PMDFC_FASTPATH", "").strip().lower()
    if v in ("off", "0", "false", "no"):
        return False
    if v in ("on", "1", "true", "yes"):
        return True
    return default


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """TCP-tier coalescer/window knobs (`runtime/net.py`) — the wire analog
    of `RuntimeConfig`'s engine coalescer, reproducing the reference's
    multi-queue batched serving (8 QPs/client + per-queue pollers,
    `server/rdma_svr.h:16-19`) on the messenger tier.

    Server side (`NetServer(net=...)`): per-connection reader threads stage
    decoded verbs into one shared queue; a flush loop drains ALL live
    connections into one fused device batch per op phase. `flush_ops` is
    the cap (RuntimeConfig.batch_size analog), `flush_timeout_us` the
    adaptive dwell from the first staged op (batch_timeout_us analog), and
    `settle_us` the early cutoff — flush as soon as the staging queue goes
    quiet for this long, so a lone client pays microseconds, not the full
    dwell. Fused widths pad up the pow2 ladder from `pad_floor` with
    INVALID-key rows (match nothing, place nothing) so the compiled-shape
    set stays bounded exactly like the engine driver's.

    Client side (`TcpBackend(pipeline=..., window=...)`): sequence-tagged
    frames with up to `window` verbs outstanding per connection and
    per-verb deadlines (`op_timeout_s`) replacing the lockstep timeout.

    `PMDFC_NET_PIPE=off` overrides everything back to lockstep."""

    pipeline: bool = True
    window: int = 32
    coalesce: bool = True
    flush_ops: int = 8192
    flush_timeout_us: int = 2000
    settle_us: int = 200
    pad_pow2: bool = True
    pad_floor: int = 16

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.flush_ops < 1:
            raise ValueError("flush_ops must be >= 1")
        if self.flush_timeout_us < 0 or self.settle_us < 0:
            raise ValueError("flush timings must be >= 0")
        if self.pad_floor < 1 or (self.pad_floor & (self.pad_floor - 1)):
            raise ValueError("pad_floor must be a positive power of two")


def qos_enabled(default: bool = True) -> bool:
    """Resolve the `PMDFC_QOS` kill switch for the multi-tenant QoS
    control plane (`runtime/qos.py`): `off` collapses a constructed
    `NetServer(qos=...)` back to the single-tenant FIFO staging queue —
    no tenant lanes, no token buckets, no shed ladder, no per-tenant
    telemetry scopes, and ZERO new wire bytes (tenancy is carved out of
    the key space, not the frame format, so the off transcript is
    verb-for-verb identical to a tree without QoS — the PMDFC_RING=off
    conformance precedent). Resolved at construction time, like every
    other switch — a server never changes scheduling discipline
    mid-life; env wins over code."""
    v = os.environ.get("PMDFC_QOS", "").strip().lower()
    if v in ("off", "0", "false", "no"):
        return False
    if v in ("on", "1", "true", "yes"):
        return True
    return default


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's declared contract inside the QoS plane
    (`runtime/qos.py`).

    A tenant OWNS a prefix of the longkey space: every key whose top
    `QosConfig.tenant_bits` bits of the hi (oid) word equal `tid`
    belongs to it. Tenant 0 is the DEFAULT tenant — untagged traffic
    and unregistered prefixes land there bit-preserved, so every
    pre-QoS transcript keeps resolving (to one tenant) without a byte
    of rewriting.

    `weight` is the tenant's deficit-round-robin share of each fused
    flush batch (quantum = weight * QosConfig.quantum_ops per round).
    `priority` orders the shed ladder — LOWER priority is shed FIRST
    when staging depth crosses the threshold. `rate_ops_per_s` bounds
    edge admission with a token bucket (0 = unlimited, the Migrator
    rate precedent) refilled continuously with burst cap `burst_ops`.
    `rate_lo`/`rate_hi` declare the per-tenant autotune envelope for
    the rate knob (0 = derive both from the declared rate via
    `AutotuneConfig.qos_rate_lo_frac`/`qos_rate_hi_frac`)."""

    tid: int
    weight: int = 1
    priority: int = 1
    rate_ops_per_s: float = 0.0
    burst_ops: int = 256
    rate_lo: float = 0.0
    rate_hi: float = 0.0

    def __post_init__(self) -> None:
        if self.tid < 0:
            raise ValueError("tid must be >= 0")
        if self.weight < 1:
            raise ValueError("weight must be >= 1")
        if self.priority < 0:
            raise ValueError("priority must be >= 0")
        if self.rate_ops_per_s < 0:
            raise ValueError("rate_ops_per_s must be >= 0")
        if self.burst_ops < 1:
            raise ValueError("burst_ops must be >= 1")
        if self.rate_lo < 0 or self.rate_hi < 0:
            raise ValueError("rate envelope bounds must be >= 0")
        if self.rate_hi and self.rate_hi < self.rate_lo:
            raise ValueError("rate_hi must be >= rate_lo (or 0 = derive)")


@dataclasses.dataclass(frozen=True)
class QosConfig:
    """Multi-tenant QoS control plane (`runtime/qos.py` +
    `NetServer(qos=...)`): tenant namespaces carved from the longkey
    space, weighted-fair (deficit-round-robin) composition of the fused
    flush batch, and edge admission + overload shedding counted into
    the `miss_shed` cause lane.

    `tenant_bits` is the width of the namespace prefix: a key's tenant
    id is the top `tenant_bits` bits of its hi (oid) word, so at most
    `2**tenant_bits` tenants share a server. Clients tag at the edge
    (`qos.tag_keys`); the server resolves ONCE per staged op at decode
    time. `tenants` registers the declared contracts (tenant 0 is
    auto-registered as the default when absent).

    Overload story: when staging depth crosses `shed_threshold`, the
    shed ladder drops up to `shed_batch` staged GET/PUT ops from the
    lowest-priority non-empty lane BEFORE the flush loop drowns — shed
    GETs answer all-miss, shed PUTs ack-and-drop, both attributed to
    the `miss_shed` cause so `misses == Σ causes` stays bit-exact on
    every stats surface. Token buckets (per `TenantConfig`) shed at
    admission instead, before ops ever stage.

    `PMDFC_QOS=off` (env wins) makes the whole plane inert — see
    `qos_enabled`."""

    enabled: bool = True
    tenant_bits: int = 4
    tenants: "tuple[TenantConfig, ...]" = ()
    # DRR quantum credited per unit weight per scheduling round; small
    # keeps interleave fine-grained, the fused batch stays one launch
    quantum_ops: int = 32
    # staging depth at/above which the shed ladder engages, and the max
    # ops dropped per ladder pass (bounds reply burst per staging call)
    shed_threshold: int = 4096
    shed_batch: int = 1024

    def __post_init__(self) -> None:
        if not (1 <= self.tenant_bits <= 16):
            raise ValueError("tenant_bits must be in [1, 16] (the "
                             "prefix rides the 32-bit oid word)")
        if self.quantum_ops < 1:
            raise ValueError("quantum_ops must be >= 1")
        if self.shed_threshold < 1:
            raise ValueError("shed_threshold must be >= 1")
        if self.shed_batch < 1:
            raise ValueError("shed_batch must be >= 1")
        seen = set()
        for tc in self.tenants:
            if not isinstance(tc, TenantConfig):
                raise ValueError("tenants must be TenantConfig instances")
            if tc.tid >= (1 << self.tenant_bits):
                raise ValueError(
                    f"tid {tc.tid} does not fit in {self.tenant_bits} "
                    f"tenant bits")
            if tc.tid in seen:
                raise ValueError(f"duplicate tenant id {tc.tid}")
            seen.add(tc.tid)


def containment_enabled(default: bool = True) -> bool:
    """Resolve the `PMDFC_CONTAINMENT` kill switch for the
    blast-radius-containment layer (PR 18): MSG_NACK negotiation +
    poison-op bisection in the coalesced flush loop, the staging-time
    poison-fingerprint gate, end-to-end deadline shedding, and shard
    quarantine in the mesh plane. `off` restores the pre-containment
    transcript exactly — the server never advertises the capability
    (old rung-3 conn-drop semantics on phase failure), never sheds on
    deadlines, and the plane never quarantines. Resolved at
    construction time like every other switch; env wins over code."""
    v = os.environ.get("PMDFC_CONTAINMENT", "").strip().lower()
    if v in ("off", "0", "false", "no"):
        return False
    if v in ("on", "1", "true", "yes"):
        return True
    return default


@dataclasses.dataclass(frozen=True)
class ContainmentConfig:
    """Blast-radius containment knobs (`runtime/net.py` +
    `runtime/failure.py` + `parallel/plane.py`).

    **Bisection** (`bisect`): on a fused-phase failure the flush loop
    retries the batch in halves to isolate the culpable op(s) — at most
    ⌈log₂ b⌉ FAILING relaunches per culprit — instead of dropping every
    involved connection. Culprits are answered `MSG_NACK` (negotiated
    peers) or rung-3 conn-dropped (legacy peers), and their key digests
    enter a bounded fingerprint ring (`fingerprint_slots`) consulted at
    staging: a resubmitted poison op is refused before it ever reaches
    the device. `fingerprint_ttl_s` ages entries out so a key whose
    failure was environmental (since fixed) regains service without a
    restart.

    **Quarantine**: per-shard `CircuitBreaker`s in the mesh plane —
    `quarantine_failures` consecutive shard-attributed failures open a
    shard's breaker (cooldown `quarantine_cooldown_s`, widened by
    `quarantine_backoff` up to `quarantine_max_cooldown_s`); while open
    the shard's routed GETs degrade to `miss_quarantined` misses
    host-side and its invalidations journal for replay at half-open
    re-admission.

    `PMDFC_CONTAINMENT=off` makes all of it inert — see
    `containment_enabled`."""

    enabled: bool = True
    bisect: bool = True
    fingerprint_slots: int = 256
    fingerprint_ttl_s: float = 30.0
    quarantine_failures: int = 3
    quarantine_cooldown_s: float = 0.5
    quarantine_max_cooldown_s: float = 10.0
    quarantine_backoff: float = 2.0

    def __post_init__(self) -> None:
        if self.fingerprint_slots < 1:
            raise ValueError("fingerprint_slots must be >= 1")
        if self.fingerprint_ttl_s <= 0:
            raise ValueError("fingerprint_ttl_s must be > 0")
        if self.quarantine_failures < 1:
            raise ValueError("quarantine_failures must be >= 1")
        if self.quarantine_cooldown_s <= 0:
            raise ValueError("quarantine_cooldown_s must be > 0")
        if self.quarantine_max_cooldown_s < self.quarantine_cooldown_s:
            raise ValueError(
                "quarantine_max_cooldown_s must be >= quarantine_cooldown_s")
        if self.quarantine_backoff < 1.0:
            raise ValueError("quarantine_backoff must be >= 1.0")
