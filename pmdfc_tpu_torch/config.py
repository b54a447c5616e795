"""Typed configuration (twin of `pmdfc_tpu/config.py`, this slice's part).

The same frozen dataclasses with the same fields and defaults, so one
configuration reads the same in both packages. Two differences:

- no environment switch on the KV: the JAX package lets `PMDFC_TIER` and
  `PMDFC_ADMIT` add or strip the tiered store and its admission gate at
  init; here they come from `KVConfig.tier` (and its `admit`) alone. The
  one switch kept is `PMDFC_QOS` (`qos_enabled`), read by the clean-cache
  client's tenant tagging;
- there is no `fused_get` switch: on CUDA a configuration that
  `ops.fused.supports` accepts always runs the fused GET kernel, and one
  it rejects runs the composed GET, as the JAX package composes it.
"""

from __future__ import annotations

import dataclasses
import enum
import os


def qos_enabled() -> bool:
    """Resolve the `PMDFC_QOS` kill switch (default on): `off` makes a
    clean-cache client send every key untagged (tenant 0), the pre-QoS
    transcript. Resolved at construction time, like every switch."""
    v = os.environ.get("PMDFC_QOS", "").strip().lower()
    return v not in ("off", "0", "false", "no")


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
