"""Logical-axis partitioning of the sharded KV state, and the host router
(twin of `pmdfc_tpu/parallel/partitioning.py`).

Every leaf of a `KVState` is named by LOGICAL axes (`shard`, `pool_row`,
`page_word`, `bloom_counter`, ...); a small rules table maps logical axes
onto GRID axes (`kv`, and `replica` on a 2-D grid). One vocabulary, three
consumers:

- `ShardedKV` places its state by `placement`: per leaf, the grid axes
  each dimension is split over and the grid axes the leaf is replicated
  along. The default rules split only the leading `shard` axis over `kv`
  (each shard's state is an independent table covering its key-space
  slice) and replicate every leaf along `replica`, so a shard's state is
  one `KVState` on its own device and a lane's a full copy of it.
- The serving plane routes request batches on the host with
  `ShardRouter`, the NUMA-queue analog (`server/NuMA_KV.cpp:136-151`:
  requests dispatch to the node that owns the page), with the numpy
  mirror of the device hash, so routing costs no device work.
- `describe()` renders the table (leaf -> logical axes -> split), and
  `validate_rules` refuses a rule that names a grid axis the grid lacks
  (a typo would otherwise quietly replicate state meant to be split).

The JAX module turns the same table into `PartitionSpec`s and
`NamedSharding`s; torch has neither, so `spec_for` returns the tuple of
grid axes (trailing unsplit axes dropped, as a `PartitionSpec` drops
them) and `placement` is the one function placement reads.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from pmdfc_tpu_torch.config import KVConfig
from pmdfc_tpu_torch.utils.hashing import SHARD_SEED
from pmdfc_tpu_torch.utils.hashing_np import hash_u64_np
from pmdfc_tpu_torch.utils.keys import INVALID_WORD

# the grid axis the leading state axis is split over
MESH_AXIS = "kv"

# the second axis of a 2-D serving grid: replica lanes. State is
# replicated along it; per-lane outputs (the attribution counts) are laid
# out one per lane via the `replica_lane` logical axis.
REPLICA_MESH_AXIS = "replica"

# logical name of the leading stacked axis (one slice per shard)
SHARD = "shard"

# logical axis of values laid out one per replica lane (no state leaf
# uses it: state is replicated along the lane)
REPLICA_LANE = "replica_lane"

# logical axis -> grid axis (None = not split along that dimension).
# First match wins; every logical axis a leaf uses must appear here.
DEFAULT_AXIS_RULES: tuple[tuple[str, str | None], ...] = (
    (SHARD, MESH_AXIS),
    # index tables (kind-specific row/col planes — shard-local)
    ("index_row", None),
    ("index_col", None),
    ("index_plane", None),
    # page pools (flat and tiered share the row/word vocabulary)
    ("pool_row", None),
    ("page_word", None),
    ("hot_row", None),
    ("cold_row", None),
    ("ghost_slot", None),
    ("key_word", None),
    # bloom counters, extent ring, counters
    ("bloom_counter", None),
    ("extent_slot", None),
    ("extent_word", None),
    ("stat", None),
    ("tier_stat", None),
    # evicted-key sketch bits (shard-local: each shard remembers only its
    # own evictions)
    ("sketch_bit", None),
    # TinyLFU admission gate (tiered pool; shard-local)
    ("cm_row", None),
    ("cm_counter", None),
    ("door_bit", None),
    ("admit_stat", None),
)

# The 2-D grid's table: the default grown by the replica axis. Picked by
# `rules_for_mesh` whenever the grid carries the `replica` axis; on a 1-D
# grid `validate_rules` refuses it.
MESH2D_AXIS_RULES: tuple[tuple[str, str | None], ...] = (
    (REPLICA_LANE, REPLICA_MESH_AXIS),
) + DEFAULT_AXIS_RULES

# Replicated-along markers for the 2-D grid: every leaf family either
# splits over the replica axis by a rule above or appears here. All state
# replicates (each lane is a full copy); a NEW leaf must be classified
# before it can ride a 2-D grid.
_PATH_REPLICATED: tuple[tuple[str, tuple[str, ...]], ...] = (
    (r"\.stats$", (REPLICA_MESH_AXIS,)),
    (r"\.evicted_filter$", (REPLICA_MESH_AXIS,)),
    (r"\.bloom\.", (REPLICA_MESH_AXIS,)),
    (r"\.extents\.", (REPLICA_MESH_AXIS,)),
    (r"\.pool\.", (REPLICA_MESH_AXIS,)),
    (r"\.index\.", (REPLICA_MESH_AXIS,)),
)

# leaf-path regex -> trailing logical axis names (the leading `shard` is
# prepended). First match wins; names beyond a leaf's rank are ignored.
_PATH_AXES: tuple[tuple[str, tuple[str, ...]], ...] = (
    (r"\.stats$", ("stat",)),
    (r"\.evicted_filter$", ("sketch_bit",)),
    (r"\.bloom\.", ("bloom_counter",)),
    (r"\.extents\.recs$", ("extent_slot", "extent_word")),
    (r"\.extents\.", ()),  # cursor scalar
    # tiered pool planes (hot/cold split, ghost ring, generations)
    (r"\.pool\.(hot_keys)$", ("hot_row", "key_word")),
    (r"\.pool\.(hfree|metric)$", ("hot_row",)),
    (r"\.pool\.(cfree|touch|live|pmask|parked|cgen)$", ("cold_row",)),
    (r"\.pool\.ghost$", ("ghost_slot", "key_word")),
    (r"\.pool\.tstats$", ("tier_stat",)),
    # TinyLFU admission gate
    (r"\.pool\.admit_cm$", ("cm_row", "cm_counter")),
    (r"\.pool\.admit_door$", ("door_bit",)),
    (r"\.pool\.admit_stats$", ("admit_stat",)),
    # flat + tiered backing arrays ([rows, page_words] / [rows])
    (r"\.pool\.(pages|sums|free)$", ("pool_row", "page_word")),
    (r"\.pool\.", ()),  # top/htop/ctop/ptop/hwm/tick/gcur scalars
    # index internals: kind-specific, named by position (row-major)
    (r"\.index\.", ("index_row", "index_col", "index_plane")),
)


def leaf_axes(path: str, ndim: int) -> tuple[str, ...]:
    """Trailing logical axes for one single-shard leaf of `ndim` dims."""
    for pat, names in _PATH_AXES:
        if re.search(pat, path):
            if ndim > len(names):
                raise ValueError(
                    f"state leaf {path} has {ndim} dims but the axis "
                    f"table names only {names} — name the new axis in "
                    "partitioning._PATH_AXES")
            return names[:ndim]
    raise ValueError(
        f"state leaf {path} matches no axis rule — name it in "
        "partitioning._PATH_AXES")


def replicated_along(path: str) -> tuple[str, ...]:
    """Grid axes the leaf at `path` is marked replicated along on a 2-D
    grid. A leaf matching no marker raises."""
    for pat, axes in _PATH_REPLICATED:
        if re.search(pat, path):
            return axes
    raise ValueError(
        f"state leaf {path} has no replicated-along marker — classify "
        "it in partitioning._PATH_REPLICATED (or give it a 2-D rule)")


def resolve_rules(extra=None) -> tuple[tuple[str, str | None], ...]:
    """Rules table with caller overrides PREPENDED (first match wins)."""
    return tuple(extra or ()) + DEFAULT_AXIS_RULES


def rules_for_mesh(mesh, extra=None):
    """The rules table matching the grid's dimensionality:
    `MESH2D_AXIS_RULES` when it carries the `replica` axis, else the 1-D
    `DEFAULT_AXIS_RULES`. Caller overrides still prepend."""
    base = (MESH2D_AXIS_RULES if REPLICA_MESH_AXIS in mesh.axis_names
            else DEFAULT_AXIS_RULES)
    return tuple(extra or ()) + base


def validate_rules(rules, mesh) -> None:
    """A rule mapping onto a grid axis the grid doesn't have is a silent
    replicate-instead-of-split bug; fail construction instead."""
    for logical, mesh_axis in rules:
        if mesh_axis is not None and mesh_axis not in mesh.axis_names:
            raise ValueError(
                f"axis rule ({logical!r} -> {mesh_axis!r}) names a mesh "
                f"axis not in {tuple(mesh.axis_names)}")


def spec_for(axes: tuple[str, ...], rules) -> tuple:
    """Logical axis names -> grid axis per dimension (None = not split),
    by the first matching rule; trailing Nones dropped."""
    mapped = []
    for a in axes:
        for logical, mesh_axis in rules:
            if logical == a:
                mapped.append(mesh_axis)
                break
        else:
            raise ValueError(
                f"logical axis {a!r} has no entry in the axis rules")
    while mapped and mapped[-1] is None:
        mapped.pop()
    return tuple(mapped)


def _named_leaves(config: KVConfig) -> list[tuple[str, tuple]]:
    """(".dotted.path", single-shard shape) per leaf of `kv.init(config)`,
    built on the `meta` device (no memory is allocated)."""
    from pmdfc_tpu_torch import carry

    return [("." + n, tuple(t.shape))
            for n, t in carry.leaves_of_config(config)]


def describe(config: KVConfig, rules=None) -> list[dict]:
    """Axis-rule table rows (leaf, shape, logical axes, split) — the
    README table's source and a debugging surface."""
    rules = rules if rules is not None else DEFAULT_AXIS_RULES
    rows = []
    for path, shape in _named_leaves(config):
        axes = (SHARD,) + leaf_axes(path, len(shape))
        rows.append({
            "leaf": path,
            "shape": ("n_shards",) + shape,
            "axes": axes,
            "spec": spec_for(axes, rules),
            "replicated_along": replicated_along(path),
        })
    return rows


def placement(config: KVConfig, rules=None) -> dict:
    """`describe`'s rows by leaf path — where `ShardedKV` puts each leaf:
    split over the grid axes of `spec`, copied along `replicated_along`.
    The port places a leaf whose only split is `shard -> kv` as one tensor
    per shard (per lane on a 2-D grid); any other split raises."""
    out = {}
    for row in describe(config, rules):
        if row["spec"] != (MESH_AXIS,):
            raise ValueError(
                f"state leaf {row['leaf']} would split as {row['spec']}: "
                "the port keeps one whole leaf per shard, so only the "
                f"leading shard axis may map onto {MESH_AXIS!r}")
        out[row["leaf"]] = row
    return out


# ---------------------------------------------------------------------------
# host-side request routing (the per-NUMA-node dispatch queue analog)
# ---------------------------------------------------------------------------


def shard_of_np(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Numpy mirror of `utils.hashing.shard_of`: bit-identical owners,
    no device work (the serving plane routes with this)."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    h = hash_u64_np(keys[:, 0], keys[:, 1], seed=SHARD_SEED)
    return (h % np.uint32(n_shards)).astype(np.uint32)


@dataclasses.dataclass
class RoutedBatch:
    """One host-routed batch: shard-major padded lanes + the scatter map
    back to request order."""

    keys: np.ndarray          # uint32[n*wl, 2] shard-major, INVALID pads
    values: np.ndarray | None  # uint32[n*wl, V] aligned with keys
    pos: np.ndarray           # int64[b] routed lane of request i
    counts: np.ndarray        # int64[n] requests routed per shard
    wl: int                   # per-shard padded width (pow2)
    b: int                    # live request count

    def scatter(self, routed: np.ndarray) -> np.ndarray:
        """Routed-lane result array -> request order ([b, ...]). Each
        request reads back its OWN lane, so pad lanes never leak."""
        return np.asarray(routed)[self.pos]


class ShardRouter:
    """Bins host batches by owning shard and pads PER SHARD up the pow2
    ladder — `GetNodeID(key)` queue dispatch fused with the serving tier's
    pad discipline.

    Per-shard padding keeps each shard's width independent of how many
    OTHER shards' requests rode the same flush, so a skewed flush pays only
    its own shard's pad waste. Requests keep their in-batch order within
    each shard (stable binning), which is what makes cross-shard
    dedupe-last-wins match the single-device ground truth."""

    def __init__(self, n_shards: int, pad_floor: int = 8):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if pad_floor < 1 or (pad_floor & (pad_floor - 1)):
            raise ValueError("pad_floor must be a positive power of two")
        self.n = n_shards
        self.pad_floor = pad_floor

    def owners(self, keys: np.ndarray) -> np.ndarray:
        return shard_of_np(keys, self.n)

    def width(self, max_count: int) -> int:
        w = self.pad_floor
        while w < max_count:
            w <<= 1
        return w

    def build(self, keys: np.ndarray,
              values: np.ndarray | None = None) -> RoutedBatch:
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        b = len(keys)
        own = self.owners(keys)
        order = np.argsort(own, kind="stable")
        counts = np.bincount(own, minlength=self.n).astype(np.int64)
        wl = self.width(int(counts.max()) if b else 0)
        starts = np.zeros(self.n, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        own_sorted = own[order]
        rank = np.arange(b, dtype=np.int64) - starts[own_sorted]
        pos_sorted = own_sorted.astype(np.int64) * wl + rank
        pos = np.empty(b, np.int64)
        pos[order] = pos_sorted
        kp = np.full((self.n * wl, 2), INVALID_WORD, np.uint32)
        kp[pos] = keys
        vp = None
        if values is not None:
            values = np.asarray(values, np.uint32)
            vp = np.zeros((self.n * wl, values.shape[-1]), np.uint32)
            vp[pos] = values
        return RoutedBatch(keys=kp, values=vp, pos=pos, counts=counts,
                           wl=wl, b=b)
