"""Carry a state across between the two packages.

A JAX `KVState` is a tree of arrays; pulled to the host with `np.asarray`
and named by their attribute paths (`"index.table"`, `"pool.pages"`,
`"stats"`, ...) its leaves become a dict of numpy arrays, which
`state_from_numpy` turns into this package's `KVState` — the counterpart
of carrying weights across. `state_to_numpy` goes the other way, with the
same names and the JAX package's dtypes (u32 words as numpy uint32), so
two states compare leaf by leaf.

A sharded state crosses the same way. The JAX plane stacks every leaf
`[n_shards, ...]` (on a 2-D grid each replica lane holds a copy; taken
lane by lane, `[n_shards, n_replicas, ...]`); `sharded_from_numpy` turns
such leaves into the port's per-shard (per-lane) `KVState`s on the
grid's devices, each lane its own allocation, and `sharded_to_numpy`
stacks them back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pmdfc_tpu_torch import kv as kv_mod
from pmdfc_tpu_torch import tier as tier_mod
from pmdfc_tpu_torch.config import IndexKind, KVConfig
from pmdfc_tpu_torch.models import cceh, cuckoo, level, path
from pmdfc_tpu_torch.models.cuckoo_probing import CCPState
from pmdfc_tpu_torch.models.hotring import HotRingState
from pmdfc_tpu_torch.models.linear import LinearState
from pmdfc_tpu_torch.models.static import StaticState
from pmdfc_tpu_torch.ops.bloom import BloomState
from pmdfc_tpu_torch.ops.pagepool import PoolState
from pmdfc_tpu_torch.utils import u32

# leaves holding u32 words (uint32 in JAX, int32 bits here)
U32_LEAVES = frozenset({"index.table", "index.head", "index.ld",
                        "index.gdepth", "index.cuckooed", "index.counters",
                        "index.hot", "pool.pages", "pool.sums",
                        "extents.recs", "extents.cursor",
                        # the tiered pool's
                        "pool.hot_keys", "pool.metric", "pool.tick",
                        "pool.touch", "pool.ghost", "pool.gcur", "pool.cgen",
                        "pool.admit_cm", "pool.admit_ops",
                        "pool.admit_thresh"})


def _tensor(name: str, a: np.ndarray, device, consume: bool) -> torch.Tensor:
    a = np.asarray(a)
    if consume and a.flags.c_contiguous and a.flags.writeable:
        # the caller's own buffer: a view crosses, with no host copy
        if name in U32_LEAVES and a.dtype in (np.uint32, np.int32):
            return torch.from_numpy(a.view(np.int32)).to(device)
        if name not in U32_LEAVES and a.dtype in (np.int32, np.bool_):
            return torch.from_numpy(a).to(device)
    if name in U32_LEAVES:
        return u32.from_numpy(a.astype(np.uint32, copy=False), device)
    return torch.from_numpy(np.array(a)).to(device)


def state_from_numpy(leaves: dict[str, np.ndarray], config: KVConfig,
                     device="cuda", consume: bool = False) -> kv_mod.KVState:
    """The JAX package's `KVState` leaves (numpy, by dotted path) -> this
    package's `KVState` on `device`: any index family over the flat pool,
    or the tiered one when `config.tier` is set (its admission leaves iff
    the leaves hold them). An index state's static knobs (CCEH's, cuckoo's
    `max_kicks`, level's `top_rows`, path's `top`) come from the config.

    `consume=True` hands the arrays over (a restore's freshly read
    leaves): a contiguous, writeable u32/int32/bool leaf crosses to the
    device as a view, without the host copy an 8 GiB page leaf would
    otherwise cost; on the CPU the state then shares its buffer."""
    dev = kv_mod.resolve_device(device)

    def t(name):
        return _tensor(name, leaves[name], dev, consume)

    def leaves_of(cls, **static):
        return cls(**{f.name: t(f"index.{f.name}")
                      for f in dataclasses.fields(cls)
                      if f.name not in static}, **static)

    ix = config.index
    kind = ix.kind
    if kind in (IndexKind.CCEH, IndexKind.EXTENDIBLE):
        index = leaves_of(cceh.CCEHState, msb=kind == IndexKind.CCEH,
                          **cceh.static_fields(ix))
    elif kind == IndexKind.CUCKOO:
        index = leaves_of(cuckoo.CuckooState,
                          max_kicks=ix.max_cuckoo_kicks)
    elif kind == IndexKind.LEVEL:
        index = leaves_of(level.LevelState, top_rows=level._top_rows(ix))
    elif kind == IndexKind.PATH:
        index = leaves_of(path.PathState, top=path._top_cells(ix))
    else:
        index = leaves_of({IndexKind.LINEAR: LinearState,
                           IndexKind.CUCKOO_PROBING: CCPState,
                           IndexKind.STATIC: StaticState,
                           IndexKind.HOTRING: HotRingState}[kind])

    pool = None
    if config.paged and config.tier is not None:
        pool = tier_mod.TierState(**{
            f.name: t(f"pool.{f.name}")
            for f in dataclasses.fields(tier_mod.TierState)
            if f"pool.{f.name}" in leaves or not f.name.startswith("admit_")})
    elif config.paged:
        pool = PoolState(pages=t("pool.pages"), sums=t("pool.sums"),
                         free=t("pool.free"), top=t("pool.top"))

    return kv_mod.KVState(
        index=index,
        bloom=BloomState(counters=t("bloom.counters"))
        if config.bloom else None,
        pool=pool,
        extents=kv_mod.ExtentState(recs=t("extents.recs"),
                                   cursor=t("extents.cursor")),
        stats=t("stats"),
        evicted_filter=t("evicted_filter"),
    )


def leaves(state: kv_mod.KVState) -> list[tuple[str, torch.Tensor]]:
    """`(dotted path, tensor)` per leaf, in the JAX package's
    `jax.tree.leaves` order: dataclass fields in declaration order, `None`
    subtrees and static knobs skipped."""
    out = []

    def walk(prefix, node):
        if isinstance(node, torch.Tensor):
            out.append((prefix, node))
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(f"{prefix}.{f.name}" if prefix else f.name,
                     getattr(node, f.name))
        # anything else (None, a static int or bool knob) is not a leaf

    walk("", state)
    return out


def leaf_to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    """One leaf on the host with the JAX package's dtype (u32 words as
    numpy uint32, viewed, not converted)."""
    return u32.to_numpy(t) if name in U32_LEAVES else t.detach().cpu().numpy()


def state_to_numpy(state: kv_mod.KVState) -> dict[str, np.ndarray]:
    """This package's `KVState` -> {dotted leaf path: numpy array}, with
    the JAX package's leaf names and dtypes."""
    return {n: leaf_to_numpy(n, t) for n, t in leaves(state)}


def sharded_from_numpy(leaves: dict[str, np.ndarray], config: KVConfig,
                       mesh) -> list[list[kv_mod.KVState]]:
    """Stacked leaves -> `states[s][r]` on `mesh.devices` (shape `(n,)` or
    `(n, R)`): a leaf `[n, ...]` is copied onto every lane of its shard, a
    leaf `[n, R, ...]` gives each lane its own slice."""
    grid = np.asarray(mesh.devices, dtype=object)
    n = grid.shape[0]
    nrep = grid.shape[1] if grid.ndim == 2 else 1
    grid = grid.reshape(n, nrep)
    single = {name: t.dim() for name, t in leaves_of_config(config)}
    out = []
    for s in range(n):
        lanes = []
        for r in range(nrep):
            one = {}
            for name, a in leaves.items():
                a = np.asarray(a)
                if a.shape[0] != n:
                    raise ValueError(f"leaf {name} stacks {a.shape[0]} "
                                     f"shards, the grid has {n}")
                lane_axis = a.ndim == single.get(name, a.ndim - 1) + 2
                one[name] = a[s, r] if lane_axis else a[s]
            lanes.append(state_from_numpy(one, config, grid[s, r]))
        out.append(lanes)
    return out


def sharded_to_numpy(states: list[list[kv_mod.KVState]],
                     lanes: bool = False) -> dict[str, np.ndarray]:
    """`states[s][r]` -> {dotted leaf path: stacked numpy array}: `[n,
    ...]` from lane 0 (the layout of the JAX plane's leaves and of a
    sharded snapshot), or with `lanes=True` `[n, R, ...]`."""
    per = [[state_to_numpy(st) for st in (row if lanes else row[:1])]
           for row in states]
    out = {}
    for name in per[0][0]:
        a = np.stack([np.stack([lane[name] for lane in row])
                      for row in per])
        out[name] = a if lanes else a[:, 0]
    return out


def leaves_of_config(config: KVConfig) -> list[tuple[str, torch.Tensor]]:
    """`leaves` of a fresh state of `config` on the `meta` device (names
    and shapes, nothing allocated)."""
    return leaves(kv_mod.init(config, "meta"))
