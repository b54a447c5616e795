"""KV state sharded over a grid of devices — the NUMA_KV analog (twin of
`pmdfc_tpu/parallel/shard.py`).

Reference: `server/NuMA_KV.cpp` routes each request to a per-NUMA-node
lock-free circular queue picked by `GetNodeID(key)` (`NuMA_KV.cpp:136-151`),
with worker/receiver/poller thread pools per node (`NuMA_KV.h:94-100`).

Single controller. One Python process drives the whole plane, as the JAX
package's does with `shard_map` over a local `Mesh`. The grid (`Mesh`
here) is a 1-D or 2-D array of `torch.device`s with the axis names
`("kv",)` or `("kv", "replica")`; shard `s` (lane `r` of it, on a 2-D
grid) holds its own `KVState` on its own device and owns the key-space
slice `shard_of(key) = murmur3(key, SHARD_SEED) % n_shards`. A grid may
name one device several times (`make_mesh(["cuda:0"] * 4)`): four shards
on one card, each a separate allocation.

Each `shard_map` body of the JAX module becomes a host loop that runs the
single-device program (`kv.insert`, `kv.get`, ...) on each shard's state,
in place, and each collective becomes explicit tensor work with JAX's
semantics:

- `all_to_all`: bucket slices moved to the owner's device, received in
  source-major order, and the reverse exchange back;
- `psum` / `pmax` / `pmin`: a reduction over the shards' results (u32
  words compared unsigned: an all-ones evicted key is the largest).

Two dispatch strategies for the host verbs `insert` / `get` / `delete`,
selected by `ShardedKV(dispatch=...)`:

- ``"a2a"`` (default): the padded batch is split into n contiguous source
  slices; each source bins its slice by owner (`batch_rank_by_segment`
  gives conflict-free bucket lanes), buckets of `pair_capacity` rows go
  to their owners, the owner runs the program on what it received, and
  the results come back. Rows past a pair's capacity are a drop on insert
  and a `miss_routed` on get, counted on the requesting shard. Deletes
  use exact buckets (a silently failed delete would serve stale bytes).
- ``"broadcast"``: every shard sees the whole batch with the keys it does
  not own masked to INVALID, and the results merge (`pmax` of slots,
  dropped and fresh, `pmin` of the evicted words).

Extents are replicated: every shard appends the same record at the same
cursor and indexes only the covers it owns (`kv.insert_extent(shard=)`);
`get_extent` probes every shard with the whole batch and keeps the lowest
winning cover height, rewriting gets/misses onto shard 0.

The serving plane (`plane_*`) is what the wire uses: the host router
(`partitioning.ShardRouter`) bins each batch by owner and pads per shard,
so each shard runs the plain single-device program on its own rows. A
read-only plane GET leaves every stats leaf as it is: its per-shard stats
delta is folded into a host plane (`_plane_stats`) that `stats()`,
`shard_report()` and `save()` merge, as the JAX package's read-only GET
program returns a delta and writes no state.

2-D grids: every mutation applies identically on every lane (each lane is
its own allocation), GETs are hedged (the first lane whose digest-checked
row answers wins, per-lane served/refused attribution), and
`replica_repair` copies validating rows over rows that fail their digest.
A 2-D grid with a tiered pool is refused. The host verbs (`get`, ...) run
on every lane and answer with lane 0's results, as the JAX host fetch
reads one lane.

The JAX `_wrap` donation rule has no counterpart: the state is updated in
place and never copied per call.

Multi-process grids (`connect_multihost`, on `torch.distributed`): after
the join, `make_mesh()` is the global grid in process-major order and
each process holds the states of its own shards. Every process passes the
same full batch (JAX's `_to_global`) and routes the source slices of its
own shards; the exchange is `all_to_all_single` over the bucket buffers
in JAX's source-major order with its `pair_capacity`, the merges are
all-reduces (SUM for psum, MAX for pmax, MIN over words widened to int64
for the unsigned pmin), and every host verb returns the full result on
every process, an all-gather of the source slices (JAX's `_fetch`):
`insert`, `get`, `delete`, `insert_extent`, `get_extent`, `find_anyway`,
`recovery`, `stats`, `utilization`, `shard_report` and the packed bloom,
on both dispatches. Extents stay replicated. The plane verbs run each
process's own shards on the routed batch and all-gather the per-shard
outputs (pages, found, the read-only stats delta, insert results, lane
attribution), so `PlaneBackend` works over such a grid driven in step;
`fast_view` gathers JAX's host mirror of every pool, `directory_snapshot`
every shard's entries; `restore`/`restore_chain` keep each process's own
shards (a reshard replays through the plane verbs); the tier, balloon
and admission verbs reduce over every shard. A tiered pool, carried
`states=` (the owned shards) and `make_mesh2d` span processes, with every
lane of a shard in one process. `save` and `snapshot` raise
`MultihostUnsupportedError`, as JAX's `checkpoint.save` fails on arrays
it cannot address. Under gloo a CUDA tensor's collective stages through
pinned host buffers; NCCL refuses two ranks on one card
(`SharedDeviceError`, before any collective runs).

Device time (`runtime/profiler.py`). With a profiler attached and every
shard and lane on one CUDA device, each plane verb records one CUDA event
pair around all of its shards' programs (they run one after another on
that device's stream): the phase's device window, first shard's start to
last shard's end, which the fetch splits over the shards by `counts` as
the JAX profiler splits its fetch window. A grid of distinct devices
records no pair (events of two devices have no common clock), and the
fetch times the host. The first call of each plane GET width sets the
`cost.plane.get` gauges from the fused kernel's bytes per shard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from pmdfc_tpu_torch import checkpoint as ckpt_mod
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as kv_mod
from pmdfc_tpu_torch import tier as tier_mod
from pmdfc_tpu_torch.config import KVConfig
from pmdfc_tpu_torch.kv import (
    DROPS, GETS, HITS, MISS_COLD, MISS_DEADLINE, MISS_DIGEST, MISS_EVICTED,
    MISS_QUARANTINED, MISS_ROUTED, MISS_SHED, MISSES, NSTATS, PUTS)
from pmdfc_tpu_torch.models.base import (
    InsertResult, batch_rank_by_segment, get_index_ops)
from pmdfc_tpu_torch.ops import bloom as bloom_ops
from pmdfc_tpu_torch.ops import pagepool
from pmdfc_tpu_torch.parallel import partitioning as pt
from pmdfc_tpu_torch.runtime import profiler
from pmdfc_tpu_torch.utils import u32
from pmdfc_tpu_torch.utils.hashing import shard_of
from pmdfc_tpu_torch.utils.keys import INVALID_I32, INVALID_WORD, is_invalid

AXIS = pt.MESH_AXIS
# second grid axis of a 2-D serving grid: replica lanes
RAXIS = pt.REPLICA_MESH_AXIS

# rows digested per step of a whole-pool pass (replica repair): bounds
# the int64 temporaries of `page_digest` to 2^16 pages at a time
_DIGEST_CHUNK = 1 << 16
# pool rows per gather of a multi-process fast-lane mirror: 32 MiB a shard
# at 4 KiB pages, so gloo's pinned staging stays bounded
_MIRROR_CHUNK = 1 << 13


class Mesh:
    """A grid of devices with named axes: `devices` is a numpy object
    array of `torch.device` of shape `(n_shards,)` or `(n_shards,
    n_replicas)`, `axis_names` `("kv",)` or `("kv", "replica")`. A device
    may appear more than once. `owners` (a multi-process grid only, see
    `connect_multihost`) is the rank of the process that holds each
    shard's device; None when one process holds every shard."""

    def __init__(self, devices, axis_names, owners=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"grid of shape {devices.shape} for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.owners = None if owners is None else np.asarray(owners, int)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def _resolve_devices(devices) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = kv_mod.resolve_device(d)
    return arr


def _local_devices() -> list:
    """Every local GPU; raises without one (the port's device rule: a
    grid on the CPU is built from an explicit device list)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        kv_mod.resolve_device("cuda")  # raises with the port's message
    return [torch.device(f"cuda:{i}") for i in range(n)]


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    """1-D grid over the given devices (default: every local GPU); axis
    name ``"kv"``. `devices` may repeat a device (`["cpu"] * 4`).

    After `connect_multihost`, the default is the global grid: every
    process's devices in process-major order (as `jax.devices()` orders
    them), each shard owned by the process that holds its device."""
    if devices is None and _LAYOUT is not None:
        lay = _LAYOUT
        flat = [d for per in lay.devices for d in per]
        devs = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            devs[i] = torch.device(d)
        owners = [p for p, per in enumerate(lay.devices) for _ in per]
        return Mesh(devs, (axis,), owners=owners)
    devs = _resolve_devices(list(np.asarray(
        devices if devices is not None else _local_devices(),
        dtype=object).reshape(-1)))
    return Mesh(devs, (axis,))


def make_mesh2d(n_shards: int, n_replicas: int, devices=None) -> Mesh:
    """2-D grid `(kv=n_shards, replica=n_replicas)`: the kv axis
    partitions the key space as the 1-D grid does, the replica axis holds
    `n_replicas` full copies of each shard's state, so one call replaces
    the host ReplicaGroup's rf TCP fan-out loops.

    After `connect_multihost` the default is the first `n_shards *
    n_replicas` devices of the global grid, process-major, as JAX's
    `make_mesh2d` takes them from `jax.devices()`."""
    need = n_shards * n_replicas
    if devices is None and _LAYOUT is not None:
        # the global grid, process-major (JAX's `jax.devices()[:need]`)
        grid = make_mesh()
        if grid.devices.size < need:
            raise ValueError(f"mesh2d needs {n_shards}x{n_replicas}={need} "
                             f"devices, the grid has {grid.devices.size}")
        return Mesh(grid.devices[:need].reshape(n_shards, n_replicas),
                    (AXIS, RAXIS),
                    owners=grid.owners[:need].reshape(n_shards, n_replicas))
    if devices is None:
        devices = _local_devices()[:need]
    flat = list(np.asarray(devices, dtype=object).reshape(-1))
    if len(flat) != need:
        raise ValueError(
            f"mesh2d needs {n_shards}x{n_replicas}={need} devices, "
            f"got {len(flat)}")
    return Mesh(_resolve_devices(flat).reshape(n_shards, n_replicas),
                (AXIS, RAXIS))


# ---------------------------------------------------------------------------
# multi-process grids (torch.distributed)
# ---------------------------------------------------------------------------

class MultihostError(RuntimeError):
    """A multi-process grid cannot be set up as asked."""


class SharedDeviceError(MultihostError):
    """Two NCCL ranks name one card: NCCL refuses a communicator whose
    ranks share a device, so the join is refused before any collective
    runs (gloo stages through host buffers and allows it)."""


class MultihostUnsupportedError(MultihostError, NotImplementedError):
    """A verb or configuration the multi-process grid does not run."""


@dataclasses.dataclass(frozen=True)
class _Layout:
    """What `connect_multihost` learned: this process's rank, the
    backend, and every process's device list (rank order)."""

    rank: int
    world: int
    backend: str
    devices: tuple


# the joined process group's layout (None: one process). Process-wide, as
# torch.distributed's default group is.
_LAYOUT: _Layout | None = None


def _card_ids(devices: list) -> list:
    """Identity of each CUDA device this process names (host and card
    UUID), None for the CPU: what the NCCL shared-card check compares."""
    import socket

    out = []
    for d in devices:
        dev = torch.device(d)
        if dev.type != "cuda":
            out.append(None)
            continue
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        props = torch.cuda.get_device_properties(idx)
        out.append(f"{socket.gethostname()}/{getattr(props, 'uuid', idx)}")
    return out


def shared_cards(cards_by_rank: list) -> dict:
    """{card: [ranks]} of every card named by more than one rank."""
    seen: dict = {}
    for rank, cards in enumerate(cards_by_rank):
        for c in set(cards):
            if c is not None:
                seen.setdefault(c, []).append(rank)
    return {c: r for c, r in seen.items() if len(r) > 1}


def connect_multihost(coordinator: str, num_processes: int, process_id: int,
                      timeout_s: float | None = None, *,
                      backend: str = "gloo", devices=None) -> int:
    """Join a multi-process grid — the twin of the JAX package's
    `connect_multihost` (`jax.distributed.initialize`) on
    `torch.distributed`. -> the global device count.

    `devices` is this process's local device list (default: every local
    GPU); a device may repeat, as on one grid (`["cpu", "cpu"]` stands in
    for the JAX worker's two forced CPU devices). Every process must name
    as many devices. `backend` is "gloo" (collectives on host tensors;
    CUDA tensors are staged through pinned host buffers) or "nccl"
    (collectives on the cards; no two ranks may name one card). There is
    no switch between the two. `timeout_s` bounds the join and every
    collective; a peer that never joins fails the join within it.

    Afterwards `make_mesh()` builds the global grid and a `ShardedKV`
    over it serves its own shards in every process: every process passes
    the same full batch and every host verb returns the full result on
    every process."""
    global _LAYOUT
    import datetime

    import torch.distributed as dist

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r} (gloo or nccl)")
    if _LAYOUT is not None or dist.is_initialized():
        raise MultihostError("this process already joined a process group")
    local = [str(kv_mod.resolve_device(d)) for d in (
        devices if devices is not None else _local_devices())]
    if backend == "nccl" and any(torch.device(d).type != "cuda"
                                 for d in local):
        raise ValueError(f"nccl needs CUDA devices, got {local}")
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)
    try:
        # the layout travels over a gloo group (the default one under
        # gloo): nothing has run on NCCL yet when the card check refuses
        side = dist.new_group(backend="gloo") if backend == "nccl" else None
        infos = [None] * num_processes
        dist.all_gather_object(infos, (local, _card_ids(local)), group=side)
        counts = {len(d) for d, _ in infos}
        if len(counts) != 1:
            raise MultihostError(
                f"every process must hold as many devices: "
                f"{[len(d) for d, _ in infos]}")
        if backend == "nccl":
            shared = shared_cards([c for _, c in infos])
            if shared:
                raise SharedDeviceError(
                    f"NCCL ranks share a card: {shared}; use gloo, or give "
                    f"each rank its own card")
    except BaseException:
        dist.destroy_process_group()
        raise
    _LAYOUT = _Layout(rank=process_id, world=num_processes, backend=backend,
                      devices=tuple(tuple(d) for d, _ in infos))
    return sum(len(d) for d, _ in infos)


def shutdown_multihost() -> None:
    """Leave the process group `connect_multihost` joined (the twin of
    `jax.distributed.shutdown`); a no-op without one."""
    global _LAYOUT
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _LAYOUT = None


def _on(dev: torch.device):
    """Enter `dev` for the calling thread (CUDA); a no-op on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _to_dev(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host u32 words -> a fresh int32 tensor on `dev` (never a view of
    the caller's buffer)."""
    a = np.ascontiguousarray(a)
    if a.dtype != np.uint32 and a.dtype != np.int32:
        a = a.astype(np.uint64).astype(np.uint32)
    t = torch.from_numpy(a.view(np.int32))
    return t.clone() if dev.type == "cpu" else t.to(dev)


def _host(t: torch.Tensor, words: bool) -> np.ndarray:
    return u32.to_numpy(t) if words else t.cpu().numpy()


def _res_host(res: InsertResult) -> dict:
    return {f: _host(x, f.startswith("evicted"))
            for f, x in res._asdict().items()}


def _unrouted(w: int, dev) -> InsertResult:
    """The InsertResult of w lanes no request was routed to, on `dev`."""
    inval = torch.full((w, 2), INVALID_I32, dtype=torch.int32, device=dev)
    return InsertResult(
        slots=torch.full((w,), -1, dtype=torch.int32, device=dev),
        evicted=inval, dropped=torch.zeros(w, dtype=torch.bool, device=dev),
        fresh=torch.zeros(w, dtype=torch.bool, device=dev),
        evicted_vals=inval)


# ---------------------------------------------------------------------------
# a2a dispatch primitives
# ---------------------------------------------------------------------------

def pair_capacity(bl: int, n: int) -> int:
    """Per-(src, dst) bucket size: exact for small batches, 2x the uniform
    expectation for large ones."""
    return min(bl, max(16, -(-2 * bl // n)))


def _route(keys: torch.Tensor, n: int, c_pair: int):
    """(ok[Bl], flat[Bl]) of one source slice: `flat = dest * c_pair +
    rank`; rows past the pair capacity (or INVALID) get the dump slot
    `n * c_pair`. Ranks are stable in batch order."""
    valid = ~is_invalid(keys)
    dest = torch.where(valid, shard_of(keys, n), 0)
    rank = batch_rank_by_segment(dest.to(torch.int32), valid)
    ok = valid & (rank < c_pair)
    flat = torch.where(ok, dest * c_pair + rank, n * c_pair)
    return ok, flat


def _bucket(x: torch.Tensor, flat: torch.Tensor, n: int, c_pair: int, fill):
    """Rows into `[n * c_pair]` bucket lanes (the dump row dropped)."""
    buf = torch.full((n * c_pair + 1, *x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    buf[flat] = x
    return buf[: n * c_pair]


def _exchange(bufs: list, devs: list, c_pair: int) -> list:
    """The all_to_all: destination d receives, in source-major order,
    slice d of every source's buckets, on its own device."""
    n = len(bufs)
    return [torch.cat([bufs[i][d * c_pair:(d + 1) * c_pair].to(devs[d])
                       for i in range(n)]) for d in range(n)]


def _exchange_back(outs: list, devs: list, c_pair: int) -> list:
    """The reverse all_to_all: source i receives, in destination-major
    order, slice i of every owner's results, on its own device."""
    n = len(outs)
    return [torch.cat([outs[d][i * c_pair:(i + 1) * c_pair].to(devs[i])
                       for d in range(n)]) for i in range(n)]


def _to_source(backs: list, flat: list, ok: list, c_pair: int,
               miss) -> list:
    """Per-request results of each source (its reverse-exchanged buffer
    `backs[i]`) gathered back to the source's batch order; rows that
    never reached an owner get `miss`."""
    res = []
    for i, back in enumerate(backs):
        got = back[flat[i].clamp(max=back.shape[0] - 1)]
        sel = ok[i].reshape(ok[i].shape + (1,) * (got.dim() - 1))
        m = miss(i) if callable(miss) else miss
        if isinstance(m, torch.Tensor):
            m = m.to(got.device)
        res.append(torch.where(sel, got, m))
    return res


# ---------------------------------------------------------------------------
# merges (the psum / pmax / pmin of the broadcast bodies)
# ---------------------------------------------------------------------------

def _gather_to(xs: list, dev: torch.device) -> torch.Tensor:
    return torch.stack([x.to(dev) for x in xs])


def _umin(xs: torch.Tensor) -> torch.Tensor:
    """pmin of u32 words over dim 0 (unsigned: all-ones is the largest)."""
    return u32.narrow(u32.widen(xs).min(dim=0).values)


def _combine_insert_result(results: list, dev) -> InsertResult:
    st = {f: _gather_to([getattr(r, f) for r in results], dev)
          for f in InsertResult._fields}
    return InsertResult(
        slots=st["slots"].max(dim=0).values,
        evicted=_umin(st["evicted"]),  # non-owners hold all-ones
        dropped=st["dropped"].any(dim=0),
        fresh=st["fresh"].any(dim=0),
        evicted_vals=_umin(st["evicted_vals"]),
    )


def _combine_values(outs: list, founds: list, dev):
    """Per-shard (values, found) -> merged: each key found on <= 1 shard."""
    f = _gather_to(founds, dev)
    v = _gather_to(outs, dev)
    v = torch.where(f[..., None], v, 0)
    return u32.narrow(u32.widen(v).sum(dim=0)), f.any(dim=0)


def _mask_to_owner(keys: torch.Tensor, n: int, me: int) -> torch.Tensor:
    mine = shard_of(keys, n) == me
    return torch.where(mine[:, None], keys, INVALID_I32)


# ---------------------------------------------------------------------------
# the exchange: one process, or many on torch.distributed
# ---------------------------------------------------------------------------

class _LocalExchange:
    """One process holds every shard: the all_to_all and the merges are
    tensor work on the shards' own devices (the single-controller
    plane), and the host rows of every shard are already here."""

    def __init__(self, n: int):
        self.mine = list(range(n))

    @staticmethod
    def to_owner(bufs: list, devs: list, c_pair: int) -> list:
        return _exchange(bufs, devs, c_pair)

    @staticmethod
    def to_source(outs: list, devs: list, c_pair: int) -> list:
        return _exchange_back(outs, devs, c_pair)

    @staticmethod
    def full(parts: list, dev) -> torch.Tensor:
        return torch.cat([p.to(dev) for p in parts])

    @staticmethod
    def merge_insert(res: InsertResult) -> InsertResult:
        return res

    @staticmethod
    def merge_values(out, found):
        return out, found

    @staticmethod
    def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        return t

    @staticmethod
    def gather_rows(rows: np.ndarray) -> np.ndarray:
        return rows

    def report(self) -> None:
        return None


class _DistExchange:
    """The collectives of a multi-process grid on torch.distributed.

    Each process holds `per` shards (`mine`, contiguous in the
    process-major grid) and routes its own source slices of the full
    batch. The all_to_all is one `all_to_all_single` over the stacked
    bucket buffers, laid out [destination][local source] so that each
    destination receives its buckets in source-major order (JAX's
    order, which dedupe-last-wins depends on); the reverse exchange is
    the same with the roles swapped. psum / pmax are SUM / MAX
    all-reduces, the unsigned pmin a MIN of the words widened to int64,
    and a host verb's result is the all-gather of every process's source
    slices, so every process returns the full result. Under gloo a CUDA
    tensor crosses through a pinned host buffer; under NCCL the tensors
    stay on the card. `calls`, `bytes` (this process's sends) and
    `seconds` (each collective's wall with its staging, between two
    device syncs) account the exchange."""

    def __init__(self, mesh: Mesh, layout: _Layout):
        import torch.distributed as dist

        self._dist = dist
        n = mesh.devices.shape[0]
        owners = mesh.owners.reshape(n, -1)
        if (owners != owners[:, :1]).any():
            # JAX's shard_map runs such a grid (XLA joins the lanes over
            # the network); here a shard's lanes merge and repair inside
            # the one process that holds all of them
            raise MultihostUnsupportedError(
                "every replica lane of a shard must live in one process")
        self.world = layout.world
        self.mine = [s for s in range(n) if owners[s, 0] == layout.rank]
        self.per = len(self.mine)
        self.dev = mesh.devices.reshape(n, -1)[self.mine[0], 0]
        self.staged = layout.backend == "gloo" and self.dev.type == "cuda"
        self.calls = self.bytes = 0
        self.seconds = 0.0

    def _run(self, collective, t: torch.Tensor, out_shape) -> torch.Tensor:
        """`collective(out, inp)` on `t` (a tensor on `self.dev`) into a
        fresh tensor of `out_shape` on `self.dev`."""
        # time the collective, not the queue
        profiler.block_ready(self.dev)
        t0 = time.perf_counter()
        flag = t.dtype == torch.bool  # carried as bytes
        if flag:
            t = t.to(torch.uint8)
        if self.staged:
            inp = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            inp.copy_(t)
            out = torch.empty(out_shape, dtype=t.dtype, pin_memory=True)
        else:
            inp = t.contiguous()
            out = torch.empty(out_shape, dtype=t.dtype, device=t.device)
        collective(out, inp)
        out = out.to(self.dev)
        profiler.block_ready(self.dev)
        self.calls += 1
        self.bytes += inp.numel() * inp.element_size()
        self.seconds += time.perf_counter() - t0
        return out.bool() if flag else out

    def _a2a(self, stacked: torch.Tensor) -> torch.Tensor:
        return self._run(self._dist.all_to_all_single, stacked,
                         stacked.shape)

    def to_owner(self, bufs: list, devs: list, c_pair: int) -> list:
        n, p = self.per * self.world, self.per
        rest = bufs[0].shape[1:]
        send = torch.stack([b.to(self.dev).view(n, c_pair, *rest)
                            for b in bufs], dim=1)  # [dest, source, c]
        recv = self._a2a(send).view(self.world, p, p, c_pair, *rest)
        return [recv[:, j].reshape(n * c_pair, *rest).to(devs[d])
                for j, d in enumerate(self.mine)]

    def to_source(self, outs: list, devs: list, c_pair: int) -> list:
        return self.to_owner(outs, devs, c_pair)  # the same permutation

    def full(self, parts: list, dev) -> torch.Tensor:
        loc = torch.cat([x.to(self.dev) for x in parts])
        out = self._run(self._all_gather, loc,
                        (self.world * loc.shape[0], *loc.shape[1:]))
        return out.to(dev)

    def _all_gather(self, out, inp):
        self._dist.all_gather(list(out.chunk(self.world)), inp)

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """SUM / MAX / MIN of `t` over every process (the local shards
        are merged already)."""
        red = {"sum": self._dist.ReduceOp.SUM, "max": self._dist.ReduceOp.MAX,
               "min": self._dist.ReduceOp.MIN}[op]

        def all_reduce(out, inp):
            out.copy_(inp)
            self._dist.all_reduce(out, op=red)

        dev = t.device
        return self._run(all_reduce, t.to(self.dev), t.shape).to(dev)

    def umin(self, words: torch.Tensor) -> torch.Tensor:
        """pmin of u32 words (unsigned: all-ones is the largest)."""
        return u32.narrow(self.reduce(u32.widen(words), "min"))

    def merge_insert(self, res: InsertResult) -> InsertResult:
        return InsertResult(
            slots=self.reduce(res.slots, "max"),
            evicted=self.umin(res.evicted),
            dropped=self.reduce(res.dropped, "max"),
            fresh=self.reduce(res.fresh, "max"),
            evicted_vals=self.umin(res.evicted_vals))

    def merge_values(self, out, found):
        return (u32.narrow(self.reduce(u32.widen(out), "sum")),
                self.reduce(found, "max"))

    def gather_rows(self, rows: np.ndarray) -> np.ndarray:
        """Host rows of the local shards -> every shard's rows."""
        t = torch.from_numpy(np.ascontiguousarray(rows, np.int64))
        out = self.full([t.to(self.dev)], "cpu").numpy()
        return out.astype(rows.dtype)

    def gather_ragged(self, rows: np.ndarray) -> np.ndarray:
        """Host rows, as many as each process has -> every process's rows
        in rank order (the lengths first, then one padded gather)."""
        k = self.gather_rows(np.array([len(rows)], np.int64))
        pad = np.zeros((max(int(k.max()), 1), *rows.shape[1:]), np.int64)
        pad[:len(rows)] = rows
        got = self.gather_rows(pad).reshape(self.world, *pad.shape)
        return np.concatenate([got[p, :k[p]] for p in range(self.world)]
                              ).astype(rows.dtype)

    def report(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "seconds": self.seconds}


class PlaneHandle:
    """One launched plane phase: the results on the devices plus the host
    read-back that reorders them to request order. `fetch()` copies to
    the host (CUDA work is asynchronous: the device time is paid there).
    `counts` is the per-shard routed-op vector (which shards this phase
    touched). `t_launch_ns` stamps the dispatch and `events` is the
    phase's CUDA event pair (None unless a profiler records one), both
    for the device-time profiler (`runtime/profiler.py`)."""

    __slots__ = ("_fetch", "b", "counts", "t_launch_ns", "events")

    def __init__(self, fetch, b: int, counts=None, events=None):
        self._fetch = fetch
        self.b = b
        self.counts = counts
        self.t_launch_ns = time.monotonic_ns()
        self.events = events

    def fetch(self):
        return self._fetch()


class PlaneGets:
    """One fetched GET phase: request-order found mask over ROUTED-LANE
    page storage. `hit_rows(lo, hi)` gathers exactly the hit rows of a
    reply slice out of the routed buffer; `dense()` builds the full
    request-order matrix only when asked."""

    __slots__ = ("found", "_rb", "_routed", "lane_served", "lane_refused")

    def __init__(self, rb: pt.RoutedBatch, routed_pages, found,
                 lane_served=None, lane_refused=None):
        self.found = found          # bool[b], request order
        self._rb = rb
        self._routed = routed_pages  # [n*wl, W] routed-lane order
        # per-replica-lane attribution of THIS phase (2-D grids only)
        self.lane_served = lane_served    # int64[R] | None
        self.lane_refused = lane_refused  # int64[R] | None

    def hit_rows(self, lo: int = 0, hi: int | None = None) -> np.ndarray:
        """Contiguous page rows for the HIT requests in [lo, hi)."""
        hi = len(self.found) if hi is None else hi
        sel = self._rb.pos[lo:hi][self.found[lo:hi]]
        return np.ascontiguousarray(np.asarray(self._routed)[sel], np.uint32)

    def dense(self) -> np.ndarray:
        """Full request-order [b, W] matrix (read the found mask before
        trusting a row)."""
        return self._rb.scatter(np.asarray(self._routed))


class PlaneFastView:
    """The one-sided fast lane over a 1-D plane: a handle on the live
    per-shard pools at directory epoch `epoch` and mutation sequence
    `seq`. A read is one call under `ShardedKV._lock` (`read`): check the
    epoch, compare each lane's stored digest on its shard's device (tiered:
    and the row's liveness), gather only the validated rows, copy them to
    the host — the per-shard form of `kv.FastView`."""

    __slots__ = ("epoch", "seq", "_skv")

    def __init__(self, skv: "ShardedKV", epoch: int, seq: int):
        self._skv = skv
        self.epoch = epoch
        self.seq = seq

    # caller-holds: ShardedKV._lock
    def _lanes(self, epoch: int, shards, rows, digs):
        """-> (ok bool[N] host, [(shard, lane idx, device rows, device ok)])."""
        skv = self._skv
        shards = np.asarray(shards, np.uint32)
        rows = np.asarray(rows, np.uint32)
        digs = np.asarray(digs, np.uint32)
        ok = np.zeros(len(rows), bool)
        parts = []
        if epoch != skv.dir_epoch:
            return ok, parts
        for s in np.unique(shards):
            s = int(s)
            if s >= skv.n_shards:
                continue
            st = skv._st[s][0]
            pool = st.pool
            dev = skv._dev[s][0]
            idx = np.flatnonzero(shards == s)
            r_h = rows[idx]
            inr = r_h < pool.sums.shape[0]
            with _on(dev):
                r = torch.from_numpy(np.where(inr, r_h, 0).astype(np.int64)
                                     ).to(dev)
                d = torch.from_numpy(digs[idx].view(np.int32)).to(dev)
                ok_d = torch.from_numpy(inr).to(dev) & (pool.sums[r] == d)
                if kv_mod._tiered(st):
                    ok_d = ok_d & tier_mod.row_live(pool, r)
                ok_h = ok_d.cpu().numpy()
            ok[idx] = ok_h
            parts.append((s, idx, r, ok_d))
        return ok, parts

    def read(self, epoch: int, shards, rows, digs):
        """One validated read -> (ok[N] bool, pages[nok, W] uint32 of the
        ok lanes in lane order, the plane's current epoch), atomic
        against every mutating verb."""
        skv = self._skv
        with skv._lock:
            ok, parts = self._lanes(epoch, shards, rows, digs)
            out = np.zeros((int(ok.sum()), skv.config.page_words), np.uint32)
            at = np.cumsum(ok) - 1
            for s, idx, r, ok_d in parts:
                with _on(skv._dev[s][0]):
                    pages = u32.to_numpy(skv._st[s][0].pool.pages[r[ok_d]])
                out[at[idx[ok[idx]]]] = pages
            return ok, out, skv.dir_epoch

    def validate(self, epoch: int, shards, rows, digs) -> np.ndarray:
        """ok[N] alone (the JAX view's `validate`); a server calls
        `read`."""
        with self._skv._lock:
            return self._lanes(epoch, shards, rows, digs)[0]


class PlaneHostView:
    """The fast lane over a plane that spans processes: JAX's host mirror
    (`kv.FastView` with a leading shard axis) of every shard's `pages`
    `[S, R, W]`, `sums` `[S, R]` and, tiered, row liveness `live`
    `[S, R]`, taken by one gather in `ShardedKV.fast_view` at directory
    epoch `epoch` and mutation sequence `seq`. A reader thread cannot
    join a collective, so a read touches only this mirror: it serves the
    bytes of that sequence point, and `fast_view()` mirrors again after
    a mutation."""

    __slots__ = ("epoch", "seq", "pages", "sums", "live")

    def __init__(self, epoch: int, seq: int, pages: np.ndarray,
                 sums: np.ndarray, live: np.ndarray | None):
        self.epoch = epoch
        self.seq = seq
        self.pages = pages
        self.sums = sums
        self.live = live

    def validate(self, epoch: int, shards, rows, digs) -> np.ndarray:
        """ok[N]: the (shard, row) is in range, live, and its stored
        digest equals the client's; a stale epoch fails every lane."""
        shards = np.asarray(shards, np.uint32)
        rows = np.asarray(rows, np.uint32)
        if epoch != self.epoch:
            return np.zeros(len(rows), bool)
        ns, nr = self.sums.shape
        ok = (shards < ns) & (rows < nr)
        s = np.where(ok, shards, 0).astype(np.int64)
        r = np.where(ok, rows, 0).astype(np.int64)
        ok &= self.sums[s, r] == np.asarray(digs, np.uint32)
        if self.live is not None:
            ok &= self.live[s, r]
        return ok

    def read(self, epoch: int, shards, rows, digs):
        """One validated read -> (ok[N] bool, pages[nok, W] uint32 of the
        ok lanes in lane order, the mirror's epoch)."""
        ok = self.validate(epoch, shards, rows, digs)
        s = np.asarray(shards, np.int64)[ok]
        r = np.asarray(rows, np.int64)[ok]
        return ok, self.pages[s, r], self.epoch


class _StackedLeaves:
    """The plane's state as `checkpoint`'s writers read it: every leaf
    stacked `[n_shards, ...]` (lane 0's copy on a 2-D grid), each shard's
    leaf crossing to the host once; a delta's dirty rows (the flat row
    space, shard axis folded into the rows) are gathered on each shard's
    own device. `stats` is the folded leaf `save` passes in."""

    def __init__(self, skv: "ShardedKV", stats: np.ndarray):
        self._per = [ckpt_mod.StateLeaves(skv._st[s][0])
                     for s in range(skv.n_shards)]
        self.names = self._per[0].names
        self._stats = stats

    def shape(self, i: int) -> tuple:
        return (len(self._per),) + self._per[0].shape(i)

    def host(self, i: int) -> np.ndarray:
        if self.names[i] == "stats":
            return self._stats
        first = self._per[0].host(i)
        out = np.empty((len(self._per),) + first.shape, first.dtype)
        out[0] = first
        del first
        for s in range(1, len(self._per)):
            out[s] = self._per[s].host(i)
        return out

    def gather_rows(self, i: int, rows: np.ndarray) -> np.ndarray:
        shape = self._per[0].shape(i)
        per = int(np.prod(shape[:-1]))
        parts = []
        for s, src in enumerate(self._per):
            sel = rows[(rows >= s * per) & (rows < (s + 1) * per)]
            parts.append(src.gather_rows(i, sel - s * per))
        return np.concatenate(parts) if parts else np.zeros(
            (0, shape[-1]), np.uint32)


class ShardedKV:
    """`kv.KV`-shaped host API over state sharded on a device grid.

    `self._st[s][r]` is the `KVState` of shard s, replica lane r (r = 0
    on a 1-D grid), on device `self._dev[s][r]`; every lane is its own
    allocation. Batches in and results out are numpy (u32 words as
    uint32), as the JAX `ShardedKV`'s are."""

    def __init__(self, config: KVConfig | None = None, mesh: Mesh | None = None,
                 dispatch: str = "a2a", lrfu_stats: bool = False,
                 plane_pad_floor: int = 8, axis_rules=None, states=None):
        """`states` (optional) is `states[s][r]` to serve from, e.g.
        `carry.sharded_from_numpy` of a JAX plane's leaves; by default
        every lane starts from `kv.init` on its device. On a grid that
        spans processes it holds the shards this process owns; the other
        entries are not read (None)."""
        if dispatch not in ("a2a", "broadcast"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        self.config = config or KVConfig()
        self.mesh = mesh or make_mesh()
        if AXIS not in self.mesh.axis_names:
            raise ValueError(
                f"mesh axes {tuple(self.mesh.axis_names)} lack the "
                f"{AXIS!r} axis")
        shape = self.mesh.shape
        self.n_shards = shape[AXIS]
        # replica lanes (2-D grid). Tiered pools are refused: tier
        # placement keys off the per-lane found mask, so a damaged lane's
        # hot/cold layout would drift for good.
        self.n_replicas = shape.get(RAXIS, 1)
        if self.n_replicas > 1 and \
                kv_mod._tier_cfg_at_init(self.config) is not None:
            raise ValueError(
                "the 2-D replica plane does not compose with the tiered "
                "pool yet — run the tier on a 1-D mesh (host ReplicaGroup "
                "replication) or drop tier= from the KVConfig")
        self.dispatch = dispatch
        # the fused/composed GET decision, made at the first GET as
        # `kv.KV._fused_on` makes it
        self._fused: bool | None = None
        self._batches_since_touch = 0
        # the exchange and the shards this process holds: every shard on
        # one process, or this process's own on a multi-process grid
        if self.mesh.owners is None:
            self._xch = _LocalExchange(self.n_shards)
        else:
            if _LAYOUT is None:
                raise MultihostError("a multi-process grid needs the process "
                                     "group of connect_multihost")
            self._xch = _DistExchange(self.mesh, _LAYOUT)
        self._mine = self._xch.mine
        # logical-axis rules -> placement, validated against the live grid:
        # every leaf splits over `kv` only and is replicated along the
        # lanes, so each shard (each lane) holds one whole KVState
        self._rules = pt.rules_for_mesh(self.mesh, axis_rules)
        pt.validate_rules(self._rules, self.mesh)
        pt.placement(self.config, self._rules)
        devs = self.mesh.devices.reshape(self.n_shards, self.n_replicas)
        self._dev = [[devs[s, r] for r in range(self.n_replicas)]
                     for s in range(self.n_shards)]
        self.device = self._dev[self._mine[0]][0]
        # the one CUDA device every shard and lane of this process names,
        # else None: only then does a plane verb record a device-time
        # event pair (over the programs this process runs)
        one = {d for s in self._mine for d in self._dev[s]}
        self._event_dev = (self.device if len(one) == 1
                           and self.device.type == "cuda" else None)
        self._router = pt.ShardRouter(self.n_shards,
                                      pad_floor=plane_pad_floor)
        # host stats plane of the read-only GETs and the host overlays
        self._plane_stats = np.zeros((self.n_shards, NSTATS), np.int64)
        # per-replica-lane totals (served / digest_refused / repaired)
        self._lane_stats = np.zeros((self.n_replicas, 3), np.int64)
        # per-shard LRFU load plane (`server/CCEH_hybrid.h:202-206`):
        # atime = last batch tick that routed work to the shard, crf =
        # decayed combined recency-frequency, freq = requests routed
        self.lrfu_stats = lrfu_stats
        self.lrfu_lambda = 0.1
        self._lrfu = np.zeros((self.n_shards, 2))  # [atime, crf]
        self._freq = np.zeros((self.n_shards,), np.int64)
        self._lrfu_tick = 0
        self._st = (self._init_states() if states is None else
                    [states[s] if s in self._mine else None
                     for s in range(self.n_shards)])
        self._tiered = isinstance(self._st[self._mine[0]][0].pool,
                                  tier_mod.TierState)
        from pmdfc_tpu_torch.runtime import sanitizer as san

        # serializes every verb against the others and against readers
        # (stats, save, the fast lane): the state is updated in place
        # guarded-by: _st, _lrfu, _freq, _lrfu_tick,
        # guarded-by: _batches_since_touch, _plane_stats, _lane_stats,
        # guarded-by: dir_epoch, _mut_seq, _fastview, _chain, _fused
        self._lock = san.rlock("ShardedKV._lock")
        # one-sided fast-path surface (same contract as kv.KV)
        self.dir_epoch = int.from_bytes(os.urandom(4), "little") | 1
        self._mut_seq = 0
        self._fastview = None
        # incremental-snapshot chain cursor over the FLAT row space
        self._chain: dict | None = None

    def _init_states(self) -> list:
        mine = set(self._mine)
        return [[kv_mod.init(self.config, self._dev[s][r])
                 for r in range(self.n_replicas)] if s in mine else None
                for s in range(self.n_shards)]

    @property
    def states(self) -> list:
        """Lane 0's `KVState` of every shard this process holds (every
        shard, unless the grid spans processes)."""
        return [self._st[s][0] for s in self._mine]

    def _one_process(self, verb: str) -> None:
        """Refuse a verb the multi-process grid does not run."""
        if self.mesh.owners is not None:
            raise MultihostUnsupportedError(
                f"ShardedKV.{verb} does not run on a multi-process grid")

    def exchange_report(self) -> dict | None:
        """A multi-process grid's exchange so far (collectives, bytes this
        process sent, seconds); None on one process."""
        return self._xch.report()

    def _on_device(self):
        """Enter the grid's first device (a server thread's default);
        every per-shard program enters its own device as well."""
        return _on(self.device)

    # caller-holds: _lock
    def _lrfu_touch(self, keys: np.ndarray) -> None:
        """Fold one routed batch into the per-shard LRFU plane (no-op
        unless `lrfu_stats`)."""
        if not self.lrfu_stats:
            return
        self._lrfu_tick += 1
        counts = np.bincount(self.node_of(keys), minlength=self.n_shards)
        touched = counts > 0
        dt = self._lrfu_tick - self._lrfu[:, 0]
        decay = np.power(0.5, self.lrfu_lambda * dt)
        self._lrfu[:, 1] = np.where(
            touched, self._lrfu[:, 1] * decay + counts, self._lrfu[:, 1])
        self._lrfu[:, 0] = np.where(touched, self._lrfu_tick,
                                    self._lrfu[:, 0])
        self._freq += counts

    # caller-holds: _lock
    def _touch_due(self) -> bool:
        """Sampled hotness cadence, `kv.KV._touch_due`'s contract."""
        every = self.config.index.touch_sample_every
        if get_index_ops(self.config.index.kind).touch is None \
                and not self._tiered:
            return False
        if every <= 1:
            return True
        self._batches_since_touch += 1
        if self._batches_since_touch >= every:
            self._batches_since_touch = 0
            return True
        return False

    # caller-holds: _lock
    def _fused_on(self) -> bool:
        """Whether the plane's GETs take the fused route, resolved once
        (`fused_ops.resolve`, which publishes it)."""
        if self._fused is None:
            self._fused = kv_mod.fused_ops.resolve(self.config)
        return self._fused

    def _pad(self, keys: np.ndarray, values: np.ndarray | None = None):
        """Pad to a power-of-two width >= 16, rounded up to a multiple of
        n_shards. -> (keys, values, b, w) numpy."""
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        b = len(keys)
        w = 16
        while w < b:
            w <<= 1
        w += -w % self.n_shards
        kpad = np.full((w, 2), INVALID_WORD, np.uint32)
        kpad[:b] = keys
        if values is None:
            return kpad, None, b, w
        values = np.asarray(values, np.uint32)
        vpad = np.zeros((w, values.shape[-1]), np.uint32)
        vpad[:b] = values
        return kpad, vpad, b, w

    # -- the per-lane dispatch bodies (lane r of every shard) --

    def _lane_devs(self, r: int) -> list:
        return [self._dev[s][r] for s in range(self.n_shards)]

    def _a2a(self, r: int, keys: np.ndarray, w: int, c_pair: int, program,
             values: np.ndarray | None = None):
        """One a2a step on lane r: route every source slice, exchange,
        run `program(s, keys, values)` on each owner (-> a tuple of
        tensors of n*c_pair rows), exchange back. -> (per-source (ok,
        flat, valid), per-owner results)."""
        n = self.n_shards
        bl = w // n
        devs = self._lane_devs(r)
        kb, vb, route = [], [], []
        for i in self._mine:
            with _on(devs[i]):
                k = _to_dev(keys[i * bl:(i + 1) * bl], devs[i])
                ok, flat = _route(k, n, c_pair)
                route.append((ok, flat, ~is_invalid(k)))
                kb.append(_bucket(k, flat, n, c_pair, INVALID_I32))
                if values is not None:
                    v = _to_dev(values[i * bl:(i + 1) * bl], devs[i])
                    vb.append(_bucket(v, flat, n, c_pair, 0))
        k_go = self._xch.to_owner(kb, devs, c_pair)
        v_go = (self._xch.to_owner(vb, devs, c_pair) if values is not None
                else [None] * len(k_go))
        outs = []
        for d, k, v in zip(self._mine, k_go, v_go):
            with _on(devs[d]):
                outs.append(program(d, k, v))
        return route, outs

    def _back(self, r, route, outs, field, c_pair, miss):
        backs = self._xch.to_source([o[field] for o in outs],
                                    self._lane_devs(r), c_pair)
        return _to_source(backs, [x[1] for x in route],
                          [x[0] for x in route], c_pair, miss)

    def _dev0(self, r: int) -> torch.device:
        """Where lane r's merged results land: the first shard's device
        this process holds."""
        return self._dev[self._mine[0]][r]

    def _bump_lost(self, r: int, route, **by_lane) -> None:
        """Account the bucket-overflow rows on their requesting shard."""
        for i, (ok, _, valid) in zip(self._mine, route):
            lost = (valid & ~ok).sum(dtype=torch.int32)
            st = self._st[i][r]
            for lane in by_lane.values():
                st.stats[lane] += lost

    def _insert_lane(self, r: int, keys, values, w: int) -> InsertResult:
        cfg, n = self.config, self.n_shards
        if self.dispatch == "a2a":
            c_pair = pair_capacity(w // n, n)

            def program(d, k, v):
                _, res = kv_mod.insert(self._st[d][r], cfg, k, v)
                return res

            route, outs = self._a2a(r, keys, w, c_pair, program, values)
            devs = self._lane_devs(r)
            inval2 = torch.full((1, 2), INVALID_I32, dtype=torch.int32)
            parts = {
                "slots": self._back(r, route, outs, 0, c_pair,
                                    torch.tensor(-1, dtype=torch.int32)),
                "evicted": self._back(r, route, outs, 1, c_pair, inval2),
                "dropped": self._back(r, route, outs, 2, c_pair,
                                      lambda i: route[i][2]),
                "fresh": self._back(r, route, outs, 3, c_pair,
                                    torch.tensor(False)),
                "evicted_vals": self._back(r, route, outs, 4, c_pair,
                                           inval2),
            }
            self._bump_lost(r, route, puts=PUTS, drops=DROPS)
            return InsertResult(**{f: self._xch.full(parts[f], self._dev0(r))
                                   for f in InsertResult._fields})
        res = []
        for s in self._mine:
            dev = self._dev[s][r]
            with _on(dev):
                k = _mask_to_owner(_to_dev(keys, dev), n, s)
                _, rs = kv_mod.insert(self._st[s][r], cfg, k,
                                      _to_dev(values, dev))
                res.append(rs)
        return self._xch.merge_insert(_combine_insert_result(res,
                                                             self._dev0(r)))

    def _get_lane(self, r: int, keys, w: int, lean: bool):
        cfg, n = self.config, self.n_shards
        if self.dispatch == "a2a":
            c_pair = pair_capacity(w // n, n)

            def program(d, k, _v):
                _, out, found = kv_mod.get(self._st[d][r], cfg, k, lean=lean)
                return out, found

            route, outs = self._a2a(r, keys, w, c_pair, program)
            devs = self._lane_devs(r)
            vals = self._back(r, route, outs, 0, c_pair,
                              torch.tensor(0, dtype=torch.int32))
            got = self._back(r, route, outs, 1, c_pair, torch.tensor(False))
            self._bump_lost(r, route, gets=GETS, misses=MISSES,
                            routed=MISS_ROUTED)
            return (self._xch.full(vals, self._dev0(r)),
                    self._xch.full(got, self._dev0(r)))
        outs, founds = [], []
        for s in self._mine:
            dev = self._dev[s][r]
            with _on(dev):
                k = _mask_to_owner(_to_dev(keys, dev), n, s)
                _, out, found = kv_mod.get(self._st[s][r], cfg, k, lean=lean)
                outs.append(out)
                founds.append(found)
        return self._xch.merge_values(*_combine_values(outs, founds,
                                                       self._dev0(r)))

    def _delete_lane(self, r: int, keys, w: int) -> torch.Tensor:
        cfg, n = self.config, self.n_shards
        if self.dispatch == "a2a":
            # EXACT per-pair buckets (c_pair = the full local width):
            # invalidation must be loss-free
            bl = w // n

            def program(d, k, _v):
                _, hit = kv_mod.delete(self._st[d][r], cfg, k)
                return (hit,)

            route, outs = self._a2a(r, keys, w, bl, program)
            got = self._back(r, route, outs, 0, bl, torch.tensor(False))
            return self._xch.full(got, self._dev0(r))
        hits = []
        for s in self._mine:
            dev = self._dev[s][r]
            with _on(dev):
                k = _mask_to_owner(_to_dev(keys, dev), n, s)
                hits.append(kv_mod.delete(self._st[s][r], cfg, k)[1])
        return self._xch.reduce(_gather_to(hits, self._dev0(r)).any(dim=0),
                                "max")

    # -- ops (numpy in/out, like kv.KV) --

    def insert(self, keys: np.ndarray, values: np.ndarray) -> InsertResult:
        with self._lock:
            self._lrfu_touch(keys)
            keys, values, b, w = self._pad(keys, values)
            res = [self._insert_lane(r, keys, values, w)
                   for r in range(self.n_replicas)][0]
            self._mut_seq += 1
            return InsertResult(**{f: v[:b] for f, v in
                                   _res_host(res).items()})

    def get(self, keys: np.ndarray):
        with self._lock:
            self._lrfu_touch(keys)
            keys, _, b, w = self._pad(keys)
            self._fused_on()
            lean = not self._touch_due()
            out, found = [self._get_lane(r, keys, w, lean)
                          for r in range(self.n_replicas)][0]
            return u32.to_numpy(out)[:b], found.cpu().numpy()[:b]

    def delete(self, keys: np.ndarray):
        with self._lock:
            self._lrfu_touch(keys)
            keys, _, b, w = self._pad(keys)
            hit = [self._delete_lane(r, keys, w)
                   for r in range(self.n_replicas)][0]
            self._mut_seq += 1
            self.dir_epoch += 1
            return hit.cpu().numpy()[:b]

    def insert_extent(self, key, value, length: int):
        """Replicated extent record, covers indexed by their owners. ->
        (InsertResult over the covers, uncovered tail pages)."""
        cfg, n = self.config, self.n_shards
        with self._lock:
            lanes = []
            for r in range(self.n_replicas):
                res = []
                for s in self._mine:
                    with _on(self._dev[s][r]):
                        _, rs, uncovered = kv_mod.insert_extent(
                            self._st[s][r], cfg, key, value, length,
                            shard=(n, s))
                        res.append(rs)
                lanes.append(self._xch.merge_insert(
                    _combine_insert_result(res, self._dev0(r))))
            self._mut_seq += 1
            return (InsertResult(**_res_host(lanes[0])), int(uncovered))

    def _get_extent_lane(self, r: int, keys: np.ndarray):
        """The broadcast GetExtent body on lane r: every shard probes the
        whole batch; the lowest winning cover height wins (heights are
        distinct across shards: a probe key has one owner); gets/misses
        are rewritten onto shard 0 and the global misses classified
        there; hits stay where they won."""
        cfg, xch = self.config, self._xch
        dev0 = self._dev0(r)
        per = []
        for s in self._mine:
            dev = self._dev[s][r]
            with _on(dev):
                _, out, found, height, ev = kv_mod._get_extent_impl(
                    self._st[s][r], cfg, _to_dev(keys, dev),
                    bump_causes=False)
                per.append((out, found, height, ev))
        with _on(dev0):
            k0 = _to_dev(keys, dev0)
            best = xch.reduce(_gather_to([p[2] for p in per], dev0)
                              .min(dim=0).values, "min")
            wins = [p[1].to(dev0) & (p[2].to(dev0) == best) for p in per]
            out, found = xch.merge_values(*_combine_values(
                [p[0] for p in per], wins, dev0))
            valid = ~is_invalid(k0)
            n_valid = valid.sum(dtype=torch.int32)
            global_hits = found.sum(dtype=torch.int32)
            miss_glob = valid & ~found
            ev_glob = xch.reduce(_gather_to([p[3] for p in per], dev0)
                                 .any(dim=0), "max") & miss_glob
            n_ev = ev_glob.sum(dtype=torch.int32)
            n_miss = miss_glob.sum(dtype=torch.int32)
        for j, s in enumerate(self._mine):
            dev = self._dev[s][r]
            with _on(dev):
                local_hits = per[j][1].sum(dtype=torch.int32)
                win_hits = wins[j].sum(dtype=torch.int32).to(dev)
                fix = torch.zeros(NSTATS, dtype=torch.int32, device=dev)
                if s == 0:
                    fix[MISSES] += local_hits - global_hits.to(dev)
                    fix[MISS_EVICTED] += n_ev.to(dev)
                    fix[MISS_COLD] += (n_miss - n_ev).to(dev)
                else:
                    fix[GETS] -= n_valid.to(dev)
                    fix[MISSES] += local_hits - n_valid.to(dev)
                fix[HITS] += win_hits - local_hits
                self._st[s][r].stats += fix
        return out, found

    def get_extent(self, keys: np.ndarray):
        with self._lock:
            keys, _, b, w = self._pad(keys)
            out, found = [self._get_extent_lane(r, keys)
                          for r in range(self.n_replicas)][0]
            return u32.to_numpy(out)[:b], found.cpu().numpy()[:b]

    # -- serving-plane verbs (host-routed shard-major dispatch) --

    def _routed(self, rb: pt.RoutedBatch, s: int, dev):
        """Shard s's routed keys, on `dev`."""
        return _to_dev(rb.keys[s * rb.wl:(s + 1) * rb.wl], dev)

    # caller-holds: _lock
    def _all_shards(self, parts: list) -> list:
        """One tensor per shard this process holds (each of one shape) ->
        one per shard of the grid: the list itself on one process, an
        all-gather on a grid that spans processes (JAX's `_fetch`: every
        process gets the full result)."""
        if self.mesh.owners is None:
            return parts
        return list(self._xch.full(parts, self.device).chunk(self.n_shards))

    def plane_insert(self, keys: np.ndarray,
                     values: np.ndarray) -> PlaneHandle:
        with self._lock:
            self._lrfu_touch(keys)
            # the router places the keys; each shard's values cross to its
            # device as its own live rows only, padded there with zeros
            # (a skewed batch would otherwise build and copy n_shards x the
            # widest shard's pages on the host)
            rb = self._router.build(keys)
            if rb.b == 0:
                return PlaneHandle(lambda: None, 0, rb.counts)
            values = np.asarray(values, np.uint32).reshape(rb.b, -1)
            live = np.argsort(rb.pos, kind="stable")  # routed-lane order
            bounds = np.concatenate([[0], np.cumsum(rb.counts)])
            ev = profiler.launch_begin(self._event_dev)
            res = []
            for s in self._mine:
                idx = live[bounds[s]:bounds[s + 1]]
                if not len(idx) and not self._tiered:
                    # nothing routed here: an all-INVALID insert changes
                    # nothing on a flat pool (a tiered one may balloon),
                    # and no request reads this shard's lanes back
                    res.append(_unrouted(rb.wl, self._dev[s][0]))
                    continue
                for r in range(self.n_replicas):
                    # one call writes every replica lane; lane 0 speaks
                    # for the plane (results are lane-identical)
                    dev = self._dev[s][r]
                    with _on(dev):
                        vals = torch.zeros((rb.wl, values.shape[1]),
                                           dtype=torch.int32, device=dev)
                        vals[:len(idx)] = _to_dev(values[idx], dev)
                        _, rs = kv_mod.insert(
                            self._st[s][r], self.config,
                            self._routed(rb, s, dev), vals)
                    if r == 0:
                        res.append(rs)
            profiler.launch_end(ev, self._event_dev)
            # every process joins the gather, a skipped shard too
            res = [InsertResult(*f) for f in zip(*(
                self._all_shards([getattr(x, f) for x in res])
                for f in InsertResult._fields))]
            self._mut_seq += 1

        def fetch():
            host = [_res_host(x) for x in res]
            return InsertResult(**{
                f: rb.scatter(np.concatenate([h[f] for h in host]))
                for f in InsertResult._fields})

        return PlaneHandle(fetch, rb.b, rb.counts, ev)

    # caller-holds: _lock
    def _get_one(self, s: int, r: int, keys, counting: bool):
        """One lane's GET on its own routed rows -> (out, found, delta):
        the stats the GET bumped land in a fresh vector (`delta`) and
        never in the state's leaf."""
        st = self._st[s][r]
        scratch = dataclasses.replace(st, stats=torch.zeros_like(st.stats))
        _, out, found = kv_mod.get(scratch, self.config, keys,
                                   lean=not counting)
        return out, found, scratch.stats

    def plane_get(self, keys: np.ndarray) -> PlaneHandle:
        with self._lock:
            self._lrfu_touch(keys)
            rb = self._router.build(keys)
            if rb.b == 0:
                vw = self.config.page_words if self.config.paged else 2
                empty = PlaneGets(rb, np.zeros((0, vw), np.uint32),
                                  np.zeros(0, bool))
                return PlaneHandle(lambda: empty, 0, rb.counts)
            return self._plane_get(rb, self._touch_due())

    # caller-holds: _lock
    def _plane_get(self, rb: pt.RoutedBatch, counting: bool) -> PlaneHandle:
        outs, founds, deltas, lanes = [], [], [], []
        nrep = self.n_replicas
        if self._fused_on():
            # the bytes of a shard this process holds (shard 0 may not be)
            profiler.cost_probe(
                "plane.get", rb.wl,
                lambda: self.n_shards * kv_mod.fused_ops.hit_bytes(
                    self._st[self._mine[0]][0], rb.wl))
        ev = profiler.launch_begin(self._event_dev)
        for s in self._mine:
            per = []
            for r in range(nrep):
                dev = self._dev[s][r]
                with _on(dev):
                    per.append(self._get_one(s, r, self._routed(rb, s, dev),
                                             counting))
            dev0 = self._dev[s][0]
            with _on(dev0):
                if nrep == 1:
                    out, found, delta = per[0]
                else:
                    out, found, delta, lane = self._replica_merge(per, dev0)
                    lanes.append(lane)
            if counting:
                # the counting path writes its stats on the device: the
                # canonical delta on every lane (lane-identical leaves)
                for r in range(nrep):
                    with _on(self._dev[s][r]):
                        self._st[s][r].stats += delta.to(self._dev[s][r])
                delta = None
            outs.append(out)
            founds.append(found)
            deltas.append(delta)
        profiler.launch_end(ev, self._event_dev)
        outs, founds = self._all_shards(outs), self._all_shards(founds)
        if not counting:  # the global delta, folded once at the fetch
            deltas = self._all_shards(deltas)
        if lanes:
            lanes = self._all_shards(lanes)

        def fetch():
            f_routed = np.concatenate([f.cpu().numpy() for f in founds])
            if not counting:
                self._plane_note_get(np.stack(
                    [d.cpu().numpy() for d in deltas]))
            ls = lr = None
            if lanes:
                lm = np.stack([x.cpu().numpy() for x in lanes]
                              ).astype(np.int64)
                ls = lm[..., 0].sum(axis=0)  # served per lane
                lr = lm[..., 1].sum(axis=0)  # digest refusals per lane
                self._note_lanes(ls, lr)
            routed = np.concatenate([u32.to_numpy(o) for o in outs])
            return PlaneGets(rb, routed, rb.scatter(f_routed), ls, lr)

        return PlaneHandle(fetch, rb.b, rb.counts, ev)

    @staticmethod
    def _replica_merge(per: list, dev0):
        """First-validated-lane-wins arbitration of one shard's lanes ->
        (out, found, canonical delta, lane[R, 2] = (served, refused)).
        The canonical delta is lane 0's with every rescued key (missed on
        lane 0, served by another: always a digest refusal, since every
        lane holds the same control state) turned from miss_digest into
        a hit."""
        nrep = len(per)
        f = torch.stack([p[1].to(dev0) for p in per])          # [R, wl]
        rr = torch.arange(nrep, device=dev0)[:, None]
        winner = torch.where(f, rr, nrep).min(dim=0).values
        wins = f & (rr == winner)
        outs = torch.stack([p[0].to(dev0) for p in per])        # [R, wl, W]
        out = u32.narrow(u32.widen(torch.where(wins[..., None], outs, 0))
                         .sum(dim=0))
        found = f.any(dim=0)
        rescued = (found & ~f[0]).sum(dtype=torch.int32)
        canon = per[0][2].to(dev0).clone()
        canon[HITS] += rescued
        canon[MISSES] -= rescued
        canon[MISS_DIGEST] -= rescued
        lane = torch.stack([
            torch.stack([wins[r].sum(dtype=torch.int32),
                         per[r][2][MISS_DIGEST].to(dev0)])
            for r in range(nrep)])
        return out, found, canon, lane

    def plane_warm_get(self, keys: np.ndarray) -> None:
        """Run BOTH GET programs (read-only and counting) at this batch's
        routed width without advancing the sampled touch cadence: the
        kernel is built at its first launch, and a build or launch
        failure then raises here. The read-only delta is not folded and
        no lane attribution is noted (warmup is not traffic)."""
        with self._lock:
            rb = self._router.build(keys)
            # warmup syncs are sanctioned and unattributed: the handles
            # (and their event pairs) are dropped unread
            self._plane_get(rb, False)
            self._sync()
            if get_index_ops(self.config.index.kind).touch is not None \
                    or self._tiered:
                self._plane_get(rb, True)
                self._sync()

    def plane_delete(self, keys: np.ndarray) -> PlaneHandle:
        with self._lock:
            self._lrfu_touch(keys)
            rb = self._router.build(keys)
            if rb.b == 0:
                return PlaneHandle(lambda: np.zeros(0, bool), 0, rb.counts)
            ev = profiler.launch_begin(self._event_dev)
            hits = []
            for s in self._mine:
                if not rb.counts[s]:
                    # an all-INVALID delete changes nothing on any pool
                    hits.append(torch.zeros(rb.wl, dtype=torch.bool,
                                            device=self._dev[s][0]))
                    continue
                per = []
                for r in range(self.n_replicas):
                    # loss-free on every lane: no lane can keep a value
                    # the tombstone missed
                    dev = self._dev[s][r]
                    with _on(dev):
                        per.append(kv_mod.delete(self._st[s][r], self.config,
                                                 self._routed(rb, s, dev))[1])
                hits.append(_gather_to(per, self._dev[s][0]).any(dim=0))
            profiler.launch_end(ev, self._event_dev)
            hits = self._all_shards(hits)
            self._mut_seq += 1
            self.dir_epoch += 1

        def fetch():
            return rb.scatter(np.concatenate([h.cpu().numpy()
                                              for h in hits]))

        return PlaneHandle(fetch, rb.b, rb.counts, ev)

    def plane_get_extent(self, keys: np.ndarray) -> PlaneHandle:
        """Extent covers are replicated, so this phase is the broadcast
        body (counts=None: every shard probes the whole batch)."""
        with self._lock:
            keys_p, _, b, w = self._pad(keys)
            ev = profiler.launch_begin(self._event_dev)
            out, found = [self._get_extent_lane(r, keys_p)
                          for r in range(self.n_replicas)][0]
            profiler.launch_end(ev, self._event_dev)

        def fetch():
            return u32.to_numpy(out)[:b], found.cpu().numpy()[:b]

        return PlaneHandle(fetch, b, None, ev)

    def _plane_note_get(self, delta: np.ndarray) -> None:
        """Fold one read-only GET's per-shard stats delta ([n, NSTATS])
        into `_plane_stats`."""
        with self._lock:
            self._plane_stats += np.asarray(delta, np.int64)

    def _note_lanes(self, served, refused, repaired=None) -> None:
        with self._lock:
            self._lane_stats[:, 0] += np.asarray(served, np.int64)
            self._lane_stats[:, 1] += np.asarray(refused, np.int64)
            if repaired is not None:
                self._lane_stats[:, 2] += np.asarray(repaired, np.int64)

    def replica_report(self) -> dict | None:
        """Per-replica-lane totals (None on 1-D grids): rows each lane
        served, rows its digest gate refused, rows repaired onto it."""
        if self.n_replicas <= 1:
            return None
        with self._lock:
            ls = self._lane_stats.copy()
        return {
            "n_replicas": self.n_replicas,
            "served": [int(x) for x in ls[:, 0]],
            "digest_refused": [int(x) for x in ls[:, 1]],
            "repaired": [int(x) for x in ls[:, 2]],
        }

    # caller-holds: _lock
    def _digest_ok(self, st) -> torch.Tensor:
        """bool[rows]: each pool row's bytes match its digest sidecar,
        digested `_DIGEST_CHUNK` rows at a time."""
        pool = st.pool
        nr = pool.sums.shape[0]
        ok = torch.empty(nr, dtype=torch.bool, device=pool.sums.device)
        for i in range(0, nr, _DIGEST_CHUNK):
            j = min(i + _DIGEST_CHUNK, nr)
            ok[i:j] = pagepool.page_digest(pool.pages[i:j]) == pool.sums[i:j]
        return ok

    def replica_repair(self) -> int:
        """Anti-entropy over the replica axis: every pool row whose bytes
        fail their digest on some lane but validate on another gets the
        lowest validating lane's bytes. -> rows repaired across all lanes;
        0 on 1-D grids and unpaged state.

        Each lane is its own allocation, and a donor row is never written:
        a row is repaired only on lanes where it fails its digest, and it
        is read only from a lane where it validates. Every donor chunk is
        gathered before the chunk is written."""
        if self.n_replicas <= 1 or not self.config.paged:
            return 0
        nrep = self.n_replicas
        per = np.zeros(nrep, np.int64)
        with self._lock:
            for s in self._mine:
                dev0 = self._dev[s][0]
                oks = []
                for r in range(nrep):
                    with _on(self._dev[s][r]):
                        oks.append(self._digest_ok(self._st[s][r]))
                with _on(dev0):
                    ok = _gather_to(oks, dev0)                # [R, rows]
                    rr = torch.arange(nrep, device=dev0)[:, None]
                    donor = torch.where(ok, rr, nrep).min(dim=0).values
                    need = ~ok & (donor < nrep)
                for r in range(nrep):
                    idx = torch.nonzero(need[r]).squeeze(1)
                    per[r] += int(idx.numel())
                    dst = self._dev[s][r]
                    for i in range(0, idx.numel(), _DIGEST_CHUNK):
                        rows = idx[i:i + _DIGEST_CHUNK]
                        dn = donor[rows]
                        got = []
                        for d in range(nrep):
                            sel = rows[dn == d]
                            if sel.numel():
                                src = self._dev[s][d]
                                with _on(src):
                                    got.append((sel.to(dst), self._st[s][d]
                                                .pool.pages[sel.to(src)]
                                                .to(dst)))
                        with _on(dst):
                            pages = self._st[s][r].pool.pages
                            for sel, rows_d in got:
                                pages[sel] = rows_d
            per = self._xch.gather_rows(per[None]).sum(axis=0)
            zero = np.zeros_like(per)
            self._note_lanes(zero, zero, per)
            self._mut_seq += 1
        return int(per.sum())

    def corrupt_replica_lane(self, lane: int) -> None:
        """Seeded fault injection for drills ONLY: XOR every pool page word
        on one replica lane (digests untouched, so the lane's rows stop
        validating and the hedged read must route around it)."""
        if self.n_replicas <= 1 or not self.config.paged:
            raise ValueError(
                "corrupt_replica_lane needs a paged 2-D replica plane")
        if not 0 <= lane < self.n_replicas:
            raise ValueError(f"lane {lane} not in [0, {self.n_replicas})")
        with self._lock:
            for s in self._mine:
                with _on(self._dev[s][lane]):
                    self._st[s][lane].pool.pages ^= 0x5A5A5A5A
            self._mut_seq += 1

    # -- scans / maintenance --

    def find_anyway(self, keys: np.ndarray):
        """Full-table scan across every shard (ref `FindAnyway`,
        `server/IKV.h:18`). -> (vals, found, slot, shard)."""
        with self._lock:
            keys, _, b, w = self._pad(keys)
            dev0 = self._dev0(0)
            vals, founds, slots, shards = [], [], [], []
            for s in self._mine:
                dev = self._dev[s][0]
                with _on(dev):
                    v, f, sl = kv_mod.find_anyway(self._st[s][0], self.config,
                                                  _to_dev(keys, dev))
                    vals.append(v)
                    founds.append(f)
                    slots.append(sl)
                    shards.append(torch.where(f, s, -1).to(torch.int32))
            with _on(dev0):
                v, f = self._xch.merge_values(*_combine_values(vals, founds,
                                                               dev0))
                slot = self._xch.reduce(_gather_to(slots, dev0)
                                        .max(dim=0).values, "max")
                sh = self._xch.reduce(_gather_to(shards, dev0)
                                      .max(dim=0).values, "max")
            return (u32.to_numpy(v)[:b], f.cpu().numpy()[:b],
                    slot.cpu().numpy()[:b], sh.cpu().numpy()[:b])

    # caller-holds: _lock
    def _occupancy(self) -> np.ndarray:
        ops = get_index_ops(self.config.index.kind)
        occ = []
        for s in self._mine:
            with _on(self._dev[s][0]):
                flat_keys, _ = ops.scan(self._st[s][0].index)
                occ.append(int((~is_invalid(flat_keys)).sum()))
        return self._xch.gather_rows(np.asarray(occ, np.int32))

    def utilization(self) -> float:
        with self._lock:
            return float(self._occupancy().sum() / self.capacity())

    def recovery(self) -> bool:
        """Per-shard post-restart repair (ref `CCEH::Recovery`)."""
        ops = get_index_ops(self.config.index.kind)
        with self._lock:
            if ops.recovery is not None:
                for s in self._mine:
                    for r in range(self.n_replicas):
                        with _on(self._dev[s][r]):
                            ops.recovery(self._st[s][r].index)
            self._mut_seq += 1
            self.dir_epoch += 1
            return True

    # -- one-sided fast-path surface --

    def fast_view(self) -> PlaneFastView | PlaneHostView | None:
        """The fast lane's handle on the per-shard pools at the current
        (epoch, seq), cached per mutation sequence. None when unpaged and
        on 2-D grids: one lane's pages with intact digests elsewhere
        could validate wrong bytes, so 2-D clients keep the (lane-
        arbitrated) verbs. One process reads the live pools under the
        lock (`PlaneFastView`); on a grid that spans processes every
        process calls this in step and gets JAX's host mirror of every
        shard (`PlaneHostView`)."""
        if not self.config.paged or self.n_replicas > 1:
            return None
        with self._lock:
            fv = self._fastview
            if fv is None or fv.seq != self._mut_seq \
                    or fv.epoch != self.dir_epoch:
                fv = self._fastview = (
                    PlaneFastView(self, self.dir_epoch, self._mut_seq)
                    if self.mesh.owners is None else self._host_view())
            return fv

    # caller-holds: _lock
    def _host_view(self) -> PlaneHostView:
        """Every shard's pages, sums and (tiered) liveness gathered to the
        host of every process, `_MIRROR_CHUNK` rows a collective, so the
        staging of one gather stays bounded."""
        pools = self._pools()
        nr = pools[0].sums.shape[0]
        n, pw = self.n_shards, self.config.page_words
        pages = np.empty((n, nr, pw), np.uint32)
        for i in range(0, nr, _MIRROR_CHUNK):
            j = min(i + _MIRROR_CHUNK, nr)
            got = self._all_shards([p.pages[i:j] for p in pools])
            for s in range(n):
                pages[s, i:j] = u32.to_numpy(got[s])
        sums = np.stack([u32.to_numpy(x) for x in
                         self._all_shards([p.sums for p in pools])])
        live = None
        if self._tiered:
            live = self._xch.gather_rows(np.stack(
                [tier_mod.live_mask(p) for p in pools]))
        return PlaneHostView(self.dir_epoch, self._mut_seq, pages, sums,
                             live)

    def directory_snapshot(self, max_entries: int = 1 << 20) -> dict | None:
        """Compact key -> (shard, row, digest) directory across every
        shard (`kv.directory_entries` per shard, on its device). None
        when unpaged, on 2-D grids, or without a scan."""
        if not self.config.paged or self.n_replicas > 1 or \
                get_index_ops(self.config.index.kind).scan is None:
            return None
        with self._lock:
            out_k, out_s, out_r, out_d = [], [], [], []
            for s in self._mine:
                with _on(self._dev[s][0]):
                    ents = kv_mod.directory_entries(self._st[s][0],
                                                    self.config)
                if ents is None:
                    return None
                keys, rows, digs = ents
                out_k.append(keys)
                out_s.append(np.full(len(rows), s, np.uint32))
                out_r.append(rows)
                out_d.append(digs)
            keys, shards, rows, digs = (
                np.concatenate(x) for x in (out_k, out_s, out_r, out_d))
            if self.mesh.owners is not None:
                # every process's entries, in shard order (ranks hold
                # contiguous shards)
                ent = self._xch.gather_ragged(np.concatenate(
                    [keys, shards[:, None], rows[:, None], digs[:, None]],
                    axis=1))
                keys, shards, rows, digs = (
                    np.ascontiguousarray(x) for x in (
                        ent[:, :2], ent[:, 2], ent[:, 3], ent[:, 4]))
            return {"epoch": self.dir_epoch, "keys": keys[:max_entries],
                    "shards": shards[:max_entries],
                    "rows": rows[:max_entries], "digs": digs[:max_entries]}

    def bump_dir_epoch(self) -> int:
        """Structural invalidation from the membership tier. -> the new
        epoch."""
        with self._lock:
            self._mut_seq += 1
            self.dir_epoch += 1
            return self.dir_epoch

    def packed_bloom(self) -> np.ndarray | None:
        """Packed bit form for the client mirror (ref `send_bf`): the OR of
        the per-shard packed filters, which equals the single-device
        filter bit for bit (each key lives on exactly one shard)."""
        per = self.packed_bloom_per_shard()
        return None if per is None else np.bitwise_or.reduce(per, axis=0)

    def packed_bloom_per_shard(self) -> np.ndarray | None:
        """[n_shards, words] per-shard packed filters."""
        if self.config.bloom is None:
            return None
        with self._lock:
            out = []
            for s in self._mine:
                with _on(self._dev[s][0]):
                    out.append(u32.to_numpy(bloom_ops.to_packed_bits(
                        self._st[s][0].bloom)))
            return self._xch.gather_rows(np.stack(out))

    # -- persistence --

    def _sync(self) -> None:
        """Wait for every lane's device: the profiler's sanctioned,
        unattributed sync (`profiler.block_ready`)."""
        profiler.block_ready([st.stats for lanes in self._st
                              if lanes is not None for st in lanes])

    def save(self, path: str, delta: bool = False) -> dict:
        """Atomic snapshot of the whole plane, every leaf stacked
        `[n_shards, ...]` (the JAX package's layout, so either package
        restores it). The host stats plane is folded into the written
        stats leaf. `delta=True` writes a chain member over the FLAT row
        space (shard axis folded into the rows); falls back to a full
        (starting a new chain) like `kv.KV.snapshot`."""
        self._one_process("save")
        with self._lock:
            self._sync()
            folded = np.clip(self._stats_matrix(),
                             np.iinfo(np.int32).min, np.iinfo(np.int32).max)
            src = _StackedLeaves(self, folded.astype(np.int32))
            sums, live = self._dirty_basis()
            report, self._chain = ckpt_mod.chain_step(
                src, path, self._chain, sums, live, delta)
            return report

    def snapshot(self, path: str, delta: bool = False) -> dict:
        """`kv.KV.snapshot` name parity (the KVServer checkpoint hook)."""
        return self.save(path, delta=delta)

    # caller-holds: _lock
    def _dirty_basis(self):
        """Host `(sums, live)` over the flat row space (a copy: the basis
        must not alias the live sidecar)."""
        if self.states[0].pool is None:
            return None, None
        sums = np.concatenate([u32.to_numpy(st.pool.sums).reshape(-1)
                               for st in self.states])
        live = None
        if self._tiered:
            live = np.concatenate([tier_mod.live_mask(st.pool).reshape(-1)
                                   for st in self.states])
        return sums, live

    def restore_chain(self, paths: list, run_recovery: bool = True) -> None:
        """Warm restart from a full+delta chain (any order of paths),
        restored like one full snapshot — onto a different shard count
        too. The chain resumes only when the shard count matches: a
        resharded restore rewrites the row space, so the next snapshot
        starts a new chain."""
        with self._lock:
            folded = ckpt_mod.materialize_chain(list(paths))
            label = paths[-1] if paths else "<chain>"
            n_loaded = int(np.asarray(folded["leaves"][0]).shape[0])
            self._restore_from_leaves(folded["leaves"], label, run_recovery)
            if n_loaded == self.n_shards:
                sums, live = self._dirty_basis()
                self._chain = {"id": folded["chain"]["id"],
                               "seq": int(folded["chain"]["seq"]),
                               "prev_crc": int(folded["chain"]["crc"]),
                               "base_sums": sums, "base_live": live}
            else:
                self._chain = None

    def restore(self, path: str, run_recovery: bool = True) -> None:
        """Load a snapshot taken by `save` (either package's) onto this
        grid. Same shard count: each shard's slice becomes its state.
        Different shard count: the snapshot's live entries are re-routed
        (see `_restore_resharded`). The admission gate starts EMPTY
        either way (`checkpoint.strip_admission`). On a grid that spans
        processes every process reads the file and keeps the shards it
        holds; a reshard replays through the plane verbs in step."""
        with self._lock:
            loaded = ckpt_mod.load_leaves(path, None)
            self._restore_from_leaves(loaded, path, run_recovery)

    # caller-holds: _lock
    def _skeleton(self):
        named = carry.leaves(ckpt_mod.strip_admission(
            kv_mod.init(self.config, "meta")))
        return [n for n, _ in named], [tuple(t.shape) for _, t in named]

    # caller-holds: _lock
    def _restore_from_leaves(self, loaded: list, path: str,
                             run_recovery: bool) -> None:
        names, shapes = self._skeleton()
        n = self.n_shards
        loaded = [np.asarray(x) for x in loaded]
        if [tuple(x.shape) for x in loaded] == [(n, *s) for s in shapes]:
            new = [None] * n
            for s in self._mine:
                lanes = []
                for r in range(self.n_replicas):
                    # lane 0 takes the freshly read arrays over; every
                    # other lane gets its own copy
                    st = carry.state_from_numpy(
                        {nm: x[s] for nm, x in zip(names, loaded)},
                        self.config, self._dev[s][r], consume=r == 0)
                    lanes.append(ckpt_mod.transplant_admission(st,
                                                               self.config))
                new[s] = lanes
            self._st = new
        else:
            self._restore_resharded(loaded, names, shapes, path)
        # reset the host stats plane only once a restore SUCCEEDED
        self._plane_stats[:] = 0
        self._mut_seq += 1
        self.dir_epoch += 1
        if run_recovery:
            self.recovery()

    # caller-holds: _lock
    def _restore_resharded(self, loaded: list, names: list, shapes: list,
                           path: str) -> None:
        """An N-shard snapshot onto this M-shard grid: every old shard's
        live entries (`kv.live_entries`, on this grid's first device) are
        replayed through the PLANE router in 4,096-key chunks (a2a would
        overflow its pair buckets when M divides N: an old shard's whole
        key set lands on one new shard), extent records replayed in ring
        order from shard 0's replicated ring, and the snapshot's counter
        totals carried onto shard 0. Replay drops (capacity pressure on a
        smaller grid) are added to the drops counter, never silent."""
        if len(loaded) != len(shapes):
            raise ValueError(
                f"snapshot {path!r} has {len(loaded)} leaves, this "
                f"config expects {len(shapes)} — reshard-restore "
                "needs the same per-shard KVConfig on both sides")
        n_olds = set()
        for x, sh in zip(loaded, shapes):
            if x.ndim != len(sh) + 1 or tuple(x.shape[1:]) != tuple(sh):
                raise ValueError(
                    f"snapshot {path!r} leaf {tuple(x.shape)} does not "
                    f"stack per-shard shape {tuple(sh)} — "
                    "reshard-restore needs the same per-shard KVConfig "
                    "on both sides")
            n_olds.add(int(x.shape[0]))
        if len(n_olds) != 1:
            raise ValueError(
                f"snapshot {path!r} leaves disagree on the shard axis "
                f"({sorted(n_olds)})")
        n_old = n_olds.pop()
        # every replay precondition fails BEFORE the live state goes
        if get_index_ops(self.config.index.kind).scan is None:
            raise ValueError(
                f"index kind {self.config.index.kind} has no scan op; "
                "reshard replay needs one")
        self._st = None  # the old plane's memory first, then the new
        self._st = self._init_states()
        totals = np.zeros((NSTATS,), np.int64)
        dev = self.device
        for s in range(n_old):
            with _on(dev):
                st_s = carry.state_from_numpy(
                    {nm: x[s] for nm, x in zip(names, loaded)},
                    self.config, dev, consume=True)
                totals += st_s.stats.cpu().numpy().astype(np.int64)
                keys, payload = kv_mod.live_entries(st_s, self.config)
                del st_s
            for lo in range(0, len(keys), 4096):
                self.plane_insert(keys[lo:lo + 4096],
                                  payload[lo:lo + 4096]).fetch()
        recs = np.asarray(loaded[names.index("extents.recs")][0])
        if len(recs):
            cur = int(np.asarray(
                loaded[names.index("extents.cursor")][0])) % len(recs)
            for i in np.r_[cur:len(recs), 0:cur]:
                khi, klo, vhi, vlo, length, valid = (int(v) for v in recs[i])
                if not valid:
                    continue
                self.insert_extent(np.array([khi, klo], np.uint32),
                                   np.array([vhi, vlo], np.uint32), length)
        n_dropped = int(self._xch.gather_rows(np.array(
            [int(st.stats[DROPS]) for st in self.states], np.int64)).sum())
        if n_dropped:
            print(f"[sharded-kv] reshard replay dropped {n_dropped} "
                  "pages (target mesh capacity pressure; legal misses)")
        totals[DROPS] += n_dropped
        stacked = np.zeros((self.n_shards, NSTATS), np.int32)
        stacked[0] = np.clip(totals, np.iinfo(np.int32).min,
                             np.iinfo(np.int32).max).astype(np.int32)
        for s in self._mine:
            for r in range(self.n_replicas):
                with _on(self._dev[s][r]):
                    self._st[s][r].stats.copy_(
                        torch.from_numpy(stacked[s]))

    def node_of(self, keys: np.ndarray) -> np.ndarray:
        """Owning shard per key — the `GetNodeID(key)` analog. Host-side,
        no device work."""
        return pt.shard_of_np(keys, self.n_shards)

    # caller-holds: _lock
    def _stats_matrix(self) -> np.ndarray:
        """[n, NSTATS] int64: each shard's stats leaf (lane 0) plus the
        host plane."""
        return self._xch.gather_rows(np.stack(
            [self._st[s][0].stats.cpu().numpy().astype(np.int64)
             + self._plane_stats[s] for s in self._mine]))

    def shard_report(self) -> dict:
        """Per-shard load report — the `segments_in_node` / per-node freq
        analog (`server/CCEH_hybrid.h:202-206`): occupancy and the stats
        vector PER shard (their sums equal `stats()`)."""
        with self._lock:
            occ = self._occupancy()
            per_stats = self._stats_matrix()
            cap = self.capacity() // self.n_shards
            return {
                "n_shards": self.n_shards,
                "occupancy": [int(x) for x in occ],
                "utilization": [round(float(x) / cap, 4) for x in occ],
                "stats": {
                    name: [int(x) for x in per_stats[:, i]]
                    for i, name in enumerate(kv_mod.STAT_NAMES)
                },
                # the LRFU plane, decayed to the CURRENT tick
                **({
                    "freq": [int(x) for x in self._freq],
                    "atime": [int(x) for x in self._lrfu[:, 0]],
                    "crf": [
                        round(float(x), 3)
                        for x in self._lrfu[:, 1] * np.power(
                            0.5,
                            self.lrfu_lambda
                            * (self._lrfu_tick - self._lrfu[:, 0]),
                        )
                    ],
                } if self.lrfu_stats else {}),
                **self._tier_report(),
                **({"replica": self.replica_report()}
                   if self.n_replicas > 1 else {}),
            }

    # caller-holds: _lock
    def _pools(self) -> list:
        return [st.pool for st in self.states]

    # caller-holds: _lock
    def _per_shard(self, rows: list) -> np.ndarray:
        """One host row per shard this process holds -> `[n_shards, ...]`
        over the grid (gathered when it spans processes)."""
        return self._xch.gather_rows(np.stack(rows))

    def _tier_report(self) -> dict:
        """shard_report's tier block (empty when the pool is flat)."""
        pools = self._pools()
        if not isinstance(pools[0], tier_mod.TierState):
            return {}
        per = self._per_shard([p.tstats.cpu().numpy() for p in pools])
        hk = [u32.to_numpy(p.hot_keys) for p in pools]
        met = [u32.to_numpy(p.metric) for p in pools]
        tick = [int(u32.widen(p.tick)) for p in pools]
        occ = self._per_shard(
            [int((~np.all(h == INVALID_WORD, axis=-1)).sum()) for h in hk])
        # float64 heats cross as their bits
        heat = self._per_shard([np.float64(round(tier_mod.hot_heat_arrays(
            hk[j], met[j], tick[j], self.lrfu_lambda), 3)).view(np.int64)
            for j in range(len(pools))]).view(np.float64)
        admit = {}
        if pools[0].admit_stats is not None:
            ast = self._per_shard([p.admit_stats.cpu().numpy()
                                   for p in pools])
            admit = {name: [int(x) for x in ast[:, i]]
                     for i, name in enumerate(tier_mod.ADMIT_STAT_NAMES)}
        return {
            "tier": {
                **{name: [int(x) for x in per[:, i]]
                   for i, name in enumerate(tier_mod.TIER_STAT_NAMES)},
                "hot_occupied": [int(x) for x in occ],
                **admit,
            },
            "hot_heat": [float(x) for x in heat],
        }

    # caller-holds: _lock
    def _balloon_rows(self, rows: int) -> int:
        """PER-SHARD balloon amount (`kv.KV._balloon_rows`'s rule)."""
        step = kv_mod._tcfg(self.config).balloon_step
        c = self.states[0].pool.cfree.shape[-1]
        return min(-(-int(rows) // step) * step, c)

    def balloon_state(self) -> dict | None:
        """Cold-pool circulation summed across shards; `step` stays the
        PER-SHARD extent. None on a flat pool."""
        with self._lock:
            pools = self._pools()
            if not isinstance(pools[0], tier_mod.TierState):
                return None
            hwm, ptop, ctop = (int(x) for x in self._per_shard(
                [np.array([int(p.hwm), int(p.ptop), int(p.ctop)])
                 for p in pools]).sum(axis=0))
            return {
                "cold_rows": self.n_shards * pools[0].cfree.shape[-1],
                "circulating": hwm - ptop,
                "parked": ptop,
                "free": ctop,
                "step": int(kv_mod._tcfg(self.config).balloon_step),
            }

    def _balloon(self, fn, rows: int) -> bool:
        with self._lock:
            if not self._tiered:
                return False
            k = self._balloon_rows(rows)
            for s in self._mine:
                with _on(self._dev[s][0]):
                    fn(self._st[s][0].pool, k)
            self._mut_seq += 1
            self.dir_epoch += 1
            return True

    def balloon_shrink(self, rows: int) -> bool:
        """Balloon every shard's cold pool down by up to `rows` rows PER
        SHARD (free rows park first, then the coldest live rows evict to
        legal misses). False on a flat pool."""
        return self._balloon(tier_mod.shrink, rows)

    def balloon_grow(self, rows: int) -> bool:
        """Ensure at least `rows` free cold rows circulate per shard.
        False on a flat pool."""
        return self._balloon(tier_mod.grow, rows)

    def tier_stats(self) -> dict | None:
        """Per-tier counters summed across every shard (None when flat)."""
        with self._lock:
            pools = self._pools()
            if not isinstance(pools[0], tier_mod.TierState):
                return None
            per = self._per_shard([p.tstats.cpu().numpy() for p in pools])
            d = tier_mod.counters_dict(per.sum(axis=0),
                                       self.config.page_words * 4)
            if pools[0].admit_stats is not None:
                ast = self._per_shard([p.admit_stats.cpu().numpy()
                                       for p in pools])
                d.update(tier_mod.admit_counters_dict(
                    torch.from_numpy(ast.sum(axis=0))))
                d["admit_threshold"] = int(self._per_shard(
                    [int(u32.widen(p.admit_thresh)) for p in pools]).max())
            return d

    def admit_state(self) -> dict | None:
        """Admission-gate snapshot summed across shards (threshold and
        reset_ops stay per-shard values). None when flat or gateless."""
        with self._lock:
            pools = self._pools()
            if not isinstance(pools[0], tier_mod.TierState) \
                    or pools[0].admit_cm is None:
                return None
            acfg = tier_mod.admit_cfg(pools[0], kv_mod._tcfg(self.config))
            ast = self._per_shard([p.admit_stats.cpu().numpy()
                                   for p in pools])
            d = tier_mod.admit_counters_dict(torch.from_numpy(ast.sum(axis=0)))
            gate = self._per_shard([np.array([int(u32.widen(p.admit_thresh)),
                                              int(u32.widen(p.admit_ops))])
                                    for p in pools])
            d.update({
                "threshold": int(gate[:, 0].max()),
                "ops": int(gate[:, 1].sum()),
                "reset_ops": int(acfg.reset_ops),
                "epochs": d["admit_age_epochs"],
            })
            return d

    def set_admit_threshold(self, value: int) -> bool:
        """Write the live admission threshold on EVERY shard. False when
        flat or gateless."""
        with self._lock:
            pools = self._pools()
            if not isinstance(pools[0], tier_mod.TierState) \
                    or pools[0].admit_cm is None:
                return False
            for s, p in zip(self._mine, pools):
                with _on(self._dev[s][0]):
                    tier_mod.set_admit_threshold(p, value)
            return True

    def _account(self, shard: int, cause: int, gets: int, puts: int):
        with self._lock:
            if gets:
                self._plane_stats[shard, GETS] += int(gets)
                self._plane_stats[shard, MISSES] += int(gets)
                self._plane_stats[shard, cause] += int(gets)
            if puts:
                self._plane_stats[shard, PUTS] += int(puts)
                self._plane_stats[shard, DROPS] += int(puts)

    def account_shed(self, gets: int, puts: int = 0) -> None:
        """QoS shed attribution: a shed op never routed, so it parks on
        shard 0's host stats row."""
        self._account(0, MISS_SHED, gets, puts)

    def account_quarantined(self, gets: int, puts: int = 0,
                            shard: int = 0) -> None:
        """Shard-quarantine attribution on the QUARANTINED shard's own
        host stats row (the op was routed there and degraded there)."""
        self._account(int(shard) % self.n_shards, MISS_QUARANTINED, gets,
                      puts)

    def account_deadline(self, gets: int, puts: int = 0) -> None:
        """Deadline-shed attribution on shard 0's host stats row."""
        self._account(0, MISS_DEADLINE, gets, puts)

    def stats(self) -> dict:
        with self._lock:
            vec = self._stats_matrix().sum(axis=0)
            d = dict(zip(kv_mod.STAT_NAMES, (int(x) for x in vec)))
            t = self.tier_stats()
        if t is not None:
            d.update(t)
        return d

    def print_stats(self) -> str:
        s = self.stats()
        line = ", ".join(f"{k}={v}" for k, v in s.items())
        print(f"[sharded-kv n={self.n_shards} {self.dispatch}] {line}")
        return line

    def capacity(self) -> int:
        return get_index_ops(self.config.index.kind).num_slots(
            self.config.index) * self.n_shards
