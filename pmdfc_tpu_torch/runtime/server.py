"""KVServer — the driver loop turning coalesced batches into device work
(twin of `pmdfc_tpu/runtime/server.py`, without the mesh plane).

This is the role of `server/rdma_svr.cpp`'s per-queue poller threads
(`server_recv_poll_cq` :755 → `process_write_twosided` :319 /
`process_read_odp` :659) redesigned for a GPU: instead of 32 pinned threads
each handling one 4-page verb, ONE driver thread drains every submission
queue into a deep batch and runs one batched KV op per op kind on the card.
Within a batch, puts land before deletes before gets, so a client that
pipelines put→get against the same key sees its own write (the reference
client gets the same guarantee from its synchronous per-queue verbs).

Batch shapes are padded up a power-of-two ladder from `pad_floor`, as the
JAX package pads them, so a flush has the same padded width in both.
Results fan back out through the engine's completion slots and, for gets,
the page lands in the request's arena destination slot — the analog of the
server RDMA-writing the page straight into the faulting page's DMA address
(`server/rdma_svr.cpp:706-719`). Page returns are hit-compacted on the
card (`kv.get_compact`, whose GET is the fused GET kernel where the config
supports it) so only found rows cross to the host.

The driver is double-buffered: flush N+1 is launched before flush N's
results are fetched. CUDA work is asynchronous, so the host's copy of
flush N's results overlaps flush N+1's device work — as far as the
launch itself does not wait on the card: the KV ops sync the host where
they write through a boolean mask (the tiered GET and the insert do), and
such a launch runs to its last sync before it returns. Results are read
with `u32.to_numpy` / `.cpu()`, which copy: nothing of a flush's result
aliases the KV's state, which the next launch updates in place.

All of the KV's device work runs on the `pmdfc-driver` thread, on the
KV's device (set for the thread, never taken from the main thread's).

`checkpoint()` snapshots through `KV.snapshot`, which takes the KV's lock
and device, so a caller's thread may cut one while the driver serves.

Mesh mode (`mesh=`, or a `ShardedKV` passed as `kv=`): the phases become
the sharded plane's routed verbs (`ShardedKV.plane_*`), each launched as a
`PlaneHandle` and fetched in `_finalize`; see `parallel/plane.py`.

Every blocking fetch in `_finalize` goes through the device-time
profiler's seam (`runtime/profiler.py` `fetch`), as in the JAX driver:
with a profiler attached, each async verb records a CUDA event pair on
the KV's stream (`KV.take_launch`; a plane handle carries its own), and
the launch stamp `t_ns` charges the launch-to-fetch gap to the first
fetched phase as `dispatch_us`. With none attached every seam passes
through.
"""

from __future__ import annotations

import collections
import threading
import time
import traceback

import numpy as np

from pmdfc_tpu_torch.config import KVConfig
from pmdfc_tpu_torch.kv import KV
from pmdfc_tpu_torch.ops.bloom import dirty_blocks
from pmdfc_tpu_torch.runtime import profiler
from pmdfc_tpu_torch.runtime import sanitizer as san
from pmdfc_tpu_torch.runtime import telemetry as tele
from pmdfc_tpu_torch.runtime import timeseries
from pmdfc_tpu_torch.runtime.engine import (
    Engine, OP_DEL, OP_GET, OP_GET_EXT, OP_INS_EXT, OP_PUT)
from pmdfc_tpu_torch.utils import u32
from pmdfc_tpu_torch.utils.keys import INVALID_WORD
from pmdfc_tpu_torch.utils.timers import Reporter, Timers


class KVServer:
    def __init__(self, config: KVConfig | None = None,
                 engine: Engine | None = None, kv: KV | None = None,
                 report_every_s: float = 0.0, pad_floor: int = 16,
                 bf_push_s: float = 0.0, bf_block_bytes: int = 8192,
                 fault_injector=None, device="cuda", mesh=None):
        """`device` places a KV built here (`cuda` unless the caller asks
        for the CPU; without a GPU, `cuda` raises, as `KV` does). A `kv`
        passed in keeps its own device.

        `mesh=` serves a sharded plane instead: a grid (`parallel.shard.
        make_mesh`), an int shard count (that many distinct local GPUs),
        True (every local GPU) or a `MeshConfig`. `PMDFC_MESH=off`
        ignores it and serves one device; an explicit `kv=` always
        wins."""
        self.config = config or KVConfig()
        if mesh is not None and kv is None:
            kv = self._build_mesh_kv(mesh, pad_floor)
        self.kv = kv or KV(self.config, device=device)
        # the plane surface (ShardedKV's routed verbs): phases launch
        # PlaneHandles instead of the KV's async verbs
        self._plane = self.kv if hasattr(self.kv, "plane_insert") else None
        self.engine = engine or Engine(
            page_bytes=self.config.page_words * 4
        )
        # ladder lower bound: batches pad to max(pad_floor, next_pow2(n))
        self.pad_floor = pad_floor
        # optional fault injector (duck-typed `.on_batch(reqs)`; "drop"
        # makes a batch's completions vanish)
        self.fault = fault_injector
        self.errors = 0  # flushes failed by `_fail_batch`
        # launched flushes that carried each op kind ("put", "get", ...):
        # with one fused GET per paged GET flush, `op_batches["get"]` is
        # the launch count a serving run must show
        self.op_batches: collections.Counter = collections.Counter()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.timers = Timers()
        self._reporter: Reporter | None = None
        if report_every_s > 0:
            # the rdpma_indicator analog (`server/rdma_svr.cpp:145-150`)
            self._reporter = Reporter(
                report_every_s,
                sinks=[
                    lambda: f"kv {self.kv.stats()}",
                    lambda: f"engine {self.engine.stats()}",
                    lambda: f"phases {self.timers.report()}",
                ],
            )
        # -- server→client bloom push (the rdpma_bf_sender analog,
        # `server/rdma_svr.cpp:157-251,1361-1363`, with the 8 KB dirty-block
        # deltas of `counting_bloom_filter.h:101-107`: after the first full
        # push, only changed blocks travel).
        self.bf_push_s = bf_push_s
        self.bf_block_bytes = bf_block_bytes
        self._bf_clients: list = []
        self._bf_last_sent: list[np.ndarray | None] = []
        # guarded-by: _bf_clients, _bf_last_sent
        self._bf_lock = san.lock("KVServer._bf_lock")
        # one push cycle at a time (the sender thread and push_bloom_now
        # callers): ranked outside _bf_lock and KV._lock, both taken
        # while it is held
        # guarded-by: bf_push_stats
        self._bf_push_lock = san.lock("KVServer._bf_push_lock")
        self._bf_thread: threading.Thread | None = None
        # "errors" appears with the first failed push, as in JAX
        self.bf_push_stats = {"cycles": 0, "full_pushes": 0,
                              "delta_pushes": 0, "blocks_pushed": 0}

    def _build_mesh_kv(self, mesh, pad_floor: int):
        """Resolve a mesh= request into a ShardedKV, or None (one device)
        when `PMDFC_MESH=off` — the rule the NetServer path shares
        (`plane.build_plane_kv`). The driver's pad floor carries onto the
        plane router's ladder unless an explicit MeshConfig says
        otherwise."""
        from pmdfc_tpu_torch.config import MeshConfig
        from pmdfc_tpu_torch.parallel.plane import build_plane_kv

        knobs = None
        if not isinstance(mesh, MeshConfig):
            f = min(pad_floor, 1024)
            knobs = MeshConfig(pad_floor=1 << (f.bit_length() - 1))
        return build_plane_kv(self.config, mesh, knobs=knobs)

    # -- lifecycle --
    def start(self) -> "KVServer":
        # Start-once: `with KVServer(...).start()` would otherwise spawn a
        # SECOND driver loop via __enter__, and two loops race the KV
        # (restart after stop is not supported: _stop is never cleared).
        if self._thread is not None:
            return self
        # the windowed time-series sampler, as the NetServer starts it
        # (idempotent; tick() honours the telemetry kill switch)
        timeseries.ensure_collector()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pmdfc-driver")
        self._thread.start()
        if self._reporter:
            self._reporter.start()
        if self.bf_push_s > 0:
            self._bf_thread = threading.Thread(
                target=self._bf_push_loop, daemon=True, name="bf-sender"
            )
            self._bf_thread.start()
        return self

    def warmup(self, max_width: int | None = None) -> int:
        """Run a put, a delete and a get at every ladder width up to the
        engine's flush cap once, with all-INVALID key batches: they run
        the real ops (the fused GET kernel among them) but match nothing,
        place nothing and touch no pool row. Call it on the caller's
        thread before `start()`: the kernel is built at its first launch,
        and a build or launch failure then raises here instead of failing
        flushes inside the driver thread. `max_width` caps the ladder
        (default: the engine's flush cap). -> the number of (kind, width)
        ops run."""
        cap = max_width or self.engine.batch
        if self._plane is not None:
            # the plane: one shared warm loop over the router's own
            # per-shard ladder (`plane.warm_plane`)
            from pmdfc_tpu_torch.parallel.plane import warm_plane

            return warm_plane(self._plane, cap)
        vw = self.config.page_words if self.config.paged else 2
        w, n = self.pad_floor, 0
        while w <= cap:
            keys = np.full((w, 2), INVALID_WORD, np.uint32)
            self.kv.insert_async(keys, np.zeros((w, vw), np.uint32),
                                 pad_floor=self.pad_floor)
            self.kv.delete_async(keys, pad_floor=self.pad_floor)
            if self.config.paged:
                int(self.kv.get_compact_async(keys,
                                              pad_floor=self.pad_floor)[3])
            else:
                self.kv.get_async(keys, pad_floor=self.pad_floor)[1].cpu()
            w, n = w << 1, n + 3
        return n

    def checkpoint(self, path: str, delta: bool = False) -> dict:
        """Crash-safe snapshot of the live KV under ITS lock
        (`KV.snapshot`): serialized against the driver's launches, so the
        saved state is always a consistent op boundary. With
        ``delta=True`` only rows dirtied since the previous link of the
        chain are written (full fallback when no chain is armed)."""
        return self.kv.snapshot(path, delta=delta)

    def health(self) -> dict:
        """One integrity/degradation surface for monitors and drills: KV
        stats (incl. `corrupt_pages` and the tier counters when tiered),
        engine stats, driver-level serve errors, and the launched flushes
        by op kind."""
        out = {
            "kv": self.kv.stats(),
            "engine": self.engine.stats(),
            "serve_errors": self.errors,
            "op_batches": dict(self.op_batches),
        }
        info = getattr(self.kv, "recovery_info", None)
        if info is not None:
            out["recovery"] = info()
        return out

    def stop(self) -> None:
        self._stop.set()
        if self._reporter:
            self._reporter.stop()
        if self._bf_thread:
            self._bf_thread.join(timeout=10)
        if self._thread:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                # Driver thread wedged (device hang?): freeing the native
                # queues under it would be a use-after-free. Leak instead.
                raise RuntimeError(
                    "driver thread did not exit; leaking engine")
        self.engine.close()

    def __enter__(self) -> "KVServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- bloom push --

    def register_bf_client(self, client) -> None:
        """Attach a client mirror (anything with `receive_bloom_full` /
        `receive_bloom_blocks`) — the MR-exchange analog for the filter."""
        with self._bf_lock:
            self._bf_clients.append(client)
            self._bf_last_sent.append(None)

    def push_bloom_now(self) -> dict:
        """One push cycle: full filter to new clients, dirty blocks to the
        rest. Returns this cycle's counters.

        `t_snap` is sampled BEFORE the filter is read: every put whose
        completion a client observed before `t_snap` is provably contained
        in this snapshot, so the client may retire its overlay entry — the
        stamp that closes the push-races-put false-negative window.
        """
        with self._bf_push_lock:
            t_snap = time.monotonic()
            packed = self.kv.packed_bloom()
            if packed is None:
                return {"blocks": 0}
            wpb = self.bf_block_bytes // 4
            can_delta = len(packed) % wpb == 0
            pushed_blocks = 0
            with self._bf_lock:
                clients = list(zip(range(len(self._bf_clients)),
                                   self._bf_clients, self._bf_last_sent))
            sent: list[int] = []
            # clients that were sent the same snapshot share one diff
            deltas: dict[int, tuple[np.ndarray, np.ndarray]] = {}
            for i, client, last in clients:
                try:
                    if last is None or not can_delta:
                        client.receive_bloom_full(packed, t_snap=t_snap)
                        self.bf_push_stats["full_pushes"] += 1
                    else:
                        if id(last) not in deltas:
                            idx = np.nonzero(dirty_blocks(
                                last, packed,
                                block_bytes=self.bf_block_bytes))[0]
                            deltas[id(last)] = (
                                idx, packed.reshape(-1, wpb)[idx])
                        idx, blocks = deltas[id(last)]
                        if len(idx):
                            client.receive_bloom_blocks(idx, blocks, wpb,
                                                        t_snap=t_snap)
                            pushed_blocks += len(idx)
                        self.bf_push_stats["delta_pushes"] += 1
                    sent.append(i)
                except Exception as e:  # noqa: BLE001 — one bad sink must
                    # not kill the sender thread for every other client
                    self.bf_push_stats["errors"] = (
                        self.bf_push_stats.get("errors", 0) + 1)
                    print(f"[kv-server] bf push to client {i} failed: {e!r}")
            with self._bf_lock:
                for i in sent:
                    # `packed` is freshly allocated each cycle and never
                    # mutated after this point; sinks copy what they keep
                    self._bf_last_sent[i] = packed
            self.bf_push_stats["cycles"] += 1
            self.bf_push_stats["blocks_pushed"] += pushed_blocks
            return {"blocks": pushed_blocks, "clients": len(clients)}

    def _bf_push_loop(self) -> None:
        while not self._stop.wait(self.bf_push_s):
            self.push_bloom_now()

    # -- driver --
    def _loop(self) -> None:
        with self.kv._on_device():
            self._drive()

    def _drive(self) -> None:
        pending: tuple | None = None  # (reqs, launch handles) in flight
        while not self._stop.is_set():
            # With a flush in flight, don't dwell in the coalescer spin:
            # grab whatever is queued (timeout 0) and launch it, THEN go
            # block on the in-flight results — that is the overlap.
            with self.timers.phase("pop"):
                reqs = self.engine.pop_batch(
                    timeout_us=0 if pending is not None else None
                )
            nxt = None
            if len(reqs):
                try:
                    with self.timers.phase("launch"):
                        nxt = (reqs, self._launch(reqs))
                except Exception as e:  # noqa: BLE001
                    self._fail_batch(reqs, e)
            if pending is not None:
                self._finalize_or_fail(*pending)
            pending = nxt
        if pending is not None:
            self._finalize_or_fail(*pending)

    def _finalize_or_fail(self, reqs: np.ndarray, handles) -> None:
        try:
            self._finalize(reqs, handles)
        except Exception as e:  # noqa: BLE001
            self._fail_batch(reqs, e)

    def _fail_batch(self, reqs: np.ndarray, e: Exception) -> None:
        # A batch must never kill the driver silently: fail ITS requests
        # (clients see -2, not a hang), count it, and keep serving.
        traceback.print_exc()
        print(f"[kv-server] serve failed: {e!r}; "
              f"failing {len(reqs)} requests")
        self.errors += 1
        tele.rung("phase_failure", tier="engine", requests=len(reqs),
                  error=repr(e))
        self.engine.complete(
            reqs["req_id"], np.full(len(reqs), -2, np.int32)
        )

    def serve_batch(self, reqs: np.ndarray) -> None:
        """Run one coalesced batch synchronously (launch + finalize)."""
        handles = self._launch(reqs)
        self._finalize(reqs, handles)

    def _launch(self, reqs: np.ndarray):
        """Dispatch one coalesced batch: puts, extent inserts, deletes,
        extent gets, then gets.

        Returns opaque handles holding device tensors; nothing here reads
        a result back (the insert and the extent insert may still sync
        the host inside the KV)."""
        if self.fault is not None and self.fault.on_batch(reqs) == "drop":
            return None  # completions vanish; clients must time out, not hang

        keys = np.stack([reqs["khi"], reqs["klo"]], axis=-1)
        handles: dict = {}
        # each phase's CUDA event pair (None unless a profiler records)
        ev = handles["events"] = {}
        floor = self.pad_floor

        puts = reqs["op"] == OP_PUT
        if puts.any():
            self.op_batches["put"] += 1
            if self.config.paged:
                # a gather, so a copy: the clients reuse their arena slots
                # once their requests complete
                vals = self.engine.arena[reqs["page_off"][puts]]
            else:
                nk = int(puts.sum())
                vals = np.stack(
                    [np.zeros(nk, np.uint32), reqs["page_off"][puts]],
                    axis=-1,
                )
            if self._plane is not None:
                # the plane: host-routed per-shard programs; the handle's
                # fetch reorders results to request order
                handles["puts"] = (puts, self._plane.plane_insert(
                    keys[puts], vals), None)
            else:
                res, nb = self.kv.insert_async(keys[puts], vals,
                                               pad_floor=floor)
                ev["puts"] = self.kv.take_launch()
                handles["puts"] = (puts, res, nb)

        # Extent inserts land after puts, before deletes/gets, so a client
        # pipelining ins_ext -> get_ext within one flush sees its covers.
        # One KV call per record (the façade op is single-extent, ref
        # `KV.cpp:129-185`); extents are orders rarer than page ops.
        iext = reqs["op"] == OP_INS_EXT
        if iext.any():
            self.op_batches["ins_ext"] += 1
            st = np.empty(int(iext.sum()), np.int32)
            for j, r in enumerate(reqs[iext]):
                staged = self.engine.arena[r["page_off"]]
                try:
                    _, uncovered = self.kv.insert_extent(
                        np.array([r["khi"], r["klo"]], np.uint32),
                        np.array(staged[:2], np.uint32),
                        int(staged[2]),
                    )
                    # status >= 0 reports the uncovered tail (0 = fully
                    # indexed), the façade's partial-coverage surface
                    st[j] = uncovered
                except Exception:  # noqa: BLE001 — fail THIS record only
                    traceback.print_exc()
                    st[j] = -2
            handles["ins_ext"] = (iext, st)

        dels = reqs["op"] == OP_DEL
        if dels.any():
            self.op_batches["del"] += 1
            if self._plane is not None:
                handles["dels"] = (dels, self._plane.plane_delete(
                    keys[dels]), None)
            else:
                hit, nb = self.kv.delete_async(keys[dels], pad_floor=floor)
                ev["dels"] = self.kv.take_launch()
                handles["dels"] = (dels, hit, nb)

        gext = reqs["op"] == OP_GET_EXT
        if gext.any():
            self.op_batches["get_ext"] += 1
            if self._plane is not None:
                handles["get_ext"] = (gext, self._plane.plane_get_extent(
                    keys[gext]), None, None)
            else:
                out, found, nb = self.kv.get_extent_async(keys[gext],
                                                          pad_floor=floor)
                ev["get_ext"] = self.kv.take_launch()
                handles["get_ext"] = (gext, out, found, nb)

        gets = reqs["op"] == OP_GET
        if gets.any():
            self.op_batches["get"] += 1
            if self._plane is not None:
                handles["gets"] = (gets, self._plane.plane_get(keys[gets]),
                                   None)
            elif self.config.paged:
                out, order, found, nfound, nb = \
                    self.kv.get_compact_async(keys[gets], pad_floor=floor)
                ev["gets"] = self.kv.take_launch()
                handles["gets"] = (gets, (out, order, found, nfound), nb)
            else:
                out, found, nb = self.kv.get_async(keys[gets],
                                                   pad_floor=floor)
                ev["gets"] = self.kv.take_launch()
                handles["gets"] = (gets, (out, None, found, None), nb)
        # launch stamp for the dispatch-vs-device split: _finalize
        # charges the launch-to-first-fetch gap as dispatch_us
        handles["t_ns"] = time.monotonic_ns()
        return handles

    def _finalize(self, reqs: np.ndarray, handles) -> None:
        """Copy one launched batch's results to the host (this is where
        the device work is waited for) and publish completions. Timer
        phases as the reference's TIME_CHECK accumulators
        (`server/rdma_svr.cpp:64-76`); every blocking fetch is the
        profiler's timed seam. `t_l` (the launch stamp) charges the
        dispatch gap to the FIRST fetched phase; plane handles carry
        their own stamps."""
        if handles is None:
            return  # fault-injected drop
        status = np.zeros(len(reqs), np.int32)
        t_l = handles.pop("t_ns", 0)
        ev = handles.pop("events", {})
        n_sh = self._plane.n_shards if self._plane is not None else 0

        def plane_fetch(program, phase, h):
            return profiler.fetch(
                program, phase, h.fetch, n_ops=h.b, counts=h.counts,
                n_shards=n_sh, t_launch_ns=h.t_launch_ns, ring=True,
                events=h.events)

        if "puts" in handles:
            with self.timers.phase("write"):
                puts, res, nb = handles["puts"]
                if nb is None:  # plane handle, request order
                    dropped = np.asarray(
                        plane_fetch("plane.put", "put", res).dropped)
                else:
                    dropped = profiler.fetch(
                        "kv.insert", "put",
                        lambda: res.dropped[:nb].cpu().numpy(),
                        n_ops=nb, t_launch_ns=t_l, ring=True,
                        events=ev.get("puts"))
                t_l = 0
                status[puts] = np.where(dropped, -1, 0)
        if "ins_ext" in handles:
            iext, st = handles["ins_ext"]
            status[iext] = st
        if "get_ext" in handles:
            with self.timers.phase("read"):
                gext, out, found, nb = handles["get_ext"]
                if nb is None:  # plane handle
                    out_h, found_h = plane_fetch("plane.get_ext", "get_ext",
                                                 out)
                else:
                    out_h, found_h = profiler.fetch(
                        "kv.get_extent", "get_ext",
                        lambda: (u32.to_numpy(out[:nb]),
                                 found[:nb].cpu().numpy()),
                        n_ops=nb, t_launch_ns=t_l, ring=True,
                        events=ev.get("get_ext"))
                t_l = 0
                self.engine.arena[reqs["page_off"][gext], :2] = out_h
                status[gext] = np.where(found_h, 0, -1)
        if "dels" in handles:
            with self.timers.phase("delete"):
                dels, hit, nb = handles["dels"]
                if nb is None:
                    hit_h = plane_fetch("plane.del", "del", hit)
                else:
                    hit_h = profiler.fetch(
                        "kv.delete", "del",
                        lambda: hit[:nb].cpu().numpy(),
                        n_ops=nb, t_launch_ns=t_l, ring=True,
                        events=ev.get("dels"))
                t_l = 0
                status[dels] = np.where(hit_h, 0, -1)
        if "gets" in handles:
            with self.timers.phase("read"):
                gets, got, nb = handles["gets"]
                if nb is None:  # plane: request-ordered PlaneGets
                    pg = plane_fetch("plane.get", "get", got)
                    found_h = np.asarray(pg.found, bool)
                    if self.config.paged and found_h.any():
                        # hit rows straight out of the routed buffer
                        self.engine.arena[reqs["page_off"][gets][found_h]] \
                            = pg.hit_rows()
                else:
                    out, order, found, nfound = got

                    def _fetch_gets():
                        found_h = found[:nb].cpu().numpy()
                        if self.config.paged:
                            # only the hit rows cross (device-compacted)
                            nf = int(nfound)
                            if nf:
                                pages = u32.to_numpy(out[:nf])
                                src = order[:nf].cpu().numpy()
                                self.engine.arena[
                                    reqs["page_off"][gets][src]] = pages
                        return found_h

                    found_h = profiler.fetch(
                        "kv.get", "get", _fetch_gets, n_ops=nb,
                        t_launch_ns=t_l, ring=True, events=ev.get("gets"))
                # (unpaged mode returns hit/miss status only, like the
                # reference's TX_READ_COMMITTED/ABORTED imm)
                status[gets] = np.where(found_h, 0, -1)
        with self.timers.phase("poll"):
            self.engine.complete(reqs["req_id"], status)
