#!/usr/bin/env python
"""test_KV-equivalent benchmark — insert-then-get over uniform keys (twin
of `pmdfc_tpu/bench/test_kv.py`).

Mirrors the reference harness (`server/test_KV.cpp:204-341`): phase 1 inserts
N uniform random keys with value=key, phase 2 gets them all back and counts
`failedSearch`; reports usec/req and ops/sec for both phases.

Baseline (BASELINE.md): the reference's own `kv_cceh` (DCCEH DRAM index,
`server/src/cceh.cpp`) measured on a host CPU, single thread, 10M uniform
keys: Insert 1.896 Mops/s, Get 4.899 Mops/s. `vs_baseline` below is GET
throughput vs. that 4.899 Mops/s.

The JAX harness's jitted steps (`insert_step`, `get_step`, `get_phase`)
are the port's `KV` verbs on device tensors: each batch of keys is made on
the device once, `KV.insert(kb, kb)` and `KV.get(kb)` take and return
device tensors (no host copy of keys or values), and the failedSearch
accounting (a miss, or a hit whose value is not its key) sums on the
device; each phase ends in one host read. `--device` (default `cuda`) is
the KV's device. Keys are `gen_input.uniform`'s, as the JAX harness's.

Prints ONE JSON line with the JAX harness's keys ({"metric", "value",
"unit", "vs_baseline", ...}) and `found` (keys the GET phase served with
their value). The exit code is 1 when `failed_search` is not 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

BASELINE_GET_MOPS = 4.899  # reference kv_cceh DRAM, single thread
BASELINE_INSERT_MOPS = 1.896
# Reference per-op latency distribution through the same kv_cceh facade
# build (BASELINE.md "per-op latency"): the 'matching p99' side.
BASELINE_GET_P50_NS = 320
BASELINE_GET_P99_NS = 668
BASELINE_GET_P999_NS = 3375
BASELINE_INSERT_P50_NS = 613
BASELINE_INSERT_P99_NS = 1141


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=32_000_000, help="number of keys")
    p.add_argument("--dataset", help="key dataset file (ref test_KV -d)")
    p.add_argument("--batch", type=int, default=8 << 20,
                   help="keys per device batch")
    p.add_argument("--capacity", type=int, default=1 << 25,
                   help="index slots")
    p.add_argument("--index", default="linear",
                   help="index kind (config.IndexKind)")
    p.add_argument("--cluster-slots", type=int, default=16,
                   help="lanes per cluster row (probe window width; 16 = "
                        "the reference linear default)")
    p.add_argument("--bloom", action="store_true", help="enable bloom filter")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--no-engine", action="store_true",
                   help="skip the engine-path p99 phase")
    p.add_argument("--engine-batch", type=int, default=1 << 17,
                   help="coalescer device batch (the engine's flush cap)")
    p.add_argument("--engine-timeout-us", type=int, default=2000,
                   help="adaptive flush deadline")
    p.add_argument("--engine-threads", type=int, default=8)
    p.add_argument("--engine-client-batch", type=int, default=16384,
                   help="keys per client verb (ref BATCH_SIZE=4 pages/verb)")
    p.add_argument("--engine-inflight", type=int, default=4,
                   help="verbs each client keeps in flight")
    p.add_argument("--engine-secs", type=float, default=6.0,
                   help="timed window per phase")
    p.add_argument("--sweep", action="store_true",
                   help="print a throughput-vs-p99 curve over batch/timeout")
    p.add_argument("--history", default=None,
                   help="BENCH_HISTORY.jsonl path for on-card evidence log")
    args = p.parse_args(argv)

    import torch

    from pmdfc_tpu_torch.bench.common import stamp_live_device
    from pmdfc_tpu_torch.bench.gen_input import load as load_dataset, uniform
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, IndexKind,
                                        KVConfig)
    from pmdfc_tpu_torch.kv import KV, STAT_NAMES

    cfg = KVConfig(
        index=IndexConfig(kind=IndexKind(args.index), capacity=args.capacity,
                          cluster_slots=args.cluster_slots),
        bloom=BloomConfig(num_bits=1 << 26) if args.bloom else None,
        paged=False,  # test_KV stores value=key (`server/test_KV.cpp:204-258`)
    )
    kv = KV(cfg, device=args.device)
    dev = kv.device
    log(f"[bench] device: {dev}"
        + (f":{torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
           else ""))

    if args.dataset:
        keys = load_dataset(args.dataset)
        args.n = len(keys)
    else:
        keys = uniform(args.n)  # value = key, like the reference harness

    # whole batches only: shrink the batch rather than inflate the op count
    b = min(args.batch, args.n)
    nb = args.n // b
    args.n = nb * b
    # each batch its own device tensor (u32 words as int32 bits)
    kb_list = [torch.from_numpy(np.ascontiguousarray(
        keys[i * b:(i + 1) * b]).view(np.int32)).to(dev) for i in range(nb)]

    def insert_step(kb):
        return kv.insert(kb, kb).dropped.sum()

    def get_step(kb):
        out, found = kv.get(kb)
        return ((~found) | (found & (out != kb).any(-1))).sum()

    # warmup on a scratch KV of the same shapes (first allocations; no
    # state of the measured KV is touched)
    warm = KV(cfg, device=dev)
    warm.insert(kb_list[0], kb_list[0])
    warm.get(kb_list[0])
    del warm
    _sync(dev)
    log(f"[bench] warmed; {nb} batches x {b} keys")

    # phase 1: insert
    t0 = time.perf_counter()
    drops = [insert_step(kb) for kb in kb_list]
    dropped = int(torch.stack(drops).sum())  # the one host read
    t_ins = time.perf_counter() - t0
    ins_mops = args.n / t_ins / 1e6

    # phase 2: get throughput + on-device failedSearch
    t0 = time.perf_counter()
    bads = [get_step(kb) for kb in kb_list]
    bad = int(torch.stack(bads).sum())
    t_get = time.perf_counter() - t0
    get_mops = args.n / t_get / 1e6
    # clean-cache rule: misses are only legal when evicted/dropped
    evictions = int(kv.state.stats[STAT_NAMES.index("evictions")])
    failed = max(0, bad - evictions - dropped)

    # phase 3: latency — synchronous round-trips of one batch each
    lat = []
    for i in range(min(64, nb * 4)):
        tb = time.perf_counter()
        int(get_step(kb_list[i % nb]))
        lat.append(time.perf_counter() - tb)
    p99_batch_ms = float(np.percentile(np.array(lat), 99) * 1e3)

    log(
        f"[bench] Insertion: {1/ins_mops:.4f} usec/req  "
        f"{ins_mops*1e6:.0f} ops/sec\n"
        f"[bench] Search:    {1/get_mops:.4f} usec/req  "
        f"{get_mops*1e6:.0f} ops/sec\n"
        f"[bench] p99 batch latency {p99_batch_ms:.2f} ms  ({b} keys/batch)\n"
        f"[bench] {failed} failedSearch ({bad} raw misses/mismatches)"
    )

    # host<->device link diagnostic (8 MB each way)
    probe = torch.zeros(1 << 21, dtype=torch.int32)
    probe.to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    dev_arr = probe.to(dev)
    _sync(dev)
    up_mbs = probe.nbytes / (time.perf_counter() - t0) / 1e6
    t0 = time.perf_counter()
    dev_arr.cpu()
    down_mbs = probe.nbytes / (time.perf_counter() - t0) / 1e6
    log(f"[bench] link: h2d {up_mbs:.0f} MB/s  d2h {down_mbs:.0f} MB/s")

    # phase 4: per-op p99 THROUGH the coalescer (engine + KVServer)
    engine_stats = {}
    if not args.no_engine:
        # a point is (flush_cap, flush_us, threads, client_batch, inflight)
        mine = (args.engine_batch, args.engine_timeout_us,
                args.engine_threads, args.engine_client_batch,
                args.engine_inflight)
        points = [mine]
        if args.sweep:
            # the JAX harness's curve: shallow clients over flush shapes,
            # then deep clients
            points += [(b, t, 4, 4096, 2) for b in (1 << 11, 1 << 13, 1 << 15)
                       for t in (100, 300, 1000)]
            points += [(1 << 17, 2000, 8, 1 << 14, 4),
                       (1 << 17, 2000, 8, 1 << 14, 8),
                       (1 << 17, 2000, 16, 1 << 14, 4),
                       (1 << 18, 2000, 8, 1 << 15, 8),
                       (1 << 17, 500, 8, 1 << 14, 4)]
            points = list(dict.fromkeys(points))
        sweep_points = []
        for point in points:
            try:
                r = _engine_phase(kv, cfg, keys, args, *point)
            except Exception as e:  # noqa: BLE001 — reported in the row
                log(f"[bench] engine phase {point} FAILED: {e!r}")
                if point == mine:
                    engine_stats = {"engine_error": repr(e)}
                continue
            log(f"[bench] engine batch={point[0]} flush={point[1]}us "
                f"threads={point[2]} verb={point[3]} inflight={point[4]}: "
                f"{r['engine_get_mops']:.3f} Mops/s  "
                f"p50={r['p50_op_us']:.0f}us p99={r['p99_op_us']:.0f}us")
            sweep_points.append({
                "batch": point[0], "flush_us": point[1],
                "threads": point[2], "client_batch": point[3],
                "inflight": point[4], "mops": r["engine_get_mops"],
                "p50_op_us": r["p50_op_us"], "p99_op_us": r["p99_op_us"]})
            if point == mine:
                engine_stats = r
        if args.sweep and sweep_points:
            engine_stats = dict(engine_stats, engine_sweep=sweep_points)

    # roofline self-report against this device's measured random-gather
    # rate at the index's row shape
    from pmdfc_tpu_torch.models.base import get_index_ops

    _ops = get_index_ops(IndexKind(args.index))
    rows_per_get = _ops.rows_per_get
    wall_slots = _ops.gather_row_slots or args.cluster_slots
    row_bytes = wall_slots * 16  # 8 B key + 8 B value per lane
    gather_wall_mrows = _measure_gather_wall(args.capacity, wall_slots, dev)
    log(f"[bench] measured random-gather wall: "
        f"{gather_wall_mrows:.1f} Mrows/s ({row_bytes} B rows)")
    record = {
        "metric": "test_KV_get_throughput",
        "value": round(get_mops, 3),
        "unit": "Mops/s",
        "vs_baseline": round(get_mops / BASELINE_GET_MOPS, 2),
        "insert_mops": round(ins_mops, 3),
        "insert_vs_baseline": round(ins_mops / BASELINE_INSERT_MOPS, 2),
        "p99_batch_ms": round(p99_batch_ms, 3),
        "baseline_get_p99_ns": BASELINE_GET_P99_NS,
        "baseline_get_p50_ns": BASELINE_GET_P50_NS,
        "failed_search": failed,
        "found": args.n - bad,
        "n": args.n,
        "batch": b,
        "index": args.index,
        "insert_path": os.environ.get("PMDFC_INSERT_PATH", "element"),
        "link_h2d_mbs": round(up_mbs, 1),
        "link_d2h_mbs": round(down_mbs, 1),
        "gather_bytes_per_s": (
            round(get_mops * 1e6 * rows_per_get * row_bytes)
            if rows_per_get else None),
        "gather_wall_mrows": round(gather_wall_mrows, 1),
        "gather_wall_frac": (
            round(get_mops * rows_per_get / gather_wall_mrows, 3)
            if rows_per_get else None),
        **engine_stats,
    }
    stamp_live_device(record, "direct", args.device)
    if record["device"] == "cuda":
        from pmdfc_tpu_torch.bench.common import append_history

        append_history(args.history, record)
    print(json.dumps(record))
    if args.history and record["device"] != "cuda":
        return 3  # an on-card evidence request run off the card
    return 1 if failed else 0


def _measure_gather_wall(capacity: int, cluster_slots: int, dev,
                         m: int = 1 << 22) -> float:
    """This device's random-row-gather rate (Mrows/s) at the index's row
    shape: gather m random rows of a [capacity/slots, slots*4]-word table
    and reduce to one scalar, closed by its host read."""
    import torch

    n_rows = max(1, capacity // cluster_slots)
    words = cluster_slots * 4
    table = torch.arange(n_rows * words, dtype=torch.int32,
                         device=dev).reshape(n_rows, words)
    idx = torch.from_numpy(np.random.default_rng(7).integers(
        0, n_rows, m).astype(np.int64)).to(dev)

    def gather():
        return int(table[idx].sum(dtype=torch.int64))

    gather()  # warm
    t0 = time.perf_counter()
    gather()
    return m / (time.perf_counter() - t0) / 1e6


def _engine_phase(kv, cfg, keys, args, engine_batch: int, timeout_us: int,
                  nthreads: int, cb: int, inflight: int) -> dict:
    """Sustained GET traffic from N client threads through the native
    coalescing engine into a KVServer wrapping the already-built KV.

    Per-op latency = submit→completion of the op's verb (every key in a
    client verb completes together, like the reference's 4-page fused
    verb, `client/rdpma.c:307-451`)."""
    import threading
    from collections import deque

    from pmdfc_tpu_torch.runtime.engine import OP_GET, Engine
    from pmdfc_tpu_torch.runtime.server import KVServer

    inflight = max(1, inflight)
    # ids stay live from submit until the waiter reads them
    outstanding = nthreads * cb * inflight
    qcap = max(1 << 14, 1 << (cb - 1).bit_length())
    eng = Engine(num_queues=8, queue_cap=qcap, batch=engine_batch,
                 timeout_us=timeout_us, arena_pages=16, page_bytes=64,
                 comp_slots=2 * outstanding)
    srv = KVServer(cfg, engine=eng, kv=kv)
    srv.warmup(max_width=min(engine_batch, outstanding))
    srv.start()
    stop_at = [0.0]
    lats: list[list[float]] = [[] for _ in range(nthreads)]
    opcount = np.zeros(nthreads, np.int64)
    errors: list[BaseException] = []

    def client(t):
        try:
            rng = np.random.default_rng(t)
            pending: deque = deque()
            while time.perf_counter() < stop_at[0]:
                while len(pending) < inflight:
                    lo = int(rng.integers(0, max(1, len(keys) - cb)))
                    kb = keys[lo: lo + cb]
                    t0 = time.perf_counter()
                    base = eng.submit_batch(t % 8, OP_GET, kb,
                                            timeout_us=300_000_000)
                    pending.append((t0, base, len(kb)))
                t0, base, n = pending.popleft()
                eng.wait_many(base, n, timeout_us=300_000_000)
                lats[t].append(time.perf_counter() - t0)
                opcount[t] += n
            while pending:
                t0, base, n = pending.popleft()
                eng.wait_many(base, n, timeout_us=300_000_000)
                lats[t].append(time.perf_counter() - t0)
                opcount[t] += n
        except Exception as e:  # noqa: BLE001 — surfaced by the caller
            errors.append(e)

    def run(secs: float) -> float:
        stop_at[0] = time.perf_counter() + secs
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(nthreads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return time.perf_counter() - t_start

    try:
        run(min(3.0, args.engine_secs))  # warm the flush widths
        for lt in lats:
            lt.clear()
        opcount[:] = 0
        window = run(args.engine_secs)
    finally:
        srv.stop()
    if errors:
        raise RuntimeError(f"engine clients failed: {errors[0]!r}")
    all_lats = np.array([x for lt in lats for x in lt])
    if len(all_lats) == 0:
        raise RuntimeError("engine phase produced no latency samples")
    return {
        "engine_get_mops": round(int(opcount.sum()) / window / 1e6, 4),
        "p50_op_us": round(float(np.percentile(all_lats, 50) * 1e6), 1),
        "p99_op_us": round(float(np.percentile(all_lats, 99) * 1e6), 1),
        "engine_client_batch": cb,
        "engine_batch": engine_batch,
        "engine_flush_us": timeout_us,
        "engine_threads": nthreads,
        "engine_inflight": inflight,
    }


if __name__ == "__main__":
    sys.exit(main())
