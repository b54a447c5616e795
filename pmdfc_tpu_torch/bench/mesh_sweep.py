"""Mesh serving-plane sweep — aggregate GET throughput vs shard count
(twin of `pmdfc_tpu/bench/mesh_sweep.py`).

Measures the partitioned serving plane (`parallel/plane.py` behind the
coalesced `NetServer`) at 1/2/4/8 shards against the `PMDFC_MESH=off`
single-device serving path at the same serving shape. All configs serve
the same preloaded key set with total table capacity held CONSTANT
across shard counts (per-shard capacity = total / n), 8 pipelined
connections by default, min-of-rounds interleaved like net_sweep.

The JAX harness forces host devices; the port's grid names `--device`
once per shard (`make_mesh([device] * n)`: on one card every shard is a
state on that card, and the plane runs the shards one after another).

Checks, each fatal: every verb of every round is content-verified (every
hit the key's page; a preloaded key that misses fails the run),
`misses == Σ miss_*` on every plane's stats and on every shard's row of
`shard_report()`, and on a card one fused-GET launch per shard per plane
GET phase.

Two ratios come out:

- ``ratio_plane_vs_off`` — the mesh plane (best shard count) over the
  single-device serving path.
- ``ratio_{n}shard_vs_1shard`` — the shard-count curve. On one card the
  shards' programs run serially, so it prices the plane's per-shard
  overhead, not parallel devices.

``--replica R1,R2`` adds the 2-D grid (kv shards × replica lanes): for
every lane count > 1 it prices REPLICATED PUTS both ways at equal
device budget and equal durability — **fused** (``tcp_coalesced_mesh2d``:
ONE NetServer over a ``(kv=s, replica=r)`` plane; a put is one wire verb
writing all r lanes) against **host** (``tcp_replica_host``: r separate
1-D NetServers behind a `ReplicaGroup` with rf=r).

Run: `python -m pmdfc_tpu_torch.bench.mesh_sweep --smoke --device cpu`
or full on a card.
"""

from __future__ import annotations

import argparse
import json
import os


def _count_phases(skv) -> dict:
    """Wrap the plane's GET verb: counts the GET phases that routed keys
    (each launches the fused GET once per shard)."""
    n = {"phases": 0}
    real = skv.plane_get

    def plane_get(keys):
        out = real(keys)
        if out.b:
            n["phases"] += 1
        return out

    skv.plane_get = plane_get
    return n


def _check_causes(stats: dict, label: str) -> None:
    from pmdfc_tpu_torch.kv import MISS_CAUSE_NAMES

    if stats["misses"] != sum(stats[c] for c in MISS_CAUSE_NAMES):
        raise AssertionError(f"{label}: misses != sum of miss causes")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--shards", default="1,2,4,8")
    p.add_argument("--connections", type=int, default=8)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--verb", type=int, default=64,
                   help="keys per GET verb")
    p.add_argument("--gets", type=int, default=30,
                   help="GET verbs per worker per round")
    p.add_argument("--replica", default="1",
                   help="replica-lane grid; counts > 1 add the fused-"
                        "vs-host replicated-PUT comparison")
    p.add_argument("--puts", type=int, default=20,
                   help="PUT verbs per worker per round (replica grid)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--page-words", type=int, default=64)
    p.add_argument("--capacity", type=int, default=1 << 14,
                   help="TOTAL table capacity (split across shards)")
    p.add_argument("--preload", type=int, default=6144)
    p.add_argument("--flush-timeout-us", type=int, default=2000)
    p.add_argument("--settle-us", type=int, default=200)
    p.add_argument("--out", default=None)
    p.add_argument("--history", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="tiny grid, asserts the machinery, fast exit")
    args = p.parse_args(argv)

    if args.smoke:
        from pmdfc_tpu_torch.bench.common import smoke_sizes

        smoke_sizes(p, args, shards="1,2", connections=4, window=4,
                    gets=10, rounds=2, verb=32, preload=2048,
                    capacity=1 << 13, puts=8)
        if args.replica != "1":
            args.replica = "2"

    import numpy as np
    import torch

    from pmdfc_tpu_torch.bench.common import (append_history,
                                              launches_per_get,
                                              stamp_live_device)
    from pmdfc_tpu_torch.bench.net_sweep import (_fill_pages, _key_pool,
                                                 _run_config)
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        MeshConfig, NetConfig, mesh_enabled)
    from pmdfc_tpu_torch.ops import fused
    from pmdfc_tpu_torch.parallel.plane import make_serving_backend
    from pmdfc_tpu_torch.parallel.shard import make_mesh, make_mesh2d
    from pmdfc_tpu_torch.runtime.net import NetServer

    if not mesh_enabled():
        print("[mesh_sweep] PMDFC_MESH=off — nothing to sweep")
        return 2

    dev = torch.device(args.device)
    per_launch = launches_per_get(dev)
    shard_grid = [int(x) for x in args.shards.split(",") if x]
    serial = True  # one device named per shard: the shards run in turn

    def cfg_for(n_shards: int) -> KVConfig:
        return KVConfig(
            index=IndexConfig(capacity=max(256, args.capacity // n_shards)),
            bloom=BloomConfig(num_bits=1 << 20),
            paged=True, page_words=args.page_words)

    pool = _key_pool(args.preload)
    pages = _fill_pages(pool, args.page_words)

    def build(kind, n_shards=1):
        """(backend, server, live keys, phase counter) for one grid
        point; preloaded + warmed."""
        counter = None
        if kind == "off":
            prev = os.environ.get("PMDFC_MESH")
            os.environ["PMDFC_MESH"] = "off"
            try:
                be = make_serving_backend(cfg_for(1), device=dev)
            finally:
                if prev is None:
                    del os.environ["PMDFC_MESH"]
                else:
                    os.environ["PMDFC_MESH"] = prev
        else:
            be = make_serving_backend(cfg_for(n_shards),
                                      MeshConfig(n_shards=n_shards),
                                      mesh=make_mesh([dev] * n_shards))
            be.warmup(2048 if not args.smoke else 512, kinds=("get",))
            counter = _count_phases(be.skv)
        be.put(pool, pages)
        _, landed = be.get(pool)
        live = pool[np.asarray(landed, bool)]
        srv = NetServer(
            lambda: be,
            net=NetConfig(flush_timeout_us=args.flush_timeout_us,
                          settle_us=args.settle_us)).start()
        return be, srv, live, counter

    points = [("off", 1)] + [("mesh", s) for s in shard_grid]
    built = {pt: build(*pt) for pt in points}
    best: dict = {}
    launch_checks = 0
    try:
        for rnd in range(args.rounds + 1):  # round 0 = warmup
            for pt in points:
                be, srv, live, counter = built[pt]
                n0 = sum(fused.launches.values())
                ph0 = counter["phases"] if counter else 0
                res = _run_config(
                    "127.0.0.1", srv.port, conns=args.connections,
                    window=args.window, verb=args.verb,
                    gets=max(4, args.gets // (2 if rnd == 0 else 1)),
                    pipe=True, page_words=args.page_words, pool=live,
                    verify=True)
                if res["misses"]:
                    raise RuntimeError(
                        f"{pt}: {res['misses']} preloaded keys missed")
                if counter is not None:
                    phases = counter["phases"] - ph0
                    got = sum(fused.launches.values()) - n0
                    if got != per_launch * pt[1] * phases:
                        raise AssertionError(
                            f"{pt}: {got} fused-GET launches for {phases} "
                            f"GET phases x {pt[1]} shards")
                    launch_checks += 1
                if rnd == 0:
                    continue
                if pt not in best \
                        or res["pages_per_s"] > best[pt]["pages_per_s"]:
                    best[pt] = res
                kind, s = pt
                print(f"[mesh_sweep] r{rnd} {kind} shards={s}: "
                      f"{res['pages_per_s'] / 1e3:.1f} Kpages/s")
    finally:
        for be, srv, _, _ in built.values():
            srv.stop()
    for (kind, s), (be, _, _, _) in built.items():
        st = be.skv.stats() if kind == "mesh" else be.kv.stats()
        _check_causes(st, f"{kind} shards={s}")
        if kind == "mesh":
            from pmdfc_tpu_torch.kv import MISS_CAUSE_NAMES

            rep = be.skv.shard_report()["stats"]
            if not all(rep["misses"][i] == sum(rep[c][i]
                                               for c in MISS_CAUSE_NAMES)
                       for i in range(s)):
                raise AssertionError(f"{kind} shards={s}: a shard's misses "
                                     "!= the sum of its miss causes")

    rows = []
    for (kind, s), res in sorted(best.items()):
        row = {
            "metric": "mesh_get_throughput",
            "value": round(res["pages_per_s"] / 1e6, 4),
            "unit": "Mpages/s",
            "transport": ("tcp_coalesced_mesh" if kind == "mesh"
                          else "tcp_coalesced"),
            "n_shards": s if kind == "mesh" else 0,
            "connections": args.connections,
            "window": args.window,
            "verb_keys": args.verb,
            "page_words": args.page_words,
            "capacity_total": args.capacity,
            "rounds": args.rounds,
            "best_wall_s": round(res["wall_s"], 4),
            "sequential_host_devices": serial,
            "host_evidence": True,
        }
        stamp_live_device(row, "direct", dev)
        rows.append(row)
        append_history(args.history, row)

    def rate(pt):
        r = best.get(pt)
        return r["pages_per_s"] if r else None

    summary: dict = {"rows": rows, "sequential_host_devices": serial,
                     "launch_checks": launch_checks}
    off, one = rate(("off", 1)), rate(("mesh", 1))
    best_mesh = max((rate(("mesh", s)) for s in shard_grid
                     if rate(("mesh", s))), default=None)
    if off and best_mesh:
        summary["ratio_plane_vs_off"] = round(best_mesh / off, 2)
    if one:
        for s in shard_grid[1:]:
            r = rate(("mesh", s))
            if r:
                summary[f"ratio_{s}shard_vs_1shard"] = round(r / one, 2)

    # --- 2-D grid: replicated PUTs, fused plane vs host ReplicaGroup ---
    rep_grid = sorted({int(x) for x in args.replica.split(",") if x
                       and int(x) > 1})
    rep_points = [(s, r) for s in shard_grid for r in rep_grid]
    rep_best: dict = {}
    if rep_points:
        import threading
        import time

        from pmdfc_tpu_torch.client.replica import ReplicaGroup
        from pmdfc_tpu_torch.config import ReplicaConfig
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        put_workers = max(2, args.connections)

        def put_round(group, verify: bool) -> dict:
            """One measured round: `put_workers` threads each issuing
            `args.puts` replicated PUT verbs of `args.verb` keys."""
            barrier = threading.Barrier(put_workers + 1)
            errs: list = []

            def worker(wi: int) -> None:
                rng = np.random.default_rng(500 + 31 * wi)
                try:
                    barrier.wait()
                    for _ in range(args.puts):
                        lo = int(rng.integers(0, len(pool) - args.verb))
                        group.put(pool[lo:lo + args.verb],
                                  pages[lo:lo + args.verb])
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)

            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(put_workers)]
            for t in ts:
                t.start()
            barrier.wait()
            t0 = time.perf_counter()
            for t in ts:
                t.join()
            wall = time.perf_counter() - t0
            if errs:
                raise errs[0]
            if verify:
                out, found = group.get(pool[:64])
                wrongv = int((out[found]
                              != pages[:64][found]).any(axis=1).sum())
                if not found.all() or wrongv:
                    raise RuntimeError(
                        f"replicated-put verify failed: found "
                        f"{int(found.sum())}/64, wrong_pages={wrongv}")
            return {"pages_per_s": put_workers * args.puts * args.verb
                    / wall, "wall_s": wall}

        ncfg = NetConfig(flush_timeout_us=args.flush_timeout_us,
                         settle_us=args.settle_us)
        rcfg = lambda n, rf: ReplicaConfig(  # noqa: E731
            n_replicas=n, rf=rf, repair_interval_s=0, hedge_ms=0)
        warm_w = 1024 if not args.smoke else 256
        for s, r in rep_points:
            # fused: ONE server over a (kv=s, replica=r) plane — a put
            # is one wire verb + one plane verb writing all r lanes
            fb = make_serving_backend(
                cfg_for(s), MeshConfig(n_shards=s, replica_axis=r),
                mesh=make_mesh2d(s, r, [dev] * (s * r)))
            fb.warmup(warm_w, kinds=("put", "get"))
            fsrv = NetServer(lambda be=fb: be, net=ncfg).start()
            fgrp = ReplicaGroup(
                [TcpBackend("127.0.0.1", fsrv.port,
                            page_words=args.page_words,
                            keepalive_s=None, op_timeout_s=120.0)],
                page_words=args.page_words, cfg=rcfg(1, 1))
            # host: r separate 1-D servers + rf=r group fan-out — a put
            # is r wire round-trips and r server flushes
            hbs = [make_serving_backend(cfg_for(s), MeshConfig(n_shards=s),
                                        mesh=make_mesh([dev] * s))
                   for _ in range(r)]
            for hb in hbs:
                hb.warmup(warm_w, kinds=("put", "get"))
            hsrvs = [NetServer(lambda be=hb: be, net=ncfg).start()
                     for hb in hbs]
            hgrp = ReplicaGroup(
                [TcpBackend("127.0.0.1", sv.port,
                            page_words=args.page_words,
                            keepalive_s=None, op_timeout_s=120.0)
                 for sv in hsrvs],
                page_words=args.page_words, cfg=rcfg(r, r))
            try:
                # preload once so the round-0 verify reads known bytes
                # (the storm itself puts random slices), in warmed widths
                for lo in range(0, len(pool), warm_w // 2):
                    sel = slice(lo, lo + warm_w // 2)
                    fgrp.put(pool[sel], pages[sel])
                    hgrp.put(pool[sel], pages[sel])
                for rnd in range(args.rounds + 1):  # round 0 = verify
                    for name, grp in (("fused", fgrp), ("host", hgrp)):
                        res = put_round(grp, verify=rnd == 0)
                        if rnd == 0:
                            continue
                        key = (s, r, name)
                        if key not in rep_best or res["pages_per_s"] \
                                > rep_best[key]["pages_per_s"]:
                            rep_best[key] = res
                        print(f"[mesh_sweep] r{rnd} put {name} "
                              f"kv={s} lanes={r}: "
                              f"{res['pages_per_s'] / 1e3:.1f} Kpages/s")
            finally:
                fgrp.close()
                hgrp.close()
                fsrv.stop()
                for sv in hsrvs:
                    sv.stop()
        for (s, r, name), res in sorted(rep_best.items()):
            row = {
                "metric": "mesh2d_put_throughput",
                "value": round(res["pages_per_s"] / 1e6, 4),
                "unit": "Mpages/s",
                "transport": ("tcp_coalesced_mesh2d" if name == "fused"
                              else "tcp_replica_host"),
                "n_shards": s,
                "replica_lanes": r,
                "rf": r,
                "connections": put_workers,
                "window": args.window,
                "verb_keys": args.verb,
                "page_words": args.page_words,
                "capacity_total": args.capacity,
                "rounds": args.rounds,
                "best_wall_s": round(res["wall_s"], 4),
                "sequential_host_devices": serial,
                "host_evidence": True,
            }
            stamp_live_device(row, "direct", dev)
            rows.append(row)
            append_history(args.history, row)
        for s, r in rep_points:
            f = rep_best.get((s, r, "fused"))
            h = rep_best.get((s, r, "host"))
            if f and h:
                summary[f"ratio_put_fused_vs_host_{s}x{r}"] = round(
                    f["pages_per_s"] / h["pages_per_s"], 2)

    stamp_live_device(summary, "direct", dev)
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    if args.smoke:
        # machinery gates: verified bytes through every plane, per-shard
        # attribution alive, and the plane not slower than half the
        # single-device path (the regression tripwire)
        be2 = built[("mesh", shard_grid[-1])][0]
        ops = sum(int(c.value) for c in be2._c_shard)
        ok = bool(best) and off and best_mesh and ops > 0 \
            and best_mesh >= 0.5 * off
        if rep_points:
            for s, r in rep_points:
                f = rep_best.get((s, r, "fused"))
                h = rep_best.get((s, r, "host"))
                ratio = (f["pages_per_s"] / h["pages_per_s"]
                         if f and h else 0)
                print(f"[mesh_sweep] smoke put fused/host {s}x{r} = "
                      f"{ratio:.2f}")
                ok = ok and f and h and ratio >= 0.5
        print(f"[mesh_sweep] smoke {'OK' if ok else 'FAIL'} "
              f"(plane/off={best_mesh / off if off else 0:.2f}, "
              f"routed_ops={ops})")
        return 0 if ok else 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
