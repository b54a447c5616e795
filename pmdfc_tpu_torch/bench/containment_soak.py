"""Blast-radius containment soak — poison storm, shard kill, deadline ramp
(twin of `pmdfc_tpu/bench/containment_soak.py`).

Three drills against the containment machinery (`MSG_NACK` + bisection
in `runtime/net.py`, `ShardQuarantine` in `runtime/failure.py` +
`parallel/plane.py`, end-to-end deadlines on the wire):

1. POISON STORM (net tier): ``b`` connections fuse one coalesced flush;
   exactly one op is poisoned (`FaultPlan.poison_keys` raises inside the
   device call). The flush must bisect the fused batch, NACK the one
   culprit, and answer every other op normally — the gate pins
   ``bisect_failures <= ceil(log2 b)``, one ``poison_ops`` isolation,
   ZERO healthy-connection drops, and the resubmitted poison op refused
   at STAGING (`poison_refused`, no second isolation). A storm phase
   then measures healthy goodput while the victim keeps resubmitting.

2. SHARD KILL (plane tier): a grid of `--devices` shards, each a state
   on `--device` (the port names the device once per shard where the JAX
   harness forces host devices), serves through
   `PlaneBackend(fault_plan=...)`; `fail_shard(k)` makes every launch
   touching shard ``k`` raise `ShardFault`. The shard's breaker trips,
   its rows degrade to `miss_quarantined` host-side (healthy shards keep
   serving), `misses == sum of causes` stays bit-exact on `stats()` AND
   `shard_report()`, and healing the shard re-admits it through the
   half-open probe (journaled invalidations replayed first).

3. DEADLINE PROOF + RAMP: with a deliberately slow flush dwell and a
   1 ms client budget, every staged op expires before dispatch — the
   pool is POISONED, so any op that *did* reach the device would raise:
   ``poison_ops == 0`` is a hard proof that expired ops never launch
   device work (they come back as legal `NACK_DEADLINE` misses). The
   ramp arms then compare goodput under ``--ramp`` x connection overload
   with and without a generous budget (`containment_deadline_goodput_
   frac`, lower-bounded in review via check_bench, not the smoke).

Rows for `--history` (host_evidence; `tools/check_bench.py` reads them):

- ``containment_bisect_failures`` (count, lower-better) with its
  ``bound`` = ceil(log2 b) attached.
- ``containment_victim_gets_per_s`` (ops/s) — healthy goodput while a
  poison storm is being refused at staging.
- ``containment_healthy_hit_frac`` (frac) — healthy-shard hit rate
  under quarantine over the no-fault baseline (gate: >= 0.9).
- ``containment_deadline_goodput_frac`` (frac) — overload goodput with
  the budget on over the budget-off baseline.

The poison and deadline drills serve the host `LocalBackend` (their
subject is the wire); the shard-kill drill serves the port's plane on
`--device` (default `cuda`). Every run also requires no serve error on
any server.

Run: `python -m pmdfc_tpu_torch.bench.containment_soak --smoke --device
cpu` (short arms + machinery gate) or full.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import threading
import time


def _srv_stats(srv) -> dict:
    return srv.stats.snapshot()


def _poison_storm(args) -> dict:
    import numpy as np

    from pmdfc_tpu_torch.bench.net_sweep import _fill_pages, _key_pool
    from pmdfc_tpu_torch.client.backends import LocalBackend
    from pmdfc_tpu_torch.config import NetConfig
    from pmdfc_tpu_torch.runtime.failure import FaultPlan, FaultyBackend
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    b = args.fanin
    plan = FaultPlan()
    shared = FaultyBackend(
        LocalBackend(args.page_words, args.capacity), plan)
    pool = _key_pool(args.keys, seed=7)
    shared.put(pool, _fill_pages(pool, args.page_words))
    bad = _key_pool(8, seed=101)  # disjoint seed: the poison working set
    plan.poison_keys(bad)

    srv = NetServer(lambda: shared,
                    net=NetConfig(flush_timeout_us=150_000,
                                  settle_us=60_000)).start()
    out: dict = {"errors": []}
    try:
        bes = [TcpBackend("127.0.0.1", srv.port,
                          page_words=args.page_words, keepalive_s=None)
               for _ in range(b)]
        if not all(be.nack for be in bes):
            raise RuntimeError("containment not negotiated")
        # -- controlled isolation: b ops fused into one flush, 1 poison --
        barrier = threading.Barrier(b)
        errs: list = []

        def one_put(ci: int) -> None:
            try:
                barrier.wait()
                if ci == 0:
                    bes[ci].put(bad, _fill_pages(bad, args.page_words))
                else:
                    sl = pool[ci::b][:8]
                    bes[ci].put(sl, _fill_pages(sl, args.page_words))
            except Exception as e:  # noqa: BLE001 — gate surfaces it
                errs.append((ci, e))

        ts = [threading.Thread(target=one_put, args=(i,), daemon=True)
              for i in range(b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        st = _srv_stats(srv)
        out["isolation"] = {k: int(st[k]) for k in
                            ("bisect_failures", "bisect_launches",
                             "poison_ops", "nacks_sent",
                             "poison_refused")}
        out["bound"] = math.ceil(math.log2(b))
        out["errors"] += [f"conn{ci}: {e!r}" for ci, e in errs]
        # every healthy conn must still be alive and serving
        for ci in range(1, b):
            _, found = bes[ci].get(pool[ci::b][:8])
            if not found.all():
                out["errors"].append(f"conn{ci} lost its puts")
        # resubmit: refused at staging, no second isolation
        bes[0].put(bad, _fill_pages(bad, args.page_words))
        st = _srv_stats(srv)
        if not st["poison_refused"]:
            out["errors"].append("resubmit was not refused at staging")
        if st["poison_ops"] != out["isolation"]["poison_ops"]:
            out["errors"].append("resubmit re-ran isolation")
        # -- storm: healthy goodput while poison keeps resubmitting --
        stop = threading.Event()
        counts = [0] * b
        storm_errs: list = []

        def good_worker(ci: int) -> None:
            rng = np.random.default_rng(900 + ci)
            try:
                while not stop.is_set():
                    idx = rng.integers(0, len(pool), 16)
                    _, found = bes[ci].get(pool[idx])
                    counts[ci] += int(found.sum())
            except Exception as e:  # noqa: BLE001
                storm_errs.append((ci, e))

        def victim_worker() -> None:
            try:
                while not stop.is_set():
                    bes[0].put(bad, _fill_pages(bad, args.page_words))
                    counts[0] += 1
            except Exception as e:  # noqa: BLE001
                storm_errs.append((0, e))

        ts = [threading.Thread(target=victim_worker, daemon=True)]
        ts += [threading.Thread(target=good_worker, args=(i,),
                                daemon=True) for i in range(1, b)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        time.sleep(args.measure_s)
        stop.set()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        st = _srv_stats(srv)
        out["errors"] += [f"storm conn{ci}: {e!r}"
                          for ci, e in storm_errs]
        out["storm"] = {
            "victim_resubmits": counts[0],
            "healthy_hits_per_s": sum(counts[1:]) / wall,
            "poison_refused": int(st["poison_refused"]),
            # fingerprint TTL (30 s) outlives the storm: the ONE
            # isolation from the controlled drill must still stand
            "bisect_failures": int(st["bisect_failures"]),
        }
        for be in bes:
            be.close()
    finally:
        srv.stop()
        out["serve_errors"] = int(srv.stats["serve_errors"])
    return out


def _shard_kill(args) -> dict:
    import numpy as np

    from pmdfc_tpu_torch.bench.net_sweep import _fill_pages, _key_pool
    from pmdfc_tpu_torch.config import (BloomConfig, ContainmentConfig,
                                        IndexConfig, KVConfig, MeshConfig)
    from pmdfc_tpu_torch.parallel.shard import make_mesh
    from pmdfc_tpu_torch.kv import MISS_CAUSE_NAMES
    from pmdfc_tpu_torch.parallel.plane import make_serving_backend
    from pmdfc_tpu_torch.runtime.failure import FaultPlan, ShardFault

    plan = FaultPlan()
    cc = ContainmentConfig(quarantine_cooldown_s=0.2,
                           quarantine_max_cooldown_s=1.0)
    cfg = KVConfig(index=IndexConfig(capacity=args.capacity),
                   bloom=BloomConfig(num_bits=1 << 13),
                   paged=True, page_words=args.page_words)
    be = make_serving_backend(cfg, MeshConfig(n_shards=args.devices),
                              mesh=make_mesh([args.device] * args.devices),
                              containment=cc, fault_plan=plan)
    if be.__class__.__name__ != "PlaneBackend":
        return {"skipped": "mesh plane unavailable (PMDFC_MESH=off?)"}
    skv = be.skv
    pool = _key_pool(args.keys, seed=7)
    be.put(pool, _fill_pages(pool, args.page_words))
    _, res = be.get(pool)
    pool = pool[np.asarray(res, bool)]
    node = skv.node_of(pool)
    k = int(np.bincount(node, minlength=skv.n_shards).argmax())
    on_k = pool[node == k]
    off_k = pool[node != k]

    def hit_frac(keys) -> float:
        _, found = be.get(keys)
        return float(np.asarray(found, bool).mean()) if len(keys) else 0.0

    out: dict = {"errors": [], "shard": k,
                 "baseline_hit": hit_frac(off_k)}
    plan.fail_shard(k)
    faults = 0
    for _ in range(16):  # breaker needs quarantine_failures strikes
        try:
            be.get(pool[:64])
        except ShardFault:
            faults += 1
        if be.quarantine.quarantined():
            break
    if be.quarantine.quarantined() != [k]:
        out["errors"].append(
            f"shard {k} not quarantined after {faults} faults "
            f"(quarantined={be.quarantine.quarantined()})")
        plan.heal_shard(k)
        return out
    pre = skv.stats()
    for _ in range(4):  # quarantined serving: sick rows masked host-side
        try:
            be.get(pool)
        except ShardFault:  # a half-open probe raced in and failed
            pass
    st = skv.stats()
    out["quarantined_misses"] = int(st["miss_quarantined"]
                                    - pre["miss_quarantined"])
    out["healthy_hit"] = hit_frac(off_k)
    causes = {c: int(st[c]) for c in MISS_CAUSE_NAMES}
    if int(st["misses"]) != sum(causes.values()):
        out["errors"].append(f"misses {st['misses']} != sum of causes "
                             f"{sum(causes.values())} ({causes})")
    rep = skv.shard_report()["stats"]
    if sum(rep["misses"]) != sum(rep[c][i] for c in MISS_CAUSE_NAMES
                                 for i in range(skv.n_shards)):
        out["errors"].append("shard_report misses != sum of causes")
    if not out["quarantined_misses"]:
        out["errors"].append("no miss_quarantined attribution")
    # -- heal: half-open probe re-admits, journal replays first --
    plan.heal_shard(k)
    deadline = time.monotonic() + 10.0
    while be.quarantine.quarantined() and time.monotonic() < deadline:
        time.sleep(0.1)  # cooldown gate before the next probe window
        try:
            be.get(on_k[:32])
        except ShardFault:
            pass
    out["readmitted"] = not be.quarantine.quarantined()
    if not out["readmitted"]:
        out["errors"].append("shard never re-admitted after heal")
    out["post_heal_hit"] = hit_frac(on_k)
    out["quarantine"] = be.quarantine.report()["stats"]
    st = skv.stats()
    causes = {c: int(st[c]) for c in MISS_CAUSE_NAMES}
    if int(st["misses"]) != sum(causes.values()):
        out["errors"].append("misses != sum of causes after heal")
    return out


def _deadline(args) -> dict:
    import numpy as np

    from pmdfc_tpu_torch.bench.net_sweep import _fill_pages, _key_pool
    from pmdfc_tpu_torch.client.backends import LocalBackend
    from pmdfc_tpu_torch.config import NetConfig
    from pmdfc_tpu_torch.runtime.failure import FaultPlan, FaultyBackend
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    out: dict = {"errors": []}
    # -- proof arm: every staged op expires; the pool is poisoned, so a
    # single op reaching the device would raise — poison_ops == 0 is
    # the never-launched proof --
    plan = FaultPlan()
    shared = FaultyBackend(
        LocalBackend(args.page_words, args.capacity), plan)
    pool = _key_pool(256, seed=7)
    plan.poison_keys(pool)
    srv = NetServer(lambda: shared,
                    net=NetConfig(flush_timeout_us=200_000,
                                  settle_us=120_000)).start()
    try:
        with TcpBackend("127.0.0.1", srv.port,
                        page_words=args.page_words, keepalive_s=None,
                        deadline_ms=1.0) as be:
            for lo in range(0, len(pool), 32):
                _, found = be.get(pool[lo:lo + 32])
                if found.any():
                    out["errors"].append("expired GET reported hits")
        st = _srv_stats(srv)
        out["proof"] = {"deadline_shed": int(st["deadline_shed"]),
                        "poison_ops": int(st["poison_ops"]),
                        "bisect_launches": int(st["bisect_launches"])}
        if not st["deadline_shed"]:
            out["errors"].append("no ops were deadline-shed")
        if st["poison_ops"] or st["bisect_launches"]:
            out["errors"].append(
                "an expired op REACHED the device (poison tripped)")
    finally:
        srv.stop()
        out["serve_errors"] = int(srv.stats["serve_errors"])

    # -- ramp arms: overload goodput, budget off vs on --
    def ramp_arm(deadline_ms: float) -> float:
        shared = LocalBackend(args.page_words, args.capacity)
        shared.put(pool, _fill_pages(pool, args.page_words))
        srv = NetServer(lambda: shared, net=NetConfig()).start()
        n = args.fanin * max(1, args.ramp)
        stop = threading.Event()
        hits = [0] * n
        errs: list = []

        def worker(ci: int) -> None:
            rng = np.random.default_rng(700 + ci)
            try:
                be = TcpBackend("127.0.0.1", srv.port,
                                page_words=args.page_words,
                                keepalive_s=None,
                                deadline_ms=deadline_ms)
                while not stop.is_set():
                    idx = rng.integers(0, len(pool), 16)
                    _, found = be.get(pool[idx])
                    hits[ci] += int(found.sum())
                be.close()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(n)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        time.sleep(args.measure_s)
        stop.set()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        srv.stop()
        out["serve_errors"] += int(srv.stats["serve_errors"])
        if errs:
            out["errors"].append(f"ramp arm ({deadline_ms}ms): {errs[0]!r}")
        return sum(hits) / wall

    base = ramp_arm(0.0)
    budget = ramp_arm(500.0)
    out["ramp"] = {"goodput_off": round(base, 1),
                   "goodput_on": round(budget, 1),
                   "frac": round(budget / base, 4) if base else 0.0}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", type=int, default=8,
                   help="shards of the shard-kill plane")
    p.add_argument("--fanin", type=int, default=8,
                   help="connections fused per flush (poison drill b)")
    p.add_argument("--ramp", type=int, default=10,
                   help="connection overload multiplier, deadline arm")
    p.add_argument("--page-words", type=int, default=32)
    p.add_argument("--capacity", type=int, default=1 << 12)
    p.add_argument("--keys", type=int, default=1024)
    p.add_argument("--measure-s", type=float, default=3.0)
    p.add_argument("--out", default=None)
    p.add_argument("--history", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="short arms + machinery gate, fast exit")
    args = p.parse_args(argv)

    from pmdfc_tpu_torch.bench.common import (append_history, smoke_sizes,
                                              stamp_live_device)

    if args.smoke:
        smoke_sizes(p, args, fanin=4, ramp=2, keys=512, measure_s=1.0)

    from pmdfc_tpu_torch.config import (containment_enabled,
                                        net_pipe_enabled)

    if not net_pipe_enabled():
        print("[containment_soak] PMDFC_NET_PIPE=off — the coalesced "
              "tier is disabled; nothing to soak")
        return 2
    if not containment_enabled():
        print("[containment_soak] PMDFC_CONTAINMENT=off — nothing to "
              "soak")
        return 2

    poison = _poison_storm(args)
    print(f"[containment_soak] poison: isolation={poison['isolation']} "
          f"bound={poison['bound']} storm={poison.get('storm')}")
    shard = _shard_kill(args)
    print(f"[containment_soak] shard_kill: {json.dumps(shard)}")
    dl = _deadline(args)
    print(f"[containment_soak] deadline: proof={dl['proof']} "
          f"ramp={dl['ramp']}")

    common = {"fanin": args.fanin, "page_words": args.page_words,
              "keys": args.keys, "backend": "local",
              "host_evidence": True}
    rows = [
        {"metric": "containment_bisect_failures", "unit": "count",
         "value": poison["isolation"]["bisect_failures"],
         "bound": poison["bound"], "transport": "tcp", **common},
        {"metric": "containment_victim_gets_per_s", "unit": "ops/s",
         "value": round(poison["storm"]["healthy_hits_per_s"], 1),
         "transport": "tcp", **common},
        {"metric": "containment_deadline_goodput_frac", "unit": "frac",
         "value": dl["ramp"]["frac"], "ramp": args.ramp,
         "transport": "tcp", **common},
    ]
    if "skipped" not in shard:
        rows.append(
            {"metric": "containment_healthy_hit_frac", "unit": "frac",
             "value": round(shard["healthy_hit"]
                            / max(shard["baseline_hit"], 1e-9), 4),
             "transport": "plane", "backend": "direct",
             **{k: v for k, v in common.items() if k != "backend"}})
    for row in rows:
        stamp_live_device(row, row.get("backend", "local"), args.device)
        append_history(args.history, row)

    summary = {"rows": rows, "poison": poison, "shard": shard,
               "deadline": dl,
               "serve_errors": poison["serve_errors"] + dl["serve_errors"]}
    stamp_live_device(summary, "direct", args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)

    print(json.dumps({
        "metric": "containment_soak", "serve_errors": summary["serve_errors"],
        "isolation": poison["isolation"], "bound": poison["bound"],
        "healthy_hit": shard.get("healthy_hit"),
        "baseline_hit": shard.get("baseline_hit"),
        "quarantined_misses": shard.get("quarantined_misses"),
        "readmitted": shard.get("readmitted"), "proof": dl["proof"],
        "ramp": dl["ramp"], "device": summary["device"],
        "device_kind": summary["device_kind"]}))
    errs = poison["errors"] + shard.get("errors", []) + dl["errors"]
    if summary["serve_errors"]:
        errs.append(f"{summary['serve_errors']} serve errors")
    iso = poison["isolation"]
    if iso["poison_ops"] != 1:
        errs.append(f"expected 1 isolation, saw {iso['poison_ops']}")
    if iso["bisect_failures"] > poison["bound"]:
        errs.append(f"bisection blew its bound: "
                    f"{iso['bisect_failures']} > {poison['bound']}")
    if not iso["nacks_sent"]:
        errs.append("victim never saw a NACK")
    if (poison["storm"]["bisect_failures"]
            != iso["bisect_failures"]):
        errs.append("the storm re-ran isolation (fingerprint miss)")
    if "skipped" not in shard:
        if shard["healthy_hit"] < 0.9 * shard["baseline_hit"]:
            errs.append(f"healthy-shard hit rate collapsed: "
                        f"{shard['healthy_hit']:.3f} vs baseline "
                        f"{shard['baseline_hit']:.3f}")
    if errs:
        for e in errs:
            print(f"[containment_soak] FAIL: {e}")
        return 1
    print("[containment_soak] "
          + ("smoke OK" if args.smoke else "soak OK"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
