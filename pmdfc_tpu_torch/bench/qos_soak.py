"""QoS soak — an antagonist tenant vs a compliant tenant, with and
without the multi-tenant QoS plane (`runtime/qos.py`) (twin of
`pmdfc_tpu/bench/qos_soak.py`).

The scenario is the one a single shared staging queue cannot survive:
a COMPLIANT tenant serving steady zipf GET verbs while an ANTAGONIST
tenant floods the same server from more connections. Without the
plane (`tcp_noqos`) both tenants share one FIFO queue and the victim's
tail is whatever the flood leaves. With it (`tcp_qos`) the antagonist
is rate-limited at the edge (token bucket -> `miss_shed`) and the
compliant tenant's lane drains under deficit-round-robin weight, so
the flood pays for itself. A third arm re-runs the QoS scenario with
the antagonist fan-in multiplied (`--ramp`, the 10x overload drill)
and reports the compliant tenant's goodput as a fraction of its rated
(base-arm) throughput.

Per arm the compliant tenant content-verifies one verb against the
key-derived fill — a scheduler that serves wrong bytes is not a
scheduler. Pools are tenant-tagged with `qos.tag_oids` before the
prefill, so served bytes check against the TAGGED keys the wire sees.

Rows for `--history` (host_evidence; `tools/check_bench.py` reads them):

- ``qos_victim_get_p99`` (unit us, lower-better), transport
  ``tcp_noqos`` vs ``tcp_qos`` — the paired headline: the compliant
  tenant's tail with the antagonist unchecked vs policed.
- ``qos_victim_gets_per_s`` (unit ops/s), same transport pair.
- ``qos_ramp_goodput_frac`` (unit frac), transport ``tcp_qos`` — the
  overload drill: compliant goodput at 10x antagonist fan-in over its
  base-arm goodput.

The default backend is the HOST `LocalBackend` — the properties under
test (edge admission, DRR drain order, shed attribution) are
transport-scheduler behavior. `--backend direct` runs the same soak
against the port's KV on `--device` (default `cuda`); the SMOKE uses it
so the `miss_shed` attribution flows through the real stats vector
(`KV.account_shed`). Every run requires no serve error on either arm's
server.

Run: `python -m pmdfc_tpu_torch.bench.qos_soak --smoke --device cpu`
(short arms + machinery gate — the antagonist was shed at the edge with
every shed attributed to `miss_shed` (`misses == sum of causes` on the
wire doc), the compliant tenant's lane shed NOTHING, the live teledump
passes `pmdfc_tpu_torch.tools.check_teledump` including the `check_qos`
lane pins, and the no-QoS arm's teledump carries no tenant scope at all)
or full.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

# the one key-derived fill formula every sweep's content verification
# shares (the mesh_sweep reuse discipline — a private copy could drift
# and fork the "served bytes != fill bytes" check across benches)
from pmdfc_tpu_torch.bench.net_sweep import _fill_pages, _key_pool

# compliant / antagonist tenant ids (tagged into the oid prefix)
_T_GOOD = 1
_T_BAD = 2
_BITS = 4


def _zipf_ranks(rng, n: int, size: int, theta: float) -> np.ndarray:
    u = rng.random(size)
    r = np.floor(n * np.power(u, 1.0 / (1.0 - theta))).astype(np.int64) \
        if theta != 1.0 else np.floor(n ** u).astype(np.int64)
    return np.clip(r, 0, n - 1)


def _drive_pair(port: int, *, pool_good: np.ndarray,
                pool_bad: np.ndarray, conns_good: int, conns_bad: int,
                verb: int, theta: float, page_words: int, warm_s: float,
                measure_s: float, seed: int) -> dict:
    """Both tenants drive CONCURRENTLY against one server: the
    compliant workers measure GET latency, the antagonist workers
    flood. The first `warm_s` are an untimed warm window (driven
    identically); latencies collect only during `measure_s`."""
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    n = conns_good + conns_bad
    backends = [TcpBackend("127.0.0.1", port, page_words=page_words,
                           keepalive_s=None, op_timeout_s=120.0)
                for _ in range(n)]
    barrier = threading.Barrier(n + 1)
    lats: list = [[] for _ in range(conns_good)]
    counts = [0] * n
    denied = [0] * n  # verbs answered all-NOTEXIST (shed or cold)
    errs: list = []
    t_measure = [0.0]

    def worker(ci: int) -> None:
        be = backends[ci]
        good = ci < conns_good
        pool = pool_good if good else pool_bad
        rng = np.random.default_rng(seed + 131 * ci)
        try:
            barrier.wait()
            end_warm = time.monotonic() + warm_s
            first = good
            while time.monotonic() < end_warm:
                idx = _zipf_ranks(rng, len(pool), verb, theta)
                out, found = be.get(pool[idx])
                if first and found.all():
                    first = False
                    want = _fill_pages(pool[idx], page_words)
                    if not (out == want).all():
                        raise RuntimeError("served bytes != fill bytes")
            barrier.wait()  # measured window starts together
            end = time.monotonic() + measure_s
            while time.monotonic() < end:
                idx = _zipf_ranks(rng, len(pool), verb, theta)
                t0 = time.perf_counter()
                _, found = be.get(pool[idx])
                if good:
                    lats[ci].append(time.perf_counter() - t0)
                counts[ci] += 1
                if not found.any():
                    denied[ci] += 1
        except Exception as e:  # noqa: BLE001 — surfaced by the main
            errs.append(e)
            try:
                barrier.abort()
            except threading.BrokenBarrierError:
                pass

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    try:
        barrier.wait()       # warm window opens
        barrier.wait()       # measured window opens
    except threading.BrokenBarrierError:
        pass  # a worker aborted; its real error surfaces from errs below
    t_measure[0] = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_measure[0]
    for be in backends:
        be.close()
    if errs:
        real = [e for e in errs
                if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errs)[0]
    lat = np.concatenate([np.asarray(x) for x in lats]) \
        if any(lats) else np.asarray([0.0])
    good_verbs = sum(counts[:conns_good])
    return {
        "p50_us": float(np.percentile(lat, 50) * 1e6),
        "p99_us": float(np.percentile(lat, 99) * 1e6),
        "gets_per_s": good_verbs / wall if wall > 0 else 0.0,
        "good_verbs": int(good_verbs),
        "bad_verbs": int(sum(counts[conns_good:])),
        "bad_denied": int(sum(denied[conns_good:])),
    }


def _run_arm(args, shared, pool_good, pool_bad, *, qos_on: bool,
             conns_bad: int) -> dict:
    """One soak arm behind a fresh NetServer, optionally with the QoS
    plane. A fresh telemetry registry per arm keeps the tenant lanes
    and the teledump attributable to THIS arm."""
    from pmdfc_tpu_torch.config import NetConfig, QosConfig, TenantConfig
    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime import timeseries
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    tele.configure()
    timeseries.ensure_collector(interval_s=0.25)
    qcfg = None
    if qos_on:
        qcfg = QosConfig(tenant_bits=_BITS, tenants=(
            # compliant: weighted 3x, shed last
            TenantConfig(tid=_T_GOOD, weight=3, priority=2),
            # antagonist: edge-rate-limited (page-units/s), shed first
            TenantConfig(tid=_T_BAD, weight=1, priority=1,
                         rate_ops_per_s=args.antag_rate,
                         burst_ops=args.antag_burst),
        ))
    srv = NetServer(lambda: shared, net=NetConfig(), qos=qcfg).start()
    try:
        res = _drive_pair(
            srv.port, pool_good=pool_good, pool_bad=pool_bad,
            conns_good=args.connections, conns_bad=conns_bad,
            verb=args.verb, theta=args.zipf,
            page_words=args.page_words, warm_s=args.warm_s,
            measure_s=args.measure_s, seed=3000 + conns_bad)
        mon = TcpBackend("127.0.0.1", srv.port,
                         page_words=args.page_words, keepalive_s=None)
        res["teledoc"] = mon.server_stats()
        mon.close()
    finally:
        srv.stop()
    res["serve_errors"] = int(srv.stats["serve_errors"])
    return res


def _lane(doc: dict, tid: int) -> dict:
    """One tenant's lane counters out of a wire teledoc."""
    ctr = (doc.get("telemetry") or {}).get("counters") or {}
    needle = f".qos.t{tid}."
    return {k.rsplit(".", 1)[-1]: int(v) for k, v in ctr.items()
            if needle in k}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default="local",
                   choices=("local", "direct"),
                   help="serving backend: host dict (isolates the "
                        "scheduler) or the real KV (smoke default — "
                        "miss_shed flows through the stats vector)")
    p.add_argument("--connections", type=int, default=2,
                   help="compliant-tenant connection count")
    p.add_argument("--antagonists", type=int, default=4,
                   help="antagonist connection count (base arms)")
    p.add_argument("--ramp", type=int, default=10,
                   help="antagonist fan-in multiplier for the "
                        "overload arm (0 = skip)")
    p.add_argument("--verb", type=int, default=16,
                   help="keys per GET verb")
    p.add_argument("--zipf", type=float, default=0.99)
    p.add_argument("--page-words", type=int, default=64)
    p.add_argument("--capacity", type=int, default=1 << 13)
    p.add_argument("--keys", type=int, default=1024,
                   help="working-set size per tenant")
    p.add_argument("--antag-rate", type=float, default=400.0,
                   help="antagonist edge budget, page-units/s")
    p.add_argument("--antag-burst", type=int, default=64)
    p.add_argument("--warm-s", type=float, default=2.0)
    p.add_argument("--measure-s", type=float, default=4.0)
    p.add_argument("--out", default=None)
    p.add_argument("--history", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="short arms + machinery gate, fast exit")
    args = p.parse_args(argv)

    from pmdfc_tpu_torch.bench.common import (
        append_history, build_backend, smoke_sizes, stamp_live_device)

    if args.smoke:
        # the smoke runs against the REAL KV so every edge shed lands
        # in the stats vector (misses == sum of causes incl. miss_shed
        # is the gate) — the host dict has no stats vector to pin
        args.backend = "direct"
        smoke_sizes(p, args, connections=2, antagonists=3, keys=512,
                    capacity=1 << 12, warm_s=1.0, measure_s=2.0, ramp=0)

    from pmdfc_tpu_torch.config import net_pipe_enabled, qos_enabled
    from pmdfc_tpu_torch.runtime import qos as qos_mod

    if not net_pipe_enabled():
        print("[qos_soak] PMDFC_NET_PIPE=off — the coalesced tier is "
              "disabled; nothing to soak")
        return 2
    if not qos_enabled():
        print("[qos_soak] PMDFC_QOS=off — nothing to soak")
        return 2

    shared, closer = build_backend(args.backend, args.page_words,
                                   args.capacity, device=args.device)
    pool_good = _key_pool(args.keys, seed=7)
    pool_bad = _key_pool(args.keys, seed=11)
    pool_good[:, 0] = qos_mod.tag_oids(pool_good[:, 0], _T_GOOD, _BITS)
    pool_bad[:, 0] = qos_mod.tag_oids(pool_bad[:, 0], _T_BAD, _BITS)
    for pool in (pool_good, pool_bad):
        shared.put(pool, _fill_pages(pool, args.page_words))
    # only keys that actually landed are servable working set
    _, lg = shared.get(pool_good)
    _, lb = shared.get(pool_bad)
    pool_good = pool_good[np.asarray(lg, bool)]
    pool_bad = pool_bad[np.asarray(lb, bool)]
    print(f"[qos_soak] pools: {len(pool_good)}/{len(pool_bad)} "
          "resident keys (compliant/antagonist)")

    runs: dict = {}
    try:
        for label, on in (("tcp_noqos", False), ("tcp_qos", True)):
            runs[label] = _run_arm(args, shared, pool_good, pool_bad,
                                   qos_on=on,
                                   conns_bad=args.antagonists)
            r = runs[label]
            print(f"[qos_soak] {label}: victim p99="
                  f"{r['p99_us']:.0f}us {r['gets_per_s']:.0f} gets/s "
                  f"antag denied={r['bad_denied']}/{r['bad_verbs']}")
        if args.ramp:
            runs["tcp_qos_ramp"] = _run_arm(
                args, shared, pool_good, pool_bad, qos_on=True,
                conns_bad=args.antagonists * args.ramp)
            r = runs["tcp_qos_ramp"]
            print(f"[qos_soak] tcp_qos_ramp ({args.ramp}x): victim "
                  f"p99={r['p99_us']:.0f}us {r['gets_per_s']:.0f} "
                  f"gets/s")
    finally:
        closer()

    rows = []
    common = {
        "connections": args.connections,
        "antagonists": args.antagonists,
        "verb_keys": args.verb,
        "page_words": args.page_words,
        "zipf": args.zipf,
        "keys": args.keys,
        "backend": args.backend,
        "host_evidence": True,
    }
    for label in ("tcp_noqos", "tcp_qos"):
        r = runs[label]
        row = {"metric": "qos_victim_get_p99", "unit": "us",
               "value": round(r["p99_us"], 1),
               "p50_us": round(r["p50_us"], 1),
               "transport": label, **common}
        stamp_live_device(row, args.backend, args.device)
        rows.append(row)
        append_history(args.history, row)
        row = {"metric": "qos_victim_gets_per_s", "unit": "ops/s",
               "value": round(r["gets_per_s"], 1),
               "transport": label, **common}
        stamp_live_device(row, args.backend, args.device)
        rows.append(row)
        append_history(args.history, row)
    ramp_frac = None
    if "tcp_qos_ramp" in runs:
        base = runs["tcp_qos"]["gets_per_s"]
        ramp_frac = (runs["tcp_qos_ramp"]["gets_per_s"] / base
                     if base > 0 else 0.0)
        row = {"metric": "qos_ramp_goodput_frac", "unit": "frac",
               "value": round(ramp_frac, 4), "ramp": args.ramp,
               "transport": "tcp_qos", **common}
        stamp_live_device(row, args.backend, args.device)
        rows.append(row)
        append_history(args.history, row)

    qd = runs["tcp_qos"]["teledoc"]
    summary = {
        "rows": rows,
        "victim_p99_ratio": round(
            runs["tcp_noqos"]["p99_us"]
            / max(runs["tcp_qos"]["p99_us"], 1e-9), 3),
        "ramp_goodput_frac": (round(ramp_frac, 4)
                              if ramp_frac is not None else None),
        "antag_denied": runs["tcp_qos"]["bad_denied"],
        "miss_shed": int(qd.get("miss_shed", 0)),
        "lanes": {"good": _lane(qd, _T_GOOD), "bad": _lane(qd, _T_BAD)},
        "serve_errors": sum(r["serve_errors"] for r in runs.values()),
        "backend": args.backend,
    }
    stamp_live_device(summary, args.backend, args.device)
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    if summary["serve_errors"]:
        print(f"[qos_soak] FAIL: {summary['serve_errors']} serve errors")
        return 1

    if args.backend == "direct":
        # machinery gate over the real KV (timing-robust: latency and
        # goodput ratios are the rows, not gates): the antagonist was
        # shed at the edge with exact miss_shed attribution, the
        # compliant lane shed NOTHING, the live teledump passes the v2
        # pins including check_qos, and the no-QoS arm carries no
        # tenant scope at all (the scope-iff-enabled conformance)
        from pmdfc_tpu_torch.kv import MISS_CAUSE_NAMES
        from pmdfc_tpu_torch.tools.check_teledump import check

        errs = []
        good, bad = summary["lanes"]["good"], summary["lanes"]["bad"]
        if not bad.get("shed_edge"):
            errs.append("antagonist saw no edge sheds")
        if good.get("shed_edge") or good.get("shed_ladder"):
            errs.append(f"compliant tenant was shed: {good}")
        if not good.get("ops"):
            errs.append("compliant lane counted no ops")
        if not summary["miss_shed"]:
            errs.append("no miss_shed attribution in the wire doc")
        causes = {k: int(qd.get(k, 0)) for k in MISS_CAUSE_NAMES}
        if int(qd.get("misses", -1)) != sum(causes.values()):
            errs.append(f"misses {qd.get('misses')} != sum of causes "
                        f"{sum(causes.values())} ({causes})")
        errs += [f"qos teledump: {e}" for e in check(qd)]
        nd = runs["tcp_noqos"]["teledoc"]
        nctr = (nd.get("telemetry") or {}).get("counters") or {}
        if any(".qos.t" in k for k in nctr):
            errs.append("no-QoS arm's teledump carries tenant lanes")
        errs += [f"noqos teledump: {e}" for e in check(nd)]
        if errs:
            for e in errs:
                print(f"[qos_soak] FAIL: {e}")
            return 1
        print("[qos_soak] gates OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
