"""Autotune sweep — hand-tuned defaults vs the closed-loop controller
on a phase-shifting zipf soak (twin of `pmdfc_tpu/bench/autotune_sweep.py`;
`--backend direct` serves the port's KV on `--device`, `cuda` by default).

The scenario is the one hand-set knobs cannot straddle: a LIGHT phase
(one connection, small zipf GET verbs — the default 2000 µs flush dwell
and 200 µs settle cutoff are pure latency tax when every flush carries
one op) followed by a FAN-IN phase over a SHIFTED working set (8
pipelined connections — now dwell is fusion and the staging queue is
the signal). The controller (`runtime/autotune.py`) walks dwell/settle
down from the series windows during the light phase and back up
under fan-in; the static run serves both phases on the NetConfig
defaults. Each phase runs an UNTIMED adaptation window first, then the
measured window — the same protocol for both runs, so the pairing is
fair (the static run just spends its adaptation window not adapting).

Per phase both runs content-verify one verb against the key-derived
fill — a controller that serves wrong bytes is not a controller.

Emitted BENCH_HISTORY lanes (host_evidence; under `check_bench`):

- ``autotune_light_get_p99`` (unit us, lower-better), transport
  ``tcp_autotune`` vs ``tcp_static`` — the paired headline: the
  controller's light-phase tail against the hand-tuned default's.
- ``autotune_fanin_gets_per_s`` (unit ops/s), same transport pair.

The default backend is the HOST `LocalBackend`: the knobs under test
are transport-scheduler properties (dwell/settle are µs-scale), which a
KV GET's own cost can bury. The host backend isolates exactly the layer
the controller tunes; `--backend direct` runs the same soak against the
real KV for the end-to-end picture.

Run: `python -m pmdfc_tpu_torch.bench.autotune_sweep --smoke` (CI hook
`autotune_smoke`: short phases + machinery gate — the controller made
clamped decisions, walked dwell down in the light phase, and the live
teledump passes `pmdfc_tpu_torch.tools.check_teledump` including the
`check_autotune` envelope pins; the static run's teledump must carry
NO ctl scope) or full.
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
from pmdfc_tpu_torch.bench.net_sweep import (  # noqa: E402
    _fill_pages, _key_pool)


def _zipf_ranks(rng, n: int, size: int, theta: float) -> np.ndarray:
    """Zipf-ish rank draw over [0, n) (the repo's bench convention:
    power-law via inverse-CDF on uniform draws)."""
    u = rng.random(size)
    r = np.floor(n * np.power(u, 1.0 / (1.0 - theta))).astype(np.int64) \
        if theta != 1.0 else np.floor(n ** u).astype(np.int64)
    return np.clip(r, 0, n - 1)


def _drive_phase(port: int, *, conns: int, verb: int, pool: np.ndarray,
                 theta: float, page_words: int, warm_s: float,
                 measure_s: float, verify: bool, seed: int) -> dict:
    """One phase: `conns` worker connections looping zipf GET verbs
    until the deadline. The first `warm_s` are the ADAPTATION window
    (driven identically, not measured); latencies collect only during
    the `measure_s` window after it."""
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    backends = [TcpBackend("127.0.0.1", port, page_words=page_words,
                           keepalive_s=None, op_timeout_s=120.0)
                for _ in range(conns)]
    barrier = threading.Barrier(conns + 1)
    lats: list = [[] for _ in range(conns)]
    counts = [0] * conns
    errs: list = []
    # per-worker, summed at the end: a shared += is a non-atomic
    # read-modify-write across worker threads
    misses = [0] * conns
    t_measure = [0.0]

    def worker(ci: int) -> None:
        be = backends[ci]
        rng = np.random.default_rng(seed + 131 * ci)
        try:
            barrier.wait()
            end_warm = time.monotonic() + warm_s
            first = verify
            while time.monotonic() < end_warm:
                idx = _zipf_ranks(rng, len(pool), verb, theta)
                out, found = be.get(pool[idx])
                if not found.all():
                    misses[ci] += int((~found).sum())
                elif first:
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
                lats[ci].append(time.perf_counter() - t0)
                counts[ci] += 1
                if not found.all():
                    misses[ci] += int((~found).sum())
        except Exception as e:  # noqa: BLE001 — surfaced by the main
            errs.append(e)
            try:
                barrier.abort()
            except threading.BrokenBarrierError:
                pass

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(conns)]
    for t in threads:
        t.start()
    try:
        barrier.wait()       # adaptation window opens
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
        # prefer the originating failure over sibling workers' broken-
        # barrier wakeups so the smoke fails with the actual cause
        real = [e for e in errs
                if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errs)[0]
    lat = np.concatenate([np.asarray(x) for x in lats])
    return {
        "p50_us": float(np.percentile(lat, 50) * 1e6),
        "p99_us": float(np.percentile(lat, 99) * 1e6),
        "gets_per_s": sum(counts) / wall if wall > 0 else 0.0,
        "verbs": int(sum(counts)),
        "misses": int(sum(misses)),
    }


def _run_scenario(args, shared, pool_a, pool_b, *,
                  autotune_on: bool) -> dict:
    """One full soak (light phase on pool A, fan-in phase on the
    shifted pool B) behind a fresh NetServer, optionally with the
    controller attached. A fresh telemetry registry per scenario keeps
    the sensor windows and the teledump attributable to THIS run."""
    from pmdfc_tpu_torch.config import AutotuneConfig, NetConfig
    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime import timeseries
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    tele.configure()
    timeseries.ensure_collector(interval_s=0.25)
    srv = NetServer(lambda: shared, net=NetConfig()).start()
    ctl = None
    knobs_light = {}
    out: dict = {}
    try:
        if autotune_on:
            from pmdfc_tpu_torch.runtime import autotune

            ctl = autotune.attach(
                server=srv,
                cfg=AutotuneConfig(interval_s=0.1),
                start=True)
        out["light"] = _drive_phase(
            srv.port, conns=1, verb=args.verb, pool=pool_a,
            theta=args.zipf, page_words=args.page_words,
            warm_s=args.adapt_s, measure_s=args.measure_s,
            verify=True, seed=1000)
        knobs_light = dict(ctl.knob_values()) if ctl else {}
        out["fanin"] = _drive_phase(
            srv.port, conns=args.connections, verb=args.verb,
            pool=pool_b, theta=args.zipf, page_words=args.page_words,
            warm_s=args.adapt_s, measure_s=args.measure_s,
            verify=True, seed=2000)
        mon = TcpBackend("127.0.0.1", srv.port,
                         page_words=args.page_words, keepalive_s=None)
        out["teledoc"] = mon.server_stats()
        mon.close()
    finally:
        if ctl is not None:
            ctl.stop()
        srv.stop()
    out["knobs_light"] = knobs_light
    out["knobs_final"] = dict(ctl.knob_values()) if ctl else {}
    out["ctl"] = dict(ctl.stats) if ctl and ctl.stats else {}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default="local",
                   choices=("local", "direct"),
                   help="serving backend: host dict (isolates the "
                        "scheduler knobs) or the real KV (dispatch-"
                        "dominated; see the honesty note)")
    p.add_argument("--connections", type=int, default=8,
                   help="fan-in phase connection count")
    p.add_argument("--verb", type=int, default=8,
                   help="keys per GET verb")
    p.add_argument("--zipf", type=float, default=0.99)
    p.add_argument("--page-words", type=int, default=64)
    p.add_argument("--capacity", type=int, default=1 << 13)
    p.add_argument("--keys", type=int, default=2048,
                   help="working-set size per phase (pool B is the "
                        "disjoint mid-run shift)")
    p.add_argument("--adapt-s", type=float, default=6.0,
                   help="untimed adaptation window per phase")
    p.add_argument("--measure-s", type=float, default=4.0)
    p.add_argument("--out", default=None)
    p.add_argument("--history", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="short phases + machinery gate, fast exit")
    args = p.parse_args(argv)

    from pmdfc_tpu_torch.bench.common import smoke_sizes

    if args.smoke:
        smoke_sizes(p, args, connections=4, keys=1024, capacity=1 << 12,
                    adapt_s=4.0, measure_s=2.0)

    from pmdfc_tpu_torch.bench.common import (
        append_history, build_backend, stamp_live_device)
    from pmdfc_tpu_torch.config import autotune_enabled, net_pipe_enabled

    if not net_pipe_enabled():
        print("[autotune_sweep] PMDFC_NET_PIPE=off — the coalesced "
              "tier is disabled; nothing to sweep")
        return 2
    if not autotune_enabled():
        print("[autotune_sweep] PMDFC_AUTOTUNE=off — nothing to sweep")
        return 2

    shared, closer = build_backend(args.backend, args.page_words,
                                   args.capacity, device=args.device)
    pool_a = _key_pool(args.keys, seed=7)
    pool_b = _key_pool(args.keys, seed=11)
    for pool in (pool_a, pool_b):
        shared.put(pool, _fill_pages(pool, args.page_words))
    # only keys that actually landed are servable working set
    _, la = shared.get(pool_a)
    _, lb = shared.get(pool_b)
    pool_a = pool_a[np.asarray(la, bool)]
    pool_b = pool_b[np.asarray(lb, bool)]
    print(f"[autotune_sweep] pools: {len(pool_a)}/{len(pool_b)} "
          "resident keys (light/shifted)")

    runs: dict = {}
    try:
        for label, on in (("tcp_static", False), ("tcp_autotune", True)):
            runs[label] = _run_scenario(args, shared, pool_a, pool_b,
                                        autotune_on=on)
            r = runs[label]
            print(f"[autotune_sweep] {label}: light p99="
                  f"{r['light']['p99_us']:.0f}us "
                  f"fanin {r['fanin']['gets_per_s']:.0f} gets/s "
                  f"knobs_light={r['knobs_light']} "
                  f"decisions={r['ctl'].get('decisions', 0)}")
    finally:
        closer()

    rows = []
    for label in ("tcp_static", "tcp_autotune"):
        r = runs[label]
        common = {
            "transport": label,
            "connections": args.connections,
            "verb_keys": args.verb,
            "page_words": args.page_words,
            "zipf": args.zipf,
            "keys": args.keys,
            "backend": args.backend,
            "host_evidence": True,
        }
        row = {"metric": "autotune_light_get_p99", "unit": "us",
               "value": round(r["light"]["p99_us"], 1),
               "p50_us": round(r["light"]["p50_us"], 1), **common}
        stamp_live_device(row, backend=args.backend, device=args.device)
        rows.append(row)
        append_history(args.history, row)
        row = {"metric": "autotune_fanin_gets_per_s", "unit": "ops/s",
               "value": round(r["fanin"]["gets_per_s"], 1), **common}
        stamp_live_device(row, backend=args.backend, device=args.device)
        rows.append(row)
        append_history(args.history, row)

    st, at = runs["tcp_static"], runs["tcp_autotune"]
    summary = {
        "rows": rows,
        "light_p99_ratio": round(
            st["light"]["p99_us"] / max(at["light"]["p99_us"], 1e-9), 3),
        "fanin_rate_ratio": round(
            at["fanin"]["gets_per_s"]
            / max(st["fanin"]["gets_per_s"], 1e-9), 3),
        "wrong_bytes": 0,  # _drive_phase raises on any content drift
        "misses": {k: r["light"]["misses"] + r["fanin"]["misses"]
                   for k, r in runs.items()},
        "knobs_light": at["knobs_light"],
        "knobs_final": at["knobs_final"],
        "ctl": {k: v for k, v in at["ctl"].items()
                if isinstance(v, (int, float))},
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)

    if args.smoke:
        # machinery gate (timing-robust: latency ratios ride the
        # check_bench lanes, not the smoke): the controller decided,
        # walked dwell DOWN inside its envelope during the light
        # phase, the live teledump passes the v2 pins including the
        # check_autotune envelope, and the static run carries no ctl
        # scope at all (the scope-iff-enabled conformance)
        from pmdfc_tpu_torch.config import AutotuneConfig

        acfg = AutotuneConfig()
        errs = []
        if not at["ctl"].get("decisions"):
            errs.append("controller made no decisions")
        dw = at["knobs_light"].get("dwell_us")
        if dw is None or not (acfg.dwell_us_lo <= dw < 2000.0):
            errs.append(f"light-phase dwell {dw} did not walk down "
                        "inside the envelope")
        from pmdfc_tpu_torch.tools.check_teledump import check

        errs += [f"autotune teledump: {e}"
                 for e in check(at["teledoc"])]
        errs += [f"static teledump: {e}" for e in check(st["teledoc"])]
        gg = (st["teledoc"].get("telemetry") or {}).get("gauges") or {}
        if any(".knob_" in k for k in gg):
            errs.append("static run's teledump carries ctl knob gauges")
        if errs:
            for e in errs:
                print(f"[autotune_sweep] SMOKE FAIL: {e}")
            return 1
        print("[autotune_sweep] smoke OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
