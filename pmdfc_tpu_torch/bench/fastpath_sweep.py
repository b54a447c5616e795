"""One-sided fast-path sweep — served-GET latency with and without the
client-mirrored directory (twin of `pmdfc_tpu/bench/fastpath_sweep.py`).

The verb path pays, per GET: staging-queue wait, flush dwell while the
scheduler accumulates batch mates, one fused device dispatch, and
reply routing. The fast path (`MSG_FASTREAD`) answers from the server's
READER thread against a host mirror of the pool — a bloom/directory
lookup client-side, one epoch compare plus a digest compare per lane
server-side, a numpy row gather, zero device work. This sweep measures
exactly that delta under fan-in, on one live KV behind one coalesced
`NetServer`:

- ``tcp_verb``      — plain pipelined clients (the verb path).
- ``tcp_fastpath``  — the same clients with `directory=True` + one
  `dir_refresh()` before the measured window.

Rounds interleave the two modes (verb/fast alternating per round, best
round per mode reported) so host drift cancels. Every verb of every round
is content-verified against the key-derived fill after its latency is
taken (every hit the key's page, every miss zeroed) — a fast path that
can serve wrong bytes is not a fast path — and the server must end with
no serve error. The headline is ``ratio_p50``:
verb-path p50 / fast-path p50 at the max connection count (acceptance
floor ≥ 1.3 on CPU through the full wire stack). `cpu_us_per_get` is
the PROCESS cpu-time delta per GET — client and server share the
process here, so it is an upper bound on server cost, honest for the
on/off comparison because the client side is identical in both modes.
The KV behind the server is the port's on `--device` (default `cuda`).

Run: `python -m pmdfc_tpu_torch.bench.fastpath_sweep --smoke --device
cpu` (tiny grid + schema-checked teledump + the `hits + stale == reads`
pin) or full; `--history` appends `transport=`-stamped `host_evidence`
rows (`fastpath_get_p50`, unit us).
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np


def _fill_pages(keys: np.ndarray, page_words: int) -> np.ndarray:
    lo = np.asarray(keys, np.uint32)[:, 1]
    hi = np.asarray(keys, np.uint32)[:, 0]
    return ((hi * np.uint32(31) + lo * np.uint32(2654435761))[:, None]
            + np.arange(1, page_words + 1, dtype=np.uint32)[None, :])


def _key_pool(n: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 24, size=n, replace=False)
    return np.stack([flat >> 12, flat & 0xFFF], -1).astype(np.uint32)


def _run_mode(host: str, port: int, *, fast: bool, conns: int, verb: int,
              gets: int, page_words: int, pool: np.ndarray) -> dict:
    """One measured round: `conns` connections, each one worker issuing
    `gets` GET verbs of `verb` hot keys, each verb checked after its
    latency is taken. Returns per-GET latency percentiles + aggregate
    rate + process-cpu per GET."""
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    backends = []
    for _ in range(conns):
        for attempt in (0, 1):
            try:
                backends.append(TcpBackend(
                    host, port, page_words=page_words, keepalive_s=None,
                    directory=fast, op_timeout_s=120.0))
                break
            except (ConnectionError, OSError):
                if attempt:
                    raise
                time.sleep(0.1)
    if fast:
        for be in backends:
            if not (be.fastpath and be.dir_refresh()):
                raise RuntimeError("fast path did not negotiate/refresh")
    barrier = threading.Barrier(conns + 1)
    lats: list = [[] for _ in range(conns)]
    errs: list = []
    misses = [0]

    def worker(ci: int) -> None:
        be = backends[ci]
        rng = np.random.default_rng(1000 + 131 * ci)
        try:
            barrier.wait()
            for g in range(gets):
                idx = rng.integers(0, len(pool), verb)
                t0 = time.perf_counter()
                out, found = be.get(pool[idx])
                lats[ci].append(time.perf_counter() - t0)
                if not found.all():
                    misses[0] += int((~found).sum())
                want = _fill_pages(pool[idx][found], page_words)
                if not (out[found] == want).all() or out[~found].any():
                    raise RuntimeError("served bytes != fill bytes")
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
    barrier.wait()
    t0, c0 = time.perf_counter(), time.process_time()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    cpu = time.process_time() - c0
    for be in backends:
        be.close()
    if errs:
        raise errs[0]
    lat = np.concatenate([np.asarray(x) for x in lats])
    n_gets = len(lat)
    return {
        "p50_us": float(np.percentile(lat, 50) * 1e6),
        "p95_us": float(np.percentile(lat, 95) * 1e6),
        "gets_per_s": n_gets / wall if wall > 0 else 0.0,
        "cpu_us_per_get": cpu / n_gets * 1e6 if n_gets else 0.0,
        "wall_s": wall,
        "misses": misses[0],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--connections", type=int, default=8)
    p.add_argument("--verb", type=int, default=16,
                   help="hot keys per GET verb")
    p.add_argument("--gets", type=int, default=120,
                   help="GET verbs per connection per round")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--page-words", type=int, default=256)
    p.add_argument("--capacity", type=int, default=1 << 13)
    p.add_argument("--preload", type=int, default=4096)
    p.add_argument("--out", default=None)
    p.add_argument("--history", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="tiny grid + schema-checked teledump, fast exit")
    args = p.parse_args(argv)

    from pmdfc_tpu_torch.bench.common import (
        append_history, build_backend, smoke_sizes, stamp_live_device)

    if args.smoke:
        smoke_sizes(p, args, connections=4, verb=16, gets=20, rounds=2,
                    preload=1024, capacity=1 << 12, page_words=64)

    from pmdfc_tpu_torch.config import NetConfig, fastpath_enabled, \
        net_pipe_enabled
    from pmdfc_tpu_torch.runtime.net import NetServer

    if not net_pipe_enabled():
        print("[fastpath_sweep] PMDFC_NET_PIPE=off — the coalesced tier "
              "is disabled; nothing to sweep")
        return 2
    if not fastpath_enabled():
        print("[fastpath_sweep] PMDFC_FASTPATH=off — nothing to sweep")
        return 2

    shared, closer = build_backend("direct", args.page_words,
                                   args.capacity, device=args.device)
    pool = _key_pool(args.preload)
    shared.put(pool, _fill_pages(pool, args.page_words))
    _, landed = shared.get(pool)
    pool = pool[np.asarray(landed, bool)]
    print(f"[fastpath_sweep] pool: {len(pool)} resident keys")

    srv = NetServer(lambda: shared, net=NetConfig()).start()
    best: dict = {}
    try:
        for rnd in range(args.rounds + 1):  # round 0 = warmup
            for fast in (False, True):
                mode = "tcp_fastpath" if fast else "tcp_verb"
                res = _run_mode(
                    "127.0.0.1", srv.port, fast=fast,
                    conns=args.connections, verb=args.verb,
                    gets=max(4, args.gets // (2 if rnd == 0 else 1)),
                    page_words=args.page_words, pool=pool)
                if res["misses"]:
                    raise RuntimeError(
                        f"{mode}: {res['misses']} resident keys missed")
                if rnd == 0:
                    continue
                if mode not in best or res["p50_us"] < best[mode]["p50_us"]:
                    best[mode] = res
                print(f"[fastpath_sweep] r{rnd} {mode} "
                      f"conns={args.connections} verb={args.verb}: "
                      f"p50={res['p50_us']:.0f}us p95={res['p95_us']:.0f}us "
                      f"cpu/get={res['cpu_us_per_get']:.0f}us")
        # the teledump doc under load — the smoke gate below pins it
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        mon = TcpBackend("127.0.0.1", srv.port,
                         page_words=args.page_words, keepalive_s=None)
        teledoc = mon.server_stats()
        mon.close()
    finally:
        srv.stop()
        closer()
    serve_errors = int(srv.stats["serve_errors"])

    rows = []
    for mode, res in sorted(best.items()):
        row = {
            "metric": "fastpath_get_p50",
            "value": round(res["p50_us"], 1),
            "unit": "us",
            "transport": mode,
            "connections": args.connections,
            "verb_keys": args.verb,
            "page_words": args.page_words,
            "rounds": args.rounds,
            "p95_us": round(res["p95_us"], 1),
            "cpu_us_per_get": round(res["cpu_us_per_get"], 1),
            "gets_per_s": round(res["gets_per_s"], 1),
            "host_evidence": True,
        }
        stamp_live_device(row, "direct", args.device)
        rows.append(row)
        append_history(args.history, row)

    summary: dict = {"rows": rows, "serve_errors": serve_errors}
    stamp_live_device(summary, "direct", args.device)
    if "tcp_verb" in best and "tcp_fastpath" in best:
        summary["ratio_p50"] = round(
            best["tcp_verb"]["p50_us"] / best["tcp_fastpath"]["p50_us"], 2)
        summary["ratio_p95"] = round(
            best["tcp_verb"]["p95_us"] / best["tcp_fastpath"]["p95_us"], 2)
        summary["ratio_cpu_per_get"] = round(
            best["tcp_verb"]["cpu_us_per_get"]
            / max(best["tcp_fastpath"]["cpu_us_per_get"], 1e-9), 2)
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    if serve_errors:
        print(f"[fastpath_sweep] FAIL: {serve_errors} serve errors")
        return 2
    if args.smoke:
        # machinery gate: both modes served verified bytes, the fast
        # path actually engaged, the teledump parses under the v2 pins
        # (incl. the fastpath hits+stale==reads invariant), and the
        # bypass beat the verb path at all (the full run's 1.3x
        # acceptance floor rides check_bench lanes, not the smoke)
        from pmdfc_tpu_torch.tools.check_teledump import check

        tele_errs = check(teledoc)
        ctr = (teledoc.get("telemetry") or {}).get("counters") or {}
        fast_reads = sum(v for k, v in ctr.items()
                         if k.endswith((".fastpath_hits",
                                        ".fastpath_stale")))
        ok = (not tele_errs and fast_reads > 0
              and summary.get("ratio_p50", 0) > 1.0)
        if tele_errs:
            print(f"[fastpath_sweep] teledump errors: {tele_errs}")
        print(f"[fastpath_sweep] smoke {'OK' if ok else 'FAIL'} "
              f"(fast_reads={fast_reads}, "
              f"ratio_p50={summary.get('ratio_p50')})")
        return 0 if ok else 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
