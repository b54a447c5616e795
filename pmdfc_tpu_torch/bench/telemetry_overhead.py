"""Telemetry overhead bench — the ≤3% kill-switch guarantee, measured
(twin of `pmdfc_tpu/bench/telemetry_overhead.py`; the served KV is the
port's, on `--device`, `cuda` by default, so on a card the profiler's ON
lane records a CUDA event pair per fetched launch).

The unified telemetry layer (`runtime/telemetry.py`) instruments the
TCP serving tier's hot paths: per-verb client spans + latency
histograms, server flush histograms, and per-phase span stamping. This
bench measures ON vs OFF over ONE traced pipelined connection to a
coalesced `NetServer` fronting a real KV (the net-smoke serving shape
the acceptance gate names), flipping the tracing tier LIVE
(`telemetry.set_enabled`) between many short alternating segments.
Pairing on/off at segment granularity over identical sockets/threads
cancels the host's common-mode scheduling noise, which on small CI
boxes swings far more run-to-run than the 3% being measured.

Acceptance: the ON lanes' summed wall stays within 3% of OFF
(`on/off <= 1.03`); both lanes append `telemetry=on|off` rows to
BENCH_HISTORY via the shared evidence logger (`host_evidence` rows —
the subject is the instrumentation, not the chip). The device-time
profiler (`runtime/profiler.py`) is installed for the measurement, so
the rows carry matching `profiler=on|off` lanes: `profiler.fetch`
gates on the same live `set_enabled` flip, which makes the ON leg
price telemetry + timed-fetch attribution together while the OFF leg
stays the uninstrumented floor.

Run: `python -m pmdfc_tpu_torch.bench.telemetry_overhead --smoke` (CI hook,
exits 2 when the overhead gate fails) or full; `--teledump PATH` also
pulls a live `MSG_STATS` telemetry snapshot into PATH for
`tools/check_teledump.py` (the agenda's telemetry_smoke step).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# the one key-derived fill and key pool every sweep shares
from pmdfc_tpu_torch.bench.net_sweep import _fill_pages, _key_pool


def _measure(*, verb: int, gets: int, pairs: int, page_words: int,
             pool: np.ndarray, teledump: str | None = None,
             seed: int = 1009, workers: int = 4,
             profiler: bool = True, device: str = "cuda") -> dict:
    """Paired on/off measurement over ONE server + ONE traced pipelined
    connection: `telemetry.set_enabled` flips the tracing tier live
    between short segments, so both lanes share the same sockets,
    threads, and host drift — the only difference inside a pair is the
    instrumentation itself.

    Statistic: MEDIAN of per-pair wall ratios, pair order randomized
    (seeded) and gc paused during measurement. On a small/noisy host
    the end-to-end wall carries multi-percent scheduler noise per
    segment; lane-granular or sum-of-walls comparisons alias that noise
    straight into the 3% gate, while the randomized-pair median is
    robust to outlier segments in either direction."""
    import gc
    import random
    import statistics

    from pmdfc_tpu_torch.bench.common import build_backend
    from pmdfc_tpu_torch.config import NetConfig, TelemetryConfig
    from pmdfc_tpu_torch.runtime import profiler as prof_mod
    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime import timeseries
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    tele.configure(TelemetryConfig(enabled=True))
    # the device-time profiler rides the ON lane too: `profiler.fetch`
    # passes through when the tracing tier is off, so the live
    # `set_enabled` flip that prices the spans prices the timed-fetch
    # seam with them — one paired measurement, whole sensor array
    pr = prof_mod.install() if profiler else None
    # the full workload-X-ray sensor array rides the ON lane: the
    # windowed series collector at its production cadence plus the
    # NetServer's workload sketches observing every routed key — the
    # gate now prices the whole sensor array, not just spans
    collector = timeseries.ensure_collector()
    # the net-smoke serving shape: a REAL KV behind the wire (the
    # acceptance workload). The instrumentation's absolute cost is a few
    # µs/verb; the gate is relative to what a verb actually costs in the
    # serving tier, not to a host-dict floor.
    shared, closer = build_backend("direct", page_words, 1 << 14,
                                   device=device)
    shared.put(pool, _fill_pages(pool, page_words))
    _, landed = shared.get(pool)
    pool = pool[np.asarray(landed, bool)]
    srv = NetServer(lambda: shared,
                    net=NetConfig(flush_timeout_us=0, settle_us=0)).start()
    be = TcpBackend("127.0.0.1", srv.port, page_words=page_words,
                    keepalive_s=None, op_timeout_s=60.0)
    if not (be.pipelined and be.traced):
        raise RuntimeError("connection did not negotiate pipeline+trace")
    order = random.Random(seed)

    def segment() -> float:
        """`workers` threads share the pipelined backend so verbs FUSE
        into multi-op flushes — the coalesced tier's operating point
        (a lone lockstep caller makes every verb a 1-op flush, charging
        the whole flush-level instrumentation to each verb: a shape the
        tier exists to avoid)."""
        import threading

        errs: list = []

        def drive(wid: int) -> None:
            r = np.random.default_rng(seed * 97 + wid)
            try:
                for _ in range(gets):
                    lo = int(r.integers(0, len(pool) - verb))
                    _, found = be.get(pool[lo:lo + verb])
                    if not found.all():
                        raise AssertionError("preloaded key missed")
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        t0 = time.perf_counter()
        ths = [threading.Thread(target=drive, args=(w,))
               for w in range(workers)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        if errs:
            raise errs[0]
        return time.perf_counter() - t0

    # warmup pair (discarded); the ON leg also proves the
    # instrumentation is actually live
    for enabled in (True, False):
        tele.set_enabled(enabled)
        segment()
    if len(tele.get().ring) == 0:
        raise RuntimeError("ON segment recorded no spans — "
                           "instrumentation is not live")
    if pr is not None and pr.snapshot()["launches"] == 0:
        raise RuntimeError("ON segment recorded no profiler launches — "
                           "the timed-fetch seam is not live")
    ratios = []
    walls = {True: 0.0, False: 0.0}
    gc.collect()
    gc.disable()
    try:
        for _ in range(pairs):
            legs = [True, False]
            if order.random() < 0.5:
                legs.reverse()
            t = {}
            for enabled in legs:
                tele.set_enabled(enabled)
                t[enabled] = segment()
            ratios.append(t[True] / t[False])
            walls[True] += t[True]
            walls[False] += t[False]
    finally:
        gc.enable()
    tele.set_enabled(True)
    if teledump:
        with open(teledump, "w") as f:
            json.dump(be.server_stats(), f, indent=1)
    spans = len(tele.get().ring)
    windows = len(collector.ring)
    wl_ops = srv.workload.snapshot()["ops"]
    be.close()
    srv.stop()
    closer()
    pages = gets * verb * workers
    return {
        "overhead_ratio": statistics.median(ratios),
        "wall_on_s": walls[True],
        "wall_off_s": walls[False],
        "pages_per_s_on": pages * pairs / walls[True],
        "pages_per_s_off": pages * pairs / walls[False],
        "spans_recorded": spans,
        "series_windows": windows,
        "workload_ops": wl_ops,
        "prof_launches": pr.snapshot()["launches"] if pr is not None else 0,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--verb", type=int, default=32)
    p.add_argument("--gets", type=int, default=30,
                   help="GET verbs per segment")
    p.add_argument("--pairs", type=int, default=60,
                   help="measured on/off segment pairs")
    p.add_argument("--page-words", type=int, default=64)
    p.add_argument("--preload", type=int, default=4096)
    p.add_argument("--gate", type=float, default=1.03,
                   help="max allowed on/off wall-time ratio")
    p.add_argument("--history", default=None)
    p.add_argument("--teledump", default=None,
                   help="write a live MSG_STATS telemetry snapshot here")
    p.add_argument("--smoke", action="store_true",
                   help="small grid, asserts the overhead gate")
    args = p.parse_args(argv)

    from pmdfc_tpu_torch.bench.common import smoke_sizes

    if args.smoke:
        # 100 pairs (up from 40): the sensor-array delta being gated is
        # now ~0.2-0.4% real, and the 40-pair median's ±1.5% host-noise
        # band straddled the 3% gate about one run in four on busy CI
        # boxes; the wider sample keeps the gate about the
        # instrumentation, not the scheduler
        smoke_sizes(p, args, gets=30, pairs=100, preload=2048)

    from pmdfc_tpu_torch.bench.common import (append_history,
                                              stamp_live_device)
    from pmdfc_tpu_torch.config import net_pipe_enabled, telemetry_enabled
    from pmdfc_tpu_torch.runtime import telemetry as tele

    if not net_pipe_enabled():
        print("[telemetry_overhead] PMDFC_NET_PIPE=off — the instrumented "
              "coalesced transport is disabled; nothing to measure")
        return 2
    if not telemetry_enabled():
        print("[telemetry_overhead] PMDFC_TELEMETRY=off in the "
              "environment — the ON lane cannot run; unset it")
        return 2

    pool = _key_pool(args.preload)
    res = _measure(verb=args.verb, gets=args.gets, pairs=args.pairs,
                   page_words=args.page_words, pool=pool,
                   teledump=args.teledump, device=args.device)
    ratio = res["overhead_ratio"]
    summary = {
        "pages_per_s_on": round(res["pages_per_s_on"], 1),
        "pages_per_s_off": round(res["pages_per_s_off"], 1),
        "overhead_ratio": round(ratio, 4),
        "overhead_pct": round((ratio - 1.0) * 100, 2),
        "gate": args.gate,
        "pairs": args.pairs,
        "spans_recorded": res["spans_recorded"],
        "series_windows": res["series_windows"],
        "workload_ops": res["workload_ops"],
        "prof_launches": res["prof_launches"],
    }
    if res["series_windows"] == 0 or res["workload_ops"] == 0:
        print("[telemetry_overhead] FAIL: collector/sketches were not "
              "live in the ON lane — the gate would be vacuous")
        return 2
    for lane in ("on", "off"):
        row = {
            "metric": "telemetry_overhead",
            "value": round(res[f"pages_per_s_{lane}"] / 1e6, 4),
            "unit": "Mpages/s",
            "telemetry": lane,
            "transport": "tcp_coalesced",
            "verb_keys": args.verb,
            "page_words": args.page_words,
            "pairs": args.pairs,
            "gets_per_segment": args.gets,
            "wall_s": round(res[f"wall_{lane}_s"], 4),
            "overhead_ratio": summary["overhead_ratio"],
            # lane identity: the ON lane now carries the series
            # collector + workload sketches (the sensor array), so its
            # history rows form a fresh lane instead of silently
            # comparing against pre-collector measurements
            "collector": "on",
            # `profiler.fetch` gates on `telemetry.enabled()`, so the
            # live flip that separates the lanes separates the profiler
            # with them: the ON lane prices the timed-fetch seam, the
            # OFF lane is the clean floor
            "profiler": lane,
            "host_evidence": True,
        }
        stamp_live_device(row, backend="direct", device=args.device)
        append_history(args.history, row)
    print(json.dumps(summary))
    # leave the process's default registry behind (the bench flipped it)
    tele.configure()
    if ratio > args.gate:
        print(f"[telemetry_overhead] FAIL: on-lane overhead "
              f"{summary['overhead_pct']}% exceeds the "
              f"{(args.gate - 1) * 100:.0f}% gate")
        return 2
    print("[telemetry_overhead] OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
