"""Serving-path soak — sustained mixed traffic, content-verified (twin
of `pmdfc_tpu/bench/soak.py`).

N client threads drive put / ~1-in-3 delete / get verbs through the
native coalescing engine into one `KVServer` for a wall-clock duration,
with every served page verified bit-exact against its expected version
and every post-delete read required to miss (stale-serve = protocol
violation). Ends by asserting the clean-cache invariant
`misses <= evictions + deletes + drops` (ref test rule,
`client/rdpma_page_test.c:116-180` storm + `test_KV.cpp` accounting),
`misses == Σ miss_*` on the KV, and no serve error in the driver.

The KV is the port's on `--device` (default `cuda`). `--smoke` runs a
few seconds at tiny sizes (the JAX harness has no smoke mode).

Run: `python -m pmdfc_tpu_torch.bench.soak --minutes 3 --threads 6
--verb 512`. Prints ONE JSON line; exits 2 on a wrong page, a stale
serve, a broken invariant or a serve error; `--history` appends the row
to an evidence log (card runs only).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np


def _page(khi: int, klo: np.ndarray, words: int, ver: np.ndarray):
    """Deterministic page content keyed by (key, version) — any stale or
    torn serve shows up as a bit mismatch."""
    lane = np.arange(words, dtype=np.uint32)[None, :]
    return (
        (np.uint32(khi) * np.uint32(2654435761))[None]
        ^ (klo.astype(np.uint32) * np.uint32(40503))[:, None]
        ^ (ver.astype(np.uint32) * np.uint32(2246822519))[:, None]
        ^ lane
    ).astype(np.uint32)


def main(argv=None) -> int:
    from pmdfc_tpu_torch.bench.common import (append_history, smoke_sizes,
                                              stamp_live_device)

    p = argparse.ArgumentParser()
    p.add_argument("--minutes", type=float, default=3.0)
    p.add_argument("--threads", type=int, default=6)
    p.add_argument("--verb", type=int, default=512, help="pages per verb")
    p.add_argument("--capacity", type=int, default=1 << 18)
    p.add_argument("--page-words", type=int, default=64)
    p.add_argument("--delete-frac", type=float, default=0.33)
    p.add_argument("--keyspace", type=int, default=1 << 14,
                   help="distinct offsets per thread (drives churn)")
    p.add_argument("--engine-batch", type=int, default=1 << 13,
                   help="coalescer flush cap; also bounds the warm "
                        "ladder")
    p.add_argument("--device", default="cuda")
    p.add_argument("--history", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="a few seconds at tiny sizes")
    args = p.parse_args(argv)
    if args.smoke:
        smoke_sizes(p, args, minutes=0.05, threads=3, verb=64,
                    capacity=1 << 12, keyspace=1 << 9,
                    engine_batch=1 << 9)
    # Engine queue_cap must be a power of two (Vyukov ring) and the
    # warmup doubling ladder only covers pow2 widths — round UP so any
    # requested cap both passes the ring assert and is fully pre-warmed
    args.engine_batch = 1 << (args.engine_batch - 1).bit_length()

    from pmdfc_tpu_torch.client import EngineBackend
    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
    from pmdfc_tpu_torch.kv import MISS_CAUSE_NAMES
    from pmdfc_tpu_torch.runtime.engine import Engine
    from pmdfc_tpu_torch.runtime.server import KVServer

    cfg = KVConfig(
        index=IndexConfig(capacity=args.capacity),
        bloom=BloomConfig(num_bits=1 << 18), paged=True,
        page_words=args.page_words,
    )
    eng = Engine(
        num_queues=8, queue_cap=max(1 << 10, args.engine_batch),
        batch=args.engine_batch, timeout_us=500,
        arena_pages=max(1 << 12, 4 * args.threads * args.verb),
        page_bytes=args.page_words * 4,
        comp_slots=8 * args.threads * args.verb,
    )
    stats = {
        "served": 0, "verified_pages": 0,
        "mismatches": 0, "misses": 0, "deleted_hits": 0, "deletes": 0,
    }
    lock = threading.Lock()
    errors: list[BaseException] = []

    with KVServer(cfg, engine=eng, device=args.device) as srv:
        srv.warmup(max_width=args.engine_batch)
        deadline = time.perf_counter() + args.minutes * 60.0
        # explicit slice sizing: the default carves arena_pages//8, which
        # caps the client population at 8 — the --threads knob must work
        # past that (each slice still >= one verb wide)
        bes = [EngineBackend(
            srv, queue=t % 8, timeout_us=120_000_000,
            slice_pages=eng.arena_pages // args.threads,
        ) for t in range(args.threads)]

        def worker(t):
            rng = np.random.default_rng(1000 + t)
            be = bes[t]
            khi = 77 + t
            ver = np.zeros(args.keyspace, np.uint32)  # 0 = never written
            live = np.zeros(args.keyspace, bool)
            local = dict.fromkeys(stats, 0)
            try:
                while time.perf_counter() < deadline:
                    n = args.verb
                    klo = rng.integers(0, args.keyspace, n).astype(np.uint32)
                    klo = np.unique(klo)
                    n = len(klo)
                    keys = np.stack(
                        [np.full(n, khi, np.uint32), klo], -1)
                    # put a fresh version of every key in the verb
                    ver[klo] += 1
                    live[klo] = True
                    pages = _page(khi, klo, args.page_words, ver[klo])
                    be.put(keys, pages)
                    # delete ~1/3
                    dmask = rng.random(n) < args.delete_frac
                    if dmask.any():
                        be.invalidate(keys[dmask])
                        live[klo[dmask]] = False
                        local["deletes"] += int(dmask.sum())
                    # read everything back
                    out, found = be.get(keys)
                    f = np.asarray(found)
                    lv = live[klo]
                    # deleted keys must never serve (stale-serve detector)
                    local["deleted_hits"] += int((f & ~lv).sum())
                    hits = f & lv
                    exp = _page(khi, klo[hits], args.page_words,
                                ver[klo[hits]])
                    ok = (np.asarray(out)[hits] == exp).all(axis=1)
                    local["verified_pages"] += int(ok.sum())
                    local["mismatches"] += int((~ok).sum())
                    local["served"] += n
                    local["misses"] += int((~f & lv).sum())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
            with lock:
                for k, v in local.items():
                    stats[k] += v

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(args.threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        dt = time.perf_counter() - t0
        kvs = srv.kv.stats()
        serve_errors = srv.errors

    if errors:
        raise errors[0]
    invariant_ok = stats["misses"] <= (
        kvs["evictions"] + kvs["deletes"] + kvs["drops"])
    causes_ok = kvs["misses"] == sum(kvs[c] for c in MISS_CAUSE_NAMES)
    out = {
        # headline = pages actually DELIVERED and verified per second;
        # "served" counts requests (incl. required misses on deleted
        # keys), which would inflate a serving-capacity comparison
        "metric": "soak_verified_pages_per_sec",
        "value": round(stats["verified_pages"] / dt, 1),
        "unit": "pages/s",
        "requests_per_sec": round(stats["served"] / dt, 1),
        "minutes": round(dt / 60.0, 2),
        "threads": args.threads,
        "verb": args.verb,
        **stats,
        "evictions": kvs["evictions"],
        "kv_deletes": kvs["deletes"],
        "drops": kvs["drops"],
        "clean_cache_invariant_ok": bool(invariant_ok),
        "causes_ok": bool(causes_ok),
        "serve_errors": int(serve_errors),
    }
    stamp_live_device(out, "direct", args.device)
    print(json.dumps(out))
    if stats["mismatches"] or stats["deleted_hits"] or not invariant_ok \
            or not causes_ok or serve_errors:
        return 2  # data-loss / protocol violation: fail loudly
    append_history(args.history, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
