#!/usr/bin/env python
"""Fill sweep — the eviction-substitute miss cost, measured (twin of
`pmdfc_tpu/bench/fill_sweep.py`).

The reference grows cuckoo and level tables when insertion pressure wins:
cuckoo resizes x2 up to kMaxGrows (`server/src/cuckoo_hash.h:94-99`), level
rehashes in place (`server/src/Level_hashing.h:60-64`). This framework
substitutes clean-cache EVICTION for those resizes (documented in each
model), which is legal — a clean cache may drop anything — but has a cost:
entries lost below nominal capacity that the reference would have kept.

This harness prices that substitution: for each index family, insert
`f x capacity` uniform keys for f in the sweep, then re-get ALL of them and
report the miss rate plus the conformance accounting
(`misses <= evictions + drops`, the test_KV failedSearch rule,
`server/test_KV.cpp:305-327`). Families with real growth (cceh splits,
hotring tag-half rehash) and the reference's own never-resizing default
(linear FIFO clusters, `src/linear_probing.cpp:26-65`) run as contrast.

The KV is the port's (unpaged, as test_KV stores value = key) on
`--device` (default `cuda`). A family that fails raises: nothing is
skipped. Prints one JSON line per (family, fill) point and a trailing
summary line; exits 1 on a conformance violation.
"""

from __future__ import annotations

import argparse
import json
import sys


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_point(kind: str, capacity: int, fill: float, batch: int,
              seed: int = 0, device="cuda") -> dict:
    import numpy as np

    from pmdfc_tpu_torch import kv as kv_mod
    from pmdfc_tpu_torch.config import IndexConfig, IndexKind, KVConfig

    cfg = KVConfig(
        index=IndexConfig(kind=IndexKind(kind), capacity=capacity),
        bloom=None, paged=False,
    )
    kv = kv_mod.KV(cfg, device=device)
    n = int(capacity * fill)
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 62, size=n, replace=False).astype(np.uint64)
    keys = np.stack(
        [(flat >> 32).astype(np.uint32), (flat & 0xFFFFFFFF).astype(np.uint32)],
        axis=-1,
    )
    dropped = 0
    for lo in range(0, n, batch):
        res = kv.insert(keys[lo:lo + batch], keys[lo:lo + batch])
        dropped += int(np.asarray(res.dropped).sum())
    misses = 0
    for lo in range(0, n, batch):
        _, found = kv.get(keys[lo:lo + batch])
        misses += int((~found).sum())
    st = kv.stats()
    # cross-check: the host-side sum of per-batch InsertResult.dropped must
    # agree with the DROPS stat bump (kv.insert makes both)
    if dropped != st["drops"]:
        raise AssertionError(f"{kind}@{fill}: dropped {dropped} != "
                             f"drops stat {st['drops']}")
    ok = misses <= st["evictions"] + st["drops"]
    return {
        "index": kind, "fill": fill, "n": n, "capacity": capacity,
        "miss_rate": round(misses / max(n, 1), 4),
        "misses": misses, "evictions": st["evictions"], "drops": st["drops"],
        "conformance_ok": bool(ok),
        "utilization": round(kv.utilization(), 4),
    }


def main(argv=None) -> int:
    from pmdfc_tpu_torch.bench.common import smoke_sizes, stamp_live_device

    p = argparse.ArgumentParser()
    p.add_argument("--capacity", type=int, default=1 << 16)
    p.add_argument("--batch", type=int, default=1 << 13)
    p.add_argument("--indexes", default="cuckoo,level,linear,cceh,hotring")
    p.add_argument("--fills", default="0.5,0.7,0.85,1.0,1.2")
    p.add_argument("--device", default="cuda")
    p.add_argument("--smoke", action="store_true",
                   help="tiny table, every family and fill")
    args = p.parse_args(argv)
    if args.smoke:
        smoke_sizes(p, args, capacity=1 << 11, batch=1 << 9)

    rows = []
    for kind in args.indexes.split(","):
        for fill in (float(x) for x in args.fills.split(",")):
            r = run_point(kind, args.capacity, fill, args.batch,
                          device=args.device)
            rows.append(r)
            log(f"[fill-sweep] {kind}@{fill}: miss_rate={r['miss_rate']} "
                f"(ev={r['evictions']} drop={r['drops']} "
                f"ok={r['conformance_ok']})")
            print(json.dumps(r), flush=True)
    bad = [r for r in rows if not r["conformance_ok"]]
    out = {"metric": "fill_sweep", "points": len(rows),
           "conformance_violations": len(bad)}
    stamp_live_device(out, "direct", args.device)
    print(json.dumps(out), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
