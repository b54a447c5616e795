"""replay_KV — trace replay benchmark (mixed R/W under realistic patterns;
twin of `pmdfc_tpu/bench/replay.py`).

Reference: `server/replay_KV.cpp` parses trace lines
`seq ts op inode isize offset size` (`:22-31`), expands each event into
per-4KB page keys `inode<<32 | page_index` (`:209-274`), and replays the
mixed read/write stream against the KV, reporting ops/sec and failed
searches.

The whole trace is vectorized host-side into (op, key) arrays once, then
replayed as coalesced batches through the port's `KV` on `--device`
(default `cuda`) — reads and writes in trace order at batch granularity
(a batch boundary is a serialization point, matching the per-queue
ordering the reference's threads provide). Besides the JAX harness's
row, every read hit is checked against the value its last write stored
(`wrong_values`; a clean-cache miss is legal, a wrong value never is).

Run: `python -m pmdfc_tpu_torch.bench.replay --trace file.txt` or `--synthetic N`
(`tests/data/fileserver.trace` is a bundled fileserver trace).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

PAGE = 4096


def parse_trace(path: str):
    """Trace lines `seq ts op inode isize offset size` -> (ops[N], keys[N,2]).

    op: 1 = write/insert, 0 = read/get (the reference treats 'W'/'R').
    Each event covering `size` bytes at `offset` expands to one op per 4 KB
    page, keyed (inode, offset//4096 + i) (`server/replay_KV.cpp:22-38`).
    """
    ops_out, hi_out, lo_out = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 7:
                continue
            _, _, op, inode, _, offset, size = parts[:7]
            npages = max(1, (int(size) + PAGE - 1) // PAGE)
            base = int(offset) // PAGE
            w = 1 if op.upper().startswith("W") else 0
            ops_out.extend([w] * npages)
            hi_out.extend([int(inode) & 0xFFFFFFFF] * npages)
            lo_out.extend((base + i) & 0xFFFFFFFF for i in range(npages))
    return (
        np.array(ops_out, np.uint8),
        np.stack([np.array(hi_out, np.uint32), np.array(lo_out, np.uint32)],
                 axis=-1),
    )


def synthetic_trace(n: int, num_files: int = 64, write_frac: float = 0.3,
                    zipf_a: float = 1.2, seed: int = 0):
    """Zipf-skewed mixed trace (stands in for real collected traces)."""
    rng = np.random.default_rng(seed)
    inode = rng.integers(1, num_files + 1, n).astype(np.uint32)
    page = (rng.zipf(zipf_a, n) % (1 << 20)).astype(np.uint32)
    ops = (rng.random(n) < write_frac).astype(np.uint8)
    return ops, np.stack([inode, page], axis=-1)


def write_fileserver_trace(path: str, n_events: int = 2000,
                           num_files: int = 48, write_frac: float = 0.35,
                           seed: int = 0) -> None:
    """Emit a fileserver-personality trace FILE in the reference's line
    format `seq ts op inode isize offset size` (`server/replay_KV.cpp:
    22-38`) — the replay_KV input-parity artifact.

    Access pattern modeled on the filebench fileserver personality the
    reference runs (`client/filebench/fileserver.f`): zipf file popularity,
    per-file sequential runs (whole-file reads / appends), and log-normal
    request sizes spanning 1..64 pages, with a wall-clock-ish timestamp
    column. Deterministic per seed.
    """
    rng = np.random.default_rng(seed)
    fsize = (rng.lognormal(12.5, 1.0, num_files)).astype(np.int64)
    fsize = np.clip(fsize, PAGE, 64 * PAGE)
    ts = 0.0
    with open(path, "w") as f:
        for seq in range(n_events):
            inode = 1 + (rng.zipf(1.3) - 1) % num_files
            size = int(np.clip(rng.lognormal(9.5, 1.2), 512, 64 * PAGE))
            size = min(size, int(fsize[inode - 1]))  # never past EOF
            max_off = max(0, int(fsize[inode - 1]) - size)
            # sequential bias: half the events continue at a page boundary
            if rng.random() < 0.5:
                offset = (rng.integers(0, max_off + 1) // PAGE) * PAGE
            else:
                offset = int(rng.integers(0, max_off + 1))
            op = "W" if rng.random() < write_frac else "R"
            ts += float(rng.exponential(0.0004))
            f.write(f"{seq} {ts:.6f} {op} {inode} {int(fsize[inode-1])} "
                    f"{offset} {size}\n")


def replay(kv, ops: np.ndarray, keys: np.ndarray, batch: int = 4096) -> dict:
    """Replay in trace order at batch granularity; count failed searches.

    A read fails only if the key was written earlier in the trace AND never
    evicted — exactly `replay_KV`'s failedSearch accounting under clean-cache
    rules (`misses <= evictions + drops` globally).
    """
    n = len(ops)
    # warm the pow2 ladder the batches will hit: KV pads every op batch
    # to a pow2 width (ceiling _pad_pow2(batch) — a non-pow2 --batch
    # still rounds UP, so warm through that), so one insert+get at each
    # reachable width takes the first allocations at that width out of
    # the timed window. INVALID keys place nothing.
    from pmdfc_tpu_torch.kv import _pad_pow2
    from pmdfc_tpu_torch.utils.keys import INVALID_WORD

    w, top = 16, _pad_pow2(batch)
    while w <= top:
        pad = np.full((w, 2), INVALID_WORD, np.uint32)
        kv.insert(pad, pad)
        kv.get(pad)
        w *= 2
    t0 = time.perf_counter()
    hits = misses = writes = wrong = 0
    for i in range(0, n, batch):
        o, k = ops[i : i + batch], keys[i : i + batch]
        wr = o == 1
        if wr.any():
            kw = k[wr]
            kv.insert(kw, kw)  # value = key, like test_KV/replay_KV
            writes += int(wr.sum())
        rd = ~wr
        if rd.any():
            got, found = kv.get(k[rd])
            hits += int(found.sum())
            misses += int((~found).sum())
            wrong += int((np.asarray(got)[found] != k[rd][found])
                         .any(-1).sum())
    dt = time.perf_counter() - t0
    s = kv.stats()
    return {
        "metric": "replay_ops_per_sec",
        "value": round(n / dt, 1),
        "unit": "ops/s",
        "ops": n,
        "writes": writes,
        "read_hits": hits,
        "read_misses": misses,
        "wrong_values": wrong,
        "evictions": s["evictions"],
        "drops": s["drops"],
        "secs": round(dt, 3),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--trace", help="trace file (seq ts op inode isize offset size)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic events instead")
    p.add_argument("--capacity", type=int, default=1 << 22)
    p.add_argument("--batch", type=int, default=1 << 14)
    p.add_argument("--index", default="linear")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--history", default=None,
                   help="BENCH_HISTORY.jsonl path for on-card evidence log")
    args = p.parse_args(argv)

    from pmdfc_tpu_torch.bench.common import append_history, stamp_live_device
    from pmdfc_tpu_torch.config import IndexConfig, IndexKind, KVConfig
    from pmdfc_tpu_torch.kv import KV

    if args.trace:
        ops, keys = parse_trace(args.trace)
    else:
        ops, keys = synthetic_trace(args.synthetic or 1_000_000)

    cfg = KVConfig(
        index=IndexConfig(kind=IndexKind(args.index), capacity=args.capacity),
        bloom=None, paged=False,
    )
    out = replay(KV(cfg, device=args.device), ops, keys, args.batch)
    stamp_live_device(out, "direct", args.device)
    out["index"] = args.index
    out["trace"] = args.trace or f"synthetic:{args.synthetic or 1_000_000}"
    print(json.dumps(out), file=sys.stdout)
    if args.history:
        if out["device"] != "cuda":
            # --history is an on-card evidence request: a run off the
            # card exits 3 and appends nothing
            return 3
        append_history(args.history, out)
    return 1 if out["wrong_values"] else 0


if __name__ == "__main__":
    sys.exit(main())
