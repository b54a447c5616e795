"""Recovery soak — priced warm restart vs cold rejoin after `kill -9`
(twin of `pmdfc_tpu/bench/recovery_soak.py`).

The bounded-RPO durability claim, measured end to end: a real
`NetServer` child (journal-attached KV, the port's
`pmdfc_tpu_torch/tools/crashbox.py`, a spawned process on `--device`) takes a
seeded fill, cuts a full + delta snapshot chain mid-storm, keeps
acking puts, and is then SIGKILLed between two acked RPCs — no flush,
no atexit. Two rejoin arms then serve the IDENTICAL seeded zipf
GET storm with put-on-miss refill (the upstream re-fetch path):

- `warm`  — restore the snapshot chain + replay the journal tail
  (`runtime/journal.warm_restart` inside a fresh child process);
- `cold`  — an empty server, the pre-chain world.

What the artifact prices:

- `pages_lost`   — acked-before-kill keys missing after warm restart;
  MUST be within the `JournalConfig(rpo_ops)` bound (acks outrun
  fsync by at most the pending window);
- `wrong_bytes`  — ALWAYS 0: every served page content-verifies
  against key-derived ground truth, through crash and recovery;
- `value` (auc)  — mean windowed hit-rate over the rejoin storm
  (higher = faster catch-up); paired `mode=warm` / `mode=cold`
  `--history` rows make the speedup a regression-gated claim;
- `t90_steps`    — storm steps until the rolling hit-rate crosses
  0.90; warm MUST be strictly better than cold;
- `misses == Σ causes` — asserted at every stats poll, throughout
  recovery (the `miss_recovering` lane keeps the taxonomy exact).

Also held: no serve error in any child (its wire stats document's
`serve_errors` counters).

Run: `python -m pmdfc_tpu_torch.bench.recovery_soak --smoke --device cpu`
(asserts the invariants and exits nonzero) or with real sizes;
`--history` appends paired `host_evidence` rows to an evidence log.
A script that runs it needs an `if __name__ == "__main__"` guard: the
children are spawned, and spawn re-imports the main module.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

WIN = 8  # rolling hit-rate window (storm steps)


def _keys_of(los: np.ndarray) -> np.ndarray:
    los = np.asarray(los, np.uint32)
    return np.stack([los >> 16, los], axis=-1).astype(np.uint32)


def _pages_of(keys: np.ndarray, page_words: int) -> np.ndarray:
    lo = np.asarray(keys, np.uint32)[:, 1]
    return (lo[:, None] * np.uint32(2654435761)
            + np.arange(1, page_words + 1, dtype=np.uint32)[None, :])


def serve_errors(doc: dict) -> int:
    """A wire stats document's serve errors: the NetServer's
    `serve_errors` counters in its telemetry snapshot."""
    ctr = (doc.get("telemetry") or {}).get("counters") or {}
    return sum(int(v) for k, v in ctr.items()
               if k.endswith(".serve_errors"))


def _assert_causes(stats: dict) -> None:
    causes = {k: v for k, v in stats.items() if k.startswith("miss_")}
    total = int(stats["misses"])
    if total != sum(causes.values()):
        raise AssertionError(
            f"miss ledger broken: misses={total} != Σ causes {causes}")


def _rejoin_storm(be, args, universe, truth) -> dict:
    """Seeded zipf GET storm with put-on-miss refill. Identical across
    arms (fresh rng per arm); returns catch-up stats + the miss-ledger
    invariant checked at every poll."""
    from pmdfc_tpu_torch.bench.tier_sweep import _zipf_stream

    rng = np.random.default_rng(args.seed + 1)
    stream = _zipf_stream(rng, args.keys, args.steps * args.batch, args.zipf)
    hits = []
    wrong = 0
    t90 = None
    t0 = time.perf_counter()
    for step in range(args.steps):
        sel = stream[step * args.batch:(step + 1) * args.batch]
        out, found = be.get(universe[sel])
        good = truth[sel]
        wrong += int((out[found] != good[found]).any(axis=1).sum())
        if not found.all():  # upstream refill of whatever is missing
            be.put(universe[sel][~found], good[~found])
        hits.append(found.mean())
        roll = float(np.mean(hits[-WIN:]))
        if t90 is None and len(hits) >= min(WIN, step + 1) and roll >= 0.90:
            t90 = step + 1
            t90_wall = time.perf_counter() - t0
        if step % WIN == 0:
            _assert_causes(be.server_stats())
    _assert_causes(be.server_stats())
    return {
        "auc": round(float(np.mean(hits)), 4),
        "t90_steps": t90 if t90 is not None else args.steps + 1,
        "t90_wall_s": round(t90_wall, 3) if t90 is not None else None,
        "wall_s": round(time.perf_counter() - t0, 3),
        "wrong_bytes": wrong,
        "final_hit": round(float(np.mean(hits[-WIN:])), 4),
    }


def run(args) -> dict:
    from pmdfc_tpu_torch.bench.common import (append_history,
                                              stamp_live_device)
    from pmdfc_tpu_torch.config import IndexConfig, JournalConfig, KVConfig
    from pmdfc_tpu_torch.runtime.net import TcpBackend
    from pmdfc_tpu_torch.tools.crashbox import Crashbox

    kv_cfg = KVConfig(index=IndexConfig(capacity=args.capacity),
                      paged=True, page_words=args.page_words)
    j_cfg = JournalConfig(rpo_ops=args.rpo_ops, rpo_ms=args.rpo_ms)

    root = Path(tempfile.mkdtemp(prefix="recovery_soak_"))
    universe = _keys_of(np.arange(args.keys, dtype=np.uint32))
    truth = _pages_of(universe, args.page_words)
    fill = args.keys // 2          # chain covers the first half
    tail = args.keys * 3 // 4      # delta link covers up to here
    # the victim never sees the last eighth: after the crash those keys
    # are the not-yet-caught-up upstream data, so the warm arm's misses
    # on them land in the `miss_recovering` lane until mark_recovered
    put_end = args.keys - args.keys // 8
    out: dict = {
        "metric": "recovery_soak", "keys": args.keys, "steps": args.steps,
        "batch": args.batch, "page_words": args.page_words,
        "rpo_ops": args.rpo_ops, "zipf": args.zipf,
        "smoke": bool(args.smoke),
    }
    try:
        # -- victim: fill, cut chain, keep acking, die mid-storm --
        box = Crashbox(kv_cfg, root / "wal", j_cfg, device=args.device)
        box.start()
        be = TcpBackend("127.0.0.1", box.port, page_words=args.page_words)
        for lo in range(0, fill, args.batch):
            be.put(universe[lo:lo + args.batch], truth[lo:lo + args.batch])
        chain = [str(root / "full.npz"), str(root / "delta.npz")]
        box.snapshot(chain[0], delta=False)
        for lo in range(fill, tail, args.batch):
            be.put(universe[lo:lo + args.batch], truth[lo:lo + args.batch])
        box.snapshot(chain[1], delta=True)
        acked = tail
        for lo in range(tail, put_end, args.batch):
            be.put(universe[lo:lo + args.batch], truth[lo:lo + args.batch])
            acked = min(put_end, lo + args.batch)
        victim_errors = serve_errors(be.server_stats())
        be.close()
        box.kill()                 # SIGKILL between two acked RPCs
        out["acked_keys"] = acked

        arms: dict[str, dict] = {}
        for mode in ("warm", "cold"):
            wal = root / ("wal" if mode == "warm" else "wal_cold")
            wal.mkdir(exist_ok=True)
            arm_box = Crashbox(kv_cfg, wal, j_cfg,
                               chain_paths=chain if mode == "warm" else (),
                               device=args.device)
            hello = arm_box.start()
            arm_be = TcpBackend("127.0.0.1", arm_box.port,
                                page_words=args.page_words)
            arm = {"replay": hello["replay"]}
            if mode == "warm":
                # RPO audit BEFORE any refill: acked keys still there?
                lost = wrong = 0
                for lo in range(0, acked, args.batch):
                    ks = universe[lo:lo + args.batch]
                    got, found = arm_be.get(ks)
                    lost += int((~found).sum())
                    good = truth[lo:lo + args.batch]
                    wrong += int((got[found] != good[found])
                                 .any(axis=1).sum())
                arm["pages_lost"] = lost
                arm["rpo_bound"] = (args.rpo_ops + 1) * args.batch
                arm["wrong_bytes_audit"] = wrong
                info = arm_box.recovery_info()
                arm["recovering_at_audit"] = bool(info["recovering"])
            arm.update(_rejoin_storm(arm_be, args, universe, truth))
            if mode == "warm":
                arm["was_recovering"] = bool(arm_be.mark_recovered())
                st = arm_be.server_stats()
                arm["miss_recovering"] = int(st.get("miss_recovering", 0))
            arm["serve_errors"] = serve_errors(arm_be.server_stats())
            arm_be.close()
            arm_box.stop()
            arms[mode] = arm
    finally:
        shutil.rmtree(root, ignore_errors=True)

    warm, cold = arms["warm"], arms["cold"]
    out.update({
        "pages_lost": warm["pages_lost"], "rpo_bound": warm["rpo_bound"],
        "wrong_bytes": (warm["wrong_bytes_audit"] + warm["wrong_bytes"]
                        + cold["wrong_bytes"]),
        "warm_auc": warm["auc"], "cold_auc": cold["auc"],
        "warm_t90_steps": warm["t90_steps"],
        "cold_t90_steps": cold["t90_steps"],
        "replayed_pages": warm["replay"]["pages"],
        "torn_bytes": warm["replay"]["truncated_bytes"],
        "miss_recovering": warm["miss_recovering"],
        "serve_errors": (victim_errors + warm["serve_errors"]
                         + cold["serve_errors"]),
        "warm": warm, "cold": cold,
    })

    # paired lanes: identical identity except the `mode` stamp, so each
    # arm regression-gates against its own history under check_bench
    for mode, arm in arms.items():
        row = {
            "metric": "recovery_soak", "mode": mode,
            "keys": args.keys, "steps": args.steps, "batch": args.batch,
            "page_words": args.page_words, "rpo_ops": args.rpo_ops,
            "zipf": args.zipf, "smoke": bool(args.smoke),
            "value": arm["auc"], "unit": "auc",
            # measured outputs ride as floats: lane identity is
            # stamps+ints, and these differ every run
            "t90_steps": float(arm["t90_steps"]),
            "wall_s": arm["wall_s"],
            "host_evidence": True,
        }
        if mode == "warm":
            row["pages_lost"] = float(arm["pages_lost"])
        stamp_live_device(row, "direct", args.device)
        append_history(args.history, row)
    stamp_live_device(out, "direct", args.device)
    return out


def main(argv=None) -> int:
    from pmdfc_tpu_torch.bench.common import smoke_sizes

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--keys", type=int, default=1 << 12)
    p.add_argument("--steps", type=int, default=400,
                   help="rejoin storm steps per arm")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--zipf", type=float, default=0.99)
    p.add_argument("--page-words", type=int, default=256)
    p.add_argument("--capacity", type=int, default=1 << 14)
    p.add_argument("--rpo-ops", type=int, default=64)
    p.add_argument("--rpo-ms", type=float, default=25.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write the JSON artifact")
    p.add_argument("--history", default=None,
                   help="evidence log path (host_evidence rows)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes, not a perf claim")
    args = p.parse_args(argv)
    if args.smoke:
        smoke_sizes(p, args, keys=1 << 9, steps=96, batch=16,
                    page_words=64, capacity=1 << 12, rpo_ops=32)
    out = run(args)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("warm", "cold")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    ok = (out["wrong_bytes"] == 0
          and out["serve_errors"] == 0
          and out["pages_lost"] <= out["rpo_bound"]
          and out["warm_t90_steps"] < out["cold_t90_steps"]
          and out["warm_auc"] > out["cold_auc"]
          and out["miss_recovering"] > 0
          and out["warm"]["recovering_at_audit"]
          and out["warm"]["was_recovering"])
    print(f"[recovery_soak] {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
