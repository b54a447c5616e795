"""Availability soak — rolling kill/restore under a zipf storm (twin of
`pmdfc_tpu/bench/replica_soak.py`).

The replica-group availability claim, measured: a `ReplicaGroup`
(n_replicas × real-KV NetServers, `ReconnectingClient`-wrapped TCP
endpoints) serves a seeded zipf GET/PUT storm while a rolling schedule
kills one server at a time and cold-restores it. Two runs with the
identical seeded schedule — no-fault reference, then faulted — so the
artifact prices availability directly:

- `hit_rate_ratio`  — faulted overall GET hit-rate / no-fault hit-rate
  (the acceptance floor is ≥ 0.8 with one server down at any instant);
- `hit_rate_floor`  — the worst windowed hit-rate during the fault run
  (the transient dip while a breaker is still counting failures);
- `hedges_fired` / `failover_gets` / `breaker_opens` / `repair_pages` —
  how the three mechanisms shared the work;
- `wrong_bytes`     — ALWAYS 0: every served page content-verifies
  against key-derived ground truth (the ladder invariant).

The nodes' KVs are the port's on `--device` (default `cuda`). Every run
holds the gates and exits 1 on a violation: zero wrong bytes, no serve
error on any node, `hit_rate_ratio >= 0.8` (the availability floor with
one node down at any instant), `repair_pages > 0` and at least one
breaker opening.

Run: `python -m pmdfc_tpu_torch.bench.replica_soak --smoke --device cpu`
(tiny shapes) or with real sizes; `--out` writes the JSON artifact and
`--history` appends it to an evidence log (card runs only).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _keys_of(los: np.ndarray) -> np.ndarray:
    los = np.asarray(los, np.uint32)
    return np.stack([los >> 16, los], axis=-1).astype(np.uint32)


def _pages_of(keys: np.ndarray, page_words: int) -> np.ndarray:
    lo = np.asarray(keys, np.uint32)[:, 1]
    return (lo[:, None] * np.uint32(2654435761)
            + np.arange(1, page_words + 1, dtype=np.uint32)[None, :])


class _Cluster:
    """n real-KV NetServers with kill / cold-restore (no chaos proxies:
    the soak prices availability, `tests/test_replica.py` owns chaos)."""

    def __init__(self, n: int, kv_cfg, device):
        from pmdfc_tpu_torch.client.backends import DirectBackend
        from pmdfc_tpu_torch.kv import KV
        from pmdfc_tpu_torch.runtime.net import NetServer

        self._mk_kv = lambda: KV(kv_cfg, device=device)
        self._mk_srv = lambda kv: NetServer(
            lambda kv=kv: DirectBackend(kv)).start()
        self.n = n
        self.kvs = [self._mk_kv() for _ in range(n)]
        self.servers = [self._mk_srv(kv) for kv in self.kvs]
        self.ports = [s.port for s in self.servers]
        self.serve_errors = 0  # over every server this cluster stopped

    def kill(self, i: int) -> None:
        if self.servers[i] is not None:
            self.serve_errors += int(self.servers[i].stats["serve_errors"])
            self.servers[i].stop()
            self.servers[i] = None
            self.kvs[i] = None

    def restore(self, i: int) -> None:
        self.kill(i)
        self.kvs[i] = self._mk_kv()          # cold: the crash lost all
        self.servers[i] = self._mk_srv(self.kvs[i])
        self.ports[i] = self.servers[i].port

    def close(self) -> None:
        for i in range(self.n):
            self.kill(i)


def _build_group(cl: _Cluster, args, seed: int):
    from pmdfc_tpu_torch.client.replica import ReplicaGroup
    from pmdfc_tpu_torch.config import ReplicaConfig
    from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    def endpoint(i: int) -> ReconnectingClient:
        def factory(i=i):
            return TcpBackend("127.0.0.1", cl.ports[i],
                              page_words=args.page_words,
                              keepalive_s=None, op_timeout_s=30.0)

        return ReconnectingClient(factory, page_words=args.page_words,
                                  retry_delay_s=0.005,
                                  max_retry_delay_s=0.05, seed=seed + i)

    cfg = ReplicaConfig(
        n_replicas=args.n_replicas, rf=args.rf, hedge_ms=args.hedge_ms,
        breaker_failures=3, breaker_cooldown_s=0.05,
        breaker_max_cooldown_s=0.4,
        repair_interval_s=0.0,  # ticked per step: deterministic rate
        repair_batch=args.repair_batch,
    )
    return ReplicaGroup([endpoint(i) for i in range(cl.n)],
                        page_words=args.page_words, cfg=cfg, seed=seed)


def _storm(group, cl: _Cluster, args, schedule: dict) -> dict:
    """One seeded storm pass. `schedule`: step -> ("kill"|"restore", i).
    Returns hit-rate stats; finishing without an exception is the
    no-exception-escapes invariant."""
    from pmdfc_tpu_torch.bench.tier_sweep import _zipf_stream

    rng = np.random.default_rng(args.seed)
    universe = _keys_of(np.arange(args.keys, dtype=np.uint32))
    truth = _pages_of(universe, args.page_words)
    # warm fill (counted separately from the storm)
    for lo in range(0, args.keys, args.batch):
        group.put(universe[lo:lo + args.batch], truth[lo:lo + args.batch])

    stream = _zipf_stream(rng, args.keys, args.steps * args.batch,
                          args.zipf)
    window = max(1, args.steps // 24)
    stats = {"gets": 0, "hits": 0, "wrong_bytes": 0, "windows": []}
    w_gets = w_hits = 0
    t0 = time.perf_counter()
    for step in range(args.steps):
        act = schedule.get(step)
        if act is not None:
            getattr(cl, act[0])(act[1])
        sel = stream[step * args.batch:(step + 1) * args.batch]
        keys = universe[sel]
        if rng.random() < args.put_frac:
            group.put(keys, truth[sel])
        else:
            out, found = group.get(keys)
            stats["gets"] += len(keys)
            stats["hits"] += int(found.sum())
            w_gets += len(keys)
            w_hits += int(found.sum())
            good = truth[sel]
            stats["wrong_bytes"] += int(
                (out[found] != good[found]).any(axis=1).sum())
        group.repair_tick()
        if (step + 1) % window == 0 and w_gets:
            stats["windows"].append(round(w_hits / w_gets, 4))
            w_gets = w_hits = 0
    stats["secs"] = round(time.perf_counter() - t0, 3)
    stats["hit_rate"] = round(stats["hits"] / max(1, stats["gets"]), 4)
    stats["hit_rate_floor"] = min(stats["windows"], default=None)
    return stats


def run(args) -> dict:
    from pmdfc_tpu_torch.bench.common import (append_history,
                                              stamp_live_device)
    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig

    kv_cfg = KVConfig(
        index=IndexConfig(capacity=args.capacity),
        bloom=BloomConfig(num_bits=args.bloom_bits),
        paged=True, page_words=args.page_words,
    )

    # rolling schedule: kill round-robin every `kill_every` steps, cold
    # restore `down_steps` later — one server down at any instant
    schedule: dict[int, tuple] = {}
    victim, step = 0, args.kill_every
    while step + args.down_steps < args.steps:
        schedule[step] = ("kill", victim)
        schedule[step + args.down_steps] = ("restore", victim)
        victim = (victim + 1) % args.n_replicas
        step += args.kill_every
    n_cycles = sum(1 for a in schedule.values() if a[0] == "kill")

    runs = {}
    for label, sched in (("nofault", {}), ("fault", schedule)):
        cl = _Cluster(args.n_replicas, kv_cfg, args.device)
        group = _build_group(cl, args, seed=args.seed)
        try:
            runs[label] = _storm(group, cl, args, sched)
            gstats = group.stats()
            runs[label]["group"] = gstats["group"]
            runs[label]["breaker_opens"] = sum(
                e["breaker_stats"]["opens"] + e["breaker_stats"]["reopens"]
                for e in gstats["endpoints"])
        finally:
            group.close()
            cl.close()
        runs[label]["serve_errors"] = cl.serve_errors

    nf, fl = runs["nofault"], runs["fault"]
    out = {
        "metric": "replica_soak",
        "n_replicas": args.n_replicas, "rf": args.rf,
        "hedge_ms": args.hedge_ms, "keys": args.keys,
        "steps": args.steps, "batch": args.batch, "zipf": args.zipf,
        "page_words": args.page_words, "kill_cycles": n_cycles,
        "nofault_hit_rate": nf["hit_rate"],
        "fault_hit_rate": fl["hit_rate"],
        "hit_rate_ratio": round(
            fl["hit_rate"] / max(1e-9, nf["hit_rate"]), 4),
        "hit_rate_floor": fl["hit_rate_floor"],
        "wrong_bytes": nf["wrong_bytes"] + fl["wrong_bytes"],
        "hedges_fired": fl["group"]["hedges_fired"],
        "failovers": fl["group"]["failover_gets"],
        "repair_pages": fl["group"]["repair_pages"],
        "breaker_opens": fl["breaker_opens"],
        "load_shed_gets": fl["group"]["load_shed_gets"],
        "serve_errors": nf["serve_errors"] + fl["serve_errors"],
        "nofault": nf, "fault": fl,
    }
    stamp_live_device(out, "direct", args.device)
    append_history(args.history, out)
    return out


def main(argv=None) -> int:
    from pmdfc_tpu_torch.bench.common import smoke_sizes

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-replicas", type=int, default=3)
    p.add_argument("--rf", type=int, default=2)
    p.add_argument("--hedge-ms", type=float, default=25.0)
    p.add_argument("--keys", type=int, default=1 << 12)
    p.add_argument("--steps", type=int, default=600,
                   help="storm steps (one batched op each)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--zipf", type=float, default=0.99)
    p.add_argument("--put-frac", type=float, default=0.2)
    p.add_argument("--kill-every", type=int, default=150,
                   help="steps between rolling kills")
    p.add_argument("--down-steps", type=int, default=75,
                   help="steps a victim stays down before cold restore")
    p.add_argument("--repair-batch", type=int, default=128)
    p.add_argument("--page-words", type=int, default=256)
    p.add_argument("--capacity", type=int, default=1 << 14)
    p.add_argument("--bloom-bits", type=int, default=1 << 18)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write the JSON artifact")
    p.add_argument("--history", default=None,
                   help="evidence log path (card runs only)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes, not a perf claim")
    args = p.parse_args(argv)
    if args.smoke:
        smoke_sizes(p, args, keys=1 << 9, steps=240, batch=16,
                    page_words=64, capacity=1 << 12, bloom_bits=1 << 14,
                    kill_every=70, down_steps=35)
    out = run(args)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("nofault", "fault")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    ok = (out["wrong_bytes"] == 0
          and out["serve_errors"] == 0
          and out["hit_rate_ratio"] >= 0.8
          and out["repair_pages"] > 0
          and out["breaker_opens"] >= 1)
    print(f"[replica_soak] {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
