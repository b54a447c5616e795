"""Elastic-membership soak — scale the fleet mid-storm, price the dip
(twin of `pmdfc_tpu/bench/elastic_sweep.py`).

The elastic claim, measured: a `ReplicaGroup` on the consistent-hash
placement ring serves a seeded zipf GET/PUT storm while the fleet
scales 3 → 5 → 2 — two joins, then three leaves, with live migration
streaming each transition's owed ~rf/N key share to its new owners and
the dual-read window covering keys mid-move. Two runs with the
identical seed — a no-churn reference, then the scaling run — so the
artifact prices elasticity directly:

- `hit_rate_ratio`   — scaling-run GET hit-rate / no-churn hit-rate
  (the dip the dual-read window + migration must bound);
- `hit_rate_floor`   — the worst windowed hit-rate during the scaling
  run (the transient while a transition drains);
- `moved_pages` / `owed_frac` — how much of the key space migration
  actually moved vs the consistent-hashing expectation (the ~1/N
  claim, counted, not assumed);
- `miss_routed`      — the dip's attributable cause lane (in-flight
  keys mid-move degrade to THIS miss, never wrong bytes);
- `wrong_bytes`      — ALWAYS 0: every served page content-verifies.

The nodes' KVs are the port's on `--device` (default `cuda`). Every run
holds the gates and exits 1 on a violation: zero wrong bytes, no serve
error on any node, five transitions, pages moved, the moved share within
2x the consistent-hashing expectation, the hit-rate ratio >= 0.75 and a
teledump that passes `pmdfc_tpu_torch.tools.check_teledump`.

Run: `python -m pmdfc_tpu_torch.bench.elastic_sweep --smoke --device cpu`
(tiny shapes) or with real sizes; `--history` appends a
`transport=tcp_elastic` row to an evidence log.
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
    """Real-KV NetServers with mid-soak spawn (grow) and stop (shrink);
    slots are append-only like the group's, so ports[i] stays the i-th
    endpoint's address for the whole run."""

    def __init__(self, n: int, kv_cfg, device):
        from pmdfc_tpu_torch.client.backends import DirectBackend
        from pmdfc_tpu_torch.kv import KV
        from pmdfc_tpu_torch.runtime.net import NetServer

        self._mk_kv = lambda: KV(kv_cfg, device=device)
        self._mk_srv = lambda kv: NetServer(
            lambda kv=kv: DirectBackend(kv)).start()
        self.kvs = []
        self.servers = []
        self.ports = []
        self.serve_errors = 0  # over every server this cluster stopped
        for _ in range(n):
            self.spawn()

    def spawn(self) -> int:
        kv = self._mk_kv()
        srv = self._mk_srv(kv)
        self.kvs.append(kv)
        self.servers.append(srv)
        self.ports.append(srv.port)
        return len(self.servers) - 1

    def stop(self, i: int) -> None:
        if self.servers[i] is not None:
            self.serve_errors += int(self.servers[i].stats["serve_errors"])
            self.servers[i].stop()
            self.servers[i] = None
            self.kvs[i] = None

    def close(self) -> None:
        for i in range(len(self.servers)):
            self.stop(i)


def _endpoint(cl: _Cluster, i: int, page_words: int, seed: int):
    from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    def factory(i=i):
        return TcpBackend("127.0.0.1", cl.ports[i],
                          page_words=page_words,
                          keepalive_s=None, op_timeout_s=30.0)

    return ReconnectingClient(factory, page_words=page_words,
                              retry_delay_s=0.005,
                              max_retry_delay_s=0.05, seed=seed + i)


def _build_group(cl: _Cluster, args, seed: int):
    from pmdfc_tpu_torch.client.replica import ReplicaGroup
    from pmdfc_tpu_torch.config import ReplicaConfig, RingConfig

    cfg = ReplicaConfig(
        n_replicas=args.n_start, rf=args.rf, hedge_ms=args.hedge_ms,
        breaker_failures=3, breaker_cooldown_s=0.05,
        breaker_max_cooldown_s=0.4,
        repair_interval_s=0.0,  # ticked per step: deterministic rate
        repair_batch=args.repair_batch,
        put_journal_cap=max(1 << 16, 2 * args.keys),
        ring=RingConfig(vnodes=args.vnodes,
                        migrate_batch=args.migrate_batch,
                        migrate_pages_per_s=args.migrate_rate,
                        migrate_burst=max(args.migrate_batch * 2, 256)),
    )
    return ReplicaGroup(
        [_endpoint(cl, i, args.page_words, seed)
         for i in range(args.n_start)],
        page_words=args.page_words, cfg=cfg, seed=seed)


def _storm(group, cl: _Cluster, args, schedule: dict) -> dict:
    """One seeded storm pass. `schedule`: step -> list of membership
    actions ("grow" or ("shrink", slot)). Returns hit-rate stats;
    finishing without an exception is the no-exception invariant."""
    from pmdfc_tpu_torch.bench.tier_sweep import _zipf_stream

    rng = np.random.default_rng(args.seed)
    universe = _keys_of(np.arange(args.keys, dtype=np.uint32))
    truth = _pages_of(universe, args.page_words)
    for lo in range(0, args.keys, args.batch):
        group.put(universe[lo:lo + args.batch], truth[lo:lo + args.batch])

    stream = _zipf_stream(rng, args.keys, args.steps * args.batch,
                          args.zipf)
    window = max(1, args.steps // 24)
    stats = {"gets": 0, "hits": 0, "wrong_bytes": 0, "windows": [],
             "transitions": []}
    w_gets = w_hits = 0
    t0 = time.perf_counter()
    for step in range(args.steps):
        for act in schedule.get(step, ()):
            # one transition at a time (the engine's contract): settle
            # the previous window before the next membership change
            group.drain_migration(30.0)
            if act == "grow":
                slot = cl.spawn()
                new = group.add_endpoint(
                    _endpoint(cl, slot, args.page_words, args.seed))
                stats["transitions"].append(("join", new, step))
            else:
                _, slot = act
                group.remove_endpoint(slot)
                stats["transitions"].append(("leave", slot, step))
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
        group.repair_tick()  # repair + migration share the cadence
        if (step + 1) % window == 0 and w_gets:
            stats["windows"].append(round(w_hits / w_gets, 4))
            w_gets = w_hits = 0
    # settle the tail transition so retired servers can stop cleanly
    group.drain_migration(30.0)
    # retired slots' servers only stop AFTER their transition drained
    for kind, slot, _ in stats["transitions"]:
        if kind == "leave":
            cl.stop(slot)
    stats["secs"] = round(time.perf_counter() - t0, 3)
    stats["hit_rate"] = round(stats["hits"] / max(1, stats["gets"]), 4)
    stats["hit_rate_floor"] = min(stats["windows"], default=None)
    return stats


def run(args) -> dict:
    from pmdfc_tpu_torch.bench.common import (append_history,
                                              stamp_live_device)
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        ring_enabled)

    if not ring_enabled():
        raise SystemExit("[elastic_sweep] PMDFC_RING=off — nothing to "
                         "sweep (membership is static)")
    kv_cfg = KVConfig(
        index=IndexConfig(capacity=args.capacity),
        bloom=BloomConfig(num_bits=args.bloom_bits),
        paged=True, page_words=args.page_words,
    )

    # 3 -> 5 -> 2: two joins a third in, three leaves two thirds in
    # (the chaos drill's shape; slots 0/1/2 are the original fleet)
    grow_at = args.steps // 3
    shrink_at = (2 * args.steps) // 3
    schedule = {
        grow_at: ["grow"],
        grow_at + args.settle_steps: ["grow"],
        shrink_at: [("shrink", 0)],
        shrink_at + args.settle_steps: [("shrink", 1)],
        shrink_at + 2 * args.settle_steps: [("shrink", 2)],
    }

    runs = {}
    for label, sched in (("nochurn", {}), ("elastic", schedule)):
        cl = _Cluster(args.n_start, kv_cfg, args.device)
        group = _build_group(cl, args, seed=args.seed)
        try:
            runs[label] = _storm(group, cl, args, sched)
            gstats = group.stats()
            runs[label]["group"] = gstats["group"]
            if "migration" in gstats:
                runs[label]["migration"] = {
                    k: v for k, v in gstats["migration"].items()
                    if isinstance(v, (int, float, bool, str))}
                runs[label]["ring_epoch"] = gstats["ring"]["epoch"]
            if label == "elastic":
                # the teledump doc under load, pulled from a LIVE
                # surviving server — the smoke gate pins the migration
                # counters on it (the client group shares the process
                # registry, so the pull carries the migration scope)
                from pmdfc_tpu_torch.runtime.net import TcpBackend

                live = next(i for i, s in enumerate(cl.servers)
                            if s is not None)
                mon = TcpBackend("127.0.0.1", cl.ports[live],
                                 page_words=args.page_words,
                                 keepalive_s=None)
                runs[label]["teledoc"] = mon.server_stats()
                mon.close()
        finally:
            group.close()
            cl.close()
        runs[label]["serve_errors"] = cl.serve_errors

    nc, el = runs["nochurn"], runs["elastic"]
    mig = el.get("migration", {})
    # the ~1/N accounting: expected moved fraction summed over the
    # schedule (join N->N+1 moves ~rf/(N+1) of keys; leave N->N-1 moves
    # the leaver's ~rf/N share), against the measured candidate count
    exp_frac = 0.0
    n = args.n_start
    for _ in range(2):
        n += 1
        exp_frac += args.rf / n
    for _ in range(3):
        exp_frac += args.rf / n
        n -= 1
    # owed_frac and expected_frac are both SUMS over the five
    # transitions, in key-space-fraction units, so they compare directly
    owed_frac = round(mig.get("candidate_keys", 0)
                      / max(1, args.keys), 4)
    out = {
        "metric": "elastic_hit_rate_ratio",
        "value": round(el["hit_rate"] / max(1e-9, nc["hit_rate"]), 4),
        "unit": "ratio",
        "transport": "tcp_elastic",
        "n_start": args.n_start, "rf": args.rf,
        "vnodes": args.vnodes, "keys": args.keys,
        "steps": args.steps, "batch": args.batch, "zipf": args.zipf,
        "page_words": args.page_words,
        "nochurn_hit_rate": nc["hit_rate"],
        "elastic_hit_rate": el["hit_rate"],
        "hit_rate_floor": el["hit_rate_floor"],
        "wrong_bytes": nc["wrong_bytes"] + el["wrong_bytes"],
        "transitions": int(mig.get("transitions", 0)),
        "moved_pages": int(mig.get("moved_pages", 0)),
        "migration_dropped": int(mig.get("dropped_keys", 0)),
        "owed_frac": owed_frac,
        "expected_frac": round(exp_frac, 4),
        "miss_routed": int(el["group"]["miss_routed"]),
        "serve_errors": nc["serve_errors"] + el["serve_errors"],
        "host_evidence": True,
    }
    stamp_live_device(out, "direct", args.device)
    append_history(args.history, out)
    out["nochurn"] = nc
    out["elastic"] = {k: v for k, v in el.items() if k != "teledoc"}
    out["teledoc"] = el.get("teledoc")
    return out


def main(argv=None) -> int:
    from pmdfc_tpu_torch.bench.common import smoke_sizes

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-start", type=int, default=3)
    p.add_argument("--rf", type=int, default=2)
    p.add_argument("--vnodes", type=int, default=64)
    p.add_argument("--hedge-ms", type=float, default=25.0)
    p.add_argument("--keys", type=int, default=1 << 12)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--zipf", type=float, default=0.99)
    p.add_argument("--put-frac", type=float, default=0.2)
    p.add_argument("--settle-steps", type=int, default=60,
                   help="steps between consecutive membership changes")
    p.add_argument("--repair-batch", type=int, default=128)
    p.add_argument("--migrate-batch", type=int, default=256)
    p.add_argument("--migrate-rate", type=float, default=0.0,
                   help="token-bucket pages/s (0 = unbounded)")
    p.add_argument("--page-words", type=int, default=256)
    p.add_argument("--capacity", type=int, default=1 << 14)
    p.add_argument("--bloom-bits", type=int, default=1 << 18)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--history", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes, not a perf claim")
    args = p.parse_args(argv)
    if args.smoke:
        smoke_sizes(p, args, keys=1 << 9, steps=180, batch=16,
                    page_words=64, capacity=1 << 12, bloom_bits=1 << 14,
                    settle_steps=20)
    out = run(args)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("nochurn", "elastic", "teledoc")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: v for k, v in out.items() if k != "teledoc"},
                      f, indent=2)
    from pmdfc_tpu_torch.tools.check_teledump import check

    tele_errs = check(out["teledoc"]) if out.get("teledoc") else \
        ["no teledump pulled"]
    if tele_errs:
        print(f"[elastic_sweep] teledump errors: {tele_errs}")
    ok = (out["wrong_bytes"] == 0
          and out["serve_errors"] == 0
          and out["transitions"] == 5
          and out["moved_pages"] > 0
          # the ~1/N claim, counted: the moved share stays within
          # vnode variance of the consistent-hashing expectation
          and out["owed_frac"] <= 2.0 * out["expected_frac"]
          and out["value"] >= 0.75
          and not tele_errs)
    print(f"[elastic_sweep] {'OK' if ok else 'FAIL'} "
          f"(ratio={out['value']}, moved={out['moved_pages']}, "
          f"owed_frac={out['owed_frac']} vs "
          f"expected {out['expected_frac']}, "
          f"miss_routed={out['miss_routed']})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
