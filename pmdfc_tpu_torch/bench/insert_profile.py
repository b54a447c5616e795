"""Insert-path phase profile — where does the element insert's time go?
(twin of `pmdfc_tpu/bench/insert_profile.py`).

Times each piece of the linear index's element insert
(`models/linear.insert_batch_element`) as its OWN warmed call at bench
shapes, so the whole insert's time gets a measured owner per piece:

- hash:     cluster selection (`hash_u64` + mask)
- plan:     `plan_insert`'s stable lexsort + winner/segment marks
- rank:     `plan_rank`'s segmented scans (cumsum/cummax + unsort scatter)
- gather:   the cluster-row gather + lane match (shared with GET)
- scatter:  the element path's four table-word scatters and the head
            bump, with precomputed targets, in place
- index:    the whole `insert_batch_element` (what the bench times)

`index` is the ground truth the pieces should sum to (within what the
whole call shares: pieces can only OVERESTIMATE it). On a card each
piece is the median of `--reps` CUDA-event windows, its queued work
alone; on the CPU the host clock.

Reference for the metric being optimized: test_KV insert phase,
`server/test_KV.cpp:204-262` (PUT storm before the GET storm).

Run: `python -m pmdfc_tpu_torch.bench.insert_profile --device cpu --n
4096 --capacity 8192` (small) or its defaults on a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def timed(fn, device, reps: int = 3) -> float:
    """Median seconds of `fn()` over `reps` timed calls after one warm
    call (the call's device time on a card)."""
    from pmdfc_tpu_torch.bench.common import timed_ms

    fn()
    return float(np.median([timed_ms(fn, device) for _ in range(reps)])
                 ) / 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1 << 22)
    p.add_argument("--capacity", type=int, default=1 << 23)
    # default matches test_kv's benched shape (16-slot / 256 B rows) so
    # the per-piece ns/key decompose the SAME configuration test_kv runs
    p.add_argument("--cluster-slots", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--history", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="a small table, every piece")
    args = p.parse_args(argv)
    if args.smoke:
        from pmdfc_tpu_torch.bench.common import smoke_sizes

        smoke_sizes(p, args, n=1 << 12, capacity=1 << 13)

    import torch

    from pmdfc_tpu_torch.bench.common import append_history
    from pmdfc_tpu_torch.config import IndexConfig
    from pmdfc_tpu_torch.kv import resolve_device
    from pmdfc_tpu_torch.models import linear
    from pmdfc_tpu_torch.models.base import plan_insert, plan_rank
    from pmdfc_tpu_torch.models.rowops import match_rows
    from pmdfc_tpu_torch.utils.keys import is_invalid

    dev = resolve_device(args.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[profile] device: {dev.type}:{kind}")
    cfg = IndexConfig(capacity=args.capacity,
                      cluster_slots=args.cluster_slots)
    state = linear.init(cfg, device=dev)
    c_count = state.table.shape[0]
    s = args.cluster_slots

    rng = np.random.default_rng(11)
    keys = torch.from_numpy(rng.integers(1, 1 << 31, (args.n, 2),
                                         dtype=np.uint32).view(np.int32)
                            ).to(dev)
    values = torch.from_numpy(rng.integers(1, 1 << 31, (args.n, 2),
                                           dtype=np.uint32).view(np.int32)
                              ).to(dev)

    ns = {}

    def piece(name, fn):
        sec = timed(fn, dev, reps=args.reps)
        ns[name] = sec / args.n * 1e9
        print(f"[profile] {name:>8}: {ns[name]:7.1f} ns/key "
              f"({sec * 1e3:.1f} ms)")

    # hash: cluster selection only
    piece("hash", lambda: linear.cluster_of(keys, c_count).sum())

    # plan: the stable lexsort (+ winner/seg marks)
    valid = ~is_invalid(keys)
    c = linear.cluster_of(keys, c_count)
    piece("plan", lambda: plan_insert(keys, c, valid,
                                      num_segments=c_count).winner.sum())

    # rank: segmented scans given a prebuilt plan
    plan = plan_insert(keys, c, valid, num_segments=c_count)
    piece("rank", lambda: plan_rank(plan, plan.winner).to(torch.int64)
          .sum())

    # gather: row gather + lane match (the GET-shared piece)
    piece("gather", lambda: match_rows(state.table[c], keys, s)[1]
          .to(torch.int64).sum())

    # scatter: the element path's word scatters with precomputed targets,
    # in place. Repeated calls rewrite the same lanes and advance the
    # FIFO head: shape-stable, cost-identical.
    rank = plan_rank(plan, plan.winner)
    ins = plan.winner & (rank < s)
    ci = c[ins]
    pos_i = (rank[ins].to(torch.int64) & (s - 1))
    k_i, v_i = keys[ins], values[ins]
    tbl, hd = state.table, state.head
    ones = torch.ones_like(ci, dtype=torch.int32)

    def scatters():
        tbl[ci, pos_i] = k_i[:, 0]
        tbl[ci, s + pos_i] = k_i[:, 1]
        tbl[ci, 2 * s + pos_i] = v_i[:, 0]
        tbl[ci, 3 * s + pos_i] = v_i[:, 1]
        hd.index_add_(0, ci, ones)

    piece("scatter", scatters)

    # index: the whole element insert (ground truth), in place
    st = linear.init(cfg, device=dev)
    piece("index", lambda: linear.insert_batch_element(st, keys, values))

    pieces = sum(v for k, v in ns.items() if k != "index")
    record = {
        "metric": "insert_phase_profile",
        "device": dev.type,
        "device_kind": kind,
        "n": args.n,
        "capacity": args.capacity,
        "ns_per_key": {k: round(v, 1) for k, v in ns.items()},
        "pieces_sum_ns": round(pieces, 1),
        "fused_ns": round(ns["index"], 1),
        "insert_mops_equiv": round(1e3 / ns["index"], 2),
    }
    append_history(args.history, record)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
