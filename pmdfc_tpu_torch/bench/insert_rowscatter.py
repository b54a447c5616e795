"""Row-rebuild insert vs element-scatter insert, on the port's linear
index (twin of `pmdfc_tpu/bench/insert_rowscatter.py`).

`models/linear.insert_batch_element` writes each placed key's four
lanes and each update's two value lanes by element scatters;
`insert_batch_row` gathers every touched cluster row once, merges the
batch's writes into it, and writes each touched row back with one
full-row scatter. This harness (a) proves the two equal bit for bit
(tables, heads and every `InsertResult` field) on randomized batches,
and (b) fills two indexes side by side, one per path, with the same
mixed batches (fresh keys, updates of earlier keys, duplicates inside
the batch, padding; same-cluster collisions come with the fill), holding
them equal after every batch and timing every insert: CUDA events on a
card, the host clock on the CPU. Each batch is new, so the timed inserts
rotate over distinct data.

Run: `python -m pmdfc_tpu_torch.bench.insert_rowscatter` (the card, a
2^21-slot index filled to 75% in 2^16-key batches), `--device cpu`, or
`--smoke` (a small index; asserts the machinery). The last line is one
JSON row with the JAX harness's keys (`metric`, `device`, `n`,
`element_ns_per_key`, `row_ns_per_key`, `element_mops`, `row_mops`,
`row_speedup`) and this harness's fill figures beside them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np


def check_equivalence(seed: int = 0, trials: int = 40,
                      device: str = "cpu") -> int:
    """Randomized equivalence on a small index: the same batches through
    both paths, on two copies of one state, give identical tables, heads
    and results after every batch (a tiny keyspace forces updates,
    evictions, drops and update-vs-evicting-insert lane collisions)."""
    import torch

    from pmdfc_tpu_torch.config import IndexConfig
    from pmdfc_tpu_torch.models import linear as L
    from pmdfc_tpu_torch.utils.keys import INVALID_WORD

    rng = np.random.default_rng(seed)
    cfg = IndexConfig(capacity=1 << 9, cluster_slots=16)
    a = L.init(cfg, device)
    b = L.LinearState(table=a.table.clone(), head=a.head.clone())
    for t in range(trials):
        bsz = int(rng.integers(8, 65))
        keys = rng.integers(0, 24, (bsz, 2), dtype=np.uint32)
        if bsz > 4:  # duplicates and padding
            keys[rng.integers(bsz)] = keys[rng.integers(bsz)]
            keys[rng.integers(bsz)] = INVALID_WORD
        vals = rng.integers(0, 1 << 32, (bsz, 2), dtype=np.uint32)
        k = torch.from_numpy(keys.view(np.int32)).to(device)
        v = torch.from_numpy(vals.view(np.int32)).to(device)
        _, ra = L.insert_batch_element(a, k, v)
        _, rb = L.insert_batch_row(b, k, v)
        _assert_same(a, b, ra, rb, f"trial {t}")
    return trials


def _assert_same(a, b, ra, rb, where: str) -> None:
    import torch

    if not torch.equal(a.table, b.table):
        raise AssertionError(f"table differs after {where}")
    if not torch.equal(a.head, b.head):
        raise AssertionError(f"head differs after {where}")
    for f in ra._fields:
        if not torch.equal(getattr(ra, f), getattr(rb, f)):
            raise AssertionError(f"InsertResult.{f} differs after {where}")


def mixed_batches(n_fresh: int, batch: int, seed: int, device):
    """Batches of `batch` keys ([batch, 2] int32 u32 bits, values the
    same) until `n_fresh` fresh keys have gone in: 3/4 fresh keys (random
    64-bit words), 1/8 updates of keys an earlier batch put, 1/16
    duplicates of this batch's fresh keys with other values, 1/16
    INVALID padding, shuffled. Made on the device."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    nf, nu, nd = 3 * batch // 4, batch // 8, batch // 16
    npad = batch - nf - nu - nd

    def rand(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                             device=device, generator=g)

    put = []
    done = 0
    while done < n_fresh:
        fresh = rand(nf, 2)
        parts = [fresh]
        if put:
            old = torch.cat(put)
            parts.append(old[torch.randint(0, old.shape[0], (nu,),
                                           device=device, generator=g)])
        else:
            parts.append(rand(nu, 2))
        parts.append(fresh[torch.randint(0, nf, (nd,), device=device,
                                         generator=g)])
        parts.append(torch.full((npad, 2), -1, dtype=torch.int32,
                                device=device))
        keys = torch.cat(parts)
        keys = keys[torch.randperm(batch, device=device, generator=g)]
        put.append(fresh)
        done += nf
        yield keys, rand(batch, 2)


def ab_fill(capacity: int = 1 << 21, batch: int = 1 << 16,
            fill: float = 0.75, device: str = "cuda", seed: int = 0,
            log=None) -> dict:
    """Fill two linear indexes of `capacity` slots (default 32 slots a
    cluster) to `fill` with the same `mixed_batches`, one through each
    insert path; assert them equal after every batch; time every insert
    (CUDA events on a card, the host clock on the CPU), the two paths
    taking turns at going first, after one untimed insert of the same
    width through each on a throwaway index (the first insert of a width
    pays the caching allocator's first allocations). -> the figures."""
    import torch

    from pmdfc_tpu_torch.config import IndexConfig
    from pmdfc_tpu_torch.models import linear as L
    from pmdfc_tpu_torch.utils.keys import is_invalid

    dev = torch.device(device)
    cfg = IndexConfig(capacity=capacity)
    a, b = L.init(cfg, dev), L.init(cfg, dev)
    n_fresh = int(fill * L.num_slots(cfg))
    cuda = dev.type == "cuda"
    t_el, t_row = [], []
    stats = {"batches": 0, "updates": 0, "evicted": 0, "dropped": 0,
             "collided": 0}

    def timed(fn, state, k, v):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            _, res = fn(state, k, v)
            e1.record()
            e1.synchronize()
            return res, e0.elapsed_time(e1)
        t0 = time.perf_counter()
        _, res = fn(state, k, v)
        return res, (time.perf_counter() - t0) * 1e3

    with (torch.cuda.device(dev) if cuda else contextlib.nullcontext()):
        k, v = next(mixed_batches(batch, batch, seed + 1, dev))
        for fn in (L.insert_batch_element, L.insert_batch_row):
            fn(L.init(cfg, dev), k, v)
        for i, (k, v) in enumerate(mixed_batches(n_fresh, batch, seed,
                                                 dev)):
            # same-cluster collisions in this batch, before it lands
            c = L.cluster_of(k[~is_invalid(k)], a.table.shape[0])
            stats["collided"] += int((torch.bincount(c).clamp(min=1) - 1)
                                     .sum())
            if cuda:
                torch.cuda.synchronize()
            if i % 2:
                rb, ms_b = timed(L.insert_batch_row, b, k, v)
                ra, ms_a = timed(L.insert_batch_element, a, k, v)
            else:
                ra, ms_a = timed(L.insert_batch_element, a, k, v)
                rb, ms_b = timed(L.insert_batch_row, b, k, v)
            _assert_same(a, b, ra, rb, f"batch {i}")
            t_el.append(ms_a)
            t_row.append(ms_b)
            stats["batches"] += 1
            stats["updates"] += int(((ra.slots >= 0) & ~ra.fresh).sum())
            stats["evicted"] += int((~is_invalid(ra.evicted)).sum())
            stats["dropped"] += int(ra.dropped.sum())
        occ = int((a.table[:, :a.table.shape[1] // 4] != -1).sum())
    el, row = float(np.mean(t_el)), float(np.mean(t_row))
    out = {
        "element_ms_per_batch": el,
        "row_ms_per_batch": row,
        "batch": batch,
        "slots": L.num_slots(cfg),
        "occupied": occ,
        **stats,
    }
    if log is not None:
        log(f"row vs element over {stats['batches']} batches of {batch} "
            f"keys into {out['slots']} slots ({occ} occupied): equal after "
            f"every batch; element {el:.4f} ms, row {row:.4f} ms per batch")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--capacity", type=int, default=1 << 21)
    p.add_argument("--n", type=int, default=1 << 16,
                   help="keys per insert batch")
    p.add_argument("--fill", type=float, default=0.75)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-check", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="a small index: asserts the machinery, fast exit")
    args = p.parse_args(argv)
    from pmdfc_tpu_torch.bench.common import smoke_sizes

    if args.smoke:
        smoke_sizes(p, args, capacity=1 << 12, n=1 << 9)

    if not args.skip_check:
        trials = check_equivalence(device=args.device)
        print(f"equivalence: {trials} randomized batches OK")
    res = ab_fill(args.capacity, args.n, args.fill, args.device, args.seed)
    el, row = res["element_ms_per_batch"], res["row_ms_per_batch"]
    n = args.n
    out = {
        "metric": "insert_rowscatter_vs_element",
        "n": n,
        "element_ns_per_key": round(el / n * 1e6, 2),
        "row_ns_per_key": round(row / n * 1e6, 2),
        "element_mops": round(n / el / 1e3, 2),
        "row_mops": round(n / row / 1e3, 2),
        "row_speedup": round(el / row, 3),
        **{k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in res.items()},
    }
    from pmdfc_tpu_torch.bench.common import stamp_live_device

    stamp_live_device(out, backend="direct", device=args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
