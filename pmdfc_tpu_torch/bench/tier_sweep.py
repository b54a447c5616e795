"""Tiered vs flat page-store GET sweep across zipf skews (twin of
`pmdfc_tpu/bench/tier_sweep.py`).

The claim to price: with a skewed GET stream (RDMAbox's observation that
remote-paging working sets are small and hot), a small HOT region serves
repeat GETs from a tier the machine can keep close, while the flat pool
strides the whole region on every batch. Two measurements per skew:

- `hot_gather` — the device gather serving a GET batch drawn from the
  PROMOTED working set, timed on each store's LIVE row distribution for
  the SAME keys: the tiered store resolves them inside its compact hot
  region (<= 1/8 of capacity), the flat store scatters them across the
  whole pool. The gather is torch indexing (`pages[rows]`), a measuring
  stick, timed by CUDA events on a card.
- `stream_mops` — end-to-end throughput of the full zipf stream through
  `KV.get` on both stores (every promotion and migration the tiered
  store pays included), host clock.

Every GET batch is checked as it is served (outside the timed region):
every hit byte-exact against the key-derived page, every miss zeroed,
and `misses == Σ miss_*` on both stores at the end of each skew; a
failed check raises. The KVs are the port's on `--device` (default
`cuda`).

Run: `python -m pmdfc_tpu_torch.bench.tier_sweep --smoke --device cpu`
(tiny shapes) or with real sizes; `--out` writes the JSON artifact and
`--history` appends it to an evidence log (card runs only).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _zipf_stream(rng, n_keys: int, n: int, a: float) -> np.ndarray:
    """Zipf ranks over [0, n_keys) — rank r picked w.p. ∝ (r+1)^-a, draw
    for draw the JAX harness's sampler.

    Finite-universe inverse-CDF sampler (numpy's `rng.zipf` needs a > 1;
    the interesting cache skews live at a <= 1)."""
    if a <= 0:
        return rng.integers(0, n_keys, n).astype(np.uint32)
    w = np.power(np.arange(1, n_keys + 1, dtype=np.float64), -a)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, rng.random(n), side="right")
    ranks = np.minimum(ranks, n_keys - 1)
    # rank-shuffled so hot keys are scattered across the key space (the
    # hash-routed reality), not clustered at low ids
    perm = rng.permutation(n_keys).astype(np.uint32)
    return perm[ranks]


def _keys(los: np.ndarray) -> np.ndarray:
    los = np.asarray(los, np.uint32)
    return np.stack([los >> 16, los], axis=-1).astype(np.uint32)


def _pages(keys: np.ndarray, page_words: int) -> np.ndarray:
    lo = np.asarray(keys, np.uint32)[:, 1]
    return (lo[:, None] * np.uint32(2654435761)
            + np.arange(page_words, dtype=np.uint32)[None, :])


def pages_on(keys, page_words: int):
    """`_pages` of int32 key words (u32 bits) as int32 bits, built on the
    keys' device."""
    import torch

    lo = keys[:, 1].long() & 0xFFFFFFFF
    pg = (lo[:, None] * 2654435761
          + torch.arange(page_words, device=keys.device)[None, :])
    pg = pg & 0xFFFFFFFF
    return torch.where(pg >= 1 << 31, pg - (1 << 32), pg).to(torch.int32)


def check_served(keys, out, found, page_words: int, label: str) -> int:
    """A served GET batch against the key-derived pages: every hit
    byte-exact, every miss zeroed. -> hits; raises on a wrong byte."""
    out, found = np.asarray(out), np.asarray(found, bool)
    wrong = int((out[found] != _pages(keys[found], page_words))
                .any(axis=1).sum())
    dirty = int(out[~found].any(axis=1).sum())
    if wrong or dirty:
        raise AssertionError(f"{label}: {wrong} hits with wrong bytes, "
                             f"{dirty} misses not zeroed")
    return int(found.sum())


def check_causes(kv, label: str) -> None:
    """`misses == Σ miss_*` on the KV's stats; raises otherwise."""
    st = kv.stats()
    causes = sum(v for k, v in st.items() if k.startswith("miss_"))
    if st["misses"] != causes:
        raise AssertionError(f"{label}: misses {st['misses']} != "
                             f"sum of causes {causes}")


def _timed_gets(kv, keys: np.ndarray, batch: int, page_words: int,
                label: str):
    """Drive GET batches -> (seconds, hits). Results come back to the
    host (the full serve cost); each batch's check runs off the clock."""
    secs = 0.0
    hits = 0
    for i in range(0, len(keys), batch):
        kb = keys[i:i + batch]
        t0 = time.perf_counter()
        out, found = kv.get(kb)
        secs += time.perf_counter() - t0
        hits += check_served(kb, out, found, page_words, label)
    return secs, hits


def _resolve_rows(kv, keys: np.ndarray) -> np.ndarray:
    """Row id per key via the KV's full-scan lookup (chunked so the
    [B, N] compare stays bounded); -1 where absent."""
    rows = np.full(len(keys), -1, np.int64)
    for lo in range(0, len(keys), 512):
        vals, found, _ = kv.find_anyway(keys[lo:lo + 512])
        rows[lo:lo + 512] = np.where(found, vals[:, 1].astype(np.int64), -1)
    return rows


def _timed_gather_pair(pages_a, rows_a: np.ndarray, pages_b,
                       rows_b: np.ndarray, reps: int = 10,
                       rounds: int = 8):
    """(µs_a, µs_b): min-of-rounds, A/B interleaved per round so the two
    sides see the same machine weather."""
    import torch

    from pmdfc_tpu_torch.bench.common import timed_ms

    dev = pages_a.device
    ra = torch.from_numpy(rows_a).to(dev)
    rb = torch.from_numpy(rows_b).to(dev)
    pages_a[ra]  # warm
    pages_b[rb]
    best_a = best_b = float("inf")
    for _ in range(rounds):
        best_a = min(best_a, timed_ms(lambda: pages_a[ra], dev, reps) * 1e3)
        best_b = min(best_b, timed_ms(lambda: pages_b[rb], dev, reps) * 1e3)
    return best_a, best_b


def run(args, keep=None) -> dict:
    """The sweep -> its row. `keep(kv, keys)`, when given, sees the last
    skew's tiered KV and its inserted keys before the stores are
    freed."""
    import torch

    from pmdfc_tpu_torch.bench.common import (append_history,
                                              stamp_live_device)
    from pmdfc_tpu_torch.config import IndexConfig, KVConfig, TierConfig
    from pmdfc_tpu_torch.kv import KV, resolve_device
    from pmdfc_tpu_torch.utils.keys import INVALID_WORD

    W = args.page_words
    cap = args.capacity
    flat_cfg = KVConfig(index=IndexConfig(capacity=cap), bloom=None,
                        paged=True, page_words=W)
    tier_cfg = KVConfig(
        index=IndexConfig(capacity=cap), bloom=None, paged=True,
        page_words=W,
        tier=TierConfig(hot_fraction=args.hot_fraction,
                        promote_touches=2,
                        max_promotes_per_batch=args.batch),
    )
    n_keys = cap // 2  # half-full: no index evictions pollute the sweep
    all_keys = _keys(np.arange(1, n_keys + 1))
    rng = np.random.default_rng(args.seed)

    sweeps = []
    flat = tier = None
    for a in args.zipfs:
        flat = tier = None  # the last skew's stores go before these fill
        flat = KV(flat_cfg, device=args.device)
        tier = KV(tier_cfg, device=args.device)
        for i in range(0, n_keys, args.batch):
            # the pages are made on the KV's device
            kt = torch.from_numpy(all_keys[i:i + args.batch].view(
                np.int32)).to(resolve_device(args.device))
            pb = pages_on(kt, W)
            flat.insert(kt, pb)
            tier.insert(kt, pb)
        stream = _zipf_stream(rng, n_keys, args.gets, a)
        skeys = all_keys[stream]

        # warm: one pass drives promotions
        _timed_gets(tier, skeys[: args.batch * 4], args.batch, W,
                    f"tier zipf {a} warm")
        _timed_gets(flat, skeys[: args.batch * 4], args.batch, W,
                    f"flat zipf {a} warm")

        t_tier, hits_t = _timed_gets(tier, skeys, args.batch, W,
                                     f"tier zipf {a}")
        t_flat, hits_f = _timed_gets(flat, skeys, args.batch, W,
                                     f"flat zipf {a}")
        check_causes(tier, f"tier zipf {a}")
        check_causes(flat, f"flat zipf {a}")

        # hot-resident batches: keys currently promoted into the hot tier,
        # gather-timed on each store's OWN row distribution
        ts = tier.tier_stats()
        pool = tier.state.pool
        h_rows = pool.hfree.shape[0]
        hk = pool.hot_keys.cpu().numpy().view(np.uint32)
        occ = ~np.all(hk == INVALID_WORD, axis=-1)
        hot_keys = hk[occ]
        hot_us = flat_us = hot_frac = None
        if len(hot_keys) >= max(256, args.batch // 4):
            hb = hot_keys[rng.integers(0, len(hot_keys), args.batch)]
            rows_t = _resolve_rows(tier, hb)
            rows_f = _resolve_rows(flat, hb)
            ok = (rows_t >= 0) & (rows_f >= 0)
            hot_frac = round(float((rows_t[ok] < h_rows).mean()), 4)
            hot_us, flat_us = _timed_gather_pair(
                pool.pages, rows_t[ok], flat.state.pool.pages, rows_f[ok])
        sweeps.append({
            "zipf": a,
            "stream_mops_tier": round(args.gets / t_tier / 1e6, 4),
            "stream_mops_flat": round(args.gets / t_flat / 1e6, 4),
            "hits_tier": hits_t, "hits_flat": hits_f,
            "hot_gather_us_tier": round(hot_us, 1) if hot_us else None,
            "hot_gather_us_flat": round(flat_us, 1) if flat_us else None,
            "hot_gather_speedup": (round(flat_us / hot_us, 3)
                                   if hot_us and flat_us else None),
            "hot_batch_frac_in_hot_tier": hot_frac,
            "tier": ts,
        })
    if keep is not None:
        keep(tier, all_keys)
    del flat, tier

    out = {
        "metric": "tier_sweep",
        "capacity": cap, "page_words": W, "batch": args.batch,
        "gets": args.gets, "hot_fraction": args.hot_fraction,
        "sweeps": sweeps,
    }
    stamp_live_device(out, "direct", args.device)
    append_history(args.history, out)
    return out


def main(argv=None) -> int:
    from pmdfc_tpu_torch.bench.common import smoke_sizes

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--capacity", type=int, default=1 << 17)
    p.add_argument("--page-words", type=int, default=512)
    p.add_argument("--batch", type=int, default=1 << 11)
    p.add_argument("--gets", type=int, default=1 << 16)
    p.add_argument("--hot-fraction", type=int, default=16,
                   help="hot rows = capacity // this (>= 8 keeps the "
                        "acceptance bound: hot <= 1/8 of capacity)")
    p.add_argument("--zipfs", type=lambda s: [float(x) for x in
                                              s.split(",")],
                   default=[0.6, 0.99, 1.2])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write the JSON artifact")
    p.add_argument("--history", default=None,
                   help="evidence log path (card runs only)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes; exercises promote/demote/balloon "
                        "machinery, not a perf claim")
    args = p.parse_args(argv)
    if args.smoke:
        smoke_sizes(p, args, capacity=1 << 11, page_words=256, batch=128,
                    gets=1 << 12, zipfs=[0.99])
    out = run(args)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    if args.smoke:
        sw = out["sweeps"][0]
        ok = (sw["tier"]["promotions"] > 0
              and sw["hits_tier"] == sw["hits_flat"])
        print(f"[tier_sweep] smoke {'OK' if ok else 'FAIL'}")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
