"""Paired fused-vs-composed GET sweep, batch × zipf × family (twin of
`pmdfc_tpu/bench/fused_get.py`).

Prices the port's one kernel: the whole GET verb — index probe, row
gather, digest verify, tier/generation fold, miss-cause classify — as
ONE launch of `ops/csrc/fused_get.cu` (the kernel side, `KV.get`),
against the composed torch chain that materializes an intermediate
between every stage (the composed side, `kv._get_core`, the GET the
seven composed families serve with).

The JAX harness picks its sides with `KVConfig(fused_get="on"|"off")`;
the port has no such switch. Its composed side runs `kv._get_core`
directly on a second `KV`'s state, under that KV's lock, with the
padding and the counting/lean choice `KV.get` makes; its kernel side is
`KV.get_async`. Per family, both KVs take the same fill, then every
(zipf, batch) stream goes through both, batch-interleaved so the two
sides see the same machine weather.

Honesty rules:
- both sides agree bit for bit on every batch — pages, found, and the
  19 stats lanes each batch adds (the miss-cause lanes among them) —
  and every hit is the key's page, every miss zeroed; a mismatch fails
  the run;
- `fused.launches` grows by one per kernel-side GET on a card and by
  none during a composed-side GET (on the CPU the wrapper runs the
  kernel's plain version and launches nothing);
- each side's time is its device time per GET batch, CUDA events around
  the verb's queued work (results stay on the device until the parity
  check); on the CPU it is the host clock and no device metric.

Run: `python -m pmdfc_tpu_torch.bench.fused_get --smoke --device cpu`
(tiny shapes, parity only) or full on a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from pmdfc_tpu_torch.bench.tier_sweep import _keys, _zipf_stream, pages_on


def _mk_kv(kind, cap, page_words, device):
    from pmdfc_tpu_torch.config import IndexConfig, KVConfig
    from pmdfc_tpu_torch.kv import KV

    return KV(KVConfig(index=IndexConfig(kind=kind, capacity=cap),
                       bloom=None, paged=True, page_words=page_words),
              device=device)


def composed_get_async(kv, keys):
    """The composed GET on `kv`'s state as `KV.get_async` would drive it
    (same padding, same lean/counting choice, same recovering state),
    under its lock -> (device out, device found, b)."""
    from pmdfc_tpu_torch import kv as kv_mod

    with kv._lock:
        b = len(keys)
        w = kv_mod._pad_pow2(b, lo=16)
        kv.state, out, found = kv_mod._get_core(
            kv.state, kv.config, kv._keys(keys, w),
            lean=not kv._touch_due(), recovering=kv._recovering)
        kv._maybe_decay(b)
        return out, found, b


def _stream_pair(kv_f, kv_c, skeys, batch, page_words: int, per_get: int):
    """Drive the SAME stream through both KVs, batch-interleaved.
    -> (ms kernel side, ms composed side, hits). Every batch is held to
    bit-for-bit parity, content and launch counts; a failure raises."""
    import torch

    from pmdfc_tpu_torch.bench.common import timed_ms
    from pmdfc_tpu_torch.ops import fused

    dev = kv_f.device
    ms_f = ms_c = 0.0
    hits = 0
    for i in range(0, len(skeys), batch):
        # the keys cross to the device before the clocks start
        kt = torch.from_numpy(skeys[i:i + batch].view(np.int32)).to(dev)
        res = {}
        s0 = kv_f.state.stats.clone()
        n0 = sum(fused.launches.values())
        ms_f += timed_ms(lambda: res.setdefault("f", kv_f.get_async(kt)),
                         dev)
        n1 = sum(fused.launches.values())
        c0 = kv_c.state.stats.clone()
        ms_c += timed_ms(
            lambda: res.setdefault("c", composed_get_async(kv_c, kt)), dev)
        n2 = sum(fused.launches.values())
        out_f, found_f, b = res["f"]
        out_c, found_c, _ = res["c"]
        out_f, found_f = out_f[:b], found_f[:b]
        out_c, found_c = out_c[:b], found_c[:b]
        hits += int(found_c.sum())
        if n1 - n0 != per_get or n2 != n1:
            raise AssertionError(
                f"launches: kernel side +{n1 - n0} (want {per_get}), "
                f"composed side +{n2 - n1} (want 0)")
        if not torch.equal(found_f, found_c):
            raise AssertionError("found mask drift")
        if not torch.equal(out_f, out_c):
            raise AssertionError("page bytes drift")
        bump_f = kv_f.state.stats - s0
        bump_c = kv_c.state.stats - c0
        if not torch.equal(bump_f, bump_c):
            raise AssertionError(f"stats lanes drift: kernel side "
                                 f"{bump_f.tolist()} composed "
                                 f"{bump_c.tolist()}")
        want = pages_on(kt, page_words)
        if not torch.equal(out_f[found_f], want[found_f]):
            raise AssertionError("a hit served bytes other than its page")
        if bool(out_f[~found_f].any()):
            raise AssertionError("a miss was not zeroed")
    return ms_f, ms_c, hits


def _stats_parity(kv_f, kv_c) -> dict:
    """Cumulative stats must match lane for lane (uptime is host wall
    clock, excluded). Returns the diff dict (empty == parity)."""
    a, b = kv_f.stats(), kv_c.stats()
    return {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
            if k != "uptime_s" and a.get(k) != b.get(k)}


def run(args, keep=None) -> dict:
    """The sweep -> its row. `keep(family, kv, keys)`, when given, sees
    each family's kernel-side KV and its inserted keys before the pair is
    freed."""
    import torch

    from pmdfc_tpu_torch.bench.common import (append_history,
                                              launches_per_get,
                                              stamp_live_device)
    from pmdfc_tpu_torch.bench.tier_sweep import check_causes
    from pmdfc_tpu_torch.config import IndexConfig, IndexKind
    from pmdfc_tpu_torch.models.base import get_index_ops

    dev = torch.device(args.device)
    on_chip = dev.type == "cuda"
    per_get = launches_per_get(dev)
    cap, W = args.capacity, args.page_words
    rng = np.random.default_rng(args.seed)

    sweeps = []
    worst = 1.0
    for fam in args.families:
        kind = IndexKind(fam)
        if args.fill is None:
            n_keys = cap // 2  # half-full: no evictions pollute the sweep
        else:
            slots = get_index_ops(kind).num_slots(
                IndexConfig(kind=kind, capacity=cap))
            n_keys = int(slots * args.fill)
        all_keys = _keys(np.arange(1, n_keys + 1))
        kv_f = kv_c = None  # the last family's pair goes before this fill
        kv_f = _mk_kv(kind, cap, W, dev)
        kv_c = _mk_kv(kind, cap, W, dev)
        step = max(args.batches)
        t0 = time.perf_counter()
        for i in range(0, n_keys, step):
            kb = all_keys[i:i + step]
            kt = torch.from_numpy(kb.view(np.int32)).to(dev)
            pb = pages_on(kt, W)
            kv_f.insert(kt, pb)
            kv_c.insert(kt, pb)
        if on_chip:
            torch.cuda.synchronize(dev)
        fill_s = time.perf_counter() - t0
        for a in args.zipfs:
            for batch in args.batches:
                stream = _zipf_stream(rng, n_keys, args.gets, a)
                skeys = all_keys[stream]
                # warm both sides outside the timed pass
                _stream_pair(kv_f, kv_c, skeys[:batch * 2], batch, W,
                             per_get)
                ms_f, ms_c, hits = _stream_pair(kv_f, kv_c, skeys, batch,
                                                W, per_get)
                drift = _stats_parity(kv_f, kv_c)
                if drift:
                    raise AssertionError(f"stats lanes drifted: {drift}")
                check_causes(kv_f, f"{fam} kernel side")
                check_causes(kv_c, f"{fam} composed side")
                calls = -(-args.gets // batch)
                base = {
                    "metric": "fused_get", "family": fam, "zipf": a,
                    "batch": batch, "capacity": cap, "page_words": W,
                    "gets": args.gets, "hits": hits, "keys": n_keys,
                }
                speedup = round(ms_c / ms_f, 3)
                worst = min(worst, speedup)
                sweeps.append({
                    **base, "speedup_fused_vs_composed": speedup,
                    "mops_fused": round(args.gets / ms_f / 1e3, 4),
                    "mops_composed": round(args.gets / ms_c / 1e3, 4),
                    "ms_fused": round(ms_f / calls, 4),
                    "ms_composed": round(ms_c / calls, 4),
                    "fill_s": round(fill_s, 3),
                    "parity": "ok"})
        if keep is not None:
            keep(fam, kv_f, all_keys)
        del kv_f, kv_c

    out = {"metric": "fused_get_sweep", "on_chip": on_chip,
           "sweeps": sweeps, "worst_speedup": worst}
    stamp_live_device(out, "direct", args.device)
    append_history(args.history, out)
    return out


def main(argv=None) -> int:
    from pmdfc_tpu_torch.bench.common import smoke_sizes

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--capacity", type=int, default=1 << 17)
    p.add_argument("--page-words", type=int, default=512)
    p.add_argument("--batches", type=lambda s: [int(x) for x in
                                                s.split(",")],
                   default=[1 << 9, 1 << 11])
    p.add_argument("--gets", type=int, default=1 << 16)
    p.add_argument("--zipfs", type=lambda s: [float(x) for x in
                                              s.split(",")],
                   default=[0.6, 0.99])
    p.add_argument("--families", type=lambda s: s.split(","),
                   default=["linear", "cceh"])
    p.add_argument("--fill", type=float, default=None,
                   help="keys inserted as a fraction of the family's "
                        "slots (default: capacity // 2 keys, as the JAX "
                        "harness fills)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write the JSON artifact")
    p.add_argument("--history", default=None,
                   help="evidence log path (card runs only)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes, every batch parity-checked; "
                        "correctness, not a perf claim")
    args = p.parse_args(argv)
    if args.smoke:
        smoke_sizes(p, args, capacity=1 << 11, page_words=64,
                    batches=[128], gets=1 << 10, zipfs=[0.99])
    out = run(args)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    if out["on_chip"] and out["worst_speedup"] < 1.0:
        print(f"[fused_get] kernel side slower than the composed chain "
              f"(worst {out['worst_speedup']}x): the rows above are the "
              f"record")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
