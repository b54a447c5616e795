#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pmdfc_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each reported on its own line; any failure exits nonzero:

1. env     — the card (nvidia-smi name and power limit), torch, CUDA, nvcc.
2. build   — compiles every kernel of the path from `pmdfc_tpu_torch/ops/csrc`.
3. kernel  — each kernel against its plain PyTorch version, bit for bit
             (tolerance 0: all integer arithmetic), on small states with
             S=16 and S=32 slots per cluster, at w in {16, 2^10, 2^14}, over
             batches that hold every miss cause.
4. main    — the main path through the `KV` host class on the default
             device at the serving size: linear index with 2^21 slots, 4 KiB
             pages in an 8 GiB flat pool, a 2^24-bit counting bloom, the
             evicted-key sketch. Fill 75% of the slots in 2^16-key inserts;
             serve mixed 2^14-key GET and get_compact batches (present,
             never-inserted, capacity-evicted, padding); delete; serve
             again with deleted keys mixed in. Every hit must return the
             exact page inserted (pages are a function of key and word
             index, made on the device), every present key must hit,
             `misses == Σ miss_*`, and every kernel of the path must have
             launched. Then phase 3's comparison again on this full-size
             state, with one page corrupted (DIGEST) and one slot tagged as
             an extent (EXT).
5. times   — CUDA-event device times per 2^14-key batch of each kernel and
             of its plain version (queued behind a busy stream, so the
             host's launch time is not counted; the host-driven loop is
             reported beside), rotated over 8 distinct batches whose pages
             (about 8 x 42 MB) far exceed the 50 MB L2, with one batch
             repeated as the warm time beside it; the kernel's bound (the
             bytes these batches must move over 3.35 TB/s); and whole-path
             insert/GET rates.

The next-to-last line is one JSON object naming each kernel with its
launches, error and times; the last is `{"ok": true, "device": ...}`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
SECTOR = 32  # bytes: the least the card reads from memory for a scattered word


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class Smoke:
    def __init__(self, seed: int):
        import torch

        from pmdfc_tpu_torch import kv as kv_mod
        from pmdfc_tpu_torch.ops import fused
        from pmdfc_tpu_torch.utils import u32

        self.torch, self.kv_mod, self.fused, self.u32 = torch, kv_mod, fused, u32
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(seed)
        self.max_err = 0

    # -- data made on the device --------------------------------------------
    def keys_of(self, hi: int, lo):
        """[n, 2] int32 keys (u32 bits) from a hi word and int64 lo words."""
        torch, u32 = self.torch, self.u32
        hiw = torch.full_like(lo, hi)
        return torch.stack([u32.narrow(hiw), u32.narrow(lo)], dim=-1)

    def pages_of(self, keys, pw: int):
        """Page contents as a function of key and word index."""
        torch, u32 = self.torch, self.u32
        hi, lo = u32.widen(keys[:, 0]), u32.widen(keys[:, 1])
        j = torch.arange(pw, device=keys.device)
        base = u32.mul(lo, 0x9E3779B1) ^ u32.mul(hi, 0x85EBCA77)
        return u32.narrow(base[:, None] + u32.mul(j, 0x01000193)[None, :]
                          + 0x165667B1)

    def pick(self, idx, n: int):
        """n rows of idx drawn uniformly (with replacement)."""
        torch = self.torch
        r = torch.randint(0, idx.shape[0], (n,), device=self.dev,
                          generator=self.gen)
        return idx[r]

    # -- kernel against plain -----------------------------------------------
    def compare(self, keys, state, label: str):
        """Kernel and plain version on the same inputs, bit for bit."""
        torch, fused = self.torch, self.fused
        args = (keys, state.index.table, state.pool.pages, state.pool.sums,
                state.evicted_filter)
        got = fused.fused_get(*args)
        want = fused.get_core_reference(*args)
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, r in zip(got, want))
        self.max_err = max(self.max_err, err)
        causes = torch.bincount(want[1], minlength=8).tolist()
        if err:
            raise AssertionError(f"{label}: kernel differs from plain "
                                 f"version (max abs err {err})")
        return causes

    def small_state(self, s: int):
        """A small KV on the card with evictions, deletes and a sketch."""
        torch, kv_mod = self.torch, self.kv_mod
        from pmdfc_tpu_torch.config import IndexConfig, KVConfig

        cfg = KVConfig(index=IndexConfig(capacity=2048, cluster_slots=s),
                       page_words=64, evicted_sketch_bits=1 << 10)
        kv = kv_mod.KV(cfg)
        lo = torch.randint(0, 1 << 32, (3072,), device=self.dev,
                           generator=self.gen)
        keys = self.keys_of(0x80000003, lo)
        for i in range(0, 3072, 1024):
            kv.insert(keys[i:i + 1024], self.pages_of(keys[i:i + 1024], 64))
        kv.delete(keys[2048:2200])
        absent = self.keys_of(7, torch.randint(0, 1 << 32, (512,),
                                               device=self.dev,
                                               generator=self.gen))
        pool = torch.cat([keys, absent,
                          torch.full((64, 2), -1, dtype=torch.int32,
                                     device=self.dev)])
        return kv, pool, keys

    def poke(self, kv, keys):
        """Corrupt one present key's page word and tag another present
        key's slot as an extent; returns an undo function."""
        from pmdfc_tpu_torch.models import linear

        st = kv.state
        res = linear.get_batch(st.index, keys)
        hit = res.found.nonzero().flatten()
        kd, ke = int(hit[0]), int(hit[1])
        row = int(res.values[kd, 1])
        slot = int(res.slots[ke])
        s = st.index.table.shape[1] // 4
        c, lane = slot // s, slot % s
        old_word = st.pool.pages[row, 0].clone()
        old_vhi = st.index.table[c, 2 * s + lane].clone()
        st.pool.pages[row, 0] ^= 1 << 7
        st.index.table[c, 2 * s + lane] = self.fused.EXTENT_TAG_I32

        def undo():
            st.pool.pages[row, 0] = old_word
            st.index.table[c, 2 * s + lane] = old_vhi

        return keys[[kd, ke]], undo

    def kernel_phase(self, kv, pool, present, label: str):
        torch = self.torch
        poked, undo = self.poke(kv, present)
        try:
            for w in (16, 1 << 10, 1 << 14):
                keys = torch.cat([poked, self.pick(pool, w - 2)])
                causes = self.compare(keys, kv.state, f"{label} w={w}")
                log("kernel", f"{label} w={w}: kernel == plain, causes "
                    f"(hit,pad,cold,evicted,ext,parked,stale,digest)="
                    f"{causes}")
        finally:
            undo()


def time_ms(torch, fns, iters: int, warmup: int = 3,
            device_only: bool = False) -> float:
    """Mean ms per call over `iters` calls taken round-robin from `fns`.
    With `device_only`, the stream is first held busy (about 50 ms) so the
    host queues every call before the first runs: the events then see the
    device's time alone, not the host's time to launch."""
    for i in range(warmup):
        fns[i % len(fns)]()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if device_only:
        torch.cuda._sleep(100_000_000)  # cycles
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fused_get_bytes(fused, causes, w: int, s: int, pw: int,
                    sketch_bytes: int) -> int:
    """Least bytes one fused GET must move for a batch with these cause
    counts: the keys in, the outputs out, and for each key only what its
    cause reads. Padding keys probe nothing; a scattered word costs one
    sector."""
    found = (causes[fused.CAUSE_HIT] + causes[fused.CAUSE_EXT]
             + causes[fused.CAUSE_DIGEST])
    index_miss = causes[fused.CAUSE_COLD] + causes[fused.CAUSE_EVICTED]
    valid = w - causes[fused.CAUSE_PAD]
    page = causes[fused.CAUSE_HIT] + causes[fused.CAUSE_DIGEST]
    return (w * (8 + 4 * pw + 12)      # keys in; page, cause, row, slot out
            + valid * 8 * s            # khi and klo halves of the bucket row
            + found * 2 * SECTOR       # vhi and vlo of the matching lane
            + page * (4 * pw + SECTOR)  # the page and its digest word
            + min(sketch_bytes, index_miss * 2 * SECTOR))  # two sketch bytes


def profile_breakdown(torch, fn, iters: int) -> str:
    """Device-side breakdown of `fn` from torch.profiler: device ops per
    call, device busy time per call, and the ops taking the most of it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return "not measured: the profiler saw no device activity"
    busy = sum(e.self_device_time_total for e in dev) / iters / 1e3
    ops = sum(e.count for e in dev) / iters
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    parts = "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / iters / 1e3:.4f} ms "
        f"x{e.count // iters}" for e in top)
    return (f"{ops:.0f} device ops, device busy {busy:.4f} ms per call; "
            f"top: {parts}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1

    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
    from pmdfc_tpu_torch.ops import _build
    from pmdfc_tpu_torch.utils.keys import is_invalid

    # 1. env
    smi = nvidia_smi()
    log("env", smi)
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvcc: {nvcc_v.splitlines()[-1]}")

    # 2. build
    t0 = time.monotonic()
    _build.load("fused_get")
    log("build", f"fused_get built and loaded in {time.monotonic() - t0:.2f} s")
    for name, (secs, out) in _build.BUILD_LOG.items():
        for line in out.strip().splitlines():
            log("build", f"{name}: {line.strip()}")

    sm = Smoke(args.seed)
    fused = sm.fused

    # 3. kernel against plain, small states
    for s in (16, 32):
        kv, pool, keys = sm.small_state(s)
        sm.kernel_phase(kv, pool, keys[:2048], f"small S={s}")
        del kv
    torch.cuda.empty_cache()

    # 4. main path
    n_slots = 1 << 21
    cfg = KVConfig(index=IndexConfig(capacity=n_slots),
                   bloom=BloomConfig(num_bits=1 << 24, num_hashes=4))
    pw = cfg.page_words
    kv = sm.kv_mod.KV(cfg)
    log("main", f"KV on {kv.device}: {kv.capacity()} slots, pool "
        f"{tuple(kv.state.pool.pages.shape)} = "
        f"{kv.state.pool.pages.numel() * 4 / 2**30:.2f} GiB, bloom "
        f"{cfg.bloom.num_bits} counters, sketch {cfg.evicted_sketch_bits} bits")
    hi = 0x80000001  # hi word >= 2^31: unsigned sort order matters
    ins_b, get_b = 1 << 16, 1 << 14
    n_fill = (3 * n_slots // 4) // ins_b * ins_b
    # key index i <-> key (hi, i); status: 0 never inserted, 1 present,
    # 2 capacity-evicted, 3 deleted, 4 dropped
    n_keys = n_fill + n_slots
    status = torch.zeros(n_keys, dtype=torch.int8, device=sm.dev)

    fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in range(0, n_fill, ins_b):
        lo = torch.arange(i, i + ins_b, device=sm.dev)
        keys = sm.keys_of(hi, lo)
        res = kv.insert(keys, sm.pages_of(keys, pw))
        status[lo] = torch.where(res.dropped, 4, 1).to(torch.int8)
        ev = res.evicted[~is_invalid(res.evicted)]
        status[sm.u32.widen(ev[:, 1])] = 2
    torch.cuda.synchronize()
    t_ins = time.monotonic() - t0
    log("main", f"fill: {n_fill} pages in {t_ins:.3f} s = "
        f"{n_fill / t_ins:.0f} pages/s; status counts "
        f"(never,present,evicted,deleted,dropped)="
        f"{torch.bincount(status.long(), minlength=5).tolist()}")

    def mixed(n: int, deleted: bool):
        present = (status == 1).nonzero().flatten()
        evicted = (status == 2).nonzero().flatten()
        never = torch.arange(n_fill, n_keys, device=sm.dev)
        parts = [sm.pick(present, n * 5 // 8), sm.pick(never, n // 8)]
        if evicted.numel():
            parts.append(sm.pick(evicted, n // 8))
        if deleted:
            parts.append(sm.pick((status == 3).nonzero().flatten(), n // 16))
        idx = torch.cat(parts)
        keys = torch.cat([sm.keys_of(hi, idx),
                          torch.full((n - idx.numel(), 2), -1,
                                     dtype=torch.int32, device=sm.dev)])
        perm = torch.randperm(n, device=sm.dev, generator=sm.gen)
        return keys[perm]

    def check_get(keys, out, found, stats_before, label):
        valid = ~is_invalid(keys)
        st = status[sm.u32.widen(keys[:, 1]).clamp(max=n_keys - 1)]
        want = valid & (st == 1)
        if not torch.equal(found, want):
            raise AssertionError(f"{label}: found mask != present keys "
                                 f"({int((found != want).sum())} differ)")
        if not torch.equal(out[found], sm.pages_of(keys[found], pw)):
            raise AssertionError(f"{label}: a hit returned wrong bytes")
        if out[~found].any():
            raise AssertionError(f"{label}: a miss returned nonzero bytes")
        d = (kv.state.stats.long() - stats_before).tolist()
        names = sm.kv_mod.STAT_NAMES
        s = dict(zip(names, d))
        causes = sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES)
        counts = [int((valid & (st == k)).sum()) for k in range(5)]
        if s["misses"] != causes:
            raise AssertionError(f"{label}: misses {s['misses']} != "
                                 f"sum of causes {causes}")
        if s["misses"] > counts[0] + counts[2] + counts[3] + counts[4]:
            raise AssertionError(f"{label}: more misses than lost keys")
        if s["miss_evicted"] < counts[2]:
            raise AssertionError(f"{label}: evicted keys not attributed")
        return s, counts

    def serve(rounds: int, deleted: bool, label: str):
        for r in range(rounds):
            keys = mixed(get_b, deleted)
            before = kv.state.stats.long()
            out, found = kv.get(keys)
            s, counts = check_get(keys, out, found, before, f"{label} get")
            before = kv.state.stats.long()
            o2, order, f2, nfound, b = kv.get_compact_async(keys)
            nf = int(nfound)
            hits = found.nonzero().flatten()
            if not (torch.equal(f2[:b], found) and nf == hits.numel()
                    and torch.equal(order[:nf].long(), hits)
                    and torch.equal(o2[:nf], out[hits])):
                raise AssertionError(f"{label}: get_compact disagrees with get")
            check_get(keys, out, found, before, f"{label} get_compact")
        log("main", f"{label}: {rounds} x (get + get_compact) of {get_b} "
            f"keys ok; last batch (never,present,evicted,deleted,dropped)="
            f"{counts}, hits={s['hits']}, misses={s['misses']} "
            f"(cold={s['miss_cold']}, evicted={s['miss_evicted']}, "
            f"digest={s['miss_digest']})")

    serve(4, False, "serve")
    present = (status == 1).nonzero().flatten()
    gone = sm.pick(present, get_b).unique()
    hit = kv.delete(sm.keys_of(hi, gone))
    if not bool(hit.all()):
        raise AssertionError("delete missed present keys")
    status[gone] = 3
    log("main", f"delete: {gone.numel()} keys, all hit")
    serve(4, True, "serve after delete")
    torch.cuda.synchronize()
    launches = fused.launches
    if launches <= 0:
        raise AssertionError("the main path never launched fused_get")
    stats = kv.stats()
    if stats["misses"] != sum(stats[c] for c in sm.kv_mod.MISS_CAUSE_NAMES):
        raise AssertionError("misses != sum of miss causes")
    log("main", f"fused_get launches on the main path: {launches}; "
        f"utilization {kv.utilization():.4f}; stats {json.dumps(stats)}")

    # 3, continued: kernel against plain on the full-size state
    every = torch.arange(n_keys, device=sm.dev)
    sm.kernel_phase(kv, torch.cat([sm.keys_of(hi, every),
                                   torch.full((64, 2), -1, dtype=torch.int32,
                                              device=sm.dev)]),
                    sm.keys_of(hi, present[:4096]), "full")

    # 5. times at the main path's batch width
    # 8 distinct batches: their pages (about 8 x 42 MB) far exceed the
    # 50 MB L2, so launches rotated over them read from memory, as a
    # stream of fresh requests does; one batch repeated is the warm time.
    st = kv.state
    s = st.index.table.shape[1] // 4
    batches = [mixed(get_b, True) for _ in range(8)]
    nbytes = [fused_get_bytes(fused, sm.compare(k, st, f"timed batch {i}"),
                              get_b, s, pw, st.evicted_filter.numel())
              for i, k in enumerate(batches)]
    kern = [lambda k=k: fused.fused_get(k, st.index.table, st.pool.pages,
                                        st.pool.sums, st.evicted_filter)
            for k in batches]
    plain = [lambda k=k: fused.get_core_reference(
        k, st.index.table, st.pool.pages, st.pool.sums, st.evicted_filter)
        for k in batches]
    ms = time_ms(torch, kern, 48, device_only=True)
    warm_ms = time_ms(torch, kern[:1], 48, device_only=True)
    host_ms = time_ms(torch, kern, 48)
    plain_ms = time_ms(torch, plain, 8, device_only=True)
    mean_bytes = sum(nbytes) / len(nbytes)
    bound_ms = mean_bytes / HBM_BYTES_PER_S * 1e3
    warm_bound_ms = nbytes[0] / HBM_BYTES_PER_S * 1e3
    log("times", f"fused_get w={get_b}, rotated over {len(batches)} "
        f"batches: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({mean_bytes:.0f} bytes per batch, "
        f"{min(nbytes)}..{max(nbytes)}) = {bound_ms / ms:.1%} of the memory "
        f"rate; no single PyTorch call computes this function, so there is "
        f"no library time ({smi})")
    log("times", f"fused_get w={get_b}, one batch repeated (warm L2): "
        f"kernel {warm_ms:.4f} ms, bound {warm_bound_ms:.4f} ms "
        f"({nbytes[0]} bytes) = {warm_bound_ms / warm_ms:.1%} ({smi})")
    log("times", f"fused_get w={get_b}, rotated, launched back to back "
        f"from the host with no queue ahead: {host_ms:.4f} ms per call "
        f"(wrapper and launch on the host included) ({smi})")
    kv_get = [lambda k=k: kv.get(k) for k in batches]
    get_ms = time_ms(torch, kv_get, 24)
    log("times", f"whole-path KV.get, rotated: {get_ms:.3f} ms per {get_b} "
        f"keys = {get_b / get_ms * 1e3:.0f} keys/s; fill "
        f"{n_fill / t_ins:.0f} pages/s ({smi})")
    try:
        log("times", "torch.profiler, KV.get of 2^14 keys: "
            + profile_breakdown(torch, kv_get[0], 5))
    except Exception as e:  # a measurement, not a check: report, go on
        log("times", f"torch.profiler breakdown not measured: {e!r}")

    print(json.dumps({"kernels": [{
        "name": "fused_get_linear_flat",
        "route": "cuda",
        "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
        "replaces": "pmdfc_tpu/ops/fused.py:414",
        "launches": launches,
        "max_abs_err": sm.max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
