"""Time the six composed index families' inserts and lean GETs.

For each family: an index alone (no page pool, no bloom) at the serving
capacity is filled to 75% of its slots in `--batch`-key inserts, then
timed on the host clock (device synchronized before and after):

- `insert_batch` of `--batch` fresh keys, each repetition on a copy of
  the same 75%-full state (so every repetition does the same work);
- `get_values` (the lean GET, with level's and path's miss tail) of
  `--get-batch` keys, 5/8 present and 3/8 never inserted.

`--tree DIR` imports `pmdfc_tpu_torch` from DIR instead of this checkout,
so two versions of the package can be compared in one session on one
card, e.g. (from the repository root; `build/` is git-ignored):

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 pmdfc_tpu_torch/bench/families.py --tree build/parent
    python3 pmdfc_tpu_torch/bench/families.py

Prints one JSON object per family, then the card's name and power limit.
`--device cpu` with a small `--capacity` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

FAMILIES = ("cuckoo", "ccp", "level", "path", "static", "hotring")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).parents[2]))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--capacity", type=int, default=1 << 21)
    ap.add_argument("--batch", type=int, default=1 << 16)
    ap.add_argument("--get-batch", type=int, default=1 << 14)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))

    import torch

    import pmdfc_tpu_torch
    from pmdfc_tpu_torch.config import IndexConfig, IndexKind
    from pmdfc_tpu_torch.kv import resolve_device
    from pmdfc_tpu_torch.models.base import get_index_ops

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def rand_keys(n):
        # u32 words as int32 bits; hi < 2^31 - 1 keeps clear of INVALID
        return torch.randint(-(1 << 31), (1 << 31) - 1, (n, 2),
                             dtype=torch.int32, device=dev, generator=gen)

    def snapshot(state):
        return {f.name: getattr(state, f.name).clone()
                for f in dataclasses.fields(state)
                if isinstance(getattr(state, f.name), torch.Tensor)}

    def restore(state, snap):
        for name, t in snap.items():
            getattr(state, name).copy_(t)

    def timed(fn, reps):
        out = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    for kind in args.families.split(","):
        cfg = IndexConfig(kind=IndexKind(kind), capacity=args.capacity)
        ops = get_index_ops(IndexKind(kind))
        state = ops.init(cfg, device=dev)
        n_slots = ops.num_slots(cfg)
        n_fill = (3 * n_slots // 4) // args.batch * args.batch
        live = []
        sync()
        t0 = time.perf_counter()
        for _ in range(n_fill // args.batch):
            keys = rand_keys(args.batch)
            state, _ = ops.insert_batch(state, keys, keys)
            live.append(keys)
        sync()
        fill_s = time.perf_counter() - t0
        live = torch.cat(live)
        snap = snapshot(state)
        fresh = rand_keys(args.batch)

        def insert():
            restore(state, snap)
            ops.insert_batch(state, fresh, fresh)

        ins = timed(insert, 1 + args.reps)[1:]
        restore(state, snap)
        g = args.get_batch
        pick = torch.randint(0, live.shape[0], (g * 5 // 8,), device=dev,
                             generator=gen)
        probe = torch.cat([live[pick], rand_keys(g - pick.numel())])
        gets = timed(lambda: ops.get_values(state, probe),
                     3 + 4 * args.reps)[3:]
        print(json.dumps({
            "package": str(pathlib.Path(pmdfc_tpu_torch.__file__).parent),
            "family": kind, "device": str(dev),
            "slots": n_slots, "fill_keys": n_fill,
            "fill_keys_per_s": n_fill / fill_s,
            "insert_batch": args.batch,
            "insert_ms_median": statistics.median(ins), "insert_ms": ins,
            "get_batch": g, "get_values_ms_median": statistics.median(gets),
        }), flush=True)
        del state, snap, live
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
