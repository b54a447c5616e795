"""Worker process of the multi-process drill (twin of the JAX package's
`tests/multihost_worker.py`).

    python -m pmdfc_tpu_torch.tools.multihost_worker <process_id> <port> \
        [--device cpu] [--backend gloo] [--timeout 60] [--dump DIR]

Each of the 2 workers holds two shards on `--device` (`["cpu", "cpu"]`
stands in for the JAX worker's two forced CPU devices), joins the other
over `torch.distributed` (`connect_multihost`; the global grid is 4
shards over 2 processes), drives a `ShardedKV` through insert, get,
delete, stats, `utilization`, `shard_report` and the extent verbs, and
checks each result against the host-computed ground truth, as the JAX
worker does. Exit code 0 = every assertion held.

With `--dump DIR` it then runs `drill` (seeded batches through both
dispatches: skewed batches that overflow a2a pairs, in-batch duplicates,
updates, padding, deletes, extents) and writes every result, the stats,
the shard report and the leaves of the shards it holds to
`DIR/worker<process_id>.npz` (`load_dump` reads it back), for a test
that holds them against one process and against the JAX plane.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

N_PROCS = 2
PER_PROC = 2

# the drill's plane: linear·flat, 2^14 slots per shard, 16-word pages
DRILL_CAPACITY = 1 << 14
DRILL_PAGE_WORDS = 16
DRILL_BLOOM_BITS = 1 << 16
DRILL_SKETCH_BITS = 1 << 12


def drill_config(m):
    """The drill's KVConfig from a config module `m` (either package's)."""
    return m.KVConfig(
        index=m.IndexConfig(kind=m.IndexKind.LINEAR,
                            capacity=DRILL_CAPACITY),
        bloom=m.BloomConfig(num_bits=DRILL_BLOOM_BITS), paged=True,
        page_words=DRILL_PAGE_WORDS, evicted_sketch_bits=DRILL_SKETCH_BITS)


def _pages(keys: np.ndarray) -> np.ndarray:
    base = keys[:, 0] * np.uint32(0x9E3779B1) ^ keys[:, 1]
    return (base[:, None] + np.arange(DRILL_PAGE_WORDS, dtype=np.uint32)
            * np.uint32(0x01000193)).astype(np.uint32)


def _owned_by(keys: np.ndarray, n: int, shard: int) -> np.ndarray:
    from pmdfc_tpu_torch.parallel.partitioning import shard_of_np

    return keys[shard_of_np(keys, n) == shard]


def _one_cluster(n: int, shard: int, count: int) -> np.ndarray:
    """`count` keys with a hi word below 2^31 that shard `shard` owns and
    that share one cluster of its linear index: inserting them evicts."""
    from pmdfc_tpu_torch.utils.hashing_np import hash_u64_np

    lo = np.arange(1 << 20, dtype=np.uint32)
    hi = np.full_like(lo, 0x11)
    keys = _owned_by(np.stack([hi, lo], -1), n, shard)
    clusters = DRILL_CAPACITY // 16  # IndexConfig's default cluster_slots
    home = hash_u64_np(keys[:, 0], keys[:, 1]) & np.uint32(clusters - 1)
    return keys[home == 5][:count]


def drill(make_kv, n_shards: int, seed: int = 0):
    """Seeded batches through `make_kv(dispatch)` (any object with the
    `ShardedKV` host verbs, either package's; a crowded cluster makes
    inserts evict keys whose hi word is below 2^31), both dispatches ->
    ({"<dispatch>/<step>/<field>": array}: every verb's results, then
    `stats()`, `utilization()` and the stats rows and occupancy of
    `shard_report()`; {dispatch: the plane})."""
    out, kvs = {}, {}
    for dispatch in ("a2a", "broadcast"):
        rng = np.random.default_rng(seed)
        kv = kvs[dispatch] = make_kv(dispatch)
        hi = rng.choice(np.array([3, 0x80000001, 0xFFFFFFF0], np.uint32),
                        4096)
        base = np.stack([hi, rng.integers(0, 1 << 32, 4096,
                                          dtype=np.uint32)], -1)
        # a skewed batch: 7/8 of it owned by shard 1, so a2a pairs to
        # shard 1 overflow (drops), with updates of earlier keys and
        # in-batch duplicates (dedupe-last-wins)
        hot = _owned_by(np.stack([np.full(1 << 14, 5, np.uint32),
                                  np.arange(1 << 14, dtype=np.uint32)], -1),
                        n_shards, 1)[:1792]
        skew = np.concatenate([hot, base[:192], hot[:64]])
        skew = skew[rng.permutation(len(skew))]
        pad = np.full((8, 2), 0xFFFFFFFF, np.uint32)
        absent = np.stack([np.full(512, 7, np.uint32),
                           rng.integers(0, 1 << 32, 512, dtype=np.uint32)],
                          -1)
        crowd = _one_cluster(n_shards, 2, 48)
        steps = [
            ("ins1", "insert", base[:3000]),
            ("ins2", "insert", skew),
            ("ins3", "insert", crowd[:24]),
            ("ins4", "insert", crowd[24:]),
            ("get1", "get", np.concatenate([base[:2000], absent, pad,
                                            hot[:300]])),
            ("get2", "get", skew),
            ("del", "delete", np.concatenate([base[:700], absent[:50]])),
            ("get3", "get", np.concatenate([base[:1500], hot[:200],
                                            crowd])),
        ]
        for name, verb, keys in steps:
            if verb == "insert":
                res = kv.insert(keys, _pages(keys))
                for f in res._fields:
                    out[f"{dispatch}/{name}/{f}"] = np.asarray(getattr(res, f))
            elif verb == "get":
                got, found = kv.get(keys)
                out[f"{dispatch}/{name}/values"] = np.asarray(got)
                out[f"{dispatch}/{name}/found"] = np.asarray(found)
            else:
                out[f"{dispatch}/{name}/hit"] = np.asarray(kv.delete(keys))
        for j in range(3):
            key = np.array([9 + j, (1 << 31) - 5 + 1000 * j], np.uint32)
            val = np.array([j, 0xFFFFF000 + 7 * j], np.uint32)
            res, unc = kv.insert_extent(key, val, 5 + 11 * j)
            for f in res._fields:
                out[f"{dispatch}/ext{j}/{f}"] = np.asarray(getattr(res, f))
            out[f"{dispatch}/ext{j}/uncovered"] = np.asarray(unc)
        probe = np.array([[9 + j, (1 << 31) - 5 + 1000 * j + i]
                          for j in range(3) for i in range(0, 40, 3)],
                         np.uint32)
        got, found = kv.get_extent(probe)
        out[f"{dispatch}/gext/values"] = np.asarray(got)
        out[f"{dispatch}/gext/found"] = np.asarray(found)
        st = kv.stats()
        out[f"{dispatch}/stats"] = np.array(
            [st[k] for k in sorted(st)], np.int64)
        out[f"{dispatch}/utilization"] = np.asarray(kv.utilization())
        rep = kv.shard_report()
        out[f"{dispatch}/occupancy"] = np.asarray(rep["occupancy"])
        out[f"{dispatch}/report_stats"] = np.array(
            [rep["stats"][k] for k in sorted(rep["stats"])], np.int64)
    return out, kvs


def check(kv, ndev: int) -> float:
    """The JAX worker's assertions on a multi-process `ShardedKV` (an
    unpaged linear index of 2^14 slots per shard). -> utilization."""
    n = 4096
    lo = np.arange(n, dtype=np.uint32)
    keys = np.stack([np.full_like(lo, 3), lo], -1)
    vals = np.stack([lo ^ np.uint32(0x5A5A), lo], axis=-1)

    res = kv.insert(keys, vals)
    assert not res.dropped.any(), "fill-phase insert dropped keys"

    got, found = kv.get(keys)
    assert found.all(), f"{(~found).sum()} inserted keys not found"
    np.testing.assert_array_equal(got, vals)

    hit = kv.delete(keys[: n // 4])
    assert hit.all(), "delete missed inserted keys"
    got2, found2 = kv.get(keys)
    assert not found2[: n // 4].any(), "deleted keys still served"
    assert found2[n // 4:].all(), "delete clobbered live keys"

    s = kv.stats()
    assert s["puts"] == n and s["gets"] == 2 * n, s
    util = kv.utilization()
    assert 0.0 < util < 1.0, util

    rep = kv.shard_report()
    assert rep["n_shards"] == ndev
    assert sum(rep["occupancy"]) == n - n // 4, rep["occupancy"]

    # extent verbs through the replicated body
    ek = np.array([9, 1 << 20], np.uint32)
    _, uncovered = kv.insert_extent(ek, np.asarray([7, 7], np.uint32), 5)
    assert uncovered == 0, uncovered
    eks = np.stack([ek + np.asarray([0, i], np.uint32) for i in range(5)])
    _, efound = kv.get_extent(eks)
    assert efound.all(), efound
    return util


def dump(path: str, results: dict, kvs: dict) -> None:
    """Write `drill`'s results and the leaves of the shards this process
    holds (`<dispatch>/leaf/<shard>/<name>`)."""
    from pmdfc_tpu_torch import carry

    arrays = dict(results)
    for dispatch, kv in kvs.items():
        for s, st in zip(kv._mine, kv.states):
            for name, a in carry.state_to_numpy(st).items():
                arrays[f"{dispatch}/leaf/{s}/{name}"] = a
    np.savez(path, **arrays)


def load_dump(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("process_id", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)

    from pmdfc_tpu_torch import config as tc
    from pmdfc_tpu_torch.config import IndexConfig, IndexKind, KVConfig
    from pmdfc_tpu_torch.parallel.shard import (
        ShardedKV, connect_multihost, make_mesh, shutdown_multihost)

    pid = args.process_id
    ndev = connect_multihost(f"localhost:{args.port}", N_PROCS, pid,
                             timeout_s=args.timeout, backend=args.backend,
                             devices=[args.device] * PER_PROC)
    try:
        assert ndev == N_PROCS * PER_PROC, \
            f"global device count {ndev} != {N_PROCS * PER_PROC}"
        cfg = KVConfig(index=IndexConfig(kind=IndexKind.LINEAR,
                                         capacity=1 << 14),
                       bloom=None, paged=False)
        util = check(ShardedKV(cfg, mesh=make_mesh(), dispatch="a2a"), ndev)
        if args.dump:
            res, kvs = drill(lambda d: ShardedKV(drill_config(tc),
                                                 mesh=make_mesh(),
                                                 dispatch=d), ndev)
            os.makedirs(args.dump, exist_ok=True)
            dump(os.path.join(args.dump, f"worker{pid}.npz"), res, kvs)
            print(json.dumps({"exchange": kvs["a2a"].exchange_report()}))
    finally:
        shutdown_multihost()
    print(f"worker {pid}: OK (devices={ndev}, util={util:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
