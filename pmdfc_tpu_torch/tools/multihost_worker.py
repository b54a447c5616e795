"""Worker process of the multi-process drill (twin of the JAX package's
`tests/multihost_worker.py`).

    python -m pmdfc_tpu_torch.tools.multihost_worker <process_id> <port> \
        [--device cpu] [--backend gloo] [--timeout 60] [--dump DIR] \
        [--plane DIR] [--mismatch]

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

With `--plane DIR` it runs only `plane_drill` (the plane verbs, the fast
lane and the directory, restores of the snapshots `write_snapshots` put
in DIR, the tiered pool, the 2 x 2 grid and states carried from
`DIR/carried.npz`) and writes `DIR/plane<process_id>.npz`. With
`--mismatch` the two processes route different batches, and the worker
must fail (exit code 1 if the plane GET returned).
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


# the plane drill's planes: linear, 2^12 slots per shard, 16-word pages;
# every second GET batch takes the counting path where the pool counts
PLANE_CAPACITY = 1 << 12
PLANE_GRID2D = (2, 2)


def plane_config(m, tiered: bool = False):
    """The plane drill's KVConfig from a config module `m` (either
    package's): flat, or tiered with the admission gate."""
    tier = (m.TierConfig(ghost_rows=32, promote_touches=1,
                         max_promotes_per_batch=32,
                         admit=m.AdmitConfig(sketch_width=1 << 10,
                                             door_bits=1 << 11,
                                             reset_ops=1 << 10))
            if tiered else None)
    return m.KVConfig(
        index=m.IndexConfig(kind=m.IndexKind.LINEAR,
                            capacity=PLANE_CAPACITY, touch_sample_every=2),
        bloom=m.BloomConfig(num_bits=1 << 14), paged=True,
        page_words=DRILL_PAGE_WORDS, evicted_sketch_bits=DRILL_SKETCH_BITS,
        tier=tier)


def _plane_keys(seed: int, n: int, hi) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lo = rng.choice(1 << 24, n, replace=False).astype(np.uint32)
    return np.stack([np.broadcast_to(np.asarray(hi, np.uint32), (n,)), lo],
                    -1).copy()


def snapshot_keys() -> np.ndarray:
    """The keys `write_snapshots` puts (hi words on both sides of 2^31)."""
    return _plane_keys(5, 1600, np.resize(np.array(
        [0x21, 0x80000021], np.uint32), 1600))


def write_snapshots(make_kv, root: str, tag: str):
    """Snapshots a plane of either package writes for the drill's
    restores: `<tag>4.npz` (4 shards, full) and `<tag>4d.npz` (a delta on
    it: more puts and some deletes), `<tag>2.npz` (2 shards, full: a
    reshard onto 4). `make_kv(n)` builds an n-shard one-process plane
    over `plane_config`. -> the 4-shard plane."""
    keys = snapshot_keys()
    kv = make_kv(4)
    kv.plane_insert(keys[:1200], _pages(keys[:1200])).fetch()
    kv.save(os.path.join(root, f"{tag}4.npz"))
    kv.plane_insert(keys[1200:], _pages(keys[1200:])).fetch()
    kv.plane_delete(keys[:100]).fetch()
    kv.save(os.path.join(root, f"{tag}4d.npz"), delta=True)
    two = make_kv(2)
    two.plane_insert(keys[:1200], _pages(keys[:1200])).fetch()
    two.save(os.path.join(root, f"{tag}2.npz"))
    return kv


def _fast_read(fv, epoch, shards, rows, digs):
    """(ok, pages) of one fast-lane read, through either package's view
    (JAX's `FastView` validates and gathers in two calls)."""
    if hasattr(fv, "read"):
        ok, pages, _ = fv.read(epoch, shards, rows, digs)
        return ok, pages
    ok = fv.validate(epoch, shards, rows, digs)
    return ok, fv.gather(shards[ok], rows[ok])


def _json(x) -> np.ndarray:
    return np.asarray(json.dumps(x, sort_keys=True))


def plane_drill(m, make_kv, root: str, seed: int = 0):
    """Seeded plane stages through either package -> ({"<stage>/<step>/
    <field>": array}, {stage: the plane}). `make_kv(cfg, lanes=1,
    carried=False)` builds a 4-shard plane over the drill's grid (a 2 x 2
    one with lanes=2; with carried=True, one serving the leaves of
    `root/carried.npz`). The snapshots are `write_snapshots`' in `root`.

    - flat: plane inserts (a batch skewed to shard 1 with in-batch
      duplicates), read-only GETs, deletes, a warm GET, extents; stats
      and the shard report; `directory_snapshot`; `fast_view` reads of a
      directory sample with stale digests, an out-of-range row and a
      stale epoch, then again after a rewrite;
    - tiered: the gate, GETs on both cadences, balloon shrink and grow,
      `tier_stats`, `balloon_state`, `admit_state`,
      `set_admit_threshold`;
    - grid2d: a 2 x 2 plane with lane 0 corrupted, GETs served around it,
      `replica_repair`;
    - restore: `restore` and `restore_chain` of JAX's and the port's
      files, onto as many shards and resharded from 2;
    - carried: a plane built from JAX's leaves."""
    out, kvs = {}, {}
    rng = np.random.default_rng(seed)
    hi = rng.choice(np.array([3, 0x80000001, 0xFFFFFFF0], np.uint32), 2048)
    base = np.stack([hi, rng.integers(0, 1 << 32, 2048, dtype=np.uint32)],
                    -1)
    hot = _owned_by(np.stack([np.full(1 << 13, 5, np.uint32),
                              np.arange(1 << 13, dtype=np.uint32)], -1),
                    4, 1)[:700]
    skew = np.concatenate([hot, base[:100], hot[:50]])
    skew = skew[rng.permutation(len(skew))]
    absent = np.stack([np.full(256, 7, np.uint32),
                       rng.integers(0, 1 << 32, 256, dtype=np.uint32)], -1)
    pad = np.full((8, 2), 0xFFFFFFFF, np.uint32)

    def put(kv, tag, keys, pages=None):
        res = kv.plane_insert(keys, _pages(keys) if pages is None
                              else pages).fetch()
        for f in res._fields:
            out[f"{tag}/{f}"] = np.asarray(getattr(res, f))

    def get(kv, tag, keys):
        g = kv.plane_get(keys).fetch()
        out[f"{tag}/found"] = np.asarray(g.found)
        out[f"{tag}/pages"] = np.asarray(g.dense())
        for f in ("lane_served", "lane_refused"):
            if getattr(g, f) is not None:
                out[f"{tag}/{f}"] = np.asarray(getattr(g, f))

    def totals(kv, tag):
        st = kv.stats()
        out[f"{tag}/stats"] = np.array([st[k] for k in sorted(st)],
                                       np.int64)
        out[f"{tag}/report"] = _json(kv.shard_report())

    # -- flat --
    kv = kvs["flat"] = make_kv(plane_config(m))
    put(kv, "flat/put1", base[:1500])
    put(kv, "flat/put2", skew)
    get(kv, "flat/get1", np.concatenate([base[:1000], absent, pad,
                                         hot[:200]]))
    get(kv, "flat/get2", skew)
    out["flat/del/hit"] = np.asarray(kv.plane_delete(
        np.concatenate([base[:300], absent[:20]])).fetch())
    get(kv, "flat/get3", np.concatenate([base[:1200], hot[:100]]))
    kv.plane_warm_get(base[:64])
    for j in range(2):
        kv.insert_extent(np.array([9 + j, 1 << 20], np.uint32),
                         np.array([j, 0xFFFFF000], np.uint32), 5 + 7 * j)
    probe = np.array([[9 + j, (1 << 20) + i] for j in range(2)
                      for i in range(0, 16, 3)], np.uint32)
    got, found = kv.plane_get_extent(probe).fetch()
    out["flat/gext/values"], out["flat/gext/found"] = got, found
    totals(kv, "flat")
    d = kv.directory_snapshot()
    for f in ("keys", "shards", "rows", "digs"):
        out[f"flat/dir/{f}"] = np.asarray(d[f])
    fv = kv.fast_view()
    sh, rw, dg = (np.asarray(d[f])[::5] for f in ("shards", "rows", "digs"))
    dg = dg.copy()
    dg[:8] ^= 1  # stale digests
    rw = rw.copy()
    rw[8] = 1 << 30  # a row out of range
    ok, pages = _fast_read(fv, fv.epoch, sh, rw, dg)
    out["flat/fast/ok"], out["flat/fast/pages"] = ok, pages
    out["flat/fast/old_epoch"] = _fast_read(fv, fv.epoch ^ 2, sh, rw, dg)[0]
    # a rewrite of a sample of the directory's keys: their old digests
    # no longer validate on the next view
    rew = np.asarray(d["keys"])[::5][:32]
    put(kv, "flat/rewrite", rew, _pages(rew) ^ np.uint32(0xA5A5A5A5))
    fv2 = kv.fast_view()
    out["flat/fast/new_view"] = np.asarray(fv2 is not fv)
    ok2, pages2 = _fast_read(fv2, fv2.epoch, sh, rw, dg)
    out["flat/fast2/ok"], out["flat/fast2/pages"] = ok2, pages2
    d2 = kv.directory_snapshot()
    for f in ("keys", "shards", "rows", "digs"):
        out[f"flat/dir2/{f}"] = np.asarray(d2[f])

    # -- tiered, with the admission gate --
    kv = kvs["tiered"] = make_kv(plane_config(m, tiered=True))
    put(kv, "tiered/put", base[:1500])
    for j in range(4):
        get(kv, f"tiered/get{j}", np.concatenate(
            [base[rng.integers(0, 1500, 600)], absent[:40], hot[:20]]))
    out["tiered/del/hit"] = np.asarray(kv.plane_delete(base[:100]).fetch())
    out["tiered/shrink"] = np.asarray(kv.balloon_shrink(64))
    get(kv, "tiered/get4", base[:1500])
    out["tiered/grow"] = np.asarray(kv.balloon_grow(64))
    out["tiered/tier_stats"] = _json(kv.tier_stats())
    out["tiered/balloon_state"] = _json(kv.balloon_state())
    out["tiered/admit_state"] = _json(kv.admit_state())
    out["tiered/set_threshold"] = np.asarray(kv.set_admit_threshold(3))
    out["tiered/admit_state2"] = _json(kv.admit_state())
    totals(kv, "tiered")

    # -- 2 x 2: lane 0 corrupted, served around, repaired --
    kv = kvs["grid2d"] = make_kv(plane_config(m), lanes=2)
    put(kv, "grid2d/put", base[:1500])
    kv.corrupt_replica_lane(0)
    probe2 = np.concatenate([base[:1000], absent[:50]])
    get(kv, "grid2d/get1", probe2)
    out["grid2d/repaired"] = np.asarray(kv.replica_repair())
    get(kv, "grid2d/get2", probe2)
    out["grid2d/replica"] = _json(kv.replica_report())
    totals(kv, "grid2d")

    # -- restores of either package's files --
    snap = snapshot_keys()
    sprobe = np.concatenate([snap, absent[:40]])
    for tag in ("jax", "port"):
        kv = kvs[f"restore-{tag}"] = make_kv(plane_config(m))
        for name, call in (
                ("full", lambda: kv.restore(os.path.join(root,
                                                         f"{tag}4.npz"))),
                ("reshard", lambda: kv.restore(os.path.join(
                    root, f"{tag}2.npz"))),
                ("chain", lambda: kv.restore_chain([
                    os.path.join(root, f"{tag}4.npz"),
                    os.path.join(root, f"{tag}4d.npz")])),
                ("chain-reshard", lambda: kv.restore_chain([
                    os.path.join(root, f"{tag}2.npz")]))):
            call()
            get(kv, f"restore-{tag}/{name}", sprobe)
            totals(kv, f"restore-{tag}/{name}")

    # -- a plane carried over from JAX's leaves --
    kv = kvs["carried"] = make_kv(plane_config(m), carried=True)
    get(kv, "carried/get", sprobe)
    totals(kv, "carried")
    return out, kvs


def mismatch_drill(make_kv, pid: int) -> None:
    """Process 1 routes a different batch than process 0: the widths its
    plane GET gathers differ, and the collective must fail (or time out)
    rather than hang."""
    from pmdfc_tpu_torch import config as tc

    kv = make_kv(plane_config(tc))
    keys = _plane_keys(1, 64 if pid == 0 else 4000, 3)
    kv.plane_insert(keys, _pages(keys)).fetch()


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


def dump_plane(path: str, results: dict, kvs: dict) -> None:
    """Write `plane_drill`'s results and, per stage, the leaves of every
    lane of the shards this process holds (`<stage>/leaf/<s>/<r>/<name>`)."""
    from pmdfc_tpu_torch import carry

    arrays = dict(results)
    for stage, kv in kvs.items():
        for s in kv._mine:
            for r, st in enumerate(kv._st[s]):
                for name, a in carry.state_to_numpy(st).items():
                    arrays[f"{stage}/leaf/{s}/{r}/{name}"] = a
    np.savez(path, **arrays)


def plane_maker(root: str, pid: int):
    """`plane_drill`'s `make_kv` over the global grid of this process's
    group: carried states are built for the shards it holds only."""
    from pmdfc_tpu_torch import carry
    from pmdfc_tpu_torch.parallel.shard import (
        Mesh, ShardedKV, make_mesh, make_mesh2d)

    def make_kv(cfg, lanes=1, carried=False):
        mesh = make_mesh2d(*PLANE_GRID2D) if lanes > 1 else make_mesh()
        states = None
        if carried:
            mine = np.flatnonzero(mesh.owners == pid)
            with np.load(os.path.join(root, "carried.npz")) as z:
                leaves = {k: z[k][mine] for k in z.files}
            part = carry.sharded_from_numpy(
                leaves, cfg, Mesh(mesh.devices[mine], mesh.axis_names))
            states = [None] * mesh.devices.shape[0]
            for j, s in enumerate(mine):
                states[s] = part[j]
        return ShardedKV(cfg, mesh=mesh, states=states)

    return make_kv


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
    ap.add_argument("--plane", default=None,
                    help="run only the plane drill over the snapshots in "
                         "this directory and dump it there")
    ap.add_argument("--mismatch", action="store_true",
                    help="run only the router-mismatch drill (must fail)")
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
        if args.mismatch:
            mismatch_drill(plane_maker("", pid), pid)
            print(f"worker {pid}: the mismatched plane GET returned",
                  flush=True)
            return 1
        if args.plane:
            from pmdfc_tpu_torch.runtime import profiler

            # the plane GET's cost probe runs on every process (process
            # 1 holds no shard 0)
            prof = profiler.install()
            res, kvs = plane_drill(tc, plane_maker(args.plane, pid),
                                   args.plane)
            res["flat/cost"] = _json(prof.snapshot()["cost"])
            dump_plane(os.path.join(args.plane, f"plane{pid}.npz"), res,
                       kvs)
            print(f"worker {pid}: plane drill OK", flush=True)
            return 0
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
