"""PyTorch port: the multi-process plane's verbs (`connect_multihost` on
`torch.distributed`) against one process and against the JAX plane.

Two worker processes (`pmdfc_tpu_torch.tools.multihost_worker --plane`,
`--device cpu`) join over gloo on loopback, two CPU shards each (a
4-shard grid; the 2 x 2 grid keeps each shard's two lanes in one
process), and run `plane_drill`: the plane verbs on both GET cadences
with skewed batches, in-batch duplicates, deletes and extents; the fast
lane (`fast_view` reads with stale digests and epochs) and
`directory_snapshot`; `restore` and `restore_chain` of files that JAX's
and the port's one-process planes wrote, onto 4 shards and resharded
from 2; the tiered pool with the gate, the balloon and `tier_stats`; the
2 x 2 grid with a corrupted lane and `replica_repair`; states carried
from JAX's leaves. While they run, the same drill goes through the
port's one-process plane over `["cpu"] * 4` and JAX's plane over 4 of
the forced CPU devices. Held bit for bit (tolerance 0): both workers'
results (every process returns the full result), the one-process
port's, JAX's, and every shard's leaves against the process that holds
it. The directory's epoch is drawn per process, as JAX draws it, and is
not compared.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu import config as jc
from pmdfc_tpu.parallel import shard as jshard
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import config as tc
from pmdfc_tpu_torch.parallel import shard as tshard
from pmdfc_tpu_torch.tools import multihost_worker as mw

from test_torch_multihost import _free_port
from test_torch_shard import jax_grid, jax_lane_leaves, jax_leaves, port_grid

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("flat", "tiered", "grid2d", "restore-jax", "restore-port",
          "carried")


def _spawn(extra: list, timeout: float) -> list:
    """The two workers with `extra` arguments -> their processes."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "pmdfc_tpu_torch.tools.multihost_worker",
         str(pid), str(port), "--device", "cpu", "--timeout", str(timeout),
         *extra], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]


def _wait(procs, timeout: float) -> list:
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    """The snapshots either package's one-process plane writes, and the
    JAX plane whose leaves `carried.npz` holds."""
    root = tmp_path_factory.mktemp("mhplane")
    jcfg, tcfg = mw.plane_config(jc), mw.plane_config(tc)
    jf = mw.write_snapshots(
        lambda n: jshard.ShardedKV(jcfg, mesh=jax_grid(n)), str(root), "jax")
    mw.write_snapshots(
        lambda n: tshard.ShardedKV(tcfg, mesh=port_grid(n)), str(root),
        "port")
    np.savez(root / "carried.npz", **jax_leaves(jf.state))
    return root, jf


@pytest.fixture(scope="module")
def workers(snaps):
    root, _ = snaps
    procs = _spawn(["--plane", str(root)], 60)
    yield procs
    _wait(procs, 1)


@pytest.fixture(scope="module")
def dumps(snaps, workers, one_process, jax_plane):
    root, _ = snaps
    outs = _wait(workers, 240)
    for _ in range(2):  # a coordinator port taken between probe and bind
        if not any("EADDRINUSE" in o or "Address already in use" in o
                   for o in outs):
            break
        workers[:] = _spawn(["--plane", str(root)], 60)
        outs = _wait(workers, 240)
    for pid, (p, out) in enumerate(zip(workers, outs)):
        assert p.returncode == 0, f"worker {pid} rc={p.returncode}\n{out}"
        assert f"worker {pid}: plane drill OK" in out, out
    return [mw.load_dump(str(root / f"plane{pid}.npz")) for pid in range(2)]


@pytest.fixture(scope="module")
def one_process(snaps, workers):
    """The drill through the port's one-process plane."""
    root, _ = snaps

    def make(cfg, lanes=1, carried=False):
        grid = port_grid(2, 2) if lanes > 1 else port_grid(4)
        states = None
        if carried:
            with np.load(root / "carried.npz") as z:
                states = carry.sharded_from_numpy(
                    {k: z[k] for k in z.files}, cfg, grid)
        return tshard.ShardedKV(cfg, mesh=grid, states=states)

    return mw.plane_drill(tc, make, str(root))


@pytest.fixture(scope="module")
def jax_plane(snaps, workers):
    """The drill through JAX's plane on 4 forced CPU devices."""
    root, jf = snaps

    def make(cfg, lanes=1, carried=False):
        if carried:
            return jf
        return jshard.ShardedKV(cfg, mesh=jax_grid(2, 2) if lanes > 1
                                else jax_grid(4))

    return mw.plane_drill(jc, make, str(root))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind == "U", \
        f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert np.array_equal(a, b), f"{what} differs"


@pytest.mark.parametrize("stage", STAGES)
def test_plane_stage_matches_one_process_and_jax(dumps, one_process,
                                                 jax_plane, stage):
    port, port_kvs = one_process
    ref, jax_kvs = jax_plane
    keys = sorted(k for k in ref if k.startswith(stage + "/"))
    assert len(keys) >= 4
    for k in keys:
        _same(port[k], ref[k], f"one process vs JAX: {k}")
        for pid, d in enumerate(dumps):
            _same(d[k], ref[k], f"worker {pid} vs JAX: {k}")
    # every shard's leaves (every lane), from the process that holds it
    jkv = jax_kvs[stage]
    lanes = jkv.n_replicas
    jl = (jax_lane_leaves(jkv.state, jkv.n_shards, lanes) if lanes > 1
          else {k: v[:, None] for k, v in jax_leaves(jkv.state).items()})
    pl = carry.sharded_to_numpy(port_kvs[stage]._st, lanes=True)
    assert sorted(jl) == sorted(pl)
    per = jkv.n_shards // 2
    for s in range(jkv.n_shards):
        d, other = dumps[s // per], dumps[1 - s // per]
        assert not any(k.startswith(f"{stage}/leaf/{s}/") for k in other)
        for r in range(lanes):
            for name in jl:
                _same(d[f"{stage}/leaf/{s}/{r}/{name}"], jl[name][s, r],
                      f"{stage} shard {s} lane {r} leaf {name} vs JAX")
                _same(pl[name][s, r], jl[name][s, r],
                      f"one process {stage} shard {s} lane {r} {name}")


def test_the_drill_reaches_what_it_holds(jax_plane):
    """The seeded data takes the branches the comparisons name: stale
    digests and epochs refused on the fast lane, the rewrite's old
    digests refused on the next view, the counting cadence migrating
    rows, a balloon shrink, a corrupted lane served around and repaired,
    every restored snapshot key served."""
    ref, _ = jax_plane
    ok = ref["flat/fast/ok"]
    assert ok[9:].any() and not ok[:9].any()
    assert not ref["flat/fast/old_epoch"].any()
    assert ref["flat/fast/new_view"] and ok.sum() > ref["flat/fast2/ok"].sum()
    tier = json.loads(str(ref["tiered/tier_stats"]))
    assert ref["tiered/shrink"] and tier["balloon_shrinks"] > 0
    assert tier["promotions"] > 0 and tier["hot_hits"] > 0
    assert ref["grid2d/repaired"] > 0 and ref["grid2d/get1/found"].any()
    assert ref["grid2d/get1/lane_refused"][0] > 0
    n = len(mw.snapshot_keys())
    for tag in ("jax", "port"):
        assert ref[f"restore-{tag}/full/found"][:1200].all()
        assert ref[f"restore-{tag}/chain/found"][100:n].all()
        assert not ref[f"restore-{tag}/chain/found"][:100].any()
    assert ref["carried/get/found"][100:n].all()


def test_cost_probe_runs_on_a_process_without_shard_0(dumps):
    """Process 1 holds shards 2 and 3: its plane GET's cost probe reads
    the bytes of a shard it holds, and both processes set the same
    gauges."""
    a, b = (str(d["flat/cost"]) for d in dumps)
    assert a == b and '"plane.get"' in a and '"bytes": 0.0' not in a


def test_read_only_gets_fold_the_global_delta_once(dumps, jax_plane):
    """A read-only plane GET's per-shard delta is gathered and folded once
    on every process: `stats()` and each shard's report row equal JAX's
    one-process plane (half of it if only the local rows were folded,
    twice if every process's fold were counted)."""
    ref, _ = jax_plane
    for d in dumps:
        _same(d["flat/stats"], ref["flat/stats"], "stats")
        _same(d["flat/report"], ref["flat/report"], "shard_report")
    rep = json.loads(str(dumps[1]["flat/report"]))["stats"]
    assert sum(rep["gets"]) > 0 and rep["misses"] == [
        sum(rep[c][i] for c in rep if c.startswith("miss_"))
        for i in range(4)]


def test_a_router_mismatch_fails_inside_its_timeout():
    """Two processes that route different batches gather different widths:
    the collective fails (or times out after 5 s) instead of hanging (a
    hung gloo collective waits 30 minutes by default); the bound leaves
    room for two interpreters to start on a loaded host."""
    t0 = time.monotonic()
    procs = _spawn(["--mismatch"], 5)
    outs = _wait(procs, 150)
    took = time.monotonic() - t0
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode not in (0, None), out
        assert "mismatched plane GET returned" not in out, out
    assert took < 120, took
