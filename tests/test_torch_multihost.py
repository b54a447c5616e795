"""PyTorch port: the multi-process `ShardedKV` (`connect_multihost` on
`torch.distributed`) against one process and against the JAX plane.

Two worker processes (`pmdfc_tpu_torch.tools.multihost_worker`, started
with `--device cpu`) join over gloo on loopback, two CPU shards each, and
run the JAX worker's assertions, then the seeded `drill` through both
dispatches (skewed batches that overflow a2a pairs, in-batch duplicates,
updates, padding, deletes, extents) at 2^14 slots per shard. Each dumps
every result, the stats, `utilization`, the shard report and the leaves
of the shards it holds. While they run, the same drill goes through the
port's single-process `ShardedKV` over `["cpu"] * 4` and JAX's
`ShardedKV` over 4 of the forced CPU devices in this process. Held bit
for bit (tolerance 0): both workers' results (every process returns the
full result), the single-process port's, JAX's, and every shard's leaves
(through `carry`) against the process that holds it.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from pmdfc_tpu import config as jc
from pmdfc_tpu.parallel import shard as jshard
from pmdfc_tpu_torch import config as tc
from pmdfc_tpu_torch.parallel import shard as tshard
from pmdfc_tpu_torch.tools import multihost_worker as mw

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
N = mw.N_PROCS * mw.PER_PROC


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Workers:
    """The two worker processes, started at once; `results()` waits. A
    pair whose coordinator port was taken between the probe and the bind
    is started again on a fresh port (twice at most)."""

    def __init__(self, out: Path):
        self.out = out
        self._outs = None
        self._start()

    def _start(self):
        port = _free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "pmdfc_tpu_torch.tools.multihost_worker",
             str(pid), str(port), "--device", "cpu", "--timeout", "60",
             "--dump", str(self.out)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for pid in range(2)]

    def _wait(self):
        try:
            return [p.communicate(timeout=120)[0] for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()

    def results(self):
        if self._outs is None:
            outs = self._wait()
            for _ in range(2):
                if not any("EADDRINUSE" in o or "Address already in use" in o
                           for o in outs):
                    break
                self._start()
                outs = self._wait()
            self._outs = outs
        return self._outs


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    w = Workers(tmp_path_factory.mktemp("multihost"))
    yield w
    w.results()


@pytest.fixture(scope="module")
def dumps(workers):
    outs = workers.results()
    for pid, (p, out) in enumerate(zip(workers.procs, outs)):
        assert p.returncode == 0, f"worker {pid} rc={p.returncode}\n{out}"
    return [mw.load_dump(str(workers.out / f"worker{pid}.npz"))
            for pid in range(2)]


@pytest.fixture(scope="module")
def one_process(workers):
    """The drill through the port's single-process plane."""
    grid = tshard.make_mesh(["cpu"] * N)
    return mw.drill(lambda d: tshard.ShardedKV(mw.drill_config(tc),
                                               mesh=grid, dispatch=d), N)


@pytest.fixture(scope="module")
def jax_plane(workers):
    """The drill through JAX's plane on 4 forced CPU devices."""
    grid = jshard.make_mesh(np.array(jax.devices()[:N]))
    return mw.drill(lambda d: jshard.ShardedKV(mw.drill_config(jc),
                                               mesh=grid, dispatch=d), N)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert np.array_equal(a, b), f"{what} differs"


def test_workers_hold_the_jax_workers_checks(workers):
    for pid, out in enumerate(workers.results()):
        assert f"worker {pid}: OK (devices=4" in out, out


@pytest.mark.parametrize("dispatch", ["a2a", "broadcast"])
def test_two_processes_match_one_process_and_jax(dumps, one_process,
                                                 jax_plane, dispatch):
    port, port_kvs = one_process
    ref, jax_kvs = jax_plane
    keys = sorted(k for k in ref if k.startswith(dispatch + "/"))
    assert len(keys) > 40
    if dispatch == "a2a":  # the skewed batch overflowed a2a pairs
        assert ref["a2a/ins2/dropped"].any()
    # the crowded cluster evicted keys whose hi word is below 2^31 (an
    # unsigned pmin over the processes must pick them over all-ones)
    ev = ref[f"{dispatch}/ins4/evicted"]
    assert ((ev[:, 0] == 0x11)).any()
    for k in keys:
        _same(port[k], ref[k], f"one process vs JAX: {k}")
        for pid, d in enumerate(dumps):
            _same(d[k], ref[k], f"worker {pid} vs JAX: {k}")
    # every shard's leaves, from the process that holds it
    jl = {".".join(p.name for p in path): np.asarray(v) for path, v in
          jax.tree_util.tree_flatten_with_path(jax_kvs[dispatch].state)[0]}
    from pmdfc_tpu_torch import carry

    pl = carry.sharded_to_numpy(port_kvs[dispatch]._st)
    assert sorted(jl) == sorted(pl)
    for s in range(N):
        d = dumps[s // mw.PER_PROC]
        for name in jl:
            got = d[f"{dispatch}/leaf/{s}/{name}"]
            assert got.dtype == jl[name].dtype, name
            _same(got, jl[name][s], f"shard {s} leaf {name} vs JAX")
            _same(pl[name][s], jl[name][s],
                  f"one process shard {s} leaf {name} vs JAX")
        other = dumps[1 - s // mw.PER_PROC]
        assert not any(k.startswith(f"{dispatch}/leaf/{s}/") for k in other)


def test_a_peer_that_never_joins_fails_within_the_timeout():
    code = (
        "from pmdfc_tpu_torch.parallel.shard import connect_multihost\n"
        f"connect_multihost('localhost:{_free_port()}', 2, 0, timeout_s=3,"
        " devices=['cpu'])\n")
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    took = time.monotonic() - t0
    assert p.returncode != 0, p.stdout
    assert took < 3 + 20, took


def test_nccl_ranks_sharing_a_card_are_named():
    assert tshard.shared_cards([["h/GPU-a", "h/GPU-a"], ["h/GPU-b"]]) == {}
    assert tshard.shared_cards([["h/GPU-a"], ["h/GPU-a"], [None]]) == {
        "h/GPU-a": [0, 1]}
    assert tshard.shared_cards([[None, None], [None]]) == {}
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        tshard.connect_multihost("localhost:1", 1, 0, backend="nccl",
                                 devices=["cpu"])
    with pytest.raises(ValueError, match="unknown backend"):
        tshard.connect_multihost("localhost:1", 1, 0, backend="mpi",
                                 devices=["cpu"])


def test_verbs_a_multi_process_grid_does_not_run_raise(monkeypatch):
    """On a grid that spans processes the plane verbs, the fast lane and
    snapshots raise a named error, as do 2-D grids and tiered pools; no
    collective runs for that (the layout is stood in for)."""
    monkeypatch.setattr(tshard, "_LAYOUT", tshard._Layout(
        rank=0, world=2, backend="gloo",
        devices=(("cpu", "cpu"), ("cpu", "cpu"))))
    grid = tshard.make_mesh()
    assert list(grid.owners) == [0, 0, 1, 1]
    cfg = tc.KVConfig(index=tc.IndexConfig(capacity=1 << 8), page_words=16)
    skv = tshard.ShardedKV(cfg, mesh=grid)
    assert skv._mine == [0, 1] and skv._st[2] is None and skv._st[3] is None
    keys = np.zeros((4, 2), np.uint32)
    for call in (lambda: skv.plane_get(keys), lambda: skv.plane_delete(keys),
                 lambda: skv.plane_insert(keys, np.zeros((4, 16), np.uint32)),
                 lambda: skv.plane_get_extent(keys), skv.fast_view,
                 skv.directory_snapshot, lambda: skv.save("x"),
                 lambda: skv.restore("x"), lambda: skv.restore_chain(["x"])):
        with pytest.raises(tshard.MultihostUnsupportedError):
            call()
    with pytest.raises(tshard.MultihostUnsupportedError):
        tshard.ShardedKV(tc.KVConfig(index=tc.IndexConfig(capacity=1 << 8),
                                     page_words=16, tier=tc.TierConfig()),
                         mesh=grid)
    with pytest.raises(tshard.MultihostUnsupportedError):
        tshard.make_mesh2d(2, 2)
    monkeypatch.setattr(tshard, "_LAYOUT", None)
    with pytest.raises(tshard.MultihostError, match="process group"):
        tshard.ShardedKV(cfg, mesh=grid)
