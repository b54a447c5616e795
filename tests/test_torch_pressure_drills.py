"""PyTorch port: `tests/test_pressure.py`, drill by drill.

Each test carries its JAX drill's name and runs the drill's script on
both packages: the filebench personalities, the paging and swap
simulators over the hermetic `LocalBackend`, and the training-pressure
harness. Every drill but the last is deterministic, so the two
transcripts must be equal: each harness row (its host-clock fields
aside), the simulators' stats, the client's counters and the backend's
store. The training drill (`slow` in JAX: 60 steps at 256-word pages; on
the card phase 13's `train_pressure`, 4 KiB pages, 100 steps) runs here
at its own size: both packages' paging counters equal, both learn.
"""

from __future__ import annotations

import json
import sys
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import registries, same, timeless  # noqa: F401
from torch_twin import twin as twin_of

import pmdfc_tpu.bench.filebench as jfb
import pmdfc_tpu.bench.paging_sim as jps
import pmdfc_tpu.bench.swap_sim as jss
import pmdfc_tpu.bench.train_pressure as jtp
import pmdfc_tpu.client.backends as jbe
import pmdfc_tpu.client.cleancache as jcc
import pmdfc_tpu_torch.bench.filebench as tfb
import pmdfc_tpu_torch.bench.paging_sim as tps
import pmdfc_tpu_torch.bench.swap_sim as tss
import pmdfc_tpu_torch.bench.train_pressure as ttp
import pmdfc_tpu_torch.client.backends as tbe
import pmdfc_tpu_torch.client.cleancache as tcc

pytestmark = pytest.mark.torch

W = 32
JAX = types.SimpleNamespace(name="jax", fb=jfb, ps=jps, ss=jss, be=jbe,
                            cc=jcc)
PORT = types.SimpleNamespace(name="port", fb=tfb, ps=tps, ss=tss, be=tbe,
                             cc=tcc)
PKGS = (JAX, PORT)
# host clocks of two different programs: never compared
TIMING = {"secs", "pages_per_sec", "mib_per_sec", "iops", "fault_iops",
          "read_mib_per_sec", "value", "mbs_4k"}


def twin(drill, *args):
    return twin_of(drill, *args, pkgs=PKGS)


def _untimed(row: dict) -> dict:
    return timeless(row, TIMING)


def _store(be) -> list:
    return sorted((k, bytes(np.asarray(v).tobytes()))
                  for k, v in be._store.items())


def _sim(p, ram_pages=64, capacity=4096):
    client = p.cc.CleanCacheClient(p.be.LocalBackend(W, capacity))
    return p.ps.PagingSim(client, ram_pages, W), client


def _personality(p, name, ram_pages=64, **kw):
    sim, client = _sim(p, ram_pages=ram_pages)
    out = p.fb.run_personality(sim, name, **kw)
    return out, (_untimed(out), dict(sim.stats), client.stats(),
                 _store(client.backend))


def test_fileserver_personality_verifies():
    def drill(p):
        out, obs = _personality(p, "fileserver", loops=12, nfiles=16,
                                mean_pages=4)
        assert out["verify_failures"] == 0
        assert out["files_created"] == 12 and out["files_deleted"] == 12
        assert out["pages_read"] > 0 and out["pages_written"] > 0
        return obs

    twin(drill)


def test_webserver_personality_verifies():
    def drill(p):
        out, obs = _personality(p, "webserver", loops=10, nfiles=16,
                                mean_pages=4, reads_per_loop=5)
        assert out["verify_failures"] == 0
        assert out["pages_read"] > out["files_created"]
        return obs

    twin(drill)


def test_dgwebserver_scales_fileset():
    def drill(p):
        out, obs = _personality(p, "dgwebserver", ram_pages=32, loops=4,
                                nfiles=8, mean_pages=2, reads_per_loop=3)
        assert out["verify_failures"] == 0
        return obs

    twin(drill)


def test_randomread_working_set():
    def drill(p):
        out, obs = _personality(p, "randomread", ram_pages=16, loops=400,
                                nfiles=8, mean_pages=8, working_set=0.25)
        assert out["verify_failures"] == 0 and out["pages_read"] == 400
        assert out["cc_hits"] > 0
        return obs

    twin(drill)


def test_trim_is_invalidate_inode():
    def drill(p):
        sim, client = _sim(p, ram_pages=8)
        fid = 5
        for i in range(16):
            sim.write(fid, i)
        for i in range(16):
            sim.read(fid, i)
        sim.trim(fid, range(16))
        assert all((fid, i) not in sim.versions for i in range(16))
        for i in range(16):
            sim.write(fid, i)
        for i in range(16):
            sim.read(fid, i)
        assert sim.stats["verify_failures"] == 0
        return dict(sim.stats), client.stats(), _store(client.backend)

    twin(drill)


def test_fileset_gamma_sizes():
    def drill(p):
        fs = p.fb.Fileset(np.random.default_rng(0), 200, mean_pages=8)
        sizes = np.array(list(fs.sizes.values()))
        assert sizes.min() >= 1 and 4 <= sizes.mean() <= 12
        assert sizes.max() > sizes.mean() * 2
        return dict(fs.sizes)

    twin(drill)


def test_train_pressure_learns(monkeypatch, capsys):
    """The JAX drill's run (`slow` there) on both packages, in process:
    60 steps over a 256-page corpus of 256-word pages, 64 RAM pages; the
    paging counters equal, every page verified, and both learn."""
    args = ["--steps", "60", "--corpus-pages", "256", "--ram-pages", "64",
            "--page-words", "256", "--batch", "32", "--capacity", "4096",
            "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", ["train_pressure", *args])
    jtp.main()
    jrow = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ttp.main(args) == 0
    trow = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for row in (jrow, trow):
        assert row["verify_failures"] == 0
        assert row["learned"], (row["loss_first"], row["loss_last"])
        assert row["cc_hits"] > 0
    for k in ("reads", "writes", "ram_hits", "cc_hits", "disk_reads",
              "disk_writes", "cc_puts", "steps"):
        assert trow[k] == jrow[k], k


def _swap_sim(p, ram_pages, capacity, page_words=32):
    return p.ss.SwapSim(p.cc.SwapClient(p.be.LocalBackend(page_words,
                                                          capacity)),
                        ram_pages, page_words)


def _swap_obs(sim, out) -> tuple:
    return _untimed(out), dict(sim.stats), _store(sim.client._cc.backend)


def test_swap_randread_all_remote():
    def drill(p):
        sim = _swap_sim(p, 32, 4096)
        out = p.ss.run(sim, ops=800, working_pages=128, write_frac=0.0)
        assert out["verify_failures"] == 0 and out["disk_hits"] == 0
        assert out["swap_hit_frac"] == 1.0 and out["faults"] > 0
        return _swap_obs(sim, out)

    twin(drill)


def test_swap_drops_recover_from_device():
    def drill(p):
        sim = _swap_sim(p, 16, 48)
        out = p.ss.run(sim, ops=600, working_pages=128, write_frac=0.0)
        assert out["verify_failures"] == 0
        assert out["disk_hits"] > 0 and out["swap_hits"] > 0
        return _swap_obs(sim, out)

    twin(drill)


def test_swap_writes_never_serve_stale():
    def drill(p):
        sim = _swap_sim(p, 16, 4096)
        out = p.ss.run(sim, ops=800, working_pages=64, write_frac=0.5)
        assert out["verify_failures"] == 0
        sim2 = _swap_sim(p, 2, 4096)
        for off in (1, 2, 3):
            sim2.touch(off, write=True)
        stored = sim2.client.load(0, 1)
        assert stored is not None and 1 in sim2.disk
        sim2.touch(1, write=False)
        assert sim2.client.load(0, 1) is None, "remote copy must be freed"
        assert 1 not in sim2.disk, "device copy must be freed"
        assert sim2.stats["verify_failures"] == 0
        return _swap_obs(sim, out), np.asarray(stored), dict(sim2.stats)

    twin(drill)


def test_swap_iodepth_batch_path_verifies():
    def drill(p):
        sim = _swap_sim(p, 16, 4096)
        out = p.ss.run(sim, ops=800, working_pages=64, write_frac=0.3,
                       iodepth=8)
        assert out["verify_failures"] == 0
        assert out["faults"] > 0 and out["swap_hits"] > 0
        assert out["touches"] == 800
        sim2 = _swap_sim(p, 4, 4096)
        sim2.touch_batch(np.array([7, 7, 7, 8]), np.zeros(4, bool))
        assert sim2.stats["faults"] == 2 and sim2.stats["ram_hits"] == 2
        assert sim2.stats["verify_failures"] == 0
        return _swap_obs(sim, out), dict(sim2.stats)

    twin(drill)


def test_swap_parallel_jobs_aggregate():
    def drill(p):
        client = p.cc.SwapClient(p.be.LocalBackend(32, 8192))
        out = p.ss.run_jobs(
            lambda j: p.ss.SwapSim(client, 16, 32, swap_type=j),
            n_jobs=4, ops=1600, working_pages=256, write_frac=0.2,
            iodepth=8)
        assert out["verify_failures"] == 0
        assert out["jobs"] == 4 and out["touches"] == out["ops"]
        assert out["swap_hits"] > 0
        return _untimed(out), _store(client._cc.backend)

    twin(drill)


def test_paging_read_batch_matches_per_op_semantics():
    seq = np.random.default_rng(5).integers(128, size=512)

    def drill(p):
        def build():
            return p.ps.PagingSim(p.cc.CleanCacheClient(
                p.be.LocalBackend(16, 4096)), ram_pages=32, page_words=16)

        a, b = build(), build()
        for i in seq:
            a.read(1, int(i))
        for lo in range(0, 512, 8):
            b.read_batch(1, seq[lo:lo + 8])
        a.flush_evictions()
        b.flush_evictions()
        assert a.stats["verify_failures"] == b.stats["verify_failures"] == 0
        assert a.stats["reads"] == b.stats["reads"] == 512
        for s in (a.stats, b.stats):
            assert s["ram_hits"] + s["cc_hits"] + s["disk_reads"] == 512
        assert len(b.ram) <= 32
        return dict(a.stats), dict(b.stats), sorted(b.ram)

    twin(drill)
