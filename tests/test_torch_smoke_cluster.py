"""PyTorch port: `chip_smoke.py`'s phases 9–12 (fleet, plane, control,
scale) rehearsed on the CPU.

Split from `tests/test_torch_smoke.py` (phases 3–8), whose `smoke`
fixture and card stand-ins these tests share, so the two halves run on
separate workers: the rehearsal had become the suite's longest file. The
sizes, stand-ins and checks are that file's; nothing here is new.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

import chip_smoke
from pmdfc_tpu_torch.ops import fused
from test_torch_smoke import KEYS, smoke  # noqa: F401  (fixture)

pytestmark = pytest.mark.torch


FLEET_TINY = (("FLEET_INDEX", dict(capacity=1 << 12)),
              ("FLEET_BLOOM_BITS", 1 << 18), ("VERB", 1 << 6),
              ("FLEET_THREADS", 2), ("FLEET_FILL", 1024),
              ("FLEET_DELTA", 256), ("FLEET_TAIL", 512), ("FLEET_INVAL", 64),
              ("FLEET_STORM", 512), ("FLEET_DOWN_PUT", 128),
              ("FLEET_DOWN_INVAL", 32), ("FLEET_DISK_BYTES", 1 << 20),
              ("FLEET_START_S", 120.0), ("FLEET_REPAIR_S", 60.0),
              # the RPO bound (rpo_ops + 1) x VERB below the tail's size,
              # so a lost tail shows as a loss
              ("FLEET_JOURNAL", dict(rpo_ops=1)))


@pytest.fixture
def fleet_smoke(smoke, monkeypatch, tmp_path):
    for name, value in FLEET_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "fleet_dir", lambda: tmp_path / "fleet")
    return smoke


def test_fleet_phase_and_its_kernels_line(fleet_smoke, tmp_path, capsys):
    """The fleet phase with three crashbox children on the CPU over 2^12
    slots each: fill, full and delta of node 2, tail, storm, SIGKILL,
    puts, invalidates and a storm while it is down, the warm restart's
    checks, the rejoin (breaker, repair drain, `mark_recovered`), the
    last delta and the in-process restore of the three-member chain with
    kernel against plain on it. The plain version runs in the children,
    so each node must count 0 kernel launches."""
    entry = chip_smoke.run_fleet(fleet_smoke)
    assert set(entry) == KEYS and entry["path"] == "fleet"
    assert entry["name"] == "fused_get_linear_flat"
    assert entry["launches"] == 0 and entry["max_abs_err"] == 0
    out = capsys.readouterr().out
    for line in ("node 2 full snapshot", "node 2 delta snapshot",
                 "node 2 killed (SIGKILL)", "node 2 warm restart",
                 "recoveries_completed 1", "in-process restore",
                 "[kernel] fleet restored w=16384: kernel == plain"):
        assert line in out, line
    assert " 0 of " in out.split("node 2 warm restart")[1]  # none lost
    assert not (tmp_path / "fleet").exists()


def test_fleet_phase_fails_on_a_journal_cut_past_the_rpo(fleet_smoke,
                                                         monkeypatch):
    """Node 2's journal cut to half after the kill (the tail past the
    delta and its invalidates gone): the warm restart's check fails."""
    from pmdfc_tpu_torch.runtime import journal
    from pmdfc_tpu_torch.tools.crashbox import Crashbox

    kill = Crashbox.kill

    def kill_and_cut(self):
        kill(self)  # the phase kills only the crashing node
        wal = str(chip_smoke.fleet_dir() / f"wal{chip_smoke.FLEET_CRASH}")
        with open(journal.segment_paths(wal)[-1], "r+b") as f:
            f.truncate(f.seek(0, 2) // 2)

    monkeypatch.setattr(Crashbox, "kill", kill_and_cut)
    with pytest.raises(AssertionError,
                       match="lost .* acknowledged keys|invalidated before"):
        chip_smoke.run_fleet(fleet_smoke)


def test_fleet_phase_fails_when_an_invalidated_page_comes_back(
        fleet_smoke, monkeypatch):
    """A client that forgets the invalidations it could not deliver while
    its node was down: the rejoined node serves those pages again, and
    the phase fails."""
    from pmdfc_tpu_torch.runtime.failure import ReconnectingClient

    def forgetful(self, keys):
        keys = np.asarray(keys, np.uint32)
        be = self._ensure(force=self._probe_forced())
        if be is None:
            self._op_failed()
            return np.zeros(len(keys), bool)
        out = be.invalidate(keys)
        self._op_ok()
        return out

    monkeypatch.setattr(ReconnectingClient, "invalidate", forgetful)
    with pytest.raises(AssertionError, match="served an invalidated key"):
        chip_smoke.run_fleet(fleet_smoke)


PLANE_TINY = (("PLANE_INDEX", dict(capacity=1 << 10)),
              ("PLANE_BLOOM_BITS", 1 << 15), ("PLANE_DIRECT", 2560),
              ("PLANE_INS_B", 1 << 10), ("PLANE_FILL", 512),
              ("PLANE_GETS", 512), ("PLANE_EXTENTS", 8),
              ("PLANE_MUTATE", 256), ("PLANE_ENGINE_THREADS", 2),
              ("PLANE_ENGINE_PAGES", 256), ("PLANE_DISK_BYTES", 1 << 20),
              ("PLANE2D_INDEX", dict(capacity=1 << 11)),
              ("PLANE2D_BLOOM_BITS", 1 << 16),
              ("SERVE_ENGINE", dict(num_queues=4, queue_cap=1 << 10,
                                    batch=1 << 10, arena_pages=256,
                                    page_bytes=4096)),
              ("GET_VERBS", 4), ("WIRE_CLIENTS", 2), ("WIRE_CONNS", 2),
              ("VERB", 1 << 6), ("WIRE_FAST_CONNS", 2),
              ("PLANE_FAST_KEYS", 256), ("WIRE_REWRITE", 64),
              ("BF_PUSH_S", 0.01))


@pytest.fixture
def plane_smoke(smoke, monkeypatch, tmp_path):
    for name, value in PLANE_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "plane_dir", lambda: tmp_path / "plane")
    return smoke


def test_plane_phase_and_its_kernels_lines(plane_smoke, tmp_path, capsys):
    """The plane phase over a grid naming the CPU four times (2^10 slots a
    shard): the a2a fill, the wire (fill, storm, extents, the fast lane),
    its checks, kernel against plain at w = 8 and the widest per-shard
    width; the full and delta snapshots, the chain restore, the engine
    pass, the 4 -> 8 reshard restore; the 2 x 2 plane with a corrupted
    lane routed around, MSG_RREPAIR, and the other lane corrupted."""
    entries = chip_smoke.run_plane(plane_smoke)
    assert [e["path"] for e in entries] == ["plane", "plane2d"]
    for e in entries:
        assert set(e) == KEYS and e["name"] == "fused_get_linear_flat"
        assert e["launches"] > 0 and e["max_abs_err"] == 0
        assert e["bound_by"] == "bytes" and e["library_ms"] is None
    out = capsys.readouterr().out
    for line in ("[plane] checks passed", "a2a pair overflow 0 rows",
                 "[kernel] plane shard 0 full w=8: kernel == plain",
                 "restore_chain([full, delta]) onto 4 shards",
                 "[plane] engine pass", "reshard restore of the full onto 8",
                 "the replay dropped 0", "[plane2d] MSG_RREPAIR",
                 "[kernel] plane2d shard 0 full w=8: kernel == plain"):
        assert line in out, line
    assert not (tmp_path / "plane").exists()


def test_plane_phase_fails_when_read_only_gets_count_twice(plane_smoke,
                                                           monkeypatch):
    """A read-only plane GET whose stats delta lands twice: the plane
    phase's count check fails."""
    from pmdfc_tpu_torch.parallel.shard import ShardedKV

    real = ShardedKV._plane_note_get

    def twice(self, delta):
        real(self, delta)
        real(self, delta)

    monkeypatch.setattr(ShardedKV, "_plane_note_get", twice)
    with pytest.raises(AssertionError, match="GETs counted for"):
        chip_smoke.run_plane(plane_smoke)


def test_plane_phase_fails_when_a_corrupt_lane_serves(plane_smoke,
                                                      monkeypatch):
    """Lane 0 damaged in a way its digest cannot see (the sidecar
    rewritten over the damaged bytes): its pages come back over the wire,
    and the 2-D storm fails. The 1-D plane and its restores ahead of the
    2 x 2 plane (held by `test_plane_phase_and_its_kernels_lines`) are
    stood in for."""
    from pmdfc_tpu_torch.ops.pagepool import page_digest
    from pmdfc_tpu_torch.parallel.shard import ShardedKV

    monkeypatch.setattr(chip_smoke, "plane_1d", lambda sm, root: ({}, None))
    monkeypatch.setattr(chip_smoke, "plane_restore", lambda sm, snap: None)
    real = ShardedKV.corrupt_replica_lane

    def unseen(self, lane):
        real(self, lane)
        if lane == 0:
            for row in self._st:
                pool = row[0].pool
                pool.sums.copy_(page_digest(pool.pages))

    monkeypatch.setattr(ShardedKV, "corrupt_replica_lane", unseen)
    with pytest.raises(AssertionError, match="wrong bytes"):
        chip_smoke.run_plane(plane_smoke)


def test_plane_phase_fails_when_a_shard_launch_fails(plane_smoke,
                                                     monkeypatch):
    """A fused GET that raises inside one shard's program of a wire GET
    phase is contained by the server (bisected, culprits answered
    MSG_NACK): the plane phase must still fail."""
    counted = fused.fused_get
    calls = [0]

    def failing(keys, *args, **kw):
        calls[0] += 1
        if calls[0] == 5:
            raise RuntimeError("injected kernel failure")
        return counted(keys, *args, **kw)

    monkeypatch.setattr(fused, "fused_get", failing)
    with pytest.raises(AssertionError, match="plane: a phase failed"):
        chip_smoke.run_plane(plane_smoke)


CONTROL_TINY = (("ROW_INDEX", dict(capacity=1 << 12)),
                ("CONTROL_INDEX", dict(capacity=1 << 12)),
                ("CONTROL_BLOOM_BITS", 1 << 18), ("CONTROL_CONNS", 4),
                ("CONTROL_LIGHT_S", 1.0), ("CONTROL_LIGHT_VERB", 16),
                ("CONTROL_FANIN_VERBS", 4), ("VERB", 1 << 6),
                ("CONTROL_CAPTURE_MS", 100),
                # a CPU session records only its own thread's ops (the
                # serving threads' are not in it) and no CUDA kernel: the
                # rehearsal holds the trace to the session's own record
                ("TRACE_CAT", "Trace"), ("TRACE_NAME", "PyTorch Profiler"),
                ("HARNESSES", (("insert_rowscatter",
                                ("--smoke", "--capacity", "1024", "--n",
                                 "256")),
                               ("telemetry_overhead",
                                ("--smoke", "--pairs", "16", "--gets", "32",
                                 "--gate", "1e9")))))


@pytest.fixture
def control_smoke(smoke, monkeypatch, tmp_path):
    """Phase 11 at a tiny size; the row-path KV runs in this process with
    the registry pointed at the row path (what PMDFC_INSERT_PATH=row does
    at import in the child)."""
    import dataclasses

    from pmdfc_tpu_torch.config import IndexKind
    from pmdfc_tpu_torch.models import base, linear

    for name, value in CONTROL_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "control_dir", lambda: tmp_path / "ctl")

    def row_kv(sm):
        monkeypatch.setitem(base._REGISTRY, IndexKind.LINEAR,
                            dataclasses.replace(
                                base._REGISTRY[IndexKind.LINEAR],
                                insert_batch=linear.insert_batch_row))
        entry = chip_smoke.run_row_kv(sm)
        entry = json_roundtrip(entry)
        monkeypatch.setitem(base._REGISTRY, IndexKind.LINEAR,
                            dataclasses.replace(
                                base._REGISTRY[IndexKind.LINEAR],
                                insert_batch=linear.insert_batch_element))
        return entry

    monkeypatch.setattr(chip_smoke, "row_kv_subprocess", row_kv)
    return smoke


@pytest.fixture
def control_checks(control_smoke, monkeypatch):
    """Phase 11 for a fault that shows in the checks of the served storm:
    the row A/B and the row-path KV ahead of it (held by
    `test_control_phase_and_its_kernels_lines`) are stood in for."""
    monkeypatch.setattr(chip_smoke, "control_row_ab", lambda sm: None)
    monkeypatch.setattr(chip_smoke, "row_kv_subprocess",
                        lambda sm: {"fill_pages_per_s": 1.0, "launches": 0})
    return control_smoke


def json_roundtrip(d):
    import json

    return json.loads(json.dumps(d))


def test_control_phase_and_its_kernels_lines(control_smoke, capsys):
    """Phase 11 at a tiny size: row and element equal after every batch,
    the KV on the row path byte-exact, the profiler and controller behind
    the wire (one kv.get launch per GET phase, a capture's trace written
    and a second refused, knobs inside their envelope, proftool over the
    stats pull), the harnesses, and the two kernels entries."""
    import os

    entries = chip_smoke.run_control(control_smoke)
    assert [e["path"] for e in entries] == ["row-path", "control"]
    assert [e["name"] for e in entries] == ["fused_get_linear_flat",
                                            "fused_get_linear_tiered"]
    for e in entries:
        assert set(e) == KEYS
        assert e["launches"] > 0 and e["max_abs_err"] == 0
        assert e["bound_by"] == "bytes" and e["library_ms"] is None
    out = capsys.readouterr().out
    assert "equal after every batch" in out
    assert "a second request inside the cooldown refused" in out
    assert "every knob inside its envelope" in out
    assert "harness insert_rowscatter" in out
    assert "harness telemetry_overhead" in out and "overhead_ratio" in out
    assert os.environ.get("PMDFC_PROF") is None


def test_control_phase_fails_on_a_trace_without_the_kernel(
        control_checks, monkeypatch):
    """A capture whose session recorded nothing of the GETs fails the
    phase."""
    class Empty:
        def __init__(self, **_):
            pass

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                f.write('{"traceEvents": []}')

    monkeypatch.setattr(torch.profiler, "profile", Empty)
    with pytest.raises(AssertionError, match="holds no"):
        chip_smoke.run_control(control_checks)


def test_control_phase_fails_on_a_knob_outside_its_envelope(
        control_checks, monkeypatch):
    from pmdfc_tpu_torch.runtime.net import NetServer

    real = NetServer.flush_knobs
    monkeypatch.setattr(NetServer, "flush_knobs",
                        lambda self: tuple(100 * v for v in real(self)))
    with pytest.raises(AssertionError, match="outside their envelope"):
        chip_smoke.run_control(control_checks)


def test_control_phase_fails_on_a_row_element_mismatch(control_smoke,
                                                       monkeypatch):
    from pmdfc_tpu_torch.models import linear

    real = linear.insert_batch_row
    calls = [0]

    def off_by_one(state, keys, values):
        state, res = real(state, keys, values)
        calls[0] += 1
        if calls[0] == 3:
            state.head[0] += 1
        return state, res

    monkeypatch.setattr(linear, "insert_batch_row", off_by_one)
    with pytest.raises(AssertionError, match="head differs after batch"):
        chip_smoke.run_control(control_smoke)


def test_control_phase_fails_when_kv_get_launches_go_uncounted(
        control_checks, monkeypatch):
    from pmdfc_tpu_torch.runtime.profiler import Profiler

    real = Profiler.note_launch
    seen = [0]

    def lossy(self, program, *a, **kw):
        if program == "kv.get":
            seen[0] += 1
            if seen[0] % 3 == 0:
                return None
        return real(self, program, *a, **kw)

    monkeypatch.setattr(Profiler, "note_launch", lossy)
    with pytest.raises(AssertionError, match="kv.get launches for"):
        chip_smoke.run_control(control_checks)


# -- phase 12, scale: the multi-process plane and the workload harnesses --

SCALE_TINY = (
    ("SCALE_INDEX", dict(capacity=1 << 10)), ("SCALE_BLOOM_BITS", 1 << 13),
    # no NCCL here: the rehearsal's one-process group is gloo's, and the
    # two-ranks-on-one-card refusal is the card's (its logic is pinned in
    # test_torch_multihost.py)
    ("SCALE_SOLO_BACKEND", "gloo"), ("SCALE_SOLO_INDEX", dict(capacity=1 << 9)),
    ("SCALE_SOLO_BLOOM_BITS", 1 << 12), ("SCALE_INS_B", 1 << 9),
    ("SCALE_GET_B", 1 << 8), ("SCALE_GETS", 2), ("SCALE_BCAST_B", 1 << 6),
    ("SCALE_DELETE", 1 << 5), ("SCALE_JOIN_S", 60.0),
    ("SCALE_PLANE_EXTENTS", 4), ("SCALE_FAST_KEYS", 1 << 8),
    ("SCALE_FAST_REWRITE", 1 << 5),
    ("SCALE_RESTORE_INDEX", dict(capacity=1 << 10)),
    ("SCALE_RESTORE_BLOOM_BITS", 1 << 13),
    ("SCALE_TIER_INDEX", dict(capacity=1 << 10, touch_sample_every=2)),
    ("SCALE_2D_INDEX", dict(capacity=1 << 10)),
    ("SCALE_SIDE_BLOOM_BITS", 1 << 13),
    ("SCALE_TIMEOUT_S", 240.0), ("SCALE_TIMED", False),
    ("SCALE_HARNESSES", (
        ("multihost_bench", ("--procs", "2", "--n", "4096", "--batch",
                             "1024", "--capacity", "4096")),
        ("test_kv", ("--n", "4000", "--batch", "1000", "--capacity", "4096",
                     "--index", "cceh", "--no-engine")),
        ("paging_sim", ("--job", "rand_rw", "--capacity", "2048",
                        "--file-pages", "256", "--ram-pages", "64", "--ops",
                        "400", "--page-words", "64")),
        ("swap_sim", ("--capacity", "2048", "--working-pages", "256",
                      "--ram-pages", "64", "--ops", "400", "--page-words",
                      "64", "--iodepth", "16")),
        ("filebench", ("--personality", "webserver", "--capacity", "2048",
                       "--loops", "4", "--nfiles", "8", "--mean-pages", "4",
                       "--page-words", "64")),
        ("replay", ("--trace", "tests/data/fileserver.trace", "--capacity",
                    "65536", "--batch", "1024")),
        ("multinode", ("--clients", "2", "--capacity", "2048", "--ops",
                       "300", "--file-pages", "128", "--ram-pages", "32",
                       "--page-words", "64")))))


@pytest.fixture
def scale_smoke(smoke, monkeypatch, tmp_path):
    for name, value in SCALE_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "scale_refusal", lambda: None)
    monkeypatch.setattr(chip_smoke, "scale_dir", lambda: tmp_path / "scale")
    return smoke


def test_scale_phase_and_its_kernels_lines(scale_smoke, tmp_path, capfd):
    """Phase 12 at a tiny size: two spawned processes over gloo and a
    one-process group, each filling, deleting and serving a2a and
    broadcast GETs byte-exact with every miss zeroed, the same results on
    every process, one launch per shard per GET phase, the kernel against
    plain in every process; the plane verbs through PlaneBackend in both
    parts; in part (a) the fast lane, the restores of a one-process
    plane's snapshots, the tiered plane and the 2 x 2 grid; then every
    harness as its own process, each held to its own gate."""
    entries = chip_smoke.run_scale(scale_smoke)
    assert [e["path"] for e in entries] == ["scale-gloo", "scale-nccl",
                                            "scale-plane", "scale-tiered"]
    for e in entries:
        assert set(e) == KEYS and e["max_abs_err"] == 0
    assert [e["name"] for e in entries] == ["fused_get_linear_flat"] * 3 + [
        "fused_get_linear_tiered"]
    # every shard of every process, per GET phase (2 a2a + 1 broadcast;
    # 2 plane GETs; 4 tiered GETs)
    assert entries[0]["launches"] == 4 * 3 and entries[1]["launches"] == 4 * 3
    assert entries[2]["launches"] == 4 * 2 and entries[3]["launches"] == 4 * 4
    out = capfd.readouterr().out
    assert "identical on every process" in out
    for line in ("plane verbs through PlaneBackend", "fast lane:",
                 "restore_chain onto 2 shards over 2 processes",
                 "tiered plane", "2 x 2 over 2 processes",
                 "replica_repair repaired"):
        assert line in out, line
    assert not (tmp_path / "scale").exists()
    for name, _ in chip_smoke.SCALE_HARNESSES:
        assert f"harness {name}" in out


def _wrong_page_child(rank, port, p, q):
    """A part (a) process whose plane GETs return one wrong page on rank
    1 (one word of its first hit flipped)."""
    from pmdfc_tpu_torch.parallel.shard import ShardedKV

    if rank == 1:
        real = ShardedKV.plane_get

        def plane_get(self, keys):
            h = real(self, keys)
            fetch = h._fetch

            def wrong():
                g = fetch()
                if g.found.any():
                    routed = np.array(g._routed)
                    routed[g._rb.pos[np.flatnonzero(g.found)[0]], 0] ^= 1
                    g._routed = routed
                return g

            h._fetch = wrong
            return h

        ShardedKV.plane_get = plane_get
    chip_smoke.scale_child(rank, port, p, q)


def test_scale_phase_fails_when_a_plane_get_serves_a_wrong_page(
        scale_smoke, monkeypatch):
    """Part (a) with rank 1's plane GETs serving one wrong page: the
    phase fails at its first plane GET."""
    monkeypatch.setattr(chip_smoke, "SCALE_TIMEOUT_S", 120.0)
    p = chip_smoke.scale_params("gloo")
    with pytest.raises(AssertionError, match="(?s)rank 1 failed.*a hit's page "
                       "differs"):
        chip_smoke.scale_spawn(_wrong_page_child, 2, (p,), "rehearsal")


def _dying_child(rank, port, q):
    import os

    if rank == 1:
        os._exit(3)
    q.put((rank, "ok", {}))


def test_scale_phase_fails_when_a_worker_dies(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SCALE_TIMEOUT_S", 60.0)
    with pytest.raises(AssertionError, match="worker 1 died"):
        chip_smoke.scale_spawn(_dying_child, 2, (), "rehearsal")


def test_scale_harness_gates_fail_on_wrong_bytes(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    ok = {"device": "cpu", "verify_failures": 0}
    chip_smoke.harness_check("swap_sim", (), ok)
    for name, row in (("swap_sim", {**ok, "verify_failures": 2}),
                      ("test_kv", {**ok, "failed_search": 1}),
                      ("replay", {**ok, "wrong_values": 1}),
                      ("multihost_bench", {**ok, "hits": 3, "n": 4}),
                      ("filebench", {**ok, "device": "cuda"})):
        with pytest.raises(AssertionError, match=f"harness {name}"):
            chip_smoke.harness_check(name, (), row)
