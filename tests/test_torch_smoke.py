"""PyTorch port: `chip_smoke.py`'s phases rehearsed on the CPU.

The smoke runs only on a GPU, at the serving size. Here its phases run on
the CPU at a tiny size (2^13 slots, 2^10-key inserts, 2^8-key GETs), with
the card-only calls stood in for: CUDA events by the host clock, the
stream sleep and synchronize by no-ops, and the kernel's launch count by
a count of the wrapper's calls (on CPU tensors it runs the plain
version). That holds every check the smoke makes on the card — kernel
against plain on every small state (flat and tiered, all eight causes on
the tiered ones), all four main paths byte-exact, the recovery drill, the
extents, find_anyway, the tiered paths' promotions, in-place updates,
deletes and balloon shrink/grow — to the code as it stands, before a chip
call. Times printed here are CPU times and mean nothing.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import chip_smoke
from pmdfc_tpu_torch.ops import fused

pytestmark = pytest.mark.torch

KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path"}


class _HostEvent:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "CPU rehearsal")
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "INS_B", 1 << 10)
    monkeypatch.setattr(chip_smoke, "GET_B", 1 << 8)
    monkeypatch.setattr(chip_smoke, "HOT_SET", 1 << 7)
    monkeypatch.setattr(chip_smoke, "LINEAR_INDEX", dict(capacity=1 << 13))
    monkeypatch.setattr(chip_smoke, "CCEH_INDEX",
                        dict(capacity=1 << 12, segment_slots=256))
    plain = fused.fused_get

    def counted(keys, *args, **kw):
        out = plain(keys, *args, **kw)
        family = "cceh" if kw.get("dirr") is not None else "linear"
        pool = "tiered" if kw.get("cgen") is not None else "flat"
        fused.launches[f"fused_get_{family}_{pool}"] += 1
        return out

    monkeypatch.setattr(fused, "fused_get", counted)
    return chip_smoke.Smoke(0)


@pytest.mark.parametrize("kind,s,tiered", [
    ("linear", 16, False), ("cceh", 32, False), ("extendible", 32, False),
    ("linear", 32, True), ("cceh", 16, True), ("extendible", 32, True)])
def test_kernel_phase_on_a_small_state(smoke, kind, s, tiered, capsys):
    kv, pool, present, covers = smoke.small_state(kind, s, tiered)
    assert kv.state.index.table.device.type == "cpu"
    smoke.kernel_phase(kv, pool, present, covers, f"small {kind} S={s}")
    assert max(smoke.max_err.values()) == 0
    if tiered:  # all eight causes at w >= 2^10, checked by kernel_phase
        assert "ghost readmits" in capsys.readouterr().out


@pytest.mark.parametrize("run", ["run_linear", "run_cceh"])
def test_main_path_and_its_kernels_line(smoke, run, capsys):
    entry = getattr(chip_smoke, run)(smoke)
    assert set(entry) == KEYS
    assert entry["launches"] > 0 and entry["max_abs_err"] == 0
    assert entry["name"] == f"fused_get_{run[4:]}_flat"
    assert entry["bound_by"] == "bytes" and entry["library_ms"] is None
    out = capsys.readouterr().out
    if run == "run_cceh":
        assert "recovery()" in out and "find_anyway" in out
        assert "addresses exact" in out


@pytest.mark.parametrize("kind", ["linear", "cceh"])
def test_tiered_main_path_and_its_kernels_line(smoke, kind, capsys):
    entry = chip_smoke.run_tiered(smoke, kind)
    assert set(entry) == KEYS
    assert entry["name"] == f"fused_get_{kind}_tiered"
    assert entry["launches"] > 0 and entry["max_abs_err"] == 0
    assert entry["bound_by"] == "bytes" and entry["library_ms"] is None
    out = capsys.readouterr().out
    assert "all hit byte-exact from hot rows" in out
    assert "missed as miss_stale" in out and "fresh keys hit" in out
    assert ("admit_state" in out) == (kind == "cceh")


def test_families_phase(smoke, monkeypatch, capsys):
    """The families phase over 2^13 requested slots per family: each fills,
    serves byte-exact (every present key hits), deletes, and its table's
    scan holds exactly the present keys; HotRing's decay fires through
    `KV` and its mirror drill passes; no family takes the fused GET."""
    monkeypatch.setattr(chip_smoke, "FAMILY_INDEX", dict(capacity=1 << 13))
    monkeypatch.setattr(chip_smoke, "HOT_GETS", 1 << 14)
    monkeypatch.setattr(chip_smoke, "POLICY_CAPACITY", 1 << 11)
    monkeypatch.setattr(chip_smoke, "POLICY_B", 1 << 7)
    assert chip_smoke.run_families(smoke) is None
    out = capsys.readouterr().out
    for kind in chip_smoke.FAMILIES:
        assert f"[families] {kind}: num_slots" in out
        assert f"[families] {kind}: fill" in out
        assert f"[families] {kind} torch.profiler, KV.get" in out
        assert f"[main] {kind} serve after the timed inserts" in out
    assert "[families] level: num_slots 12288" in out
    assert "hotring mirror: 1 decay(s) through KV after 16384 GET keys" in out
    assert "served their new bytes from the table" in out
    for policy in ("lru", "lfu", "fifo"):
        assert f"[families] policy cache {policy} on cpu: every get" in out


def test_profiled_inserts_are_checked(smoke, monkeypatch):
    """The families phase's profiled inserts of fresh keys (past the 75%
    fill) are real verbs: one that raises fails the phase instead of being
    reported as an unmeasured profile."""
    monkeypatch.setattr(chip_smoke, "FAMILY_INDEX", dict(capacity=1 << 13))
    n_fill = (3 * 8192 // 4) // chip_smoke.INS_B * chip_smoke.INS_B
    kv_cls = smoke.kv_mod.KV
    real = kv_cls.insert

    def insert(self, keys, *a, **k):
        if int(keys[:, 1].min()) >= n_fill:
            raise RuntimeError("an insert past the fill failed")
        return real(self, keys, *a, **k)

    monkeypatch.setattr(kv_cls, "insert", insert)
    with pytest.raises(RuntimeError, match="past the fill failed"):
        chip_smoke.run_family(smoke, "static")


def test_profile_breakdown_reports_only_its_own_failure(smoke, monkeypatch):
    """An exception from the profiled function propagates; a profiler that
    cannot start is reported as "not measured", and the function still
    runs 1 + iters times."""
    import torch.profiler

    def boom():
        raise RuntimeError("the verb failed")

    with pytest.raises(RuntimeError, match="the verb failed"):
        chip_smoke.profile_breakdown(torch, boom, 2)

    class Broken:
        def __init__(self, **_):
            pass

        def start(self):
            raise RuntimeError("no tracer")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    calls = []
    line = chip_smoke.profile_breakdown(torch, lambda: calls.append(1), 2)
    assert line.startswith("not measured") and "no tracer" in line
    assert len(calls) == 3


def test_serving_path_and_its_kernels_line(smoke, monkeypatch, capsys):
    """The serving path at 2 clients x 2 threads over 2^12 slots: the fill
    through the engine, the push, the mirror check, the GET storm, the
    extents, and kernel against plain on the server's state."""
    for name, value in (("SERVE_INDEX", dict(capacity=1 << 12)),
                        ("SERVE_BLOOM_BITS", 1 << 18),
                        ("SERVE_ENGINE", dict(num_queues=4, queue_cap=1 << 10,
                                              batch=1 << 10, arena_pages=256,
                                              page_bytes=4096)),
                        ("CLIENT_GROUPS", 2), ("GROUP_THREADS", 2),
                        ("VERB", 1 << 6), ("GET_VERBS", 4),
                        ("SERVE_EXTENTS", 16), ("BF_PUSH_S", 0.01),
                        ("PUT_ODD", 185)):
        monkeypatch.setattr(chip_smoke, name, value)
    entry = chip_smoke.run_serving(smoke)
    assert set(entry) == KEYS and entry["path"] == "serving"
    assert entry["name"] == "fused_get_linear_flat"
    assert entry["launches"] > 0 and entry["max_abs_err"] == 0
    assert entry["bound_by"] == "bytes" and entry["library_ms"] is None
    out = capsys.readouterr().out
    assert "[serve] checks passed" in out and "every address exact" in out
    assert "kernel == plain" in out
    assert "of 185 pages (padded to 256)" in out  # the quiet flushes' line


WIRE_TINY = (("WIRE_INDEX", dict(capacity=1 << 12)),
             ("WIRE_BLOOM_BITS", 1 << 18), ("WIRE_CLIENTS", 2),
             ("WIRE_CONNS", 2), ("VERB", 1 << 6), ("WIRE_DIRECT", 3584),
             ("WIRE_FILL", 512), ("WIRE_GETS", 512), ("WIRE_EXTENTS", 8),
             ("WIRE_FAST_CONNS", 2), ("WIRE_FAST_KEYS", 256),
             ("WIRE_REWRITE", 64), ("POOL_ROWS", 1 << 10),
             ("POOL_CLIENTS", 2), ("POOL_PAGES", 128), ("BF_PUSH_S", 0.01))


def test_wire_path_and_its_kernels_line(smoke, monkeypatch, capsys):
    """The wire phase at 2 clients x 2 connections over 2^12 slots: the
    pre-fill, the fill over TCP, the push and mirror check, the storm, the
    extents, the fast-lane passes around rewrites and invalidates, the
    recovering batch, kernel against plain at the widths the phase
    launched, and the one-sided sub-phase."""
    for name, value in WIRE_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    entry = chip_smoke.run_wire(smoke)
    assert set(entry) == KEYS and entry["path"] == "wire"
    assert entry["name"] == "fused_get_linear_flat"
    assert entry["launches"] > 0 and entry["max_abs_err"] == 0
    assert entry["bound_by"] == "bytes" and entry["library_ms"] is None
    out = capsys.readouterr().out
    assert "[wire] checks passed" in out and "served no old byte" in out
    assert "[kernel] wire full w=" in out
    assert "directory_snapshot:" in out
    assert "[onesided] write" in out and "read back byte-exact" in out


def test_wire_phase_fails_when_a_get_phase_fails(smoke, monkeypatch):
    """A fused GET that raises inside a wire flush is contained by the
    server (bisected, culprits answered MSG_NACK, a legal miss for the
    client): the wire phase must still fail."""
    for name, value in WIRE_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    counted = fused.fused_get
    calls = [0]

    def failing(keys, *args, **kw):
        calls[0] += 1
        if calls[0] == 5:
            raise RuntimeError("injected kernel failure")
        return counted(keys, *args, **kw)

    monkeypatch.setattr(fused, "fused_get", failing)
    # the server retries the failed phase in halves, so the clients may
    # even get every page: only the phase check can see the failure
    with pytest.raises(AssertionError, match="wire: a phase failed"):
        chip_smoke.run_wire(smoke)


@pytest.mark.parametrize("lie", [False, True])
def test_quiet_flushes_check_what_they_serve(smoke, monkeypatch, capsys,
                                             lie):
    """The quiet flushes on a small served state: they log their times, and
    a GET flush whose statuses disagree with `KV.get` (every status forced
    to 0 here) fails the path instead of being left out as a
    measurement."""
    from types import SimpleNamespace

    from pmdfc_tpu_torch.config import IndexConfig, KVConfig
    from pmdfc_tpu_torch.runtime import KVServer

    monkeypatch.setattr(chip_smoke, "PUT_ODD", 185)
    n = 1 << 10
    srv = KVServer(KVConfig(index=IndexConfig(capacity=1 << 12)),
                   device="cpu")
    lo = np.arange(n, dtype=np.uint32)
    hi = np.full(n, chip_smoke.SERVE_HI, np.uint32)
    keys = np.stack([hi, lo], -1)
    srv.kv.insert(keys, chip_smoke.pages_np(hi, lo, srv.config.page_words))
    srv.kv.delete(keys[-64:])
    client = SimpleNamespace(n_fill=n, tid=0, inval=lo[-64:])
    path = chip_smoke.ServePath(smoke, srv.kv, [client], 1.0)
    if lie:
        real = KVServer._finalize

        def lying(self, reqs, handles):
            if self.engine.num_queues == 1:  # the probe's engine
                complete = self.engine.complete
                self.engine.complete = lambda ids, st: complete(
                    ids, np.zeros_like(st))
            real(self, reqs, handles)

        monkeypatch.setattr(KVServer, "_finalize", lying)
        with pytest.raises(AssertionError, match="disagrees with KV.get"):
            chip_smoke.quiet_flushes(smoke, srv, path)
    else:
        chip_smoke.quiet_flushes(smoke, srv, path)
        out = capsys.readouterr().out
        assert "of 185 pages (padded to 256)" in out
        assert "torch.profiler of the quiet GET flush" in out


def test_client_threads_share_one_phase_deadline(monkeypatch):
    """A serving phase's client threads are joined by one deadline: a phase
    whose threads all outrun it fails whichever thread ends last (a
    timeout per join let a late thread pass when a later one outlasted
    it); threads inside it pass."""
    monkeypatch.setattr(chip_smoke, "PHASE_TIMEOUT_S", 0.3)
    assert chip_smoke.run_threads([lambda: time.sleep(0.05)] * 2, "ok") < 0.3
    with pytest.raises(AssertionError, match="did not finish within 0.3 s"):
        chip_smoke.run_threads([lambda: time.sleep(0.5),
                                lambda: time.sleep(0.55)], "late")


def test_smoke_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py"])
    assert chip_smoke.main() == 1
    assert '"ok"' not in capsys.readouterr().out


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
    and the 2-D storm fails."""
    from pmdfc_tpu_torch.ops.pagepool import page_digest
    from pmdfc_tpu_torch.parallel.shard import ShardedKV

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
