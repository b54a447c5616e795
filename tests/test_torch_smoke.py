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
call. Times printed here are CPU times and mean nothing. This file holds
phases 3–8; `test_torch_smoke_cluster.py` phases 9–12 and
`test_torch_smoke_tail.py` phase 13, both on this file's `smoke` fixture.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

import chip_smoke
from pmdfc_tpu_torch.ops import fused

pytestmark = pytest.mark.torch

KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path"}

# the function itself: the `smoke` fixture caps its windows
PROFILE_BREAKDOWN = chip_smoke.profile_breakdown


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
    # the times printed here mean nothing: each timing loop runs its
    # calls (the same code) twice, each profiled window once
    time_ms = chip_smoke.time_ms
    monkeypatch.setattr(
        chip_smoke, "time_ms",
        lambda torch, fns, iters, warmup=3, device_only=False: time_ms(
            torch, fns, min(iters, 2), min(warmup, 1), device_only))
    monkeypatch.setattr(
        chip_smoke, "profile_breakdown",
        lambda torch, fn, iters: PROFILE_BREAKDOWN(torch, fn, 1))
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "CPU rehearsal")
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "INS_B", 1 << 10)
    monkeypatch.setattr(chip_smoke, "GET_B", 1 << 8)
    monkeypatch.setattr(chip_smoke, "HOT_SET", 1 << 7)
    monkeypatch.setattr(chip_smoke, "EXTENTS", 40)
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
    """The families phase over 2^12 requested slots per family: each fills,
    serves byte-exact (every present key hits), deletes, and its table's
    scan holds exactly the present keys; HotRing's decay fires through
    `KV` and its mirror drill passes; no family takes the fused GET."""
    monkeypatch.setattr(chip_smoke, "FAMILY_INDEX", dict(capacity=1 << 12))
    monkeypatch.setattr(chip_smoke, "HOT_GETS", 1 << 13)
    monkeypatch.setattr(chip_smoke, "POLICY_CAPACITY", 1 << 11)
    monkeypatch.setattr(chip_smoke, "POLICY_B", 1 << 7)
    assert chip_smoke.run_families(smoke) is None
    out = capsys.readouterr().out
    for kind in chip_smoke.FAMILIES:
        assert f"[families] {kind}: num_slots" in out
        assert f"[families] {kind}: fill" in out
        assert f"[families] {kind} torch.profiler, KV.get" in out
        assert f"[main] {kind} serve after the timed inserts" in out
    assert "[families] level: num_slots 6144" in out
    assert "hotring mirror: 1 decay(s) through KV after 8192 GET keys" in out
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
        PROFILE_BREAKDOWN(torch, boom, 2)

    class Broken:
        def __init__(self, **_):
            pass

        def start(self):
            raise RuntimeError("no tracer")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    calls = []
    line = PROFILE_BREAKDOWN(torch, lambda: calls.append(1), 2)
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
