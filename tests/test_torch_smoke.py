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

import pytest
import torch

import chip_smoke
from pmdfc_tpu_torch.ops import fused

pytestmark = pytest.mark.torch

KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


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


def test_smoke_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py"])
    assert chip_smoke.main() == 1
    assert '"ok"' not in capsys.readouterr().out
