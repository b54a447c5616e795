"""PyTorch port: `chip_smoke.py`'s phase 13 (`tail`) rehearsed on the CPU.

The phase runs the bench tail's harnesses on the card. Here it runs on
the CPU at tiny sizes, with the card-only calls stood in for as
`tests/test_torch_smoke.py` stands them in (CUDA events by the host
clock, the kernel's launch count by a count of the wrapper's calls), and
with `launches_per_get` reading one launch per GET so the harnesses hold
the card's launch rule: fused_get and tier_sweep in this process, their
launches counted, beside mesh_sweep, the soak and every host-bound
harness, each its own process with `--device cpu` (tiny sizes), side by
side.
The mutation cases show the phase fails when a composed-side GET
secretly launches the kernel and when a harness serves one wrong byte.
"""

from __future__ import annotations

import json

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

import chip_smoke
from test_torch_smoke import KEYS, smoke  # noqa: F401  (fixture)

pytestmark = pytest.mark.torch


@pytest.fixture
def tail(smoke, monkeypatch):  # noqa: F811
    from pmdfc_tpu_torch.bench import common

    monkeypatch.setattr(common, "launches_per_get", lambda device: 1)
    monkeypatch.setattr(chip_smoke, "TAIL_FUSED", (("linear", 1 << 11),
                                                   ("cceh", 1 << 11)))
    monkeypatch.setattr(chip_smoke, "TAIL_FUSED_ARGS", dict(
        page_words=64, fill=0.75, batches=[128, 512], gets=1 << 10,
        zipfs=[0.0, 0.99]))
    monkeypatch.setattr(chip_smoke, "TAIL_TIER_ARGS", dict(
        capacity=1 << 12, page_words=64, batch=128, gets=1 << 11,
        zipfs=[0.99], hot_fraction=16))
    monkeypatch.setattr(chip_smoke, "TAIL_WIDTHS", (64, 256))
    monkeypatch.setattr(chip_smoke, "TAIL_TIMED_W", 256)
    mesh = ("--shards", "1,2", "--connections", "2", "--window", "2",
            "--gets", "4", "--rounds", "1", "--preload", "512",
            "--capacity", str(1 << 12))
    monkeypatch.setattr(chip_smoke, "TAIL_LANE_RUNS", tuple(
        (name, mesh if name == "mesh_sweep" else ("--smoke",))
        for name, _ in chip_smoke.TAIL_LANE_RUNS))
    return smoke


def test_tail_phase_and_its_kernels_lines(tail, capsys):
    entries = chip_smoke.run_tail(tail)
    assert {e["name"] for e in entries} == {
        "fused_get_linear_flat", "fused_get_cceh_flat",
        "fused_get_linear_tiered"}
    for e in entries:
        assert set(e) == KEYS and e["path"] == "tail"
        assert e["launches"] > 0 and e["max_abs_err"] == 0
        assert e["bound_by"] == "bytes" and e["library_ms"] is None
    out = capsys.readouterr().out
    assert out.count("[tail] fused_get linear·flat zipf") == 4
    assert out.count("[tail] fused_get cceh·flat zipf") == 4
    assert "composed chain" in out and "[tail] tier_sweep zipf 0.99" in out
    for name, _ in chip_smoke.TAIL_LANE_RUNS:
        assert f"[tail] harness {name} " in out, name
    assert "[tail] phase 13 took" in out
    json.dumps(entries)


@pytest.fixture
def tail_alone(tail, monkeypatch):
    """Phase 13 without the harness processes: the in-process sweeps."""
    monkeypatch.setattr(chip_smoke, "TAIL_LANE_RUNS", ())
    return tail


def test_tail_fails_when_the_composed_side_launches_the_kernel(
        tail_alone, monkeypatch):
    from pmdfc_tpu_torch import kv as kv_mod
    from pmdfc_tpu_torch.ops import fused

    def composed(state, config, keys, lean=False, recovering=False):
        return fused.get_core(state, config, keys, lean=lean,
                              recovering=recovering)

    monkeypatch.setattr(kv_mod, "_get_core", composed)
    with pytest.raises(AssertionError, match="composed side \\+1"):
        chip_smoke.run_tail(tail_alone)


def test_tail_fails_when_a_harness_serves_one_wrong_byte(tail_alone,
                                                         monkeypatch):
    from pmdfc_tpu_torch import kv as kv_mod

    real = kv_mod.KV.get
    done = []

    def get(self, keys):
        out, found = real(self, keys)
        if not done and found.any():
            done.append(1)
            out = out.copy()
            out[found.nonzero()[0][0], 7] ^= 1 << 20
        return out, found

    monkeypatch.setattr(kv_mod.KV, "get", get)
    with pytest.raises(AssertionError, match="1 hits with wrong bytes"):
        chip_smoke.run_tail(tail_alone)


def test_tail_fails_on_a_lane_harness_gate(tail, monkeypatch):
    """A lane harness whose row breaks its gate fails the phase even when
    the process exited 0."""
    monkeypatch.setattr(chip_smoke, "TAIL_LANE_RUNS",
                        (("recovery_soak", ("--smoke",)),))
    real = chip_smoke.run_harness

    def run_harness(name, args):
        row = real(name, args)
        row["miss_recovering"] = 0
        return row

    monkeypatch.setattr(chip_smoke, "run_harness", run_harness)
    with pytest.raises(AssertionError, match="miss_recovering 0"):
        chip_smoke.run_tail(tail)
