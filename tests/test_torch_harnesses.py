"""PyTorch port: the bench harnesses that drive the profiler, the row
insert and the controller (`pmdfc_tpu_torch/bench/`).

Each harness's smoke mode runs on the CPU (`--device cpu`, shortened
further by explicit flags where its JAX sizes take longer than a tier-1
case may) and exits 0, and the rows it prints carry the JAX harness's
keys. `bench/common.py`'s backends are built here on the CPU, and its
evidence log refuses an unstamped row.
"""

from __future__ import annotations

import json

import pytest

from pmdfc_tpu_torch.bench import common

pytestmark = pytest.mark.torch

JAX_ROW_KEYS = {
    "insert_rowscatter": {"metric", "device", "n", "element_ns_per_key",
                          "row_ns_per_key", "element_mops", "row_mops",
                          "row_speedup"},
    "net_sweep": {"metric", "value", "unit", "transport", "connections",
                  "window", "verb_keys", "page_words", "rounds",
                  "best_wall_s", "host_evidence", "device", "device_kind"},
    "telemetry_overhead": {"pages_per_s_on", "pages_per_s_off",
                           "overhead_ratio", "overhead_pct", "gate", "pairs",
                           "spans_recorded", "series_windows",
                           "workload_ops", "prof_launches"},
    "autotune_sweep": {"light_p99_ratio", "fanin_rate_ratio", "wrong_bytes",
                       "misses", "knobs_light", "knobs_final", "ctl"},
}


def _last_json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


@pytest.mark.parametrize("name,argv", [
    ("insert_rowscatter", ["--smoke", "--device", "cpu"]),
    ("net_sweep", ["--smoke", "--device", "cpu"]),
    ("telemetry_overhead", ["--smoke", "--device", "cpu", "--pairs", "16",
                            "--gets", "32", "--gate", "100"]),
    ("autotune_sweep", ["--smoke", "--device", "cpu", "--adapt-s", "1.5",
                        "--measure-s", "0.25"]),
])
def test_harness_smoke_runs_on_the_cpu(name, argv, capsys):
    import importlib

    from pmdfc_tpu_torch.runtime import telemetry as tele

    mod = importlib.import_module(f"pmdfc_tpu_torch.bench.{name}")
    try:
        assert mod.main(argv) == 0
    finally:
        tele.configure()
    out = capsys.readouterr().out
    doc = _last_json(out)
    if name == "net_sweep":
        assert doc["rows"] and all(JAX_ROW_KEYS[name] <= set(r)
                                   for r in doc["rows"])
        assert {r["transport"] for r in doc["rows"]} == {"tcp_lockstep",
                                                         "tcp_coalesced"}
    else:
        assert JAX_ROW_KEYS[name] <= set(doc), set(doc)
    if name == "insert_rowscatter":
        assert doc["device"] == "cpu" and doc["batches"] > 0
        assert "equivalence: 40 randomized batches OK" in out
    if name == "telemetry_overhead":
        assert doc["prof_launches"] > 0 and doc["spans_recorded"] > 0
    if name == "autotune_sweep":
        assert doc["ctl"]["decisions"] > 0 and doc["wrong_bytes"] == 0
        assert "smoke OK" in out


def test_common_backends_and_history(tmp_path, capsys):
    import numpy as np

    keys = np.stack([np.full(8, 1, np.uint32),
                     np.arange(8, dtype=np.uint32)], -1)
    pages = np.arange(8 * 16, dtype=np.uint32).reshape(8, 16)
    for kind in ("local", "direct", "engine"):
        be, closer = common.build_backend(kind, 16, 1 << 10, device="cpu")
        try:
            be.put(keys, pages)
            out, found = be.get(keys)
            assert found.all() and (np.asarray(out) == pages).all()
        finally:
            closer()
    row = {"metric": "m", "value": 1}
    common.stamp_live_device(row, backend="direct", device="cpu")
    assert row["device"] == "cpu" and row["device_kind"] == "cpu"
    log = tmp_path / "hist.jsonl"
    common.append_history(str(log), row)            # off-card: skipped
    common.append_history(str(log), {"metric": "x"})  # unstamped: refused
    assert "no device stamp" in capsys.readouterr().err
    common.append_history(str(log), {**row, "host_evidence": True})
    lines = log.read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["host_evidence"]
