"""PyTorch port: the seven `tests/test_xray.py` drills that
`test_torch_xray.py` ran through the port alone, on both packages.

The schema drills (the v2 snapshot with its series and v1 fields, the
`check_teledump` pins, the SLO breach dump's series tail) are
deterministic: each runs on each package's fresh registry and the two
transcripts must be equal (the document's keys, the checker's verdicts,
the breach window's p99). The threaded and clocked drills (concurrent
writers, the collector daemon's exit on a registry swap, the workload
window's roll) run on both packages under the JAX drill's own
invariants. The acceptance soak (`slow` in JAX; on the card phase 14
(b) at 2^16 slots a shard) runs the JAX drill itself and the port's
`chip_smoke.run_xray` rehearsal at the JAX drill's size.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
import types

import numpy as np
import pytest
import test_torch_xray as txray
import test_xray as jxray
import torch_threads  # noqa: F401 (one torch thread a worker)
from test_torch_smoke import smoke  # noqa: F401 (the fixture)
from torch_twin import JAX as _JAX
from torch_twin import PORT as _PORT
from torch_twin import fresh_jax_registry, registries, same  # noqa: F401
from torch_twin import twin as twin_of

import pmdfc_tpu.runtime.slo as jslo
import pmdfc_tpu_torch.runtime.slo as tslo
from tools import check_teledump as chk

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

JAX = types.SimpleNamespace(**vars(_JAX), name="jax", slo=jslo)
PORT = types.SimpleNamespace(**vars(_PORT), name="port", slo=tslo)
PKGS = (JAX, PORT)


def twin(drill, *args):
    return twin_of(drill, *args, pkgs=PKGS)


def _fresh(p):
    return p.tele.configure(p.config.TelemetryConfig(enabled=True))


def _keys(n, seed=0, space=1 << 20):
    rng = np.random.default_rng(seed)
    flat = rng.choice(space, size=n, replace=False)
    return np.stack([flat >> 10, flat & 0x3FF], -1).astype(np.uint32)


def test_series_concurrent_writers():
    def drill(p):
        _fresh(p)
        c = p.tele.scope("xr").counter("ops")
        col = p.ts.Collector(interval_s=0.001, capacity=256)
        col.tick()
        stop = threading.Event()

        def writer():
            while not stop.is_set():
                c.inc(1)

        ths = [threading.Thread(target=writer) for _ in range(4)]
        for t in ths:
            t.start()
        for _ in range(50):
            col.tick()
        stop.set()
        for t in ths:
            t.join()
        final = col.tick()
        sampled = sum(w["counters"].get("xr0.ops", 0)
                      for w in col.ring.tail())
        assert final is not None and sampled == c.value, (p.name, sampled)
        return True

    twin(drill)


def test_collector_daemon_dies_with_registry_swap():
    def drill(p):
        _fresh(p)
        col = p.ts.ensure_collector(interval_s=0.01)
        assert p.ts.ensure_collector() is col
        th = col._thread
        assert th is not None and th.is_alive()
        _fresh(p)
        th.join(timeout=2)
        assert not th.is_alive(), p.name
        return True

    twin(drill)


def test_snapshot_v2_carries_series_and_v1_fields():
    def drill(p):
        _fresh(p)
        col = p.ts.ensure_collector(interval_s=0.01)
        p.tele.scope("xr").inc("ops", 3)
        col.tick()
        col.tick()
        snap = p.tele.snapshot()
        assert snap["schema"] == "pmdfc-telemetry-v2"
        for k in ("enabled", "counters", "gauges", "histograms", "ring"):
            assert k in snap
        assert snap["series"]["windows"], snap["series"]
        v1 = json.loads(json.dumps(snap))
        v1["schema"] = "pmdfc-telemetry-v1"
        del v1["series"]
        verdicts = (chk.check({"telemetry": snap}),
                    chk.check({"telemetry": v1}))
        assert verdicts == ([], [])
        last = snap["series"]["windows"][-1]
        return (sorted(snap), sorted(snap["series"]), sorted(last),
                snap["counters"].get("xr0.ops"), verdicts)

    twin(drill)


def test_workload_window_rolls():
    def drill(p):
        sketch = p.wl.WorkloadSketch(window_s=0.01)
        sketch.observe(_keys(50, seed=9))
        time.sleep(0.02)
        sketch.observe(_keys(60, seed=10))
        snap = sketch.snapshot()
        assert snap["window"]["ops"] in (50, 60)
        assert snap["ops"] == 110 and snap["working_set"] > 80
        return snap["ops"], sorted(snap), sorted(snap["window"])

    twin(drill)


def test_check_teledump_pins_v2():
    def drill(p):
        _fresh(p)
        col = p.ts.ensure_collector(interval_s=0.01)
        p.tele.scope("xr").inc("ops", 2)
        col.tick()
        col.tick()
        doc = {"telemetry": p.tele.snapshot(),
               "workload": p.wl.WorkloadSketch().snapshot(),
               "gets": 10, "misses": 4, "miss_cold": 3, "miss_evicted": 1}
        for k in p.kv_mod.MISS_CAUSE_NAMES:
            doc.setdefault(k, 0)
        doc = json.loads(json.dumps(doc))
        found = [chk.check(doc) == []]
        bad = json.loads(json.dumps(doc))
        bad["miss_cold"] = 99
        found.append(any("drift" in e for e in chk.check(bad)))
        bad2 = json.loads(json.dumps(doc))
        bad2["shard_report"] = {"n_shards": 2, "stats": {
            k: [0, 0] for k in p.kv_mod.MISS_CAUSE_NAMES}}
        bad2["shard_report"]["stats"].update(misses=[2, 2],
                                             miss_cold=[2, 1])
        found.append(any("shard 1" in e for e in chk.check(bad2)))
        bad3 = json.loads(json.dumps(doc))
        bad3["workload"]["heat"]["skew"] = 7.0
        found.append(any("skew" in e for e in chk.check(bad3)))
        bad4 = json.loads(json.dumps(doc))
        bad4["telemetry"]["series"]["windows"][0]["dt_s"] = "fast"
        found.append(any("dt_s" in e for e in chk.check(bad4)))
        bad5 = json.loads(json.dumps(doc))
        del bad5["telemetry"]["series"]
        found.append(any("series" in e for e in chk.check(bad5)))
        assert all(found), (p.name, found)
        return found, sorted(doc["workload"])

    twin(drill)


def test_slo_breach_dump_carries_series_tail(tmp_path):
    def drill(p):
        root = tmp_path / p.name
        reg = p.tele.configure(p.config.TelemetryConfig(
            enabled=True, dump_dir=str(root), dump_min_interval_s=0.0))
        col = p.ts.Collector(interval_s=0.01, registry=reg)
        sc = p.tele.scope("slo_xr2")
        h = sc.hist("get_us")
        wd = p.slo.SloWatchdog(p.slo.SloConfig(
            targets=(p.slo.SloTarget(name="p99", kind="latency_p99",
                                     metric=f"{sc.prefix}.get_us",
                                     threshold=100.0),),
            burn_windows=2, min_count=4))
        wd.tick()
        for _ in range(2):
            for _ in range(8):
                h.observe(50000.0)
            col.tick()
            wd.tick()
        dumps = sorted(glob.glob(str(root / "flight_slo_breach_*.json")))
        assert dumps, os.listdir(root)
        doc = json.load(open(dumps[-1]))
        assert doc["schema"] == "pmdfc-flight-v2"
        series = doc["series"]["windows"]
        assert len(series) >= 2
        metric = f"{sc.prefix}.get_us"
        breach_w = [w for w in series if metric in w["hists"]]
        p99 = breach_w[-1]["hists"][metric]["p99"]
        assert p99 > 100.0 and chk.check_flight(doc) == []
        return doc["schema"], len(dumps), len(breach_w), p99, \
            wd.stats["breaches"]

    twin(drill)


def test_xray_acceptance_soak_and_teletop(smoke, monkeypatch,  # noqa: F811
                                          capsys):
    """The JAX drill itself (4-shard coalesced plane, zipf soak with a
    balloon shrink and ChaosProxy faults, teletop against two servers),
    then the port's phase 14 (b) rehearsal at the JAX drill's size."""
    reg = JAX.tele.configure(JAX.config.TelemetryConfig(enabled=True))
    jxray.test_xray_acceptance_soak_and_teletop(reg)
    txray.test_xray_acceptance_soak_and_teletop(smoke, monkeypatch, capsys)
