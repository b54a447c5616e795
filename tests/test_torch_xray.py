"""PyTorch port: `tests/test_xray.py`'s twins.

The windowed series (`DeltaTracker`, `SeriesRing`, `Collector`), the
miss-cause drills (flat, tiered, parked/nopage, extents and the sharded
arbitration), the workload sketches (`KmvSketch`, `HeatSketch`), the SLO
watchdog over the shared windows and the Prometheus labels run through
both packages on one seed: windows, estimates, rendered text and the
whole stats document (all 19 counters, stronger than the JAX test's
sums) must be equal. The timing-dependent drills (concurrent writers,
the collector daemon, window rolling) and the schema pins
(`tools/check_teledump.py` over the port's own snapshot, the breach
dump's series tail) run through the port. The acceptance soak (`slow` in
the JAX suite) runs here at the JAX test's size through
`chip_smoke.run_xray`, which phase 14 runs on the card at 2^16 slots a
shard: every hit byte-exact, `misses == Σ miss_*` on every surface and
shard row, and the port's `teletop --once --json` against two live port
servers.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from test_torch_chaos import CHAOS_TINY
from test_torch_smoke import smoke  # noqa: F401 (the fixture)
from torch_twin import JAX, PKGS, PORT, counters, registries  # noqa: F401
from torch_twin import walk_in_reverse

import chip_smoke
from tools import check_teledump as chk

pytestmark = pytest.mark.torch

W = 16


def _cfg(p, capacity=1 << 10, tier=None):
    c = p.config
    return c.KVConfig(index=c.IndexConfig(capacity=capacity),
                      bloom=c.BloomConfig(num_bits=1 << 15), page_words=W,
                      tier=None if tier is None else c.TierConfig(**tier))


def _keys(n, seed=0, space=1 << 20):
    rng = np.random.default_rng(seed)
    flat = rng.choice(space, size=n, replace=False)
    return np.stack([flat >> 10, flat & 0x3FF], -1).astype(np.uint32)


def _pages(keys):
    return ((keys[:, 0] * np.uint32(31) + keys[:, 1])[:, None]
            + np.arange(1, W + 1, dtype=np.uint32)[None, :])


def _reconciled(p, st):
    names = p.kv_mod.MISS_CAUSE_NAMES
    assert int(st["misses"]) == sum(int(st[k]) for k in names), st


def _fresh(p):
    return p.tele.configure(p.config.TelemetryConfig(enabled=True))


def _both(script):
    a, b = (script(p) for p in PKGS)
    assert a == b, f"jax {a}\nport {b}"
    return b


# --- 1. windowed time-series ----------------------------------------------


def test_delta_tracker_windows():
    def script(p):
        _fresh(p)
        sc = p.tele.scope("xr")
        c, h = sc.counter("ops"), sc.hist("lat_us")
        tr = p.ts.DeltaTracker()
        out = [tr.counter_window("c", c)]
        c.inc(5)
        out += [tr.counter_window("c", c), tr.counter_window("c", c),
                tr.hist_window("h", h)]
        for v in (100.0, 200.0, 400.0, 100000.0):
            h.observe(v)
        q, live = tr.window_quantiles("h", h), h.snapshot()
        out += [q, live["count"], live["p99"], live["p50"]]
        h.observe(7.0)
        out.append(tr.window_quantiles("h", h))
        c2 = p.tele.Counter()
        c2.inc(100)
        out.append(tr.counter_window("c", c2))
        return out

    out = _both(script)
    assert out[:4] == [None, 5, 0, None]
    q, count, p99, p50, q2, rearmed = out[4:]
    assert q["count"] == 4 == count and q["p99"] == p99 and q["p50"] == p50
    assert q2["count"] == 1 and q2["p50"] <= 8.0 and rearmed is None


def test_series_ring_wraparound_and_sparse_windows():
    def script(p):
        _fresh(p)
        sc = p.tele.scope("xr")
        c, idle = sc.counter("ops"), sc.counter("idle")
        col = p.ts.Collector(interval_s=0.01, capacity=4)
        col.tick()
        for i in range(6):
            c.inc(i + 1)
            col.tick()
        tail = col.ring.tail()
        snap = col.ring.snapshot(2)
        return ([w["counters"] for w in tail], idle.value,
                snap["capacity"], len(snap["windows"]))

    wins, idle, cap, n = _both(script)
    assert [w["xr0.ops"] for w in wins] == [3, 4, 5, 6]
    assert all("xr0.idle" not in w for w in wins)
    assert idle == 0 and cap == 4 and n == 2


def test_series_concurrent_writers():
    sc = PORT.tele.scope("xr")
    c = sc.counter("ops")
    col = PORT.ts.Collector(interval_s=0.001, capacity=256)
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
    sampled = sum(w["counters"].get("xr0.ops", 0) for w in col.ring.tail())
    assert final is not None and sampled == c.value


def test_collector_daemon_dies_with_registry_swap():
    col = PORT.ts.ensure_collector(interval_s=0.01)
    assert PORT.ts.ensure_collector() is col
    th = col._thread
    assert th is not None and th.is_alive()
    _fresh(PORT)
    th.join(timeout=2)
    assert not th.is_alive()


def test_snapshot_v2_carries_series_and_v1_fields():
    col = PORT.ts.ensure_collector(interval_s=0.01)
    PORT.tele.scope("xr").inc("ops", 3)
    col.tick()
    col.tick()
    snap = PORT.tele.snapshot()
    assert snap["schema"] == "pmdfc-telemetry-v2"
    for k in ("enabled", "counters", "gauges", "histograms", "ring"):
        assert k in snap
    assert snap["series"]["windows"], snap["series"]
    assert chk.check({"telemetry": snap}) == []
    v1 = json.loads(json.dumps(snap))
    v1["schema"] = "pmdfc-telemetry-v1"
    del v1["series"]
    assert chk.check({"telemetry": v1}) == []


def test_slo_watchdog_breaches_on_shared_windows():
    import pmdfc_tpu.runtime.slo as jslo
    import pmdfc_tpu_torch.runtime.slo as tslo

    def script(p):
        slo = jslo if p is JAX else tslo
        _fresh(p)
        sc = p.tele.scope("slo_xr")
        h = sc.hist("get_us")
        wd = slo.SloWatchdog(slo.SloConfig(
            targets=(slo.SloTarget(name="p99", kind="latency_p99",
                                   metric=f"{sc.prefix}.get_us",
                                   threshold=1000.0),),
            burn_windows=2, min_count=4))
        out = [len(wd.tick())]
        for n, v in ((8, 50000.0), (8, 50000.0), (8, 10.0), (1, 90000.0)):
            for _ in range(n):
                h.observe(v)
            out.append([b["value"] for b in wd.tick()])
        return out, wd.stats["breaches"], wd.stats["starved_windows"]

    ticks, breaches, starved = _both(script)
    assert ticks[0] == 0 and ticks[1] == [] and len(ticks[2]) == 1
    assert ticks[2][0] > 1000.0 and ticks[3] == [] and ticks[4] == []
    assert breaches == 1 and starved >= 1


# --- 2. miss-cause taxonomy -------------------------------------------------


def test_causes_cold_vs_evicted_flat():
    def script(p):
        kv = p.KV(_cfg(p, capacity=256))
        keys = _keys(600, seed=2)
        pages = _pages(keys)
        for lo in range(0, 600, 64):
            kv.insert(keys[lo:lo + 64], pages[lo:lo + 64])
        out, found = kv.get(keys)
        s = counters(kv.stats())
        kv2 = p.KV(_cfg(p))
        kv2.get(keys[:32])
        return (np.asarray(out).tolist(), np.asarray(found).tolist(), s,
                counters(kv2.stats()))

    _, _, s, s2 = _both(script)
    _reconciled(PORT, s)
    _reconciled(PORT, s2)
    assert s["evictions"] > 0 and s["miss_evicted"] > 0
    assert s["miss_cold"] == 0
    assert s2["miss_cold"] == 32 and s2["miss_evicted"] == 0


def _poison(p, kv, bit):
    if p is JAX:
        import dataclasses

        import jax.numpy as jnp

        pool = kv.state.pool
        kv.state = dataclasses.replace(kv.state, pool=dataclasses.replace(
            pool, pages=pool.pages ^ jnp.uint32(bit)))
    else:
        with kv._lock, kv._on_device():
            kv.state.pool.pages.bitwise_xor_(bit)


def test_causes_stale_and_digest_tiered():
    def script(p):
        kv = p.KV(_cfg(p, capacity=256,
                       tier=dict(balloon_step=32, ghost_rows=16)))
        keys = _keys(128, seed=3)
        kv.insert(keys, _pages(keys))
        kv.balloon_shrink(512)
        _, found = kv.get(keys)
        s = counters(kv.stats())
        kv3 = p.KV(_cfg(p, capacity=256))
        k3 = _keys(8, seed=4)
        kv3.insert(k3, _pages(k3))
        _poison(p, kv3, 1 << 7)
        _, f3 = kv3.get(k3)
        return (np.asarray(found).tolist(), s, np.asarray(f3).tolist(),
                counters(kv3.stats()))

    _, s, f3, s3 = _both(script)
    _reconciled(PORT, s)
    _reconciled(PORT, s3)
    assert s["miss_stale"] > 0
    assert not any(f3) and s3["miss_digest"] == 8 == s3["corrupt_pages"]


def test_causes_parked_nopage():
    from pmdfc_tpu.models.base import get_index_ops as jops
    from pmdfc_tpu_torch.models.base import get_index_ops as tops

    def script(p):
        cfg = _cfg(p, capacity=256, tier=dict(ghost_rows=16))
        kv = p.KV(cfg)
        keys = _keys(4, seed=5)
        kv.insert(keys, _pages(keys))
        nopage = np.tile(np.array([p.kv_mod.NOPAGE_TAG, 0], np.uint32),
                         (4, 1))
        if p is JAX:
            import dataclasses

            import jax.numpy as jnp

            ops = jops(cfg.index.kind)
            res = ops.get_batch(kv.state.index, jnp.asarray(keys))
            kv.state = dataclasses.replace(kv.state, index=ops.set_values(
                kv.state.index, res.slots, jnp.asarray(nopage)))
        else:
            ops = tops(cfg.index.kind)
            with kv._lock, kv._on_device():
                idx = kv.state.index
                dev = idx.table.device
                res = ops.get_batch(idx, torch.from_numpy(
                    keys.view(np.int32)).to(dev))
                ops.set_values(idx, res.slots, torch.from_numpy(
                    nopage.view(np.int32)).to(dev))
        _, found = kv.get(keys)
        return np.asarray(found).tolist(), counters(kv.stats())

    found, s = _both(script)
    assert not any(found)
    _reconciled(PORT, s)
    assert s["miss_parked"] == 4


def test_causes_get_extent_and_sharded_arbitration():
    from pmdfc_tpu.parallel.shard import ShardedKV as JSharded
    from pmdfc_tpu.parallel.shard import make_mesh as jmesh
    from pmdfc_tpu_torch.parallel.shard import ShardedKV as TSharded
    from pmdfc_tpu_torch.parallel.shard import make_mesh as tmesh

    def script(p):
        cfg = _cfg(p, capacity=1 << 9)
        skv = (JSharded(cfg, mesh=jmesh(np.array(jax.devices()[:4])))
               if p is JAX else TSharded(cfg, mesh=tmesh(["cpu"] * 4)))
        skv.insert_extent(np.array([9, 0], np.uint32),
                          np.array([0, 8192], np.uint32), 16)
        probe = np.stack([np.full(64, 9, np.uint32),
                          np.arange(64, dtype=np.uint32)], -1)
        vals, ef = skv.get_extent(probe)
        rep = skv.shard_report()
        return (np.asarray(vals).tolist(), np.asarray(ef).tolist(),
                counters(skv.stats()),
                {k: [int(x) for x in v] for k, v in rep["stats"].items()})

    _, ef, s, rep = _both(script)
    assert all(ef[:16]) and not any(ef[16:])
    _reconciled(PORT, s)
    assert s["miss_cold"] == 48
    for i in range(4):
        assert rep["misses"][i] == sum(
            rep[k][i] for k in PORT.kv_mod.MISS_CAUSE_NAMES)


# --- 3. workload sketches -------------------------------------------------


def test_kmv_exact_below_k_and_bounded_error_above():
    def script(p):
        sk = p.wl.KmvSketch(k=256)
        sk.add_hashes(p.wl._key_hashes(_keys(100, seed=6)))
        small = sk.estimate()
        sk.add_hashes(p.wl._key_hashes(_keys(20000, seed=7,
                                             space=1 << 19)))
        return small, sk.estimate()

    small, est = _both(script)
    assert small == 100.0 and 20100 * 0.7 < est < 20100 * 1.3


def test_heat_sketch_finds_the_hot_region():
    hot = np.tile(np.array([[3, 7]], np.uint32), (3000, 1))
    cold = _keys(3000, seed=8)

    def script(p):
        sketch = p.wl.WorkloadSketch(window_s=3600.0, fold_keys=512)
        for lo in range(0, 3000, 300):
            sketch.observe(hot[lo:lo + 300])
            sketch.observe(cold[lo:lo + 300])
        snap = sketch.snapshot()
        sketch.observe(np.full((10, 2), 0xFFFFFFFF, np.uint32))
        hot_prefix = int(p.wl._key_hashes(hot[:1])[0] >> np.uint64(48))
        return (snap["ops"], snap["heat"], hot_prefix,
                sketch.snapshot()["ops"])

    ops, heat, hot_prefix, ops_after = _both(script)
    assert ops == 6000 == ops_after
    assert heat["skew"] >= 0.4 and heat["top"][0][0] == hot_prefix


def test_workload_window_rolls():
    sketch = PORT.wl.WorkloadSketch(window_s=0.01)
    sketch.observe(_keys(50, seed=9))
    time.sleep(0.02)
    sketch.observe(_keys(60, seed=10))
    snap = sketch.snapshot()
    assert snap["window"]["ops"] in (50, 60)
    assert snap["ops"] == 110 and snap["working_set"] > 80


# --- 4. export schemas ----------------------------------------------------


def test_prometheus_render_labels_shard_families():
    def script(p):
        _fresh(p)
        sc = p.tele.scope("mesh", unique=False)
        hists = sc.hist_family("phase_get_us", 2)
        hists[1].observe(100.0)
        sc.counter("shard1_ops").inc(7)
        sc.counter("plain_total").inc(1)
        return p.tele.render()

    txt = _both(script)
    assert 'pmdfc_mesh_shard_ops{shard="1"} 7' in txt
    assert 'pmdfc_mesh_phase_get_us{shard="1",quantile="p99"}' in txt
    assert 'pmdfc_mesh_phase_get_us_count{shard="1"} 1' in txt
    assert "pmdfc_mesh_shard1_ops 7" in txt
    assert 'pmdfc_mesh_phase_get_us_s1{quantile="p99"}' in txt
    assert "pmdfc_mesh_plain_total 1" in txt
    assert txt.count("# TYPE pmdfc_mesh_shard_ops counter") == 1


def test_check_teledump_pins_v2():
    col = PORT.ts.ensure_collector(interval_s=0.01)
    PORT.tele.scope("xr").inc("ops", 2)
    col.tick()
    col.tick()
    doc = {"telemetry": PORT.tele.snapshot(),
           "workload": PORT.wl.WorkloadSketch().snapshot(),
           "gets": 10, "misses": 4, "miss_cold": 3, "miss_evicted": 1}
    for k in PORT.kv_mod.MISS_CAUSE_NAMES:
        doc.setdefault(k, 0)
    doc = json.loads(json.dumps(doc))
    assert chk.check(doc) == []
    bad = json.loads(json.dumps(doc))
    bad["miss_cold"] = 99
    assert any("drift" in e for e in chk.check(bad))
    bad2 = json.loads(json.dumps(doc))
    bad2["shard_report"] = {"n_shards": 2, "stats": {
        k: [0, 0] for k in PORT.kv_mod.MISS_CAUSE_NAMES}}
    bad2["shard_report"]["stats"].update(misses=[2, 2], miss_cold=[2, 1])
    assert any("shard 1" in e for e in chk.check(bad2))
    bad3 = json.loads(json.dumps(doc))
    bad3["workload"]["heat"]["skew"] = 7.0
    assert any("skew" in e for e in chk.check(bad3))
    bad4 = json.loads(json.dumps(doc))
    bad4["telemetry"]["series"]["windows"][0]["dt_s"] = "fast"
    assert any("dt_s" in e for e in chk.check(bad4))
    bad5 = json.loads(json.dumps(doc))
    del bad5["telemetry"]["series"]
    assert any("series" in e for e in chk.check(bad5))


def test_slo_breach_dump_carries_series_tail(tmp_path):
    from pmdfc_tpu_torch.runtime import slo

    reg = PORT.tele.configure(PORT.config.TelemetryConfig(
        enabled=True, dump_dir=str(tmp_path), dump_min_interval_s=0.0))
    col = PORT.ts.Collector(interval_s=0.01, registry=reg)
    sc = PORT.tele.scope("slo_xr2")
    h = sc.hist("get_us")
    wd = slo.SloWatchdog(slo.SloConfig(
        targets=(slo.SloTarget(name="p99", kind="latency_p99",
                               metric=f"{sc.prefix}.get_us",
                               threshold=100.0),),
        burn_windows=2, min_count=4))
    wd.tick()
    for _ in range(2):
        for _ in range(8):
            h.observe(50000.0)
        col.tick()
        wd.tick()
    dumps = glob.glob(str(tmp_path / "flight_slo_breach_*.json"))
    assert dumps, os.listdir(tmp_path)
    doc = json.load(open(sorted(dumps)[-1]))
    assert doc["schema"] == "pmdfc-flight-v2"
    series = doc["series"]["windows"]
    assert len(series) >= 2
    breach_w = [w for w in series if f"{sc.prefix}.get_us" in w["hists"]]
    assert breach_w and breach_w[-1]["hists"][
        f"{sc.prefix}.get_us"]["p99"] > 100.0
    assert chk.check_flight(doc) == []


# --- 5. the acceptance soak + console -------------------------------------


def test_xray_acceptance_soak_and_teletop(smoke, monkeypatch, capsys):
    """Phase 14 (b) at the JAX test's size (2^9 slots a shard, 2^10 keys,
    16 steps of 256): every hit byte-exact, `misses == Σ miss_*` on every
    surface and shard row, the balloon shrink's stale or parked misses,
    `check_teledump` on the wire document, and teletop's rows for two
    live port servers."""
    for name, value in CHAOS_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    entry = chip_smoke.run_xray(smoke, "CPU rehearsal")
    assert entry["path"] == "xray-plane" and entry["launches"] > 0
    assert entry["max_abs_err"] == 0
    out = capsys.readouterr().out
    assert "teletop rows" in out and "every hit byte-exact" in out


walk_in_reverse(globals())
