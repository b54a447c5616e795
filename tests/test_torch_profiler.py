"""PyTorch port: the device-time profiler against the JAX profiler.

The drills of `tests/test_profiler.py`, each run through both packages on
the CPU with the same inputs: the timed-fetch seam and its attribution
table, snapshot and `prof.*` histogram names for one KV verb sequence;
the shard lanes of a 4-shard plane (`["cpu"] * 4` against JAX's forced
CPU devices) reconciled with the mesh counters; the imbalance window fed
one launch sequence; `MSG_PROFILE` across packages both ways (ack,
capture, cooldown, the old peer, no dump dir); `tools/proftool.py` over
the port's snapshot; and `PMDFC_PROF=off` leaving snapshots v2. The
recorded differences are the only ones allowed: `device_us` (host time
here, CUDA events on a card, taken from a pair when the fetch is given
one, checked with a duck-typed pair) and the cost gauges (the port sets
only the fused GET's).
"""

from __future__ import annotations

import json
import os
import socket
import time

import numpy as np
import pytest

import pmdfc_tpu.client.backends as jbackends
import pmdfc_tpu.config as jconfig
import pmdfc_tpu.kv as jkv
import pmdfc_tpu.runtime.net as jnet
import pmdfc_tpu_torch.client.backends as tbackends
import pmdfc_tpu_torch.config as tconfig
import pmdfc_tpu_torch.kv as tkv
import pmdfc_tpu_torch.runtime.net as tnet
from pmdfc_tpu.runtime import profiler as jprof
from pmdfc_tpu.runtime import telemetry as jtele
from pmdfc_tpu_torch.ops import fused as tfused
from pmdfc_tpu_torch.runtime import profiler as tprof
from pmdfc_tpu_torch.runtime import telemetry as ttele

pytestmark = pytest.mark.torch

W = 16


def _cfg(m, capacity=1 << 10):
    return m.KVConfig(index=m.IndexConfig(capacity=capacity),
                      bloom=m.BloomConfig(num_bits=1 << 15),
                      paged=True, page_words=W)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 20, size=n, replace=False)
    return np.stack([flat >> 10, flat & 0x3FF], -1).astype(np.uint32)


def _pages(keys):
    return ((keys[:, 0] * np.uint32(31) + keys[:, 1])[:, None]
            + np.arange(1, W + 1, dtype=np.uint32)[None, :])


@pytest.fixture()
def regs(tmp_path):
    """Fresh registries in both packages, each with its own dump dir."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    j = jtele.configure(jconfig.TelemetryConfig(
        ring_capacity=1 << 15, dump_dir=str(tmp_path / "jax"),
        dump_min_interval_s=0.0))
    t = ttele.configure(tconfig.TelemetryConfig(
        ring_capacity=1 << 15, dump_dir=str(tmp_path / "port"),
        dump_min_interval_s=0.0))
    yield j, t
    jtele.configure()
    ttele.configure()


def _rows(snap):
    """The attribution table without its times (host clocks differ)."""
    return [(r["phase"], r["program"], r["shard"], r["ops"])
            for r in snap["rows"]]


def _prof_hists(reg):
    return {k: v["count"] for k, v in reg.snapshot()["histograms"].items()
            if k.startswith("prof.")}


def _device_spans(reg):
    return [(r["program"], r["phase"], r["ops"]) for r in reg.ring_tail()
            if r.get("src") == "prof" and r.get("op") == "device"]


# --- 1. the timed-fetch seam ----------------------------------------------


def test_fetch_splits_device_and_dispatch_like_jax(regs):
    """JAX's first drill, through both seams: a stamped fetch feeds both
    histogram families, an unstamped one only `device_us`, `ring=True`
    rings one device span, and the registry snapshot turns v3."""
    got = {}
    for name, prof, tele in (("jax", jprof, jtele), ("port", tprof, ttele)):
        p = prof.install()
        t_launch = time.monotonic_ns()
        assert prof.fetch("kv.get", "get", lambda: time.sleep(0.002) or 41,
                          n_ops=8, t_launch_ns=t_launch, ring=True) == 41
        prof.fetch("kv.get", "get", lambda: time.sleep(0.004), n_ops=8)
        snap = p.snapshot()
        assert snap["schema"] == "pmdfc-prof-v1"
        h = tele.get().snapshot()["histograms"]["prof.kv.get.device_us"]
        assert h["max"] >= 4000 and h["count"] == 2
        doc = tele.get().snapshot()
        assert doc["schema"] == "pmdfc-telemetry-v3"
        got[name] = (_rows(snap), snap["launches"], _prof_hists(tele.get()),
                     _device_spans(tele.get()))
    assert got["port"] == got["jax"]
    assert got["port"][2] == {"prof.kv.get.device_us": 2,
                              "prof.kv.get.dispatch_us": 1}


def test_kv_verbs_attribute_like_jax(regs):
    """One verb sequence through each package's `KV`: the same table rows
    (phase, program, ops), launches, histogram families and device spans.
    The cost block is the recorded difference: the port sets the fused
    GET's bytes only."""
    got = {}
    for name, prof, tele, kv in (
            ("jax", jprof, jtele, jkv.KV(_cfg(jconfig))),
            ("port", tprof, ttele, tkv.KV(_cfg(tconfig), device="cpu"))):
        p = prof.install()
        keys = _keys(64)
        kv.insert(keys, _pages(keys))
        out, found = kv.get(keys)
        assert found.all() and (np.asarray(out) == _pages(keys)).all()
        kv.delete(keys[:8])
        kv.get(_keys(40, seed=1))
        kv.get_extent(keys[:4])
        snap = p.snapshot()
        got[name] = (_rows(snap), snap["launches"], _prof_hists(tele.get()),
                     _device_spans(tele.get()))
        if name == "port":
            w = 64  # the padded width of the first GET
            want = float(tfused.hit_bytes(kv.state, w))
            assert snap["cost"] == {"kv.get": {"flops": 0.0,
                                               "bytes": want}}
            g = tele.get().snapshot()["gauges"]
            assert g["cost.kv.get.bytes"] == want
            assert g["cost.kv.get.flops"] == 0.0
    assert got["port"] == got["jax"]
    progs = {r[1] for r in got["port"][0]}
    assert progs == {"kv.insert", "kv.get", "kv.delete", "kv.get_extent"}


class _Event:
    """A duck-typed CUDA event: `elapsed_time` in ms, as torch's."""

    def __init__(self, t_ms=0.0):
        self.t_ms = t_ms
        self.synced = 0

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms

    def synchronize(self):
        self.synced += 1

    def record(self):
        pass


class _Pair:
    def __init__(self, ms):
        self.start, self.end = _Event(0.0), _Event(ms)


def test_fetch_takes_device_us_from_an_event_pair(regs, monkeypatch):
    """Given a launch's event pair, `device_us` is `start.elapsed_time(end)`
    (after the end event is waited for), whatever the host spent in the
    thunk; and the KV's async verbs hand the pair their launch recorded to
    their fetch (a CPU KV records none: `launch_begin` is None there)."""
    p = tprof.install()
    pair = _Pair(2.5)
    assert tprof.fetch("kv.get", "get", lambda: time.sleep(0.01) or 7,
                       n_ops=4, events=pair) == 7
    assert pair.end.synced == 1
    (row,) = p.snapshot()["rows"]
    assert row["device_us"] == 2500.0  # not the 10 ms the host slept

    kv = tkv.KV(_cfg(tconfig), device="cpu")
    assert tprof.launch_begin(kv.device) is None
    keys = _keys(32)
    kv.insert(keys, _pages(keys))
    assert kv.take_launch() is None
    # a launch that records a pair (as on a card) hands it to the fetch
    made = []

    def begin(device):
        made.append(_Pair(0.75 * (len(made) + 1)))
        return made[-1]

    monkeypatch.setattr(tprof, "launch_begin", begin)
    monkeypatch.setattr(tprof, "launch_end", lambda ev, device=None: ev)
    kv.get(keys)
    kv.insert(keys[:4], _pages(keys[:4]))
    rows = {(r["program"]): r["device_us"] for r in p.snapshot()["rows"]}
    assert rows["kv.get"] == 2500.0 + 750.0
    assert rows["kv.insert"] > 1500.0  # host time of the first + 1500
    h = ttele.get().snapshot()["histograms"]["prof.kv.get.device_us"]
    assert h["count"] == 2 and h["max"] == 2500.0


def test_fetch_is_a_passthrough_when_nothing_attaches(monkeypatch):
    """With `PMDFC_PROF` off no profiler attaches, no event pair is made,
    snapshots stay `pmdfc-telemetry-v2` in both packages, and every seam
    passes through (JAX's kill-switch drill)."""
    monkeypatch.delenv("PMDFC_PROF", raising=False)
    docs = []
    try:
        for prof, tele, kv in (
                (jprof, jtele, lambda: jkv.KV(_cfg(jconfig))),
                (tprof, ttele, lambda: tkv.KV(_cfg(tconfig),
                                              device="cpu"))):
            tele.configure(type(tele.get().config)(ring_capacity=1 << 12))
            assert prof.active() is None
            k = kv()
            keys = _keys(32)
            k.insert(keys, _pages(keys))
            assert k.get(keys)[1].all()
            snap = tele.get().snapshot()
            assert snap["schema"] == "pmdfc-telemetry-v2"
            assert "profile" not in snap
            assert not any(n.startswith("prof.") or n.startswith("cost.")
                           for n in (*snap["histograms"], *snap["gauges"]))
            assert prof.fetch("kv.get", "get", lambda: 7, n_ops=1,
                              ring=True) == 7
            assert not any(r.get("src") == "prof"
                           for r in tele.get().ring_tail())
            docs.append(json.loads(json.dumps(snap)) == snap)
        assert tprof.launch_begin(_FakeCuda()) is None
    finally:
        jtele.configure()
        ttele.configure()
    assert docs == [True, True]


class _FakeCuda:
    type = "cuda"


def test_cost_gauges_once_per_program_and_width(regs):
    """`cost_probe` sets `cost.<program>.*` at the first (program, padded
    width) only, and a program without a byte count sets no gauge."""
    p = tprof.install()
    calls = []

    def nbytes():
        calls.append(1)
        return 1000

    tprof.cost_probe("kv.get", 64, nbytes)
    tprof.cost_probe("kv.get", 64, lambda: 5)  # seen: nothing changes
    tprof.cost_probe("kv.insert", 64)          # no byte count
    assert calls == [1]
    assert p.snapshot()["cost"] == {"kv.get": {"flops": 0.0,
                                               "bytes": 1000.0}}
    g = ttele.get().snapshot()["gauges"]
    assert not any(k.startswith("cost.kv.insert") for k in g)
    tprof.cost_probe("kv.get", 128, 2000)  # a new width re-probes
    assert p.snapshot()["cost"]["kv.get"]["bytes"] == 2000.0


# --- 2. per-shard lanes against the JAX plane -----------------------------


def _planes():
    import jax

    from pmdfc_tpu.parallel import plane as jplane
    from pmdfc_tpu.parallel import shard as jshard
    from pmdfc_tpu_torch.parallel import plane as tplane
    from pmdfc_tpu_torch.parallel import shard as tshard

    jskv = jshard.ShardedKV(_cfg(jconfig), mesh=jshard.make_mesh(
        np.array(jax.devices()[:4])))
    tskv = tshard.ShardedKV(_cfg(tconfig),
                            mesh=tshard.make_mesh(["cpu"] * 4))
    return jplane.PlaneBackend(jskv), tplane.PlaneBackend(tskv)


def test_shard_lanes_reconcile_like_jax(regs):
    """Driving each package's 4-shard plane with the same puts and gets:
    the profiler's `shard_ops` lanes equal the mesh scope's
    `shard{i}_ops` counters exactly, in both, and the two packages'
    lanes, table rows and launches agree."""
    got = {}
    for name, prof, be in zip(("jax", "port"), (jprof, tprof), _planes()):
        p = prof.install()
        keys = _keys(400, seed=7)
        be.put(keys, _pages(keys))
        out, found = be.get(keys)
        assert found.all()
        snap = p.snapshot()
        assert snap["n_shards"] == 4
        mesh_ops = [int(be._tele.get(f"shard{i}_ops", 0)) for i in range(4)]
        assert snap["shard_ops"] == mesh_ops
        assert sum(mesh_ops) == 800
        per_shard = [0] * 4
        for r in snap["rows"]:
            if r["shard"] >= 0:
                per_shard[r["shard"]] += r["ops"]
        assert per_shard == mesh_ops
        got[name] = (_rows(snap), snap["launches"], snap["shard_ops"])
    assert got["port"] == got["jax"]


def test_imbalance_window_matches_jax(regs):
    """One launch sequence (skewed, then balanced windows, then a partial
    window) into both profilers gives equal snapshots — device times
    included, since they are given — and equal imbalance gauges."""
    seq = ([np.array([30, 2, 2, 2])] * 8 + [np.array([9, 9, 9, 9])] * 8
           + [np.array([0, 5, 1, 0])] * 3)
    snaps = []
    for prof, tele in ((jprof, jtele), (tprof, ttele)):
        p = prof.install()
        for i, c in enumerate(seq):
            p.note_launch("plane.get", "get", 100.0 + i, dispatch_us=3.0,
                          n_ops=int(c.sum()), counts=c, n_shards=4)
        p.note_launch("kv.get", "get", 7.0, n_ops=5)
        s = p.snapshot()
        g = tele.get().snapshot()["gauges"]
        snaps.append((s, g["prof.shard_imbalance"],
                      [g[f"prof.shard{i}_device_us"] for i in range(4)]))
    assert snaps[0] == snaps[1]
    assert snaps[1][0]["imbalance"] == pytest.approx(1.0, abs=1e-3)


# --- 3. MSG_PROFILE across packages ----------------------------------------


def _stop(srv):
    try:
        srv._lsock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.stop()


def _wait_trace(path, deadline_s=30.0):
    t = time.monotonic() + deadline_s
    f = os.path.join(path, "trace.json")
    while not os.path.exists(f):
        assert time.monotonic() < t, f"no trace written under {path}"
        time.sleep(0.05)
    with open(f) as fh:
        return json.load(fh)


def test_msg_profile_port_server_captures_for_both_clients(
        regs, tmp_path, monkeypatch):
    """The port's server, with a profiler attached and a dump dir: each
    package's client negotiates the verb, a capture returns a path under
    the port's dump dir whose `trace.json` the capture thread writes, a
    second request inside the cooldown is refused, and the connection
    serves on. A server started with `PMDFC_PROF` unset is the old peer:
    neither client gets the ack, and `server_profile` answers None."""
    shared = tbackends.DirectBackend(tkv.KV(_cfg(tconfig), device="cpu"))
    monkeypatch.delenv("PMDFC_PROF", raising=False)
    old = tnet.NetServer(lambda: shared).start()
    try:
        monkeypatch.setenv("PMDFC_PROF", "on")
        for pkg in (jnet, tnet):
            be = pkg.TcpBackend("127.0.0.1", old.port, page_words=W,
                                keepalive_s=None)
            assert be.prof is False and be.server_profile(50) is None
            be.close()
    finally:
        _stop(old)

    tprof.install(tconfig.ProfilerConfig(trace_min_interval_s=60.0))
    srv = tnet.NetServer(lambda: shared, net=tconfig.NetConfig()).start()
    try:
        paths = []
        for pkg in (jnet, tnet):
            be = pkg.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                keepalive_s=None)
            assert be.prof is True
            res = be.server_profile(50)
            if pkg is jnet:
                assert res is not None and res["duration_ms"] == 50
                assert res["path"].startswith(str(tmp_path / "port"))
                paths.append(res["path"])
            assert be.server_profile(50) is None  # live, then cooldown
            keys = np.array([[1, 2]], np.uint32)
            be.put(keys, np.ones((1, W), np.uint32))
            assert be.get(keys)[1].all()  # the connection lives on
            be.close()
        doc = _wait_trace(paths[0])
        assert "traceEvents" in doc
    finally:
        _stop(srv)


def test_msg_profile_jax_server_captures_for_the_port_client(
        regs, tmp_path, monkeypatch):
    """The JAX server with its profiler attached: the port's client
    negotiates the verb, gets a capture path under the JAX dump dir, and
    is refused inside the cooldown."""
    monkeypatch.setenv("PMDFC_PROF", "on")
    jprof.install()
    shared = jbackends.DirectBackend(jkv.KV(_cfg(jconfig)))
    srv = jnet.NetServer(lambda: shared).start()
    try:
        be = tnet.TcpBackend("127.0.0.1", srv.port, page_words=W,
                             keepalive_s=None)
        assert be.prof is True
        res = be.server_profile(50)
        assert res is not None and res["duration_ms"] == 50
        assert res["path"].startswith(str(tmp_path / "jax"))
        assert be.server_profile(50) is None
        be.close()
    finally:
        _stop(srv)


def test_msg_profile_refused_without_dump_dir(monkeypatch):
    """No dump dir on the port's registry: the verb is negotiated, every
    capture refused, for either package's client."""
    monkeypatch.setenv("PMDFC_PROF", "on")
    ttele.configure(tconfig.TelemetryConfig(ring_capacity=1 << 12))
    try:
        p = tprof.install()
        assert p.start_capture(50) is None
        shared = tbackends.DirectBackend(tkv.KV(_cfg(tconfig),
                                                device="cpu"))
        srv = tnet.NetServer(lambda: shared).start()
        try:
            for pkg in (jnet, tnet):
                be = pkg.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                    keepalive_s=None)
                assert be.prof is True
                assert be.server_profile(50) is None
                be.close()
        finally:
            _stop(srv)
    finally:
        ttele.configure()


# --- 4. proftool over the port's snapshot ----------------------------------


def test_proftool_reads_the_port_snapshot(regs, tmp_path):
    """`tools/proftool.py` takes the port's flight dump unchanged: the
    breakdown table, its shard reconciliation against the mesh counters,
    and the Perfetto lanes of the device spans."""
    import tools.proftool as proftool
    from pmdfc_tpu_torch.parallel import plane as tplane
    from pmdfc_tpu_torch.parallel import shard as tshard

    tprof.install()
    be = tplane.PlaneBackend(tshard.ShardedKV(
        _cfg(tconfig), mesh=tshard.make_mesh(["cpu"] * 4)))
    keys = _keys(256, seed=3)
    be.put(keys, _pages(keys))
    be.get(keys)
    tprof.fetch("kv.get", "get", lambda: time.sleep(0.001), n_ops=4,
                ring=True)
    dump = {"schema": "pmdfc-flight-v2", "rung": "manual", "detail": {},
            "ts_unix": 0.0, "telemetry": ttele.get().snapshot(),
            "records": ttele.get().ring_tail()}
    path = tmp_path / "flight.json"
    path.write_text(json.dumps(dump))
    agg = proftool._merge(proftool.load_docs([str(path)]))
    table = proftool.breakdown(agg)
    assert table["schema"] == "pmdfc-proftable-v1"
    assert table["launches"] > 0 and table["rows"]
    assert len(table["shards"]) == 4
    assert all(s["match"] == "yes" for s in table["shards"])
    assert abs(sum(r["share"] for r in table["rows"]) - 1.0) < 0.01
    trace = proftool.device_lane_trace([str(path)])
    dev = [e for e in trace["traceEvents"]
           if str(e.get("tid", "")).startswith("device:")]
    assert dev and {e["tid"] for e in dev} == {"device:kv.get"}
    assert proftool.main([str(path), "--json"]) == 0
