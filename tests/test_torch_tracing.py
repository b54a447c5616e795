"""PyTorch port: `tests/test_tracing.py`'s twins.

Each drill of the JAX suite runs through both packages on the same
seeded inputs, each package with a fresh registry of its own (JAX's is
put back as it was found):

1. span semantics — begin/end and ambient nesting, the out-of-order
   unwind, the kill switch, `record_span` parenting: the records' shapes
   and ok flags equal;
2. the acceptance drill — one pipelined GET through `ReplicaGroup` →
   `ReconnectingClient` → `TcpBackend` → `NetServer` (no coalescing
   delay, one client, so each verb is its own flush) → a 4-shard
   `PlaneBackend`: the GET trace's shape equal in both packages, and the
   port's own flight dump through `tools/tracetool.py` (depth ≥ 6, the
   chain down to `shard_program`, the Chrome export, the CLI, the stage
   breakdown) and `tools/check_teledump.py`'s `check_flight`;
3. the hedge span — `hedge=True` attempts parented to the group get;
4. recompile — JAX's assertions on JAX's side; on the port's side the
   recorded differences (no `recompile.kv.*`, no `recompile.plane.*`, no
   fused-program tracking: driving the port's `KV`, plane and fused GET
   moves no `recompile.*` counter and rings no `recompile` event), and
   the registry seam `track_program` counting exactly as JAX's does;
5. SLO — burn windows and starvation, `attribute_stage`, the restartable
   watchdog and `SloConfig.from_dict` validation: outputs, stats and
   error messages equal;
6. the injected-latency breach — a 20 ms lag breaches a 2 ms p99 GET
   target in both packages, each breach dump names `flush:get`;
7. dump rotation and shard-span attribution — the 30-op seeded mix on a
   4-shard plane: per-shard `shard_program` op sums equal the
   `mesh.shard{i}_ops` counters in each package and across them;
8. `tools/check_bench.py` — its two drills over rows the port's
   `bench/net_sweep.py --smoke` writes to a history file.

A trace's shape is its tree of `(src, op)` nodes with each node's
attributes but ids, times, durations, connection ids and flush sequence
numbers, children sorted; tolerance 0.
"""

from __future__ import annotations

import json
import os
import time
import types

import numpy as np
import pytest
import test_tracing as jtracing
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import stop

import pmdfc_tpu.client.backends as jbackends
import pmdfc_tpu.client.replica as jreplica
import pmdfc_tpu.config as jconfig
import pmdfc_tpu.kv as jkv
import pmdfc_tpu.runtime.failure as jfailure
import pmdfc_tpu.runtime.net as jnet
import pmdfc_tpu.runtime.slo as jslo
import pmdfc_tpu.runtime.telemetry as jtele
import pmdfc_tpu_torch.client.backends as tbackends
import pmdfc_tpu_torch.client.replica as treplica
import pmdfc_tpu_torch.config as tconfig
import pmdfc_tpu_torch.kv as tkv
import pmdfc_tpu_torch.runtime.failure as tfailure
import pmdfc_tpu_torch.runtime.net as tnet
import pmdfc_tpu_torch.runtime.slo as tslo
import pmdfc_tpu_torch.runtime.telemetry as ttele
from tools import check_bench, check_teledump, tracetool

pytestmark = pytest.mark.torch

W = 16


def _jax_plane(cfg, n):
    from pmdfc_tpu.parallel.plane import make_serving_backend

    return make_serving_backend(cfg, jconfig.MeshConfig(n_shards=n))


def _port_plane(cfg, n):
    from pmdfc_tpu_torch.parallel.plane import make_serving_backend
    from pmdfc_tpu_torch.parallel.shard import make_mesh

    return make_serving_backend(cfg, mesh=make_mesh(["cpu"] * n))


JAX = types.SimpleNamespace(
    name="jax", config=jconfig, tele=jtele, slo=jslo, replica=jreplica,
    failure=jfailure, net=jnet, backends=jbackends,
    KV=lambda cfg: jkv.KV(cfg), plane=_jax_plane)
PORT = types.SimpleNamespace(
    name="port", config=tconfig, tele=ttele, slo=tslo, replica=treplica,
    failure=tfailure, net=tnet, backends=tbackends,
    KV=lambda cfg: tkv.KV(cfg, device="cpu"), plane=_port_plane)
PKGS = (JAX, PORT)

# record fields that are ids, clocks or per-run sequence numbers: a
# trace's shape is everything else
_NOT_SHAPE = frozenset(("kind", "span", "parent", "trace", "t", "t0_ns",
                        "t1_ns", "dur_us", "conn", "flush"))


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 20, size=n, replace=False)
    return np.stack([flat >> 10, flat & 0x3FF], -1).astype(np.uint32)


def _pages(keys):
    return ((keys[:, 0] * np.uint32(31) + keys[:, 1])[:, None]
            + np.arange(1, W + 1, dtype=np.uint32)[None, :])


def _cfg(p, capacity=1 << 10):
    c = p.config
    return c.KVConfig(index=c.IndexConfig(capacity=capacity),
                      bloom=c.BloomConfig(num_bits=1 << 15),
                      paged=True, page_words=W)


def _configure(p, dump_dir, **kw):
    return p.tele.configure(p.config.TelemetryConfig(
        ring_capacity=1 << 15, dump_dir=str(dump_dir),
        dump_min_interval_s=0.0, **kw))


class _Registries:
    """A fresh registry in each package (dumps under `root/<package>`);
    `restore()` puts JAX's back as it was found and resets the port's."""

    def __init__(self, root):
        state = jtele._STATE
        self._found = (state.registry, state.tracing)
        self.dirs, self.regs = {}, {}
        for p in PKGS:
            d = root / p.name
            d.mkdir(exist_ok=True)
            self.dirs[p.name] = d
            self.regs[p.name] = _configure(p, d)

    def __getitem__(self, p):
        return self.regs[p.name]

    def restore(self) -> None:
        state = jtele._STATE
        state.registry, state.tracing = self._found
        ttele.configure()


@pytest.fixture()
def fresh(tmp_path):
    regs = _Registries(tmp_path)
    yield regs
    regs.restore()


def _spans(reg) -> list:
    return [r for r in reg.ring if r.get("kind") == "span"]


def _attrs(rec) -> tuple:
    return tuple(sorted((k, v) for k, v in rec.items()
                        if k not in _NOT_SHAPE))


def _flat_shape(recs) -> list:
    """Span records in ring order, each as (attributes, its parent's op):
    the semantics drills' shape."""
    op_of = {r["span"]: r["op"] for r in recs}
    return [(_attrs(r), op_of.get(r.get("parent"), r.get("parent") or 0))
            for r in recs]


def _tree_shape(node) -> tuple:
    kids = sorted((_tree_shape(k) for k in node.all_children()),
                  key=lambda s: (s[0], s[1], str(s[2].get("shard")),
                                 str(s[2].get("phase")), repr(s)))
    attrs = dict(_attrs(node.rec))
    return (node.rec.get("src"), node.rec.get("op"), attrs, kids)


def _trace_shape(records, trace) -> list:
    roots = tracetool.trace_tree(tracetool.build_tree(records), trace)
    return sorted((_tree_shape(n) for n in roots), key=repr)


def _both(script):
    a, b = (script(p) for p in PKGS)
    assert a == b, f"jax {a}\nport {b}"
    return b


# --- 1. span-tree semantics ------------------------------------------------


def _begin_end(p, reg):
    t = p.tele
    a = t.span_begin("client", "outer")
    b = t.span_begin("client", "inner")
    c = t.span_begin("server", "detached", parent=a.sid, ambient=False)
    d = t.span_begin("client", "inner2")
    t.span_end(d)
    t.span_end(c)
    t.span_end(b)
    t.span_end(a, extra_attr=7)
    recs = {r["op"]: r for r in _spans(reg)}
    assert recs["outer"]["parent"] == 0
    assert recs["inner"]["parent"] == recs["outer"]["span"]
    assert recs["detached"]["parent"] == recs["outer"]["span"]
    assert recs["inner2"]["parent"] == recs["inner"]["span"]
    assert recs["outer"]["extra_attr"] == 7
    for r in recs.values():
        assert 0 < r["span"] <= 0xFFFFFFFF
        assert r["t1_ns"] >= r["t0_ns"]
        assert r["dur_us"] == pytest.approx(
            (r["t1_ns"] - r["t0_ns"]) / 1e3, abs=0.06)


def _out_of_order(p, reg):
    a = p.tele.span_begin("client", "a")
    b = p.tele.span_begin("client", "b")
    p.tele.span_end(a)
    p.tele.span_end(b)
    assert len(_spans(reg)) == 2


def _kill_switch(p, reg):
    t = p.tele
    t.set_enabled(False)
    try:
        sp = t.span_begin("client", "x")
        assert sp is None
        t.span_end(sp)
        assert len(reg.ring) == 0
    finally:
        t.set_enabled(True)
    sp = t.span_begin("client", "y")
    t.set_enabled(False)
    try:
        t.span_end(sp)
        assert t._SPAN_TLS.stack == []
    finally:
        t.set_enabled(True)
    assert not [r for r in _spans(reg) if r["op"] == "y"]


def _record_span(p, reg):
    a = p.tele.span_begin("client", "root")
    p.tele.record_span("client", "shot", 5, True, dur_us=1.0)
    p.tele.span_end(a)
    recs = {r["op"]: r for r in _spans(reg)}
    assert recs["shot"]["parent"] == recs["root"]["span"]
    assert recs["shot"]["span"] > 0


@pytest.mark.parametrize("drill", [_begin_end, _out_of_order, _kill_switch,
                                   _record_span],
                         ids=["begin_end_ambient", "out_of_order_unwind",
                              "kill_switch", "record_span_parent"])
def test_span_semantics_match_jax(fresh, drill):
    def script(p):
        drill(p, fresh[p])
        assert p.tele._SPAN_TLS.stack == []
        return _flat_shape(_spans(fresh[p]))

    _both(script)


# --- 2. the nested-trace acceptance drill ----------------------------------


def _serving_stack(p, n_shards=4):
    """ReplicaGroup(1) -> ReconnectingClient -> TcpBackend -> NetServer
    (no coalescing delay) -> PlaneBackend over an n-shard grid."""
    plane = p.plane(_cfg(p), n_shards)
    srv = p.net.NetServer(lambda: plane, net=p.config.NetConfig(
        flush_timeout_us=0, settle_us=0)).start()

    def factory():
        return p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                keepalive_s=None, op_timeout_s=60.0)

    rc = p.failure.ReconnectingClient(factory, page_words=W, seed=3)
    group = p.replica.ReplicaGroup(
        [rc], page_words=W, seed=3,
        cfg=p.config.ReplicaConfig(n_replicas=1, rf=1,
                                   repair_interval_s=0.0))
    return srv, group


def _acceptance(p, reg):
    srv, group = _serving_stack(p)
    try:
        keys = _keys(16, seed=11)
        group.put(keys, _pages(keys))
        out, found = group.get(keys)
        assert found.all()
        np.testing.assert_array_equal(out, _pages(keys))
    finally:
        group.close()
        stop(srv)
    ggets = [r for r in _spans(reg) if r.get("src") == "group"
             and r.get("op") == "get" and r.get("ok")]
    assert ggets, "no group get span recorded"
    trace = ggets[-1]["trace"]
    assert trace != 0
    path = p.tele.dump_now("tracetest")
    assert path and os.path.exists(path)
    return trace, path


@pytest.fixture(scope="module")
def acceptance(tmp_path_factory):
    """The acceptance drill once through each package: {name: (trace id,
    its flight dump's path, the dump's records)}."""
    regs = _Registries(tmp_path_factory.mktemp("acceptance"))
    try:
        out = {}
        for p in PKGS:
            trace, path = _acceptance(p, regs[p])
            out[p.name] = (trace, path, tracetool.load_dumps([path]))
    finally:
        regs.restore()
    return out


def test_get_trace_shape_matches_jax(acceptance):
    shapes = [_trace_shape(recs, trace)
              for trace, _, recs in acceptance.values()]
    assert shapes[0], "no GET trace"
    assert shapes[0] == shapes[1], f"jax {shapes[0]}\nport {shapes[1]}"


def _chains(n, acc):
    acc = acc + [n.op]
    yield acc
    for k in n.all_children():
        yield from _chains(k, acc)


def test_port_trace_is_nested_six_deep_down_to_the_shard_program(
        acceptance):
    trace, _, records = acceptance["port"]
    roots = tracetool.trace_tree(tracetool.build_tree(records), trace)
    assert roots, "trace has no root span"
    depth = max(n.depth() for n in roots)
    assert depth >= 6, f"nesting depth {depth} < 6"
    chains = [c for root in roots for c in _chains(root, [])]
    best = max((c for c in chains if c[-1] == "shard_program"), key=len)
    assert best == ["get", "attempt", "get", "get", "phase", "flush:get",
                    "shard_program"], best
    assert any("queue_wait" in c[-1] for c in chains), chains


def test_port_dump_through_tracetool(acceptance, tmp_path, capsys):
    trace, path, records = acceptance["port"]
    offsets, _fb = tracetool.clock_offsets(records)
    assert offsets, "no clock record captured"
    assert all(abs(off) < 50_000_000 for off in offsets.values())
    doc = tracetool.chrome_trace(records, trace=None)
    assert len(doc["traceEvents"]) >= 6
    for e in doc["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] > 0 and e["ts"] >= 0
    outp = tmp_path / "chrome.json"
    assert tracetool.main([path, "--out", str(outp), "--trace", str(trace),
                           "--table"]) == 0
    exported = json.loads(outp.read_text())
    assert len(exported["traceEvents"]) >= 6
    names = {e["name"] for e in exported["traceEvents"]}
    assert {"get", "attempt", "queue_wait", "phase"} <= names, names
    assert "max nesting depth" in capsys.readouterr().out
    stages = {r["stage"] for r in tracetool.breakdown(records)}
    assert {"flush:get", "shard:get"} <= stages, stages


def test_port_dump_passes_check_flight(acceptance):
    with open(acceptance["port"][1]) as f:
        dumpdoc = json.load(f)
    assert dumpdoc["schema"] == "pmdfc-flight-v2"
    assert check_teledump.check_flight(dumpdoc) == []
    bad = json.loads(json.dumps(dumpdoc))
    for r in bad["records"]:
        if r.get("kind") == "span" and "span" in r:
            r["span"] = "not-an-id"
            break
    assert check_teledump.check_flight(bad)
    v1 = json.loads(json.dumps(dumpdoc))
    v1["schema"] = "pmdfc-flight-v1"
    for r in v1["records"]:
        for k in ("span", "parent", "t0_ns", "t1_ns"):
            r.pop(k, None)
    assert check_teledump.check_flight(v1) == []


# --- 3. the hedge span -----------------------------------------------------


class _SlowMiss:
    def __init__(self, delay):
        self.delay = delay

    def put(self, keys, pages):
        return None

    def get(self, keys):
        time.sleep(self.delay)
        return (np.zeros((len(keys), W), np.uint32),
                np.zeros(len(keys), bool))

    def invalidate(self, keys):
        return np.zeros(len(keys), bool)

    def packed_bloom(self):
        return None

    def close(self):
        pass


def test_hedge_attempt_spans_match_jax(fresh):
    def script(p):
        cfg = p.config.ReplicaConfig(n_replicas=2, rf=2, hedge_ms=2.0,
                                     repair_interval_s=0.0)
        with p.replica.ReplicaGroup([_SlowMiss(0.05), _SlowMiss(0.05)],
                                    page_words=W, cfg=cfg, seed=1) as g:
            g.get(_keys(4, seed=1))
        spans = _spans(fresh[p])
        gget = [r for r in spans if r["src"] == "group" and r["op"] == "get"]
        hedges = [r for r in spans
                  if r["op"] == "attempt" and r.get("hedge")]
        assert gget and hedges, (gget, hedges)
        assert all(h["parent"] == gget[-1]["span"] for h in hedges)
        assert all(h["trace"] == gget[-1]["trace"] for h in hedges)
        return sorted(_attrs(r) for r in spans if r["op"] == "attempt"), \
            _attrs(gget[-1])

    _both(script)


# --- 4. recompile ----------------------------------------------------------


def _recompile(reg) -> tuple[dict, list]:
    counters = {k: v for k, v in reg.snapshot()["counters"].items()
                if k.startswith("recompile.")}
    return counters, [r for r in reg.ring if r.get("kind") == "recompile"]


def _ladder(p):
    kv = p.KV(_cfg(p))
    keys = _keys(64, seed=7)
    kv.insert(keys[:16], _pages(keys[:16]))
    kv.get(keys[:16])
    kv.get(keys[:30])
    return kv, keys


def test_cold_ladder_rung_counts_in_jax_and_not_in_port(fresh):
    """JAX: a width outside the warmed ladder bumps exactly one named
    `recompile.kv.get*` counter, once. The port (recorded difference: no
    `recompile.kv.*`, no fused-program tracking): the same verbs, fused
    GET included, move no `recompile.*` counter and ring no event."""
    def kv_counters(reg):
        return {k: v for k, v in _recompile(reg)[0].items()
                if k.startswith("recompile.kv.")}

    kv, keys = _ladder(JAX)
    reg = fresh[JAX]
    before = kv_counters(reg)
    kv.get(keys[:33])
    after = kv_counters(reg)
    bumped = {k: after[k] - before.get(k, 0) for k in after
              if after[k] != before.get(k, 0)}
    assert len(bumped) == 1, f"expected exactly one named bump: {bumped}"
    (name, delta), = bumped.items()
    assert delta == 1 and name.startswith("recompile.kv.get")
    kv.get(keys[:40])
    assert kv_counters(reg) == after
    evs = _recompile(reg)[1]
    assert any(r["program"] == name[len("recompile."):] and "64" in r["sig"]
               for r in evs), evs

    from pmdfc_tpu_torch.ops import fused

    calls = []
    real = fused.fused_get

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    fused.fused_get = spy
    try:
        kv, keys = _ladder(PORT)
        kv.get(keys[:33])
        kv.get(keys[:40])
    finally:
        fused.fused_get = real
    assert len(calls) == 4  # every GET took the fused wrapper
    assert _recompile(fresh[PORT]) == ({}, [])


def test_plane_wrap_tracked_in_jax_and_not_in_port(fresh):
    """JAX's `ShardedKV._wrap` cache misses count as `recompile.plane.*`;
    the port has no program cache to miss (recorded difference)."""
    for p in PKGS:
        be = p.plane(_cfg(p), 2)
        keys = _keys(8, seed=9)
        be.put(keys, _pages(keys))
        out, found = be.get(keys)
        assert found.all()
        counters, events = _recompile(fresh[p])
        plane = {k: v for k, v in counters.items()
                 if k.startswith("recompile.plane.")}
        if p is JAX:
            assert plane and all(v >= 1 for v in plane.values())
        else:
            assert (counters, events) == ({}, [])


def test_track_program_seam_matches_jax(fresh):
    """The registry seam itself counts as JAX's: first sightings of a
    (program, signature) bump `recompile.<program>` and
    `recompile.programs` and ring one event; repeats count nothing."""
    calls = [("kv.get", (16, 16), None), ("kv.get", (32, 16), None),
             ("kv.get", (16, 16), None), ("plane.get", (8, 4), "w=8,s=4"),
             ("kv.insert", (16, 16), None), ("plane.get", (8, 4), "w=8"),
             ("kv.get_fused.kernel", ("linear", False, 64), "w=64")]

    def script(p):
        firsts = [p.tele.track_program(name, sig, detail=detail)
                  for name, sig, detail in calls]
        counters, events = _recompile(fresh[p])
        return firsts, counters, [(r["program"], r["sig"]) for r in events]

    firsts, counters, events = _both(script)
    assert firsts == [True, True, False, True, True, False, True]
    assert counters["recompile.programs"] == 5


# --- 5. SLO watchdog -------------------------------------------------------


def test_slo_burn_windows_and_starvation_match_jax(fresh):
    def script(p):
        slo = p.slo
        sc = p.tele.scope("svc", unique=False)
        h = sc.hist("lat_us")
        num, den = sc.counter("errs"), sc.counter("ops")
        cfg = slo.SloConfig(targets=(
            slo.SloTarget("p99", "latency_p99", "svc.lat_us", 100.0),
            slo.SloTarget("errs", "ratio_max", "svc.errs", 0.1,
                          denominator="svc.ops"),
        ), window_s=1.0, burn_windows=2, min_count=8)
        wd = slo.SloWatchdog(cfg)
        out = []

        def tick():
            out.append(sorted((b["target"].name, float(b["value"]),
                               b.get("count")) for b in wd.tick()))
            out.append(dict(wd.stats))

        tick()
        for lat, n, bad in ((10.0, 16, 0), (5000.0, 16, 8), (5000.0, 16, 8),
                            (9999.0, 1, 0), (10.0, 16, 0)):
            for _ in range(n):
                h.observe(lat)
            den.inc(n)
            num.inc(bad)
            tick()
        return out

    out = _both(script)
    assert [len(b) for b in out[::2]] == [0, 0, 0, 2, 0, 0]
    assert out[-1]["breaches"] == 2 and out[-1]["starved_windows"] >= 2


def _span(op, dur, **kw):
    return {"kind": "span", "op": op, "dur_us": dur, "src": "server", **kw}


@pytest.mark.parametrize("recs,stage", [
    ([_span("get", 1000.0), _span("queue_wait", 50.0),
      _span("flush:get", 900.0, phase="get"),
      _span("phase", 900.0, phase="get"),
      _span("phase", 900.0, phase="get"),
      _span("shard_program", 800.0, phase="get", shard=2),
      _span("shard_program", 40.0, phase="get", shard=0)], "shard2:get"),
    ([_span("get", 10.0)], "server:get"),
    ([_span("queue_wait", 700.0), _span("flush:get", 300.0, phase="get"),
      _span("flush:put", 900.0, phase="put"),
      _span("shard_program", 100.0, phase="put", shard=1)], "flush:put"),
    ([], "unknown"),
], ids=["shard_dominates", "whole_op_fallback", "queue_and_flush",
        "empty"])
def test_attribute_stage_matches_jax(recs, stage):
    """A containing span never buries the child that grew: per-op `phase`
    spans are skipped and `flush:<ph>` is charged only its exclusive
    time; whole-op spans are the fallback."""
    got, table = _both(lambda p: p.slo.attribute_stage(recs))
    assert got == stage, (got, table)
    if stage == "shard2:get":
        assert table["flush:get"] == pytest.approx(60.0)


def test_slo_watchdog_restartable_in_both(fresh):
    for p in PKGS:
        wd = p.slo.SloWatchdog(p.slo.SloConfig(window_s=0.05))
        wd.start()
        time.sleep(0.12)
        wd.stop()
        ticks = wd.stats["ticks"]
        assert ticks >= 1
        wd.start()
        time.sleep(0.12)
        wd.stop()
        assert wd.stats["ticks"] > ticks, f"{p.name}: did not restart"
        assert set(wd.stats) == set(JAX.slo.SloWatchdog(
            JAX.slo.SloConfig()).stats)


def _target(t):
    return (t.name, t.kind, t.metric, t.threshold, t.denominator)


_SLO_DICT = {
    "window_s": 2.5, "burn_windows": 3,
    "targets": [{"name": "g", "kind": "latency_p99",
                 "metric": "net.client.get_us", "threshold": 5e4},
                {"name": "hr", "kind": "ratio_min", "threshold": 0.9,
                 "metric": "a.hits", "denominator": "a.gets"}]}


@pytest.mark.parametrize("build", [
    lambda slo: slo.SloConfig.from_dict(_SLO_DICT),
    lambda slo: slo.SloTarget("x", "p42", "m", 1.0),
    lambda slo: slo.SloTarget("x", "ratio_min", "m", 1.0),
    lambda slo: slo.SloConfig.from_dict({"window_s": 0.0}),
    lambda slo: slo.SloConfig.from_dict({"burn_windows": 0}),
], ids=["roundtrip", "unknown_kind", "ratio_needs_denominator",
        "window_s", "burn_windows"])
def test_slo_config_from_dict_matches_jax(build):
    def script(p):
        try:
            cfg = build(p.slo)
        except ValueError as e:
            return "ValueError", str(e)
        return ("ok", cfg.window_s, cfg.burn_windows, cfg.min_count,
                [_target(t) for t in cfg.targets])

    out = _both(script)
    if out[0] == "ok":
        assert out[1] == 2.5 and len(out[4]) == 2


def test_injected_latency_breach_names_flush_get_in_both(fresh):
    def script(p):
        slo = p.slo

        class Laggy(p.backends.LocalBackend):
            def get(self, keys):
                time.sleep(0.02)
                return super().get(keys)

        cfg = slo.SloConfig(targets=(
            slo.SloTarget("get_p99", "latency_p99", "net.client.get_us",
                          2000.0),), window_s=0.5, burn_windows=2,
            min_count=4)
        wd = slo.SloWatchdog(cfg)
        shared = Laggy(page_words=W, capacity=1 << 10)
        breaches = []
        srv = p.net.NetServer(lambda: shared, net=p.config.NetConfig()).start()
        try:
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None, op_timeout_s=10.0) as be:
                keys = _keys(8, seed=5)
                be.put(keys, _pages(keys))
                be.get(keys)
                wd.tick()
                for _round in range(2):
                    for _ in range(6):
                        be.get(keys)
                    breaches += wd.tick()
        finally:
            stop(srv)
        assert breaches, f"{p.name}: p99 target never breached"
        b = breaches[0]
        assert b["target"].name == "get_p99" and b["value"] > 2000.0
        d = fresh.dirs[p.name]
        dumps = sorted(f for f in os.listdir(d)
                       if f.startswith("flight_slo_breach_")
                       and f.endswith(".json"))
        assert dumps, f"{p.name}: no slo_breach flight dump written"
        with open(d / dumps[-1]) as f:
            doc = json.load(f)
        assert doc["schema"] == "pmdfc-flight-v2"
        det = doc["detail"]
        assert det["value"] > det["threshold"]
        assert det["stages"]["flush:get"] > 0
        assert check_teledump.check_flight(doc) == []
        return det["target"], det["metric"], det["threshold"], det["stage"]

    assert _both(script) == ("get_p99", "net.client.get_us", 2000.0,
                             "flush:get")


# --- 7. satellites ---------------------------------------------------------


def test_dump_dir_rotation_caps_file_count_in_both(tmp_path):
    regs = _Registries(tmp_path)
    try:
        def script(p):
            d = tmp_path / f"rot_{p.name}"
            d.mkdir()
            p.tele.configure(p.config.TelemetryConfig(
                dump_dir=str(d), dump_min_interval_s=0.0, dump_max_files=3))
            for i in range(8):
                p.tele.rung("bad_frame", n=i)
                time.sleep(0.01)
            files = sorted(f for f in os.listdir(d)
                           if f.startswith("flight_") and f.endswith(".json"))
            return [int(f.rsplit("_", 1)[1].split(".")[0]) for f in files]

        assert _both(script) == [5, 6, 7]
    finally:
        regs.restore()


def test_shard_span_attribution_sums_to_mesh_counters_in_both(fresh):
    def script(p):
        be = p.plane(_cfg(p), 4)
        rng = np.random.default_rng(21)
        universe = _keys(128, seed=21)
        for _ in range(30):
            lo = int(rng.integers(0, 112))
            n = int(rng.integers(1, 12))
            sel = universe[lo:lo + n]
            op = int(rng.integers(3))
            if op == 0:
                be.put(sel, _pages(sel))
            elif op == 1:
                be.get(sel)
            else:
                be.invalidate(sel)
        reg = fresh[p]
        sums = {}
        for r in _spans(reg):
            if r["op"] == "shard_program":
                sums[r["shard"]] = sums.get(r["shard"], 0) + r["ops"]
        assert sums, "no shard_program spans recorded"
        for i in range(4):
            ctr = reg.metric(f"mesh.shard{i}_ops")
            want = ctr.value if ctr is not None else 0
            assert sums.get(i, 0) == want, \
                f"{p.name} shard {i}: spans {sums.get(i, 0)} != {want}"
        return sums

    _both(script)


# --- 8. check_bench over the port's net_sweep rows -------------------------


@pytest.fixture(scope="module")
def net_sweep_rows(tmp_path_factory):
    """Two runs of the port's `net_sweep --smoke` appending to one history
    -> (the history's rows, the first run's row count)."""
    from pmdfc_tpu_torch.bench import net_sweep

    hist = tmp_path_factory.mktemp("bench") / "history.jsonl"
    counts = []
    for _ in range(2):
        assert net_sweep.main(["--smoke", "--device", "cpu", "--history",
                               str(hist), "--gets", "4", "--rounds",
                               "1"]) == 0
        counts.append(len(check_bench.load_history(str(hist))))
    return check_bench.load_history(str(hist)), counts[0]


def test_check_bench_gate_over_port_net_sweep_rows(net_sweep_rows, tmp_path):
    """A rerun of each port row lands in its own lane (secondary measured
    outputs like `best_wall_s` are not identity), so the gate compares
    it; a 20% drop of a throughput lane regresses, within-band drift
    passes, and the CLI exits 1 then 0. The JAX drill runs first, the
    same gate over the JAX system's synthetic rows."""
    (tmp_path / "jax").mkdir()
    jtracing.test_check_bench_lane_regression_gate(tmp_path / "jax")
    rows, n = net_sweep_rows
    first, second = rows[:n], rows[n:]
    assert first and len(second) == n
    assert [check_bench.lane_key(r) for r in first] == \
        [check_bench.lane_key(r) for r in second]
    assert {r["unit"] for r in rows} == {"Mpages/s"}
    base = first[0]
    drop = dict(base, value=base["value"] * 0.8, best_wall_s=9.9)
    regs = check_bench.check_history([base, drop], tolerance=0.15)
    assert len(regs) == 1 and regs[0]["direction"] == "higher-better"
    drift = dict(base, value=base["value"] * 0.9)
    assert check_bench.check_history([base, drift], tolerance=0.15) == []
    assert check_bench.check_history([drop, base]) == []
    hist = tmp_path / "h.jsonl"
    hist.write_text("\n".join(json.dumps(r) for r in [base, drop]) + "\n")
    assert check_bench.main([str(hist)]) == 1
    hist.write_text("\n".join(json.dumps(r) for r in [base, drift]) + "\n")
    assert check_bench.main([str(hist), "--tolerance", "0.15"]) == 0


def test_check_bench_port_transports_never_collapse(net_sweep_rows):
    """The sweep's lockstep and coalesced rows at the same connections,
    window and verb are distinct lanes (a 2x gap between them never
    fires), and every (transport, connections, window) point is its own
    lane; within one lane the band still gates. The JAX drill runs first,
    over the fused GET sweep's paired kernel rows."""
    jtracing.test_check_bench_fused_kernel_lanes_never_collapse()
    rows, n = net_sweep_rows
    first = rows[:n]
    lanes = {check_bench.lane_key(r) for r in first}
    assert len(lanes) == n
    by = {(r["transport"], r["connections"], r["window"]): r for r in first}
    lock, coal = by[("tcp_lockstep", 1, 1)], by[("tcp_coalesced", 1, 1)]
    assert check_bench.lane_key(lock) != check_bench.lane_key(coal)
    assert check_bench.check_history(
        [dict(coal, value=2.0), dict(lock, value=1.0)]) == []
    assert len(check_bench.check_history(
        [dict(lock, value=2.0), dict(lock, value=1.0)])) == 1
    assert {t for t, _, _ in by} == {"tcp_lockstep", "tcp_coalesced"}
