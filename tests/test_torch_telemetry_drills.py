"""PyTorch port: `tests/test_telemetry.py`'s drills on both packages.

Each drill runs on JAX's telemetry stack and on the port's, each with a
fresh registry and, where it dumps, a dump directory of its own; JAX's
registry is put back after the test (hazards (bh), (bo), (bq)). Where the
drill is deterministic the two transcripts are compared exactly: scope
reads, collisions, log2 histogram quantiles, the Prometheus render and its
round trip, the kill switches, the rung dumps' attribution, the dump
cooldown, the `MSG_STATS` document's shape and the migrated counter
surfaces. Where it runs over loopback or through a `ChaosProxy` (span
negotiation on both servers, JAX's seed-17 chaos soak whose every
completed verb must join a server span), both packages are held to the
JAX drill's own invariants and compared on what does not depend on timing.
The `MSG_STATS` document passes both checkers: the root
`tools/check_teledump.py` and the port's `pmdfc_tpu_torch.tools.
check_teledump` CLI on the same document written to a file.
"""

from __future__ import annotations

import itertools
import json
import os
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import (JAX, PORT, fresh_jax_registry,  # noqa: F401
                        registries, same, stop)

import pmdfc_tpu.client.replica as jreplica
import pmdfc_tpu_torch.client.replica as treplica
from pmdfc_tpu_torch.tools import check_teledump as tcheck
from tools import check_teledump as jcheck

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

PKGS = (JAX, PORT)
REPLICA = {id(JAX): jreplica, id(PORT): treplica}
W = 16


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 1:2].astype(np.uint32) * 3 + 1) * np.arange(
        1, W + 1, dtype=np.uint32)


def fresh(p, **cfg):
    """A fresh registry of `p` (JAX's own is put back by `registries`)."""
    return p.tele.configure(p.config.TelemetryConfig(
        **{"ring_capacity": 1 << 15, **cfg}))


def twin(drill, *args):
    a, b = (drill(p, *args) for p in PKGS)
    same(a, b, drill.__name__)
    return b


def _dumps(dump_dir, rung_name):
    out = []
    for f in sorted(os.listdir(dump_dir)):
        if f.startswith(f"flight_{rung_name}_") and f.endswith(".json"):
            with open(os.path.join(dump_dir, f)) as fh:
                out.append(json.load(fh))
    return out


# --- 1. registry semantics ---------------------------------------------------


def test_scope_counters_and_mapping_reads():
    def drill(p):
        fresh(p)
        s = p.tele.scope("t", {"a": 0, "b": 0})
        s.inc("a", 3)
        s.inc("c")
        s.max("hwm", 7)
        s.max("hwm", 4)
        with pytest.raises(KeyError):
            s["nope"]
        out = (dict(s), "a" in s, len(s), s.prefix)
        assert out[:3] == ({"a": 3, "b": 0, "c": 1, "hwm": 7}, True, 4)
        return out

    twin(drill)


def test_scope_instances_never_share_counters():
    def drill(p):
        fresh(p)
        a = p.tele.scope("srv", {"ops": 0})
        b = p.tele.scope("srv", {"ops": 0})
        a.inc("ops", 5)
        assert a["ops"] == 5 and b["ops"] == 0 and a.prefix != b.prefix
        return a.prefix, b.prefix, dict(a), dict(b)

    twin(drill)


def test_shared_scope_with_seed_counters():
    def drill(p):
        fresh(p)
        s = p.tele.scope("sh", {"a": 2}, unique=False)
        s2 = p.tele.scope("sh", {"a": 5}, unique=False)
        assert s2 is s and s["a"] == 2
        return s.prefix, dict(s)

    twin(drill)


def test_registry_collision_asserts():
    def drill(p):
        reg = fresh(p)
        reg._register("x.ops", p.tele.Counter)
        with pytest.raises(ValueError, match="already registered") as e:
            reg._register("x.ops", p.tele.Gauge)
        return str(e.value)

    twin(drill)


def test_histogram_log2_quantiles():
    def drill(p):
        fresh(p)
        h = p.tele.scope("h").hist("lat")
        for v in [1] * 50 + [100] * 45 + [5000] * 5:
            h.observe(v)
        snap = h.snapshot()
        assert snap["count"] == 100
        assert snap["sum"] == pytest.approx(50 + 4500 + 25000)
        assert snap["p50"] <= 2 and 100 <= snap["p95"] <= 128
        assert snap["p99"] <= 5000 and snap["max"] == 5000
        return snap

    twin(drill)


def test_render_prometheus_style():
    def drill(p):
        fresh(p)
        s = p.tele.scope("net", {"bad_frames": 2})
        s.hist("lat").observe(10)
        text = p.tele.render()
        assert "# TYPE pmdfc_net0_bad_frames counter" in text
        assert "pmdfc_net0_bad_frames 2" in text
        assert 'pmdfc_net0_lat{quantile="p95"}' in text
        assert p.tele.render_snapshot(p.tele.snapshot()) == text
        return text

    twin(drill)


def test_kill_switch_noops_tracing_keeps_counters():
    def drill(p):
        p.tele.configure(p.config.TelemetryConfig(enabled=False))
        s = p.tele.scope("k", {"ops": 0})
        s.inc("ops")
        s.hist("lat").observe(5)
        p.tele.record_span("client", "get", 1, True)
        p.tele.record_event("x")
        p.tele.rung("bad_frame")
        out = (s["ops"], s.hist("lat").snapshot()["count"],
               len(p.tele.get().ring), p.tele.get()._rungs["bad_frame"],
               p.tele.enabled())
        assert out == (1, 0, 0, 1, False)
        return out

    twin(drill)


def test_env_kill_switch_resolution(monkeypatch):
    def drill(p):
        monkeypatch.setenv("PMDFC_TELEMETRY", "off")
        out = [p.config.telemetry_enabled(),
               p.config.telemetry_enabled(default=True)]
        reg = p.tele.configure(p.config.TelemetryConfig(enabled=True))
        out.append(p.tele.enabled())
        monkeypatch.setenv("PMDFC_TELEMETRY", "on")
        out.append(p.config.telemetry_enabled(default=False))
        monkeypatch.delenv("PMDFC_TELEMETRY")
        fresh(p)
        out.append(reg is not p.tele.get())
        assert out == [False, False, False, True, True]
        return out

    twin(drill)


def test_set_enabled_runtime_toggle():
    def drill(p):
        fresh(p)
        p.tele.record_span("client", "get", 1, True)
        p.tele.set_enabled(False)
        p.tele.record_span("client", "get", 2, True)
        p.tele.set_enabled(True)
        p.tele.record_span("client", "get", 3, True)
        traces = [r["trace"] for r in p.tele.get().ring]
        assert traces == [1, 3]
        return traces

    twin(drill)


def test_mint_trace_32bit_nonzero(monkeypatch):
    def drill(p):
        fresh(p)
        seen = {p.tele.mint_trace() for _ in range(1000)}
        assert all(0 < t <= 0xFFFFFFFF for t in seen)
        assert len(seen) == 1000
        # from one start, the same ids across the 32-bit wrap
        monkeypatch.setattr(p.tele, "_TRACE_CTR",
                            itertools.count(0xFFFFFFFD))
        return [p.tele.mint_trace() for _ in range(5)]

    assert twin(drill) == [0xFFFFFFFD, 0xFFFFFFFE, 0xFFFFFFFF, 1, 1]


# --- 2. trace-id propagation ---------------------------------------------------


def _span_index(reg):
    spans = [r for r in reg.ring if r.get("kind") == "span"]
    return ([s for s in spans if s["src"] == "client"],
            {s["trace"] for s in spans if s["src"] == "server"})


def test_trace_negotiation_and_server_spans():
    def drill(p):
        reg = fresh(p)
        shared = p.backends.LocalBackend(page_words=W, capacity=1 << 12)
        srv = p.net.NetServer(lambda: shared,
                              net=p.config.NetConfig()).start()
        out = []
        try:
            for pipe in (True, False):
                with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                      keepalive_s=None, pipeline=pipe) as be:
                    keys = _keys(8, seed=3)
                    be.put(keys, _pages(keys))
                    _, found = be.get(keys)
                    out.append((be.traced, be.pipelined, found))
        finally:
            stop(srv)
        client, server_traces = _span_index(reg)
        ok = [s for s in client if s["ok"] and s["op"] in ("put", "get")]
        assert len(ok) >= 4
        for s in ok:
            assert s["trace"] != 0 and s["trace"] in server_traces, s
            assert s["dur_us"] > 0
        out.append(sorted(s["op"] for s in ok))
        return out

    out = twin(drill)
    assert [o[:2] for o in out[:2]] == [(True, True), (True, False)]


def test_trace_off_when_telemetry_disabled():
    def drill(p):
        p.tele.configure(p.config.TelemetryConfig(enabled=False))
        shared = p.backends.LocalBackend(page_words=W, capacity=1 << 12)
        srv = p.net.NetServer(lambda: shared).start()
        try:
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None) as be:
                traced = be.traced
                _, found = be.get(_keys(4))
        finally:
            stop(srv)
        ring = len(p.tele.get().ring)
        assert not traced and not found.any() and ring == 0
        return traced, found, ring

    twin(drill)


CHAOS_RATES = {"flip": 0.01, "truncate": 0.005, "duplicate": 0.01}


def chaos_traces(p) -> dict:
    """JAX's seed-17 chaos soak over a pipelined window of 8 -> what its
    invariants read."""
    reg = fresh(p)
    shared = p.backends.LocalBackend(page_words=W, capacity=1 << 13)
    srv = p.net.NetServer(lambda: shared, net=p.config.NetConfig()).start()
    wrong = 0
    try:
        with p.failure.ChaosProxy("127.0.0.1", srv.port, seed=17,
                                  rates=CHAOS_RATES) as px:
            def factory():
                return p.net.TcpBackend(
                    "127.0.0.1", px.port, page_words=W, keepalive_s=None,
                    op_timeout_s=1.0, pipeline=True, window=8)

            rc = p.failure.ReconnectingClient(
                factory, page_words=W, retry_delay_s=0.002,
                max_retry_delay_s=0.02, seed=17)
            keys = _keys(128, seed=17)
            pages = _pages(keys)
            rng = np.random.default_rng(17)
            for _ in range(300):
                lo = int(rng.integers(0, 96))
                n = int(rng.integers(1, 16))
                if rng.integers(2):
                    rc.put(keys[lo:lo + n], pages[lo:lo + n])
                else:
                    out, found = rc.get(keys[lo:lo + n])
                    wrong += int((out[found] != pages[lo:lo + n][found])
                                 .any(axis=1).sum())
                if not rc.connected:
                    time.sleep(0.003)
            rc.close()
            fired = sum(v for k, v in px.stats.items()
                        if k.endswith("_frames") and k != "forwarded_frames")
    finally:
        stop(srv)
    client, server_traces = _span_index(reg)
    verbs = [s for s in client if s["op"] in ("put", "get", "invalidate")]
    return {"completed": [s for s in verbs if s["ok"]],
            "failed": [s for s in verbs if not s["ok"]],
            "server": server_traces, "fired": fired, "wrong": wrong}


def test_trace_ids_match_under_chaos():
    for p in PKGS:
        r = chaos_traces(p)
        assert len(r["completed"]) > 50, "soak barely ran"
        assert r["fired"] > 0 and r["failed"], (r["fired"], len(r["failed"]))
        missing = [s for s in r["completed"] if s["trace"] not in r["server"]]
        assert not missing, f"{len(missing)} completed verbs lack spans"
        for s in r["failed"]:
            assert s["err"], s
            assert s["span"] and 0 < s["span"] <= 0xFFFFFFFF
            assert s["t1_ns"] >= s["t0_ns"] and s["dur_us"] >= 0
        assert r["wrong"] == 0


# --- 3. flight recorder --------------------------------------------------------


def test_rung3_phase_failure_dump_attributes_conn_and_phase(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("PMDFC_CONTAINMENT", "off")

    def drill(p):
        root = tmp_path / p.config.__name__.split(".")[0]
        root.mkdir()
        fresh(p, ring_capacity=1 << 14, dump_dir=str(root),
              dump_min_interval_s=0.0)

        class Poisoned(p.backends.LocalBackend):
            def get(self, keys):
                raise RuntimeError("injected phase failure")

        shared = Poisoned(page_words=W, capacity=1 << 10)
        srv = p.net.NetServer(lambda: shared,
                              net=p.config.NetConfig()).start()
        try:
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None, op_timeout_s=5.0) as be:
                keys = _keys(4, seed=9)
                be.put(keys, _pages(keys))
                with pytest.raises((ConnectionError, OSError)):
                    be.get(keys)
                deadline = time.time() + 5
                while not _dumps(root, "phase_failure") \
                        and time.time() < deadline:
                    time.sleep(0.02)
        finally:
            stop(srv)
        docs = _dumps(root, "phase_failure")
        assert docs, "no phase_failure dump written"
        d = docs[0]
        fails = [r for r in d["records"] if r.get("kind") == "span"
                 and r.get("src") == "server" and not r.get("ok")]
        assert d["detail"]["conns"]
        assert any(r.get("conn") in d["detail"]["conns"] for r in fails)
        assert d["telemetry"]["counters"]["rung.phase_failure"] >= 1
        assert [c.check_flight(d) for c in (jcheck, tcheck)] \
            == [[], []]
        return (d["schema"], d["rung"], d["detail"]["phase"],
                len(d["detail"]["conns"]), d["detail"]["ops"] >= 1,
                sorted(d["detail"]))

    out = twin(drill)
    assert out[:3] == ("pmdfc-flight-v2", "phase_failure", "get")


def test_rung5_replica_exhausted_dump_attributes_endpoints(tmp_path):
    def drill(p):
        root = tmp_path / p.config.__name__.split(".")[0]
        root.mkdir()
        fresh(p, ring_capacity=1 << 14, dump_dir=str(root),
              dump_min_interval_s=0.0)

        def dead_factory():
            raise ConnectionError("server down")

        eps = [p.failure.ReconnectingClient(dead_factory, page_words=W,
                                            retry_delay_s=0.001,
                                            max_retry_delay_s=0.01, seed=i)
               for i in range(2)]
        cfg = p.config.ReplicaConfig(n_replicas=2, rf=2, hedge_ms=1.0,
                                     breaker_failures=2,
                                     breaker_cooldown_s=30.0,
                                     repair_interval_s=0.0)
        keys = _keys(8, seed=5)
        with REPLICA[id(p)].ReplicaGroup(eps, page_words=W, cfg=cfg,
                                         seed=5) as g:
            founds = [g.get(keys)[1] for _ in range(5)]
            states = [br.state for br in g.breakers]
            shed = g.counters["load_shed_gets"]
        assert not any(f.any() for f in founds)
        assert states == ["open", "open"] and shed > 0
        opens = _dumps(root, "breaker_open")
        sheds = _dumps(root, "replica_exhausted")
        assert opens and sheds
        d = sheds[-1]["detail"]
        return (states, shed, sorted(o["detail"]["endpoint"] for o in opens),
                d["op"], sorted(d["open_endpoints"]), d["keys"], len(sheds))

    out = twin(drill)
    assert out[2][0].startswith("replica") and out[3:5] == ("get", [0, 1])


def test_dump_cooldown_limits_writes(tmp_path):
    def drill(p):
        root = tmp_path / p.config.__name__.split(".")[0]
        root.mkdir()
        fresh(p, dump_dir=str(root), dump_min_interval_s=60.0)
        for _ in range(5):
            p.tele.rung("bad_frame", conn=1)
        out = (len(_dumps(root, "bad_frame")),
               p.tele.get()._rungs["bad_frame"])
        assert out == (1, 5)
        return out

    twin(drill)


# --- 4. wire export and schema -------------------------------------------------


def test_msg_stats_ships_registry_and_schema_conforms(tmp_path, capsys):
    def drill(p):
        fresh(p)
        shared = p.backends.LocalBackend(page_words=W, capacity=1 << 10)
        srv = p.net.NetServer(lambda: shared,
                              net=p.config.NetConfig()).start()
        try:
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None) as be:
                keys = _keys(8, seed=1)
                be.put(keys, _pages(keys))
                be.get(keys)
                doc = be.server_stats()
        finally:
            stop(srv)
        snap = doc["telemetry"]
        assert "stored" in doc and "workload" in doc
        assert snap["schema"] == "pmdfc-telemetry-v2"
        assert any(k.endswith(".ops") for k in snap["counters"])
        assert any(k.endswith("get_us") for k in snap["histograms"])
        # both check functions pass it: the root checker's, and the
        # port's CLI on the same document as a file
        path = tmp_path / f"{p.config.__name__.split('.')[0]}.json"
        path.write_text(json.dumps(doc))
        assert jcheck.check(doc) == []
        assert tcheck.main([str(path)]) == 0
        bad = json.loads(json.dumps(doc))
        bad["telemetry"]["counters"]["net0.ops"] = "three"
        path.write_text(json.dumps(bad))
        assert jcheck.check(bad) and tcheck.main([str(path)]) == 1
        assert jcheck.check({}) != []
        return (sorted(doc), snap["schema"], sorted(snap),
                doc["stored"], snap["counters"]["net0.ops"])

    twin(drill)


# --- 5. migrated stats surfaces ------------------------------------------------


def test_reconnecting_client_counters_shim_removed():
    def drill(p):
        fresh(p)
        rc = p.failure.ReconnectingClient(
            lambda: (_ for _ in ()).throw(ConnectionError()), page_words=W)
        rc.get(_keys(3))
        out = (rc.stats(), hasattr(rc, "counters"))
        assert out[0]["missed_gets"] == 3 and not out[1]
        return out

    twin(drill)


def test_integrity_backend_namespaces_wrapper_counters():
    def drill(p):
        fresh(p)
        be = p.backends.IntegrityBackend(
            p.backends.LocalBackend(page_words=W))
        keys = _keys(4, seed=2)
        be.put(keys, _pages(keys))
        _, found = be.get(keys)
        s = be.stats()
        assert found.all() and s["integrity.verified_gets"] == 4
        assert s["integrity.corrupt_pages"] == 0
        assert "client_corrupt_pages" not in s
        inner = be._be._store
        kk = (int(keys[0][0]), int(keys[0][1]))
        inner[kk] = inner[kk] + 1
        out, found2 = be.get(keys)
        assert not found2[0] and be.counters["corrupt_pages"] == 1
        assert p.tele.get()._rungs["digest_mismatch"] >= 1
        return (s, found2, out[found2], dict(be.counters),
                p.tele.get()._rungs["digest_mismatch"])

    twin(drill)
