"""PyTorch port: the three `tests/test_qos.py` drills that
`test_torch_qos.py` ran through the port alone, on both packages.

The wire shed drill and the `PMDFC_QOS=off` conformance (`slow` in JAX;
on the card phase 14's `qos_soak` arms) are deterministic: a tenant
whose verbs exceed its bucket's burst sheds whatever the refill timing,
and the kill switch takes the plane away at construction. Each runs its
script over each package's own `NetServer` and `TcpBackend`, and the two
transcripts must be equal: found masks and pages, the `KV`'s counters,
the wire document's miss counters and the tenant lanes. The lock-rank
pin compares the two packages' sanitizer ranks for the QoS lock.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import JAX as _JAX
from torch_twin import PORT as _PORT
from torch_twin import (cause_sum, counters, fresh_jax_registry,  # noqa: F401
                        registries, same, stop)
from torch_twin import twin as twin_of

import pmdfc_tpu.runtime.sanitizer as jsan
import pmdfc_tpu_torch.runtime.sanitizer as tsan
from tools.analyze.lockorder import RANKED_MODULES
from tools.check_teledump import check

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

W = 16
JAX = types.SimpleNamespace(**vars(_JAX), name="jax", san=jsan)
PORT = types.SimpleNamespace(**vars(_PORT), name="port", san=tsan)
PKGS = (JAX, PORT)


def twin(drill, *args):
    return twin_of(drill, *args, pkgs=PKGS)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 0] * 7 + keys[:, 1])[:, None] + np.arange(
        W, dtype=np.uint32)


def test_wire_shed_drill_end_to_end():
    def drill(p):
        c = p.config
        p.tele.configure(c.TelemetryConfig(enabled=True))
        kv = p.KV(c.KVConfig(index=c.IndexConfig(capacity=1 << 12),
                             bloom=c.BloomConfig(num_bits=1 << 13),
                             paged=True, page_words=W))
        qcfg = c.QosConfig(tenant_bits=4, tenants=(
            c.TenantConfig(tid=2, rate_ops_per_s=1.0, burst_ops=4),))
        srv = p.net.NetServer(lambda: p.backends.DirectBackend(kv),
                              net=c.NetConfig(), qos=qcfg).start()
        try:
            assert srv.qos_plane() is not None
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None) as be:
                good = _keys(64, seed=1)
                be.put(good, _pages(good))
                out, found = be.get(good)
                assert found.all() and (out == _pages(good)).all()
                bad = _keys(24, seed=2)
                bad[:, 0] = p.qos.tag_oids(bad[:, 0], 2, 4)
                be.put(bad[:8], _pages(bad[:8]))
                shed = []
                for i in range(3):
                    o, f = be.get(bad[i * 8:(i + 1) * 8])
                    assert not f.any() and not o.any()
                    shed.append(f)
                doc = be.server_stats()
            st = kv.stats()
            assert st["miss_shed"] == 24 and st["drops"] >= 8
            assert st["misses"] == cause_sum(p, st)
            assert int(doc["miss_shed"]) == 24
            assert int(doc["misses"]) == cause_sum(p, doc)
            lane = dict(srv.qos_plane().scope(2))
            assert lane["ops"] == 4 and lane["shed_edge"] == 4
            assert lane["staged"] == 0 and lane["shed_ladder"] == 0
            assert lane["shed_gets"] == 3 and lane["shed_puts"] == 1
            lane0 = dict(srv.qos_plane().scope(0))
            assert lane0["shed_edge"] == 0
            assert check(doc) == []
            wire = {k: int(doc[k]) for k in ("misses", "miss_shed", "gets",
                                             "puts", "drops")}
            return (found, shed, counters(st), wire, lane,
                    {k: int(v) for k, v in lane0.items()})
        finally:
            stop(srv)

    twin(drill)


def test_qos_off_is_single_tenant_fifo(monkeypatch):
    monkeypatch.setenv("PMDFC_QOS", "off")

    def drill(p):
        c = p.config
        p.tele.configure(c.TelemetryConfig(enabled=True))
        qcfg = c.QosConfig(tenant_bits=4, tenants=(
            c.TenantConfig(tid=2, rate_ops_per_s=1.0, burst_ops=1),))
        shared = p.backends.LocalBackend(page_words=W, capacity=1 << 12)
        srv = p.net.NetServer(lambda: shared, net=c.NetConfig(),
                              qos=qcfg).start()
        try:
            assert srv._qos is None
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None) as be:
                keys = _keys(32, seed=4)
                keys[:, 0] = p.qos.tag_oids(keys[:, 0], 2, 4)
                be.put(keys, _pages(keys))
                out, found = be.get(keys)
                assert found.all() and (out == _pages(keys)).all()
                doc = be.server_stats()
            snap = doc.get("telemetry") or {}
            lanes = sorted(k for part in ("counters", "gauges")
                           for k in (snap.get(part) or {}) if ".qos.t" in k)
            assert lanes == []
        finally:
            stop(srv)
        cc = p.cleancache.CleanCacheClient(
            p.backends.LocalBackend(page_words=W, capacity=1 << 10),
            tenant=5, tenant_bits=4)
        oids = np.array([1, 2, 3], np.uint32)
        tagged = np.asarray(cc._tag(oids))
        np.testing.assert_array_equal(tagged, oids)
        return keys, out, found, lanes, tagged

    twin(drill)


def test_lock_rank_and_module_coverage_pins():
    def drill(p):
        h = p.san.HIERARCHY
        assert "TokenBucket._lock" in h
        names = ("NetServer._flush_cv", "TokenBucket._lock",
                 "TcpBackend._lock")
        ranks = [h[n] for n in names]
        assert ranks == sorted(ranks) and len(set(ranks)) == 3
        return ranks

    twin(drill)
    assert "runtime/qos.py" in RANKED_MODULES
