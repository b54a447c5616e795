"""PyTorch port: `tests/test_bf_push.py`'s bloom-push drills on both packages.

The server pushes its packed filter into each registered client's mirror,
full first, then only the dirty blocks; the safety property is that no
push, however it interleaves with in-flight puts, leaves a false
negative in a mirror. Each drill below runs through the JAX package's
`KVServer` + `Engine` and the port's (`device="cpu"`) on the same seeded
keys, and the mirrors' bits, the bloom queries and the push counters
must be equal across the packages. The drill whose pushes come from the
sender thread depends on timing and is held on each package to the JAX
test's invariants: no pull, no false negative, every put served. The
three drills `tests/test_torch_client.py` already runs against the port
are named in `tests/test_torch_twins.py`.
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import fresh_jax_registry, registries, twin  # noqa: F401

import pmdfc_tpu.client.backends as jbackends
import pmdfc_tpu.client.cleancache as jcc
import pmdfc_tpu.config as jconfig
import pmdfc_tpu.runtime.engine as jengine
import pmdfc_tpu.runtime.server as jserver
import pmdfc_tpu.utils.hashing_np as jhnp
import pmdfc_tpu_torch.client.backends as tbackends
import pmdfc_tpu_torch.client.cleancache as tcc
import pmdfc_tpu_torch.config as tconfig
import pmdfc_tpu_torch.runtime.engine as tengine
import pmdfc_tpu_torch.runtime.server as tserver
import pmdfc_tpu_torch.utils.hashing_np as thnp

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("fresh_jax_registry")]

BLOCK_BYTES = 64  # tiny blocks so deltas exercise multi-block paths
PW = 16

JAX = types.SimpleNamespace(
    config=jconfig, backends=jbackends, cc=jcc, engine=jengine,
    hnp=jhnp, server=lambda cfg, eng, **kw: jserver.KVServer(
        cfg, engine=eng, **kw))
PORT = types.SimpleNamespace(
    config=tconfig, backends=tbackends, cc=tcc, engine=tengine,
    hnp=thnp, server=lambda cfg, eng, **kw: tserver.KVServer(
        cfg, engine=eng, device="cpu", **kw))
PKGS = (JAX, PORT)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _server(pkg):
    c = pkg.config
    cfg = c.KVConfig(index=c.IndexConfig(capacity=1 << 12),
                     bloom=c.BloomConfig(num_bits=1 << 13), paged=True,
                     page_words=PW)
    eng = pkg.engine.Engine(num_queues=2, queue_cap=1 << 10, batch=256,
                            timeout_us=200, arena_pages=512,
                            page_bytes=PW * 4)
    return pkg.server(cfg, eng, bf_push_s=0.0, bf_block_bytes=BLOCK_BYTES)


def _close(srv):
    srv.stop()
    srv.engine.close()


def _deletes_drill(pkg):
    srv = _server(pkg)
    try:
        cc = pkg.cc.CleanCacheClient(pkg.backends.DirectBackend(srv.kv))
        srv.register_bf_client(cc)
        keys = _keys(40, seed=3)
        srv.kv.insert(keys, np.zeros((40, PW), np.uint32))
        r1 = srv.push_bloom_now()
        bits1 = np.array(cc._bloom)
        srv.kv.delete(keys[:20])
        r2 = srv.push_bloom_now()
        maybe = pkg.hnp.query_packed_np(cc._bloom, keys, cc.num_hashes)
        return dict(r1=r1, r2=r2, bits1=bits1, bits2=np.array(cc._bloom),
                    server=np.asarray(srv.kv.packed_bloom()), maybe=maybe,
                    stats=dict(srv.bf_push_stats),
                    received=cc.counters["bf_blocks_received"])
    finally:
        _close(srv)


def test_delta_push_reflects_deletes():
    t = twin(_deletes_drill, pkgs=PKGS)
    assert t["maybe"][20:].all()          # present keys: never negative
    assert not t["maybe"][:20].all()      # most deleted keys cleared
    assert np.array_equal(t["bits2"], t["server"])
    assert t["r2"]["blocks"] > 0 and t["stats"]["delta_pushes"] == 1


def _stale_drill(pkg):
    srv = _server(pkg)
    try:
        cc = pkg.cc.CleanCacheClient(pkg.backends.DirectBackend(srv.kv))
        srv.register_bf_client(cc)
        stale = srv.kv.packed_bloom()
        t_stale = time.monotonic()
        cc.put_pages(np.array([4]), np.array([44]),
                     np.arange(PW, dtype=np.uint32)[None])
        overlay = len(cc._overlay)
        cc.receive_bloom_full(srv.kv.packed_bloom(), t_snap=time.monotonic())
        retired = not cc._overlay
        fresh = np.array(cc._bloom)
        cc.receive_bloom_full(stale, t_snap=t_stale)   # out of order
        maybe = pkg.hnp.query_packed_np(
            cc._bloom, np.array([[4, 44]], np.uint32), cc.num_hashes)
        _, found = cc.get_pages(np.array([4]), np.array([44]))
        return dict(overlay=overlay, retired=retired, fresh=fresh,
                    after=np.array(cc._bloom), maybe=maybe, found=found)
    finally:
        _close(srv)


def test_stale_snapshot_delivery_rejected():
    t = twin(_stale_drill, pkgs=PKGS)
    assert t["overlay"] == 1 and t["retired"]
    assert np.array_equal(t["after"], t["fresh"])   # the stale one ignored
    assert t["maybe"][0] and t["found"][0]


def _push_error_drill(pkg):
    class BadSink:
        def receive_bloom_full(self, *a, **k):
            raise RuntimeError("boom")

    srv = _server(pkg)
    try:
        good = pkg.cc.CleanCacheClient(pkg.backends.DirectBackend(srv.kv))
        srv.register_bf_client(BadSink())
        srv.register_bf_client(good)
        srv.kv.insert(_keys(10, seed=8), np.zeros((10, PW), np.uint32))
        r = srv.push_bloom_now()
        return dict(r=r, stats=dict(srv.bf_push_stats),
                    good=np.array(good._bloom),
                    server=np.asarray(srv.kv.packed_bloom()))
    finally:
        _close(srv)


def test_push_error_does_not_kill_other_clients():
    t = twin(_push_error_drill, pkgs=PKGS)
    assert t["stats"]["errors"] == 1
    assert np.array_equal(t["good"], t["server"])


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_pushed_client_stops_pulling(pkg):
    """The sender thread on each package: the mirror tracks the server
    without one `refresh_bloom()` pull; after a settling push it holds
    every completed put, and every put serves."""
    srv = _server(pkg).start()
    try:
        srv.bf_push_s = 0.01
        srv._bf_thread = threading.Thread(target=srv._bf_push_loop,
                                          daemon=True)
        srv._bf_thread.start()
        with pkg.backends.EngineBackend(srv, slice_pages=64) as be:
            cc = pkg.cc.CleanCacheClient(be)
            srv.register_bf_client(cc)
            pulls_before = cc.counters["bf_refreshes"]
            keys = _keys(64, seed=4)
            pages = np.tile(np.arange(PW, dtype=np.uint32), (64, 1))
            for lo in range(0, 64, 16):
                cc.put_pages(keys[lo:lo + 16, 0], keys[lo:lo + 16, 1],
                             pages[lo:lo + 16])
            deadline = time.time() + 5
            while srv.bf_push_stats["cycles"] < 3 \
                    and time.time() < deadline:
                time.sleep(0.01)
            assert srv.bf_push_stats["cycles"] >= 3
            assert cc.counters["bf_pushes"] >= 1   # at least the full push
            srv.push_bloom_now()                   # settle
            assert cc.counters["bf_refreshes"] == pulls_before
            assert pkg.hnp.query_packed_np(cc._bloom, keys,
                                           cc.num_hashes).all()
            out, found = cc.get_pages(keys[:, 0], keys[:, 1])
            assert found.all() and np.array_equal(out, pages)
            # the settled mirror holds the server's filter bit for bit
            assert np.array_equal(np.asarray(cc._bloom) | np.asarray(
                srv.kv.packed_bloom()), np.asarray(cc._bloom))
    finally:
        srv.stop()
        srv.engine.close()
