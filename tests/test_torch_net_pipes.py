"""PyTorch port: `tests/test_net.py`'s pipelined, chaos and plane drills.

As in `test_torch_net_drills.py`: the JAX test's script against both
packages' `NetServer` and `TcpBackend` over loopback, replies, `net`
counters and `KV.stats()` compared, and the drills whose outcome depends
on timing (cross-connection coalescing, eight threads on one pipelined
connection, the chaos proxy's reconnects) held to their own invariants
on both. Here: pipelining's negotiation and its environment kill switch,
the coalescer fusing connections, the pipelined storm on one shared
connection, the coalesced path against lockstep on a seeded workload,
the three ChaosProxy frame drills (a flipped, a duplicated and a
truncated frame, a half-open peer), the clean-cache stack over a sharded
plane (the port's on a grid naming the CPU eight times, as
`test_torch_plane.py` runs it) and the `multinode` harness.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from test_torch_net_drills import (JAX, PKGS, PORT, W, _keys, _kv_server,
                                   _local_server, _pages, _settled, _tcp,
                                   twin)
from torch_twin import (counters, fresh_jax_registry,  # noqa: F401
                        registries, same, stop)

import pmdfc_tpu.parallel as jparallel
import pmdfc_tpu_torch.parallel as tparallel

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]


def _negotiation(p, monkeypatch):
    out = []
    monkeypatch.delenv("PMDFC_NET_PIPE", raising=False)
    srv, _ = _local_server(p)
    try:
        be = _tcp(p, srv.port, keepalive_s=30.0)
        out.append(be.pipelined)  # a lockstep server still acks seq-echo
        keys = _keys(16)
        be.put(keys, _pages(keys))
        out.append(be.get(keys))
        be.close()
        be2 = _tcp(p, srv.port, pipeline=False)  # explicit opt-out
        out.append(be2.pipelined)
        out.append(be2.get(_keys(16)))
        be2.close()
    finally:
        stop(srv)
    monkeypatch.setenv("PMDFC_NET_PIPE", "off")
    srv2, _ = _local_server(p, net=p.config.NetConfig())
    try:
        out.append(srv2._coalesce)  # the env kills the coalescer too
        be3 = _tcp(p, srv2.port)
        out.append(be3.pipelined)  # no ack: the lockstep fallback
        keys = _keys(8, seed=2)
        be3.put(keys, _pages(keys))
        out.append(be3.get(keys))
        be3.close()
        out.append(_settled(srv2, "ops", 2))
    finally:
        stop(srv2)
    return out


def test_pipeline_negotiation_and_env_killswitch(monkeypatch):
    out = twin(_negotiation, monkeypatch)
    assert out[0] is True and out[2] is False
    assert out[4] is False and out[5] is False
    assert out[1][1].all() and out[3][1].all() and out[6][1].all()


def _fuses(p):
    srv, _ = _local_server(p, net=p.config.NetConfig(
        flush_timeout_us=200_000, settle_us=30_000))
    try:
        n_conns = 6
        bes = [_tcp(p, srv.port) for _ in range(n_conns)]
        all_keys = [_keys(24, seed=60 + i) for i in range(n_conns)]
        barrier = threading.Barrier(n_conns)
        errs: list = []

        def worker(i):
            try:
                barrier.wait()
                bes[i].put(all_keys[i], _pages(all_keys[i]))
                out, found = bes[i].get(all_keys[i])
                assert found.all() and np.array_equal(
                    out, _pages(all_keys[i])), i
                _, f2 = bes[i].get(_keys(8, seed=90 + i))
                assert not f2.any(), i  # padding rows match nothing
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append((i, repr(e)))

        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(n_conns)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not errs, (p.name, errs)
        assert srv.stats["flushes"] >= 1
        assert srv.stats["flush_max"] > 1, (
            f"{p.name}: no cross-connection coalescing happened")
        for b in bes:
            b.close()
        return _settled(srv, "ops", 3 * n_conns)
    finally:
        stop(srv)


@pytest.mark.netpipe
def test_coalesced_server_fuses_across_connections():
    for p in PKGS:
        st = _fuses(p)
        assert st["ops"] == 18 and st["serve_errors"] == 0, p.name


def _storm(p):
    shared = p.backends.LocalBackend(page_words=W, capacity=1 << 13)
    srv = p.net.NetServer(lambda: shared, net=p.config.NetConfig()).start()
    try:
        be = _tcp(p, srv.port, window=16)
        assert be.pipelined
        errs: list = []

        def storm(i):
            try:
                keys = _keys(48, seed=200 + i)
                pages = _pages(keys)
                for _ in range(6):
                    be.put(keys, pages)
                    out, found = be.get(keys)
                    assert found.all() and np.array_equal(out, pages), i
                assert be.invalidate(keys[:8]).all(), i
                _, f2 = be.get(keys[:8])
                assert not f2.any(), i
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append((i, repr(e)))

        ts = [threading.Thread(target=storm, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts), f"{p.name}: stuck waiter"
        assert not errs, (p.name, errs)
        be.close()
        st = _settled(srv, "ops", 8 * 14)
        held = sorted((k, v.tolist()) for k, v in shared._store.items())
        return st["ops"], st["serve_errors"], held
    finally:
        stop(srv)


@pytest.mark.netpipe
def test_pipelined_storm_shared_backend():
    """Eight threads on one pipelined connection: every reply matched by
    its sequence id, and both packages' stores end equal."""
    ops, errors, held = twin(_storm)
    assert ops == 8 * 14 and errors == 0 and len(held) == 8 * 40


def _conformance(p, coalesced: bool):
    srv, kv = _kv_server(
        p, **({"net": p.config.NetConfig(flush_timeout_us=5000,
                                           settle_us=200)}
              if coalesced else {"serialize_ops": True}))
    results = []
    try:
        be = _tcp(p, srv.port, pipeline=coalesced)
        assert be.pipelined == coalesced
        rng = np.random.default_rng(77)
        universe = _keys(256, seed=77)
        for _ in range(120):
            op = int(rng.integers(4))
            lo = int(rng.integers(0, 240))
            n = int(rng.integers(1, 16))
            sel = universe[lo:lo + n]
            if op == 0:
                be.put(sel, _pages(sel))
                results.append(("put", n))
            elif op in (1, 2):
                out, found = be.get(sel)
                results.append(("get", found.tolist(), out[found].tolist()))
            else:
                results.append(("inval", be.invalidate(sel).tolist()))
        be.close()
    finally:
        stop(srv)
    return results, counters(kv.stats())


@pytest.mark.netpipe
def test_coalesced_vs_lockstep_conformance():
    """The seeded mixed workload gives verb-for-verb the same replies and
    `KV.stats()` lockstep and coalesced, in each package and across."""
    runs = [_conformance(p, c) for p in PKGS for c in (False, True)]
    for i, r in enumerate(runs[1:], 1):
        same(runs[0], r, f"conformance run {i}")


def _proxied(p, srv, proxy, **kw):
    kw.setdefault("op_timeout_s", 2.0)

    def factory():
        return _tcp(p, proxy.port, **kw)

    return p.failure.ReconnectingClient(factory, page_words=W,
                                        retry_delay_s=0.01,
                                        max_retry_delay_s=0.2, seed=3)


def _recovered(rc, keys, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out, found = rc.get(keys)
        if found.all():
            return out, found
        time.sleep(0.02)
    return out, found


def _bitflip(p):
    srv, _ = _local_server(p)
    px = p.failure.ChaosProxy("127.0.0.1", srv.port, seed=11)
    try:
        rc = _proxied(p, srv, px)
        keys = _keys(32, seed=51)
        rc.put(keys, _pages(keys))
        px.flip_next(1)
        out = [rc.get(keys)]  # the flipped request: a legal miss
        out.append(_recovered(rc, keys))
        s = rc.stats()
        assert s["disconnects"] >= 1
        out.append((int(srv.stats["bad_frames"]), px.stats["flipped_frames"]))
        rc.close()
        return out
    finally:
        px.close()
        stop(srv)


def test_chaos_bitflip_is_dropped_frame_then_reconnect():
    out = twin(_bitflip)
    got, found = out[0]
    assert not found.any() and not got.any()
    got, found = out[1]
    assert found.all() and np.array_equal(got, _pages(_keys(32, seed=51)))
    assert out[2][0] >= 1 and out[2][1] == 1


def _duplicate(p):
    srv, _ = _local_server(p)
    px = p.failure.ChaosProxy("127.0.0.1", srv.port, seed=12)
    try:
        rc = _proxied(p, srv, px)
        keys = _keys(16, seed=52)
        pages = _pages(keys)
        rc.put(keys, pages)
        px.dup_next(1)
        got, found = rc.get(keys[:8])  # a duplicated GET: two replies
        assert np.array_equal(got[found], pages[:8][found])
        rc.put(keys[:4], pages[:4])  # the desync is detected (legal drop)
        out = [_recovered(rc, keys), px.stats["duplicated_frames"]]
        rc.close()
        return out
    finally:
        px.close()
        stop(srv)


def test_chaos_duplicate_frame_desync_is_detected():
    out = twin(_duplicate)
    got, found = out[0]
    assert found.all() and np.array_equal(got, _pages(_keys(16, seed=52)))
    assert out[1] == 1


def _truncate_half_open(p):
    srv, _ = _local_server(p)
    px = p.failure.ChaosProxy("127.0.0.1", srv.port, seed=13)
    try:
        rc = _proxied(p, srv, px, op_timeout_s=1.0)
        keys = _keys(8, seed=53)
        rc.put(keys, _pages(keys))
        px.truncate_next(1)
        out = [rc.get(keys)]
        deadline = time.time() + 5
        while not rc.connected and time.time() < deadline:
            rc.get(keys[:1])
            time.sleep(0.02)
        assert rc.connected
        px.half_open_next(1)
        t0 = time.monotonic()
        out.append(rc.get(keys))  # swallowed: the recv times out
        dt = time.monotonic() - t0
        assert dt < 4.0, f"{p.name}: a half-open hang not bounded ({dt})"
        out.append((px.stats["truncated_frames"],
                    px.stats["half_open_drops"] >= 1))
        rc.close()
        return out
    finally:
        px.close()
        stop(srv)


def test_chaos_truncated_frame_and_half_open_are_bounded():
    out = twin(_truncate_half_open)
    assert not out[0][1].any() and not out[1][1].any()
    assert out[2] == (1, True)


def _sharded_plane(p):
    cfg = p.config.KVConfig(index=p.config.IndexConfig(capacity=1 << 10),
                            bloom=p.config.BloomConfig(num_bits=1 << 13),
                            paged=True, page_words=W)
    if p is PORT:
        skv = tparallel.ShardedKV(cfg, mesh=tparallel.make_mesh(["cpu"] * 8))
    else:
        skv = jparallel.ShardedKV(cfg)
    assert skv.n_shards == 8
    shared = p.backends.DirectBackend(skv)
    srv = p.net.NetServer(lambda: shared).start()
    out = []
    try:
        be = _tcp(p, srv.port)
        cc = p.cleancache.CleanCacheClient(be)
        keys = _keys(96, seed=31)
        oids, idxs = keys[:, 0], keys[:, 1]
        cc.put_pages(oids, idxs, _pages(keys))
        out.append(cc.get_pages(oids, idxs))
        rep = skv.shard_report()
        out.append(list(rep["occupancy"]))
        out.append(cc.get_page(12345, 67) is None)
        out.append(cc.invalidate_pages(oids[:5], idxs[:5]))
        out.append(cc.get_pages(oids[:5], idxs[:5]))
        # the mirror holds the server's filter: false positives are
        # legal, a missing server bit never is
        cc.refresh_bloom()
        server_bits = np.asarray(skv.packed_bloom())
        assert np.array_equal(cc._bloom | server_bits, cc._bloom)
        out.append(server_bits)
        cc.close()
        be.close()
        out.append(_settled(srv, "ops", 4))
    finally:
        stop(srv)
    out.append(counters(skv.stats()))
    return out


def test_tcp_over_sharded_mesh_server():
    out = twin(_sharded_plane)
    keys = _keys(96, seed=31)
    got, found = out[0]
    assert found.all() and np.array_equal(got, _pages(keys))
    assert sum(1 for o in out[1] if o > 0) >= 4
    assert out[2] and out[3].all() and not out[4][1].any()


_MULTINODE = ["--clients", "2", "--ops", "400", "--file-pages", "128",
              "--ram-pages", "32", "--page-words", "32", "--capacity", "2048"]


def _multinode(module, *extra):
    proc = subprocess.run([sys.executable, "-m", module, *_MULTINODE, *extra],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.slow  # as the JAX drill: a JAX child process compiles
def test_multinode_harness_small():
    """The orchestration driver at test scale, each package's harness in
    its own process (the port's on the CPU): both clients finish, no
    page fails its check, in both."""
    rows = [_multinode("pmdfc_tpu.bench.multinode"),
            _multinode("pmdfc_tpu_torch.bench.multinode", "--device", "cpu")]
    for row in rows:
        assert row["ok"] == 2 and row["verify_failures"] == 0
    assert rows[0]["clients"] == rows[1]["clients"] == 2
