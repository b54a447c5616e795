"""PyTorch port: `tests/test_net.py`'s socket and frame drills, drill by drill.

Each drill runs the JAX test's script against both packages' `NetServer`
and `TcpBackend` over loopback (a `LocalBackend`, or a `DirectBackend`
over each package's `KV`, the port's on the CPU) and compares the
replies, the server's `net` counters (`NET_COUNTERS` of
`test_torch_net.py`, `bad_frames` and `serve_errors` among them) and
`KV.stats()`. Where the JAX drill's outcome depends on timing (idle
kills, push stamps, the reconnect after a restart, processes) both
packages are held to its own invariants and whatever does not depend on
timing is compared. Here: the client's frame bound, the handshake's page
words, the clean-cache client, the idle timeout against keepalive, the
reconnect over a restart on the same port, client processes (the port's
in interpreters that refuse JAX), garbage and truncated frames, the
`EngineBackend` factory behind the wire, the bloom push (a full filter
then deltas), the pull/push stamp domains, the stale delta's OR merge
and the push race.
`test_torch_net_pipes.py` holds the pipelined and chaos drills.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import threading
import time
import types
import zlib

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from test_torch_net import NET_COUNTERS, _Sink
from torch_twin import JAX as _JAX
from torch_twin import PORT as _PORT
from torch_twin import (counters, fresh_jax_registry,  # noqa: F401
                        registries, stop)
from torch_twin import twin as twin_of

import chip_smoke
import pmdfc_tpu.runtime.engine as jengine
import pmdfc_tpu.runtime.server as jserver
import pmdfc_tpu.utils.hashing_np as jhash
import pmdfc_tpu_torch.runtime.engine as tengine
import pmdfc_tpu_torch.runtime.server as tserver
import pmdfc_tpu_torch.utils.hashing_np as thash

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

W = 16
JAX = types.SimpleNamespace(**vars(_JAX), name="pmdfc_tpu", engine=jengine,
                            server=jserver, hashing=jhash, server_kw={})
PORT = types.SimpleNamespace(**vars(_PORT), name="pmdfc_tpu_torch",
                             engine=tengine, server=tserver, hashing=thash,
                             server_kw={"device": "cpu"})
PKGS = (JAX, PORT)


def twin(drill, *args):
    """`drill(pkg, *args)` on JAX, then on the port: equal transcripts."""
    return twin_of(drill, *args, pkgs=PKGS)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 0] * 7 + keys[:, 1])[:, None] + np.arange(
        W, dtype=np.uint32)


def _cfg(p, capacity=1 << 12):
    c = p.config
    return c.KVConfig(index=c.IndexConfig(capacity=capacity),
                      bloom=c.BloomConfig(num_bits=1 << 13), paged=True,
                      page_words=W)


def _local_server(p, **kw):
    shared = p.backends.LocalBackend(page_words=W, capacity=1 << 12)
    return p.net.NetServer(lambda: shared, **kw).start(), shared


def _kv_server(p, capacity=1 << 12, **kw):
    kv = p.KV(_cfg(p, capacity))
    shared = p.backends.DirectBackend(kv)
    return p.net.NetServer(lambda: shared, **kw).start(), kv


def _net(srv) -> dict:
    return {k: int(srv.stats[k]) for k in NET_COUNTERS}


def _settled(srv, key: str, at_least: int, timeout: float = 5.0) -> dict:
    """The server's counters once `key` reached `at_least` and nothing
    moved for 0.2 s (reader threads count after the client returns)."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        now = _net(srv)
        if now[key] >= at_least and now == last:
            return now
        last = now
        time.sleep(0.2)
    return _net(srv)


def _tcp(p, port, **kw):
    kw.setdefault("keepalive_s", None)
    return p.net.TcpBackend("127.0.0.1", port, page_words=W, **kw)


def _wait_push(srv):
    deadline = time.time() + 5
    while not any(d["push"] for d in srv._clients.values()) \
            and time.time() < deadline:
        time.sleep(0.01)


# --- frames and handshakes -----------------------------------------------


def _oversized_frame(p):
    net, held = p.net, []

    def evil(port_box, ready):
        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)
        port_box.append(lsock.getsockname()[1])
        ready.set()
        conn, _ = lsock.accept()
        held.append(conn)
        conn.recv(1 << 16)  # the HOLA
        net._send_msg(conn, net.MSG_HOLASI, words=W)
        conn.recv(1 << 16)  # the GET
        # the reply's header claims 256 MiB, over the client's 1 MiB bound
        conn.sendall(net._HDR.pack(net.MAGIC, net.MSG_SENDPAGE, 0, 0, W, 0,
                                   256 << 20, 0))
        lsock.close()

    port_box, ready = [], threading.Event()
    th = threading.Thread(target=evil, args=(port_box, ready), daemon=True)
    th.start()
    assert ready.wait(5)
    be = _tcp(p, port_box[0], max_frame_bytes=1 << 20)
    with pytest.raises((net.ProtocolError, ConnectionError, ValueError)) as e:
        be.get(_keys(4))
    th.join(timeout=5)
    for c in held:
        c.close()
    return type(e.value).__name__


def test_client_bounds_oversized_server_frame():
    """Each package's client fails the read of a reply whose header
    announces a payload past its `max_frame_bytes`, with the same error."""
    assert twin(_oversized_frame) in ("ProtocolError", "ConnectionError",
                                      "ValueError")


def _handshake(p):
    srv, _ = _local_server(p)
    out = []
    try:
        for c in PKGS:  # both packages' clients against this server
            with pytest.raises(c.net.ProtocolError):
                c.net.TcpBackend("127.0.0.1", srv.port, page_words=W * 2)
            be = _tcp(c, srv.port)
            keys = _keys(8)
            be.put(keys, _pages(keys))
            out.append(be.get(keys))
            be.close()
        out.append(_settled(srv, "ops", 4))
    finally:
        stop(srv)
    return out


def test_handshake_word_mismatch_rejected():
    """Both packages' clients refuse each server's reply to a HOLA with
    the wrong page words; the refused handshakes count no connection."""
    out = twin(_handshake)
    assert out[0][1].all() and out[1][1].all()
    assert out[2]["connects"] == 2 and out[2]["bad_frames"] == 0


def _garbage(p):
    net = p.net
    srv, _ = _local_server(p)
    socks, out = [], []
    try:
        good = _tcp(p, srv.port)
        keys = _keys(8)
        good.put(keys, _pages(keys))
        s1 = socket.create_connection(("127.0.0.1", srv.port))
        socks.append(s1)
        s1.sendall(b"\xde\xad\xbe\xef" * 9)  # bad magic
        s2 = socket.create_connection(("127.0.0.1", srv.port))
        s2.sendall(b"\x13\xfc")  # a truncated header, then close
        s2.close()
        s3 = socket.create_connection(("127.0.0.1", srv.port))
        socks.append(s3)
        s3.sendall(net._HDR.pack(0xFC13, 0, 0, 0, 0, 0, 1 << 40, 0))
        s4 = socket.create_connection(("127.0.0.1", srv.port))
        socks.append(s4)
        s4.settimeout(5)
        net._send_msg(s4, net.MSG_HOLA, count=77, words=W)
        s4.recv(4096)  # HOLASI
        net._send_msg(s4, 99)  # a valid frame, an unknown verb
        s5 = socket.create_connection(("127.0.0.1", srv.port))
        socks.append(s5)
        s5.settimeout(5)
        net._send_msg(s5, net.MSG_HOLA, count=78, words=W)
        s5.recv(4096)
        kk = _keys(4)
        body = (np.ascontiguousarray(kk, np.uint32).tobytes()
                + _pages(kk).tobytes())
        hdr0 = net._HDR.pack(0xFC13, net.MSG_PUTPAGE, 0, 4, W, 0,
                             len(body), 0)
        crc = zlib.crc32(body, zlib.crc32(hdr0))
        frame = bytearray(hdr0[:-4] + crc.to_bytes(4, "little") + body)
        frame[net._HDR.size + 10] ^= 0x40  # the in-flight bit flip
        s5.sendall(bytes(frame))
        time.sleep(0.2)
        out.append(good.get(keys))  # the healthy client still serves
        counted = _settled(srv, "bad_frames", 2)
        out.append(good.get(kk))  # the flipped put did not land
        good.close()
        out.append(counted)
    finally:
        for s in socks:
            s.close()
        stop(srv)
    return out


def test_server_survives_garbage_and_truncation():
    out = twin(_garbage)
    got, found = out[0]
    assert found.all() and np.array_equal(got, _pages(_keys(8)))
    assert not out[1][1].any(), "a corrupted frame's payload was applied"
    assert out[2]["bad_frames"] >= 2 and out[2]["serve_errors"] == 0


def _kill_op_conn(p):
    net = p.net
    srv, _ = _local_server(p)
    out = []
    try:
        a, b = socket.socketpair()
        cs = net._ConnState(a, {"addr": "drill"})
        op1 = net._StagedOp(cs, 0, 1, 0, 0)
        op2 = net._StagedOp(cs, 0, 2, 0, 0)  # a second phase, same conn
        drops: list = []
        orig = srv._drop_conn
        srv._drop_conn = lambda conn: drops.append(conn)
        try:
            srv._kill_op_conn(op1)
            out.append((cs.alive, len(drops)))
            srv._kill_op_conn(op2)
            out.append((cs.alive, len(drops)))
        finally:
            srv._drop_conn = orig
        a.close()
        b.close()
    finally:
        stop(srv)
    return out


def test_kill_op_conn_is_idempotent():
    assert twin(_kill_op_conn) == [(False, 1), (False, 1)]


# --- clients over the wire -------------------------------------------------


def _cleancache(p):
    srv, kv = _kv_server(p)
    out = []
    try:
        be = _tcp(p, srv.port)
        cc = p.cleancache.CleanCacheClient(be)
        oids = np.full(32, 7, np.uint32)
        idxs = np.arange(32, dtype=np.uint32)
        pages = np.arange(32, dtype=np.uint32)[:, None] + np.zeros(
            (32, W), np.uint32)
        cc.put_pages(oids, idxs, pages)
        out.append(cc.get_pages(oids, idxs))
        out.append(cc.get_page(7, 999) is None)
        # the client's pull fetches the real packed filter over the wire
        cc.refresh_bloom()
        out.append(np.array(cc._bloom))
        assert np.array_equal(cc._bloom, np.asarray(kv.packed_bloom()))
        out.append(dict(cc.counters))
        cc.close()
        be.close()
        out.append(_settled(srv, "ops", 1))
    finally:
        stop(srv)
    out.append(counters(kv.stats()))
    return out


def test_cleancache_client_over_tcp():
    out = twin(_cleancache)
    got, found = out[0]
    assert found.all() and out[1]
    assert np.array_equal(got, np.arange(32, dtype=np.uint32)[:, None]
                          + np.zeros((32, W), np.uint32))


def _engine_factory(p):
    eng = p.engine.Engine(num_queues=2, queue_cap=1 << 10, batch=256,
                          timeout_us=200, arena_pages=512, page_bytes=W * 4)
    ksrv = p.server.KVServer(_cfg(p), engine=eng, **p.server_kw).start()
    out = []
    try:
        srv = p.net.NetServer(
            lambda: p.backends.EngineBackend(ksrv)).start()
        try:
            b1, b2 = _tcp(p, srv.port), _tcp(p, srv.port)
            k1, k2 = _keys(32, seed=41), _keys(32, seed=42)
            # interleaved clients: their arena slices never bleed
            b1.put(k1, _pages(k1))
            b2.put(k2, _pages(k2))
            out.append(b1.get(k1))
            out.append(b2.get(k2))
            out.append(b1.get(_keys(8, seed=43)))
            b1.close()
            b2.close()
            out.append(_settled(srv, "ops", 5))
        finally:
            stop(srv)
        out.append(counters(ksrv.kv.stats()))
        out.append(ksrv.health()["serve_errors"])
    finally:
        ksrv.stop()
    return out


def test_engine_backend_factory_over_tcp():
    out = twin(_engine_factory)
    for (got, found), k in zip(out[:2], (41, 42)):
        assert found.all() and np.array_equal(got, _pages(_keys(32, seed=k)))
    assert not out[2][1].any()
    assert out[3]["serve_errors"] == 0 and out[5] == 0


def _idle_timeout(p):
    srv, _ = _local_server(p, idle_timeout_s=0.3)
    out = []
    try:
        # no keepalive: the connection dies after idling past the timeout
        be = _tcp(p, srv.port)
        keys = _keys(4)
        be.put(keys, _pages(keys))
        time.sleep(0.8)
        with pytest.raises(ConnectionError):
            be.put(keys, _pages(keys))
        kills = int(srv.stats["idle_kills"])
        assert kills >= 1
        # keepalive faster than the timeout: the connection survives
        be2 = _tcp(p, srv.port, keepalive_s=0.1)
        be2.put(keys, _pages(keys))
        time.sleep(0.8)
        be2.put(keys, _pages(keys))
        out.append(be2.get(keys))
        be2.close()
        out.append(int(srv.stats["idle_kills"]) == kills)
    finally:
        stop(srv)
    return out


def test_idle_timeout_kills_and_keepalive_survives():
    out = twin(_idle_timeout)
    assert out[0][1].all() and out[1]


def _reconnect_restart(p):
    srv, shared = _local_server(p)
    port = srv.port

    def factory():
        return _tcp(p, port)

    rc = p.failure.ReconnectingClient(factory, page_words=W,
                                      retry_delay_s=0.01)
    keys = _keys(32, seed=11)
    pages = _pages(keys)
    rc.put(keys, pages)
    out = [rc.get(keys)]
    stop(srv)
    out.append(rc.get(keys))   # degraded, nothing escapes
    rc.put(keys, pages)        # a dropped put is legal
    rc.invalidate(keys[:4])    # journaled for the replay
    assert rc.stats()["disconnects"] >= 1
    # the same store back on the same port (a restore's analog: the
    # invalidated keys live there until the journal replays)
    srv2 = p.net.NetServer(lambda: shared, port=port).start()
    try:
        deadline = time.time() + 5
        while time.time() < deadline:
            got, found = rc.get(keys[4:])
            if found.all():
                break
            time.sleep(0.05)
        out.append((got, found))
        out.append(rc.get(keys[:4]))
        s = rc.stats()
        assert s["reconnects"] >= 1 and s["replayed_invalidates"] >= 4
        out.append(s["replayed_invalidates"])
    finally:
        rc.close()
        stop(srv2)
    return out


def test_reconnecting_client_over_tcp_restart():
    out = twin(_reconnect_restart)
    keys = _keys(32, seed=11)
    assert out[0][1].all() and not out[1][1].any()
    got, found = out[2]
    assert found.all() and np.array_equal(got, _pages(keys)[4:])
    assert not out[3][1].any()  # the journal replayed: gone again


_CHILD = r"""
import sys
import numpy as np
from {pkg}.runtime.net import TcpBackend

port, W, seed = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
rng = np.random.default_rng(seed)
flat = rng.choice(1 << 22, size=128, replace=False)
keys = np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)
pages = (keys[:, 0] * 7 + keys[:, 1])[:, None] + np.arange(W, dtype=np.uint32)
with TcpBackend("127.0.0.1", port, page_words=W) as be:
    be.put(keys, pages)
    out, found = be.get(keys)
    assert found.all(), found.sum()
    assert np.array_equal(out, pages)
print("CHILD_OK")
"""


def _processes(p):
    """Three client processes of package `p` against its server; the
    port's children run where importing JAX or the JAX package raises."""
    srv, shared = _local_server(p)
    code = _CHILD.format(pkg=p.name)
    if p is PORT:
        code = chip_smoke.NO_JAX_PRELUDE + code
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(srv.port), str(W), str(seed)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for seed in (1, 2, 3)]
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err
            assert "CHILD_OK" in out
        counted = _settled(srv, "connects", 3)
    finally:
        stop(srv)
    return counted, len(shared._store)


def test_multiprocess_clients():
    counted, held = twin(_processes)
    assert counted["connects"] == 3 and held == 3 * 128


# --- the bloom mirror over the wire ----------------------------------------


def _wait_frames(sink, n):
    deadline = time.time() + 5
    while len(sink.frames) <= n and time.time() < deadline:
        time.sleep(0.01)


def _bf_push(p):
    srv, kv = _kv_server(p, bf_block_bytes=64)
    try:
        sink = _Sink()
        be = _tcp(p, srv.port, bloom_sink=sink)
        keys = _keys(32)
        be.put(keys, _pages(keys))
        _wait_push(srv)
        srv.push_bloom_now()
        _wait_frames(sink, 0)
        assert sink.frames and sink.frames[0][0] == "full"
        assert np.array_equal(sink.frames[0][1], np.asarray(kv.packed_bloom()))
        n0 = len(sink.frames)
        srv.push_bloom_now()  # no change: nothing travels
        time.sleep(0.2)
        assert len(sink.frames) == n0
        more = _keys(8, seed=5)
        be.put(more, _pages(more))
        srv.push_bloom_now()  # only the dirtied blocks travel
        _wait_frames(sink, n0)
        kind, idx, blocks, wpb = sink.frames[-1]
        full = np.asarray(kv.packed_bloom())
        assert kind == "delta"
        assert np.array_equal(blocks, full.reshape(-1, wpb)[idx])
        assert len(idx) < len(full) // wpb  # strictly partial
        be.close()
        return sink.frames, _settled(srv, "ops", 2)
    finally:
        stop(srv)


def test_bf_push_full_then_delta():
    """The push channel over the wire: a full filter first, nothing when
    nothing changed, then only the dirtied blocks; the same frames and
    counters from both packages' servers."""
    frames, st = twin(_bf_push)
    assert [f[0] for f in frames] == ["full", "delta"]
    assert st["full_pushes"] == 1 and st["delta_pushes"] >= 1


def _pull_then_push(p):
    srv, kv = _kv_server(p, bf_block_bytes=64)
    try:
        be = _tcp(p, srv.port)
        cc = p.cleancache.CleanCacheClient(be)  # __init__ pulls
        push_be = _tcp(p, srv.port, bloom_sink=cc, client_id=be.client_id)
        _wait_push(srv)
        ks = _keys(4, seed=11)
        cc.put_pages(ks[:, 0], ks[:, 1], _pages(ks))
        cc.refresh_bloom()
        # another client's put dirties the filter: the next push must be
        # applied, not refused as stale
        other = _tcp(p, srv.port)
        more = _keys(8, seed=12)
        other.put(more, _pages(more))
        n0 = cc.counters["bf_pushes"]
        srv.push_bloom_now()
        deadline = time.time() + 5
        while cc.counters["bf_pushes"] == n0 and time.time() < deadline:
            time.sleep(0.01)
        assert cc.counters["bf_pushes"] > n0, (
            f"{p.name}: the push after a pull was refused as stale")
        with cc._bloom_lock:
            assert p.hashing.query_packed_np(cc._bloom, more,
                                             cc.num_hashes).all()
        other.close()
        push_be.close()
        be.close()
        return np.asarray(kv.packed_bloom())
    finally:
        stop(srv)


def test_pull_then_push_stamp_domains_coherent():
    twin(_pull_then_push)


def _stale_delta(p):
    kv = p.KV(_cfg(p))
    cc = p.cleancache.CleanCacheClient(p.backends.DirectBackend(kv))
    full0 = np.asarray(kv.packed_bloom())
    cc.receive_bloom_full(full0, t_snap=time.monotonic())
    t_stale = time.monotonic()
    ks = _keys(6, seed=21)
    kv.insert(ks, _pages(ks))
    packed = np.asarray(kv.packed_bloom())
    wpb = 16
    diff = (full0 ^ packed).reshape(-1, wpb)
    idx = np.flatnonzero((diff != 0).any(axis=1))
    blocks = packed.reshape(-1, wpb)[idx]
    cc.receive_bloom_full(packed, t_snap=time.monotonic())  # newer first
    before = cc._bloom.copy()
    cc.receive_bloom_blocks(idx, blocks, wpb, t_snap=t_stale)  # then stale
    with cc._bloom_lock:
        after = cc._bloom.copy()
        assert (after & before == before).all(), "a stale delta cleared bits"
        assert p.hashing.query_packed_np(after, ks, cc.num_hashes).all()
    return [full0, idx, before, after]


def test_stale_delta_or_merges_instead_of_dropping():
    twin(_stale_delta)


def _push_race(p):
    srv, kv = _kv_server(p, bf_block_bytes=64)
    try:
        be = _tcp(p, srv.port)
        cc = p.cleancache.CleanCacheClient(be)
        push_be = _tcp(p, srv.port, bloom_sink=cc, client_id=be.client_id)
        _wait_push(srv)
        all_keys = _keys(512, seed=3)
        done = threading.Event()

        def pusher():
            while not done.is_set():
                srv.push_bloom_now()
                time.sleep(0.002)

        t = threading.Thread(target=pusher)
        t.start()
        try:
            for lo in range(0, len(all_keys), 16):
                chunk = all_keys[lo:lo + 16]
                cc.put_pages(chunk[:, 0], chunk[:, 1], _pages(chunk))
        finally:
            done.set()
            t.join()
        srv.push_bloom_now()
        time.sleep(0.1)
        # every completed put still passes the client's bloom gate
        with cc._bloom_lock:
            bloom = cc._bloom
            overlay = dict(cc._overlay)
        assert bloom is not None
        in_bloom = p.hashing.query_packed_np(bloom, all_keys, cc.num_hashes)
        in_overlay = np.array([(int(k[0]), int(k[1])) in overlay
                               for k in all_keys])
        assert (in_bloom | in_overlay).all(), f"{p.name}: false negative"
        cc.close()
        push_be.close()
        be.close()
        return np.asarray(kv.packed_bloom()), counters(kv.stats())
    finally:
        stop(srv)


def test_push_race_no_false_negative():
    """The server's filter after the race is the same in both packages
    (every put landed); each client's mirror holds every put key."""
    twin(_push_race)
