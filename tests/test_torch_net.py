"""PyTorch port: the wire against the JAX package's wire.

One seeded client script (puts, gets, invalidates, extents, a bloom push
to a sink, a pull of the packed filter, a full directory pull, fast
reads, rewrites, a delta directory pull, fast reads again, the
recovering verbs, the stats verb) runs through each package's own
`NetServer` + `TcpBackend` over loopback, on a `DirectBackend` over each
package's `KV` (the port's on the CPU). One connection issues the verbs
in order, lockstep (`NetConfig(coalesce=False)`, `pipeline=False`) and
pipelined into the coalescing server, with `PMDFC_FASTPATH` on and off:
every reply, `KV.stats()` and the `net` counters must be equal. Then the
cross drills (a JAX client against the port's server, and the reverse),
`MSG_PROFILE` on the port's server (every capture refused without a dump
dir; with one, a capture and a refusal inside its cooldown), the
one-sided pool over the wire against JAX's host pool, and a region saved
by one package loaded by the other.
"""

from __future__ import annotations

import contextlib
import socket
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import timeless

import pmdfc_tpu.client.backends as jbackends
import pmdfc_tpu.config as jconfig
import pmdfc_tpu.kv as jkv
import pmdfc_tpu.onesided as jonesided
import pmdfc_tpu.runtime.net as jnet
import pmdfc_tpu.runtime.telemetry as jtele
import pmdfc_tpu_torch.client.backends as tbackends
import pmdfc_tpu_torch.config as tconfig
import pmdfc_tpu_torch.kv as tkv
import pmdfc_tpu_torch.onesided as tonesided
import pmdfc_tpu_torch.runtime.net as tnet

pytestmark = pytest.mark.torch

W = 16
NET_COUNTERS = ("connects", "ops", "bad_frames", "full_pushes",
                "delta_pushes", "blocks_pushed", "push_cycles", "flushes",
                "coalesced_ops", "serve_errors", "pad_rows", "fastpath_hits",
                "fastpath_stale", "dir_pulls", "dir_entries_sent")

JAX = types.SimpleNamespace(
    config=jconfig, net=jnet, backends=jbackends, onesided=jonesided,
    kv=lambda cfg: jkv.KV(cfg))
PORT = types.SimpleNamespace(
    config=tconfig, net=tnet, backends=tbackends, onesided=tonesided,
    kv=lambda cfg: tkv.KV(cfg, device="cpu"))


def _cfg(pkg):
    c = pkg.config
    return c.KVConfig(index=c.IndexConfig(capacity=1 << 10),
                      bloom=c.BloomConfig(num_bits=1 << 13), page_words=W,
                      evicted_sketch_bits=1 << 10)


def _stop(srv):
    """Stop a server of either package without waiting out its accept
    loop's join timeout (a close() alone does not wake a blocked
    accept() on Linux; the port's `stop` shuts the socket down first)."""
    try:
        srv._lsock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.stop()


def _keys(rng, n, hi):
    return np.stack([np.full(n, hi, np.uint32),
                     rng.choice(1 << 20, n, replace=False).astype(np.uint32)],
                    -1)


class _Sink:
    def __init__(self):
        self.frames = []

    def receive_bloom_full(self, packed, t_snap=None):
        self.frames.append(("full", np.array(packed)))

    def receive_bloom_blocks(self, idx, blocks, wpb, t_snap=None):
        self.frames.append(("delta", np.array(idx), np.array(blocks), wpb))


def _script(server_pkg, client_pkg, coalesce: bool):
    """Run the client script; -> (transcript, KV stats, net counters)."""
    kv = server_pkg.kv(_cfg(server_pkg))
    shared = server_pkg.backends.DirectBackend(kv)
    net = server_pkg.config.NetConfig(coalesce=coalesce)
    srv = server_pkg.net.NetServer(lambda: shared, net=net).start()
    out = []
    try:
        sink = _Sink()
        be = client_pkg.net.TcpBackend(
            "127.0.0.1", srv.port, page_words=W, keepalive_s=None,
            client_id=7, pipeline=coalesce, bloom_sink=sink,
            directory=True, op_timeout_s=30.0)
        out.append(("negotiated", be.pipelined, be.fastpath))
        rng = np.random.default_rng(11)
        keys = _keys(rng, 96, 3)
        pages = rng.integers(0, 1 << 32, (96, W), dtype=np.uint32)
        for i in range(0, 96, 32):
            be.put(keys[i:i + 32], pages[i:i + 32])
        probe = np.concatenate([keys[::2], _keys(rng, 16, 4)])
        out.append(("get", *be.get(probe)))
        out.append(("invalidate", be.invalidate(keys[:8])))
        out.append(("get after invalidate", *be.get(keys[:16])))
        for j in range(3):
            key = np.array([9, 4096 * (j + 1)], np.uint32)
            out.append(("insert_extent", be.insert_extent(
                key, np.array([j, 0x10000], np.uint32), 5 + j)))
        ext = np.array([[9, 4096 + o] for o in range(8)], np.uint32)
        out.append(("get_extent", *be.get_extent(ext)))
        srv.push_bloom_now()
        out.append(("packed_bloom", be.packed_bloom()))
        out.append(("dir_refresh full", be.dir_refresh()))
        if be.directory is not None:
            out.append(("directory", len(be.directory),
                        dict(be.directory.counters)))
        out.append(("fast get", *be.get(keys[16:64])))
        # a second connection rewrites and invalidates keys the first
        # one holds in its directory (its own puts drop their entries)
        other = client_pkg.net.TcpBackend(
            "127.0.0.1", srv.port, page_words=W, keepalive_s=None,
            client_id=8, pipeline=coalesce, op_timeout_s=30.0)
        new = rng.integers(0, 1 << 32, (8, W), dtype=np.uint32)
        other.put(keys[16:24], new)
        out.append(("stale fast get", *be.get(keys[16:64])))
        out.append(("invalidate", other.invalidate(keys[60:62])))
        out.append(("after the epoch bump", *be.get(keys[16:64])))
        other.close()
        out.append(("dir_refresh delta", be.dir_refresh()))
        if be.directory is not None:
            out.append(("directory", len(be.directory),
                        dict(be.directory.counters)))
        out.append(("fast get", *be.get(keys[16:64])))
        out.append(("recovery_info", be.recovery_info()))
        out.append(("mark_recovered", be.mark_recovered()))
        stats = be.server_stats()
        out.append(("server_stats", {k: v for k, v in stats.items()
                                     if k in tkv.STAT_NAMES}))
        be.close()
        # the push channel delivered the same frames in both packages
        out.append(("pushes", sink.frames))
    finally:
        _stop(srv)
    kvs = timeless(kv.stats())
    counters = {k: int(srv.stats[k]) for k in NET_COUNTERS}
    return out, kvs, counters


def _same(a, b, where=""):
    """Deep equality of transcripts: numpy arrays by dtype and value."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


@pytest.mark.parametrize("fastpath", ["on", "off"])
@pytest.mark.parametrize("mode", ["lockstep", "pipelined"])
def test_wire_transcript_matches_jax(mode, fastpath, monkeypatch):
    monkeypatch.setenv("PMDFC_FASTPATH", fastpath)
    coalesce = mode == "pipelined"
    ja, ka, na = _script(JAX, JAX, coalesce)
    tb, kb, nb = _script(PORT, PORT, coalesce)
    _same(ja, tb, "transcript")
    assert ka == kb
    assert na == nb
    assert kb["misses"] == sum(kb[c] for c in tkv.MISS_CAUSE_NAMES)
    negotiated = tb[0]
    assert negotiated == ("negotiated", coalesce, fastpath == "on")
    if fastpath == "on":
        assert nb["fastpath_hits"] > 0 and nb["fastpath_stale"] > 0
        assert nb["dir_pulls"] == 2
    else:
        assert nb["fastpath_hits"] == nb["fastpath_stale"] == 0


@pytest.mark.parametrize("client,server", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-client", "port-client"])
def test_cross_package_wire(client, server):
    """The wire format is byte for byte: each package's client against the
    other's server gives the transcript of the port against itself."""
    want = _script(PORT, PORT, True)
    got = _script(server, client, True)
    _same(want[0], got[0], "transcript")
    assert want[1] == got[1] and want[2] == got[2]


def test_profile_verb_is_refused_without_a_profiler(monkeypatch, tmp_path):
    """MSG_PROFILE on the port's server, for both packages' clients: with
    PMDFC_PROF on the verb is acked; a profiler with no dump dir to write
    to refuses every capture (MSG_NOTEXIST) and the connection serves on;
    with a dump dir the same server captures (a path under it, where the
    capture thread writes `trace.json`) and refuses a second request
    inside the cooldown."""
    import os
    import time

    from pmdfc_tpu_torch.runtime import profiler as tprof
    from pmdfc_tpu_torch.runtime import telemetry as ttele

    monkeypatch.setenv("PMDFC_PROF", "on")
    kv = PORT.kv(_cfg(PORT))
    shared = tbackends.DirectBackend(kv)
    try:
        for dump in (None, tmp_path):
            ttele.configure(tconfig.TelemetryConfig(
                dump_dir=str(dump) if dump else None))
            tprof.install(tconfig.ProfilerConfig(trace_min_interval_s=60.0))
            paths = []
            for net in (None, tconfig.NetConfig()):
                with tnet.NetServer(lambda: shared, net=net).start() as srv:
                    for pkg in (JAX, PORT):
                        be = pkg.net.TcpBackend("127.0.0.1", srv.port,
                                                page_words=W,
                                                keepalive_s=None)
                        assert be.prof
                        res = be.server_profile(50)
                        if dump is None or paths:
                            assert res is None
                        else:
                            assert res["path"].startswith(str(tmp_path))
                            assert res["duration_ms"] == 50
                            paths.append(res["path"])
                        keys = np.array([[1, 2]], np.uint32)
                        be.put(keys, np.ones((1, W), np.uint32))
                        assert be.get(keys)[1].all()  # the connection lives
                        be.close()
            if dump is not None:
                assert len(paths) == 1
                trace = os.path.join(paths[0], "trace.json")
                deadline = time.monotonic() + 30
                while not os.path.exists(trace):
                    assert time.monotonic() < deadline
                    time.sleep(0.05)
    finally:
        ttele.configure()


def _pool_script(pkg, pool):
    """Two one-sided clients over RemotePools with their own grants."""
    out = []
    srv = pkg.net.PoolServer(pool).start()
    try:
        rng = np.random.default_rng(3)
        remotes = [pkg.net.RemotePool("127.0.0.1", srv.port, page_words=W,
                                      keepalive_s=None) for _ in range(2)]
        bes = [pkg.onesided.OneSidedBackend(r, grant=r.grant(48))
               for r in remotes]
        for i, be in enumerate(bes):
            keys = np.stack([np.full(64, i, np.uint32),
                             np.arange(64, dtype=np.uint32)], -1)
            pages = rng.integers(0, 1 << 32, (64, W), dtype=np.uint32)
            be.put(keys[:40], pages[:40])
            be.put(keys[30:], pages[30:])  # past the grant: FIFO drops
            out.append(be.get(keys))
            out.append(be.invalidate(keys[::5]))
            out.append(be.get(keys))
            out.append(be.stats())
        out.append(remotes[0].server_stats()["granted_rows"])
        out.append(remotes[0].read_rows(np.array([0, 5, 95, -1, 1 << 20],
                                                 np.int32)))
        for r in remotes:
            r.close()
        out.append({k: int(srv.stats[k]) for k in
                    ("connects", "ops", "bad_rows", "bad_frames")})
    finally:
        _stop(srv)
    out.append(pool.stats())
    return out


@contextlib.contextmanager
def _fresh_jax_registry():
    """The JAX side under a fresh telemetry registry, and the registry
    found before put back after: the JAX `PoolServer`'s `poolN` scope
    must not stay behind for a later JAX test of the same worker that
    reads the registry's pool gauges."""
    state = jtele._STATE
    found = (state.registry, state.tracing)
    jtele.configure()
    try:
        yield
    finally:
        state.registry, state.tracing = found


def test_pool_server_matches_jax_host_pool():
    registry = jtele.get()
    gauges = set(registry.snapshot()["gauges"])
    with _fresh_jax_registry():
        a = _pool_script(JAX, jonesided.PassivePool(256, W, mode="host"))
    assert jtele.get() is registry
    assert set(registry.snapshot()["gauges"]) == gauges
    b = _pool_script(PORT, tonesided.PassivePool(256, W, device="cpu"))
    _same(a, b, "one-sided transcript")


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_saved_region_loads_in_the_other_package(direction, tmp_path):
    rng = np.random.default_rng(4)
    rows = rng.choice(128, 40, replace=False).astype(np.int32)
    pages = rng.integers(0, 1 << 32, (40, W), dtype=np.uint32)
    path = str(tmp_path / "region.npz")
    if direction == "jax-to-port":
        src = jonesided.PassivePool(128, W, mode="host")
        dst = tonesided.PassivePool(128, W, device="cpu")
    else:
        src = tonesided.PassivePool(128, W, device="cpu")
        dst = jonesided.PassivePool(128, W, mode="host")
    src.grant(77)
    src.write_rows(rows, pages)
    src.save(path)
    dst.load(path)
    assert dst.granted_rows == 77
    _same(np.asarray(dst.read_rows(np.arange(128, dtype=np.int32))),
          np.asarray(src.read_rows(np.arange(128, dtype=np.int32))),
          "region")
