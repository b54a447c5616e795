"""PyTorch port: `tests/test_failure.py`'s failure ladder, drill by drill.

Each drill builds the same seeded script on both packages: a `KVServer`
behind an `Engine` (the JAX drill's `CFG`: 16-word pages, 2^12 slots, a
2^13-bit bloom; the port on the CPU with `pad_floor` where JAX passes
`pad_to`) and a `ReconnectingClient` over a registry factory of
`EngineBackend`s. The deterministic drills (kill -> save -> restore ->
reconnect, a put first after a kill, the invalidation replay that blocks
resurrection, the torn and rotten checkpoint refusals, the fallback past
a torn newest snapshot) must give equal transcripts: found masks and
pages, the client's counters, the restored server's `kv.stats()` and
`health()["serve_errors"]`. Two cross drills restore one package's
served snapshot in the other. The drills whose outcome depends on timing
(restart under load, dropped completions, a stalled driver, `paging_sim`
across a restart, the reconnect backoff) run on both packages under the
JAX drill's own invariants, and whatever of them does not depend on
timing is compared exactly.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import JAX as _JAX
from torch_twin import PORT as _PORT
from torch_twin import (cause_sum, counters, fresh_jax_registry,  # noqa: F401
                        registries, same, timeless)
from torch_twin import twin as twin_of

import pmdfc_tpu.bench.paging_sim as jpaging
import pmdfc_tpu.checkpoint as jckpt
import pmdfc_tpu.runtime.engine as jengine
import pmdfc_tpu.runtime.server as jserver
import pmdfc_tpu_torch.bench.paging_sim as tpaging
import pmdfc_tpu_torch.checkpoint as tckpt
import pmdfc_tpu_torch.runtime.engine as tengine
import pmdfc_tpu_torch.runtime.server as tserver

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

W = 16
CLIENT_STATS = ("dropped_puts", "disconnects", "reconnects", "missed_gets",
                "replayed_invalidates")

JAX = types.SimpleNamespace(
    **vars(_JAX), name="jax", ckpt=jckpt, engine=jengine, server=jserver,
    paging=jpaging,
    server_kw=lambda pad: {"pad_to": pad} if pad else {},
    kv_of=lambda cfg, state: _JAX.kv_mod.KV(cfg, state=state),
    load=lambda path, cfg: jckpt.load(path, cfg))
PORT = types.SimpleNamespace(
    **vars(_PORT), name="port", ckpt=tckpt, engine=tengine, server=tserver,
    paging=tpaging,
    server_kw=lambda pad: {"device": "cpu",
                           **({"pad_floor": pad} if pad else {})},
    kv_of=lambda cfg, state: _PORT.kv_mod.KV(cfg, state=state, device="cpu"),
    load=lambda path, cfg: tckpt.load(path, cfg, device="cpu"))
PKGS = (JAX, PORT)


def twin(drill, *args):
    return twin_of(drill, *args, pkgs=PKGS)


def _cfg(p):
    c = p.config
    return c.KVConfig(index=c.IndexConfig(capacity=1 << 12),
                      bloom=c.BloomConfig(num_bits=1 << 13), paged=True,
                      page_words=W)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    # content derived from the key: any wrong-data bug is detectable
    return (keys[:, 1:2].astype(np.uint32)
            * np.arange(1, W + 1, dtype=np.uint32))


def _engine(p, **kw):
    d = dict(num_queues=2, queue_cap=1 << 8, batch=128, timeout_us=200,
             arena_pages=512, page_bytes=W * 4)
    d.update(kw)
    return p.engine.Engine(**d)


def _server(p, pad=128, kv=None, fi=None, **eng):
    """A started `KVServer` of package `p` (the JAX drill's `pad_to=128`,
    or its default where `pad` is None)."""
    return p.server.KVServer(_cfg(p), engine=_engine(p, **eng), kv=kv,
                             fault_injector=fi, **p.server_kw(pad)).start()


def _restored(p, path, pad=128):
    cfg = _cfg(p)
    return _server(p, pad=pad, kv=p.kv_of(cfg, p.load(path, cfg)))


def _client(p, registry, timeout_us=30_000_000, slice_pages=256, **kw):
    """The JAX drill's `ReconnectingClient` over a registry factory of
    `EngineBackend`s (a fresh backend against whatever server is
    registered now; ConnectionError while none is)."""
    def factory():
        srv = registry.get("server")
        if srv is None:
            raise ConnectionError("server down")
        return p.backends.EngineBackend(srv, slice_pages=slice_pages,
                                        timeout_us=timeout_us)
    kw.setdefault("retry_delay_s", 0.0)
    return p.failure.ReconnectingClient(factory, page_words=W, **kw)


def _kill(registry):
    srv = registry["server"]
    registry["server"] = None
    srv.stop()


def _warm(p, registry, keys, pages):
    """Compile every batch shape the drill will use, outside fault
    windows (the JAX drill's `_warm`)."""
    warm = _client(p, registry)
    warm.put(keys, pages)
    warm.get(keys)
    assert warm.stats()["disconnects"] == 0
    warm.close()


def _client_stats(rc) -> dict:
    s = rc.stats()
    return {k: int(s[k]) for k in CLIENT_STATS}


def _served(p, srv) -> dict:
    """The server's side of a transcript: `kv.stats()` (the int32[19]
    vector, clock aside) and the driver's serve errors."""
    st = counters(srv.kv.stats())
    assert st["misses"] == cause_sum(p, st)
    return {"kv": st, "serve_errors": int(srv.health()["serve_errors"])}


# --- the deterministic drills, compared exactly --------------------------


def _kill_restore_reconnect(p, tmp):
    registry = {"server": _server(p)}
    rc = _client(p, registry)
    keys = _keys(128, seed=1)
    pages = _pages(keys)
    for lo in range(0, 128, 32):
        rc.put(keys[lo:lo + 32], pages[lo:lo + 32])
    out = [rc.get(keys)]
    path = str(tmp / f"{p.name}.npz")
    p.ckpt.save(registry["server"].kv.state, path)
    _kill(registry)
    # downtime: every op degrades legally, nothing raises
    out.append(rc.get(keys[:16]))
    rc.put(keys[:8], pages[:8])
    out.append(_client_stats(rc))
    registry["server"] = _restored(p, path, pad=None)
    try:
        out.append(rc.get(keys))
        out.append(_client_stats(rc))
        out.append(_served(p, registry["server"]))
    finally:
        registry["server"].stop()
    return out


def test_restart_with_checkpoint_restore_and_reconnect(tmp_path):
    out = twin(_kill_restore_reconnect, tmp_path)
    keys = _keys(128, seed=1)
    assert out[0][1].all()
    down_out, down_found = out[1]
    assert not down_found.any() and (down_out == 0).all()
    assert out[2]["dropped_puts"] >= 8 and out[2]["disconnects"] >= 1
    got, found = out[3]
    assert found.all() and np.array_equal(got, _pages(keys))
    assert out[4]["reconnects"] >= 2
    assert out[5]["serve_errors"] == 0


def _put_first_after_kill(p):
    registry = {"server": _server(p)}
    rc = _client(p, registry)
    keys = _keys(8, seed=9)
    rc.put(keys, _pages(keys))  # attach + warm
    _kill(registry)
    rc.put(keys, _pages(keys))  # the arena is gone: staging raises inside
    return _client_stats(rc)


def test_put_first_after_kill_degrades_not_raises():
    s = twin(_put_first_after_kill)
    assert s["dropped_puts"] >= 8 and s["disconnects"] == 1


def _invalidation_replay(p, tmp):
    registry = {"server": _server(p)}
    rc = _client(p, registry)
    keys = _keys(16, seed=6)
    pages = _pages(keys)
    rc.put(keys, pages)
    path = str(tmp / f"{p.name}.npz")
    p.ckpt.save(registry["server"].kv.state, path)  # holds keys[:8]
    out = [rc.invalidate(keys[:8])]                 # AFTER the snapshot
    _kill(registry)
    registry["server"] = _restored(p, path)
    try:
        out.append(rc.get(keys[:1]))  # trips dead-backend detection
        out.append(rc.get(keys))
        out.append(_client_stats(rc))
        out.append(_served(p, registry["server"]))
    finally:
        registry["server"].stop()
    return out


def test_invalidation_journal_blocks_stale_resurrection(tmp_path):
    out = twin(_invalidation_replay, tmp_path)
    keys = _keys(16, seed=6)
    assert out[0].all()
    got, found = out[2]
    assert not found[:8].any(), "invalidated pages must not resurrect"
    assert found[8:].all() and np.array_equal(got[8:], _pages(keys)[8:])
    assert out[3]["replayed_invalidates"] >= 8
    assert out[4]["serve_errors"] == 0


def _corrupt_inputs(path, tmp, tag):
    """The JAX drill's four refused inputs, cut from the pristine file at
    `path`: torn at 60%, one bit flipped mid-archive, zeros, an archive
    without the integrity manifest."""
    data = open(path, "rb").read()
    files = {}
    files["torn"] = str(tmp / f"{tag}-torn.npz")
    open(files["torn"], "wb").write(data[: int(len(data) * 0.6)])
    mut = bytearray(data)
    mut[len(mut) // 2] ^= 0x10
    files["rot"] = str(tmp / f"{tag}-rot.npz")
    open(files["rot"], "wb").write(bytes(mut))
    files["junk"] = str(tmp / f"{tag}-junk.npz")
    open(files["junk"], "wb").write(b"\x00" * 512)
    files["bare"] = str(tmp / f"{tag}-bare.npz")
    np.savez(files["bare"], **{f"leaf_{i}": np.zeros(2) for i in range(3)})
    return files


def test_torn_checkpoint_detected_and_rejected(tmp_path):
    """Each package's loader refuses each package's torn, rotten, junk
    and bare files with its typed `CheckpointCorruptError`; the pristine
    files restore to the same served pages and stats."""
    keys = _keys(64, seed=21)
    pristine, corrupt = {}, {}
    for p in PKGS:
        kv = p.KV(_cfg(p))
        kv.insert(keys, _pages(keys))
        pristine[p.name] = str(tmp_path / f"{p.name}-snap.npz")
        p.ckpt.save(kv.state, pristine[p.name])
        corrupt[p.name] = _corrupt_inputs(pristine[p.name], tmp_path, p.name)
    refused = []
    for p in PKGS:
        for src, files in corrupt.items():
            for what, path in files.items():
                with pytest.raises(p.ckpt.CheckpointCorruptError):
                    p.load(path, _cfg(p))
                refused.append((p.name, src, what))
    assert len(refused) == 16

    def restore(p):
        kv = p.kv_of(_cfg(p), p.load(pristine[p.name], _cfg(p)))
        out, found = kv.get(keys)
        return np.asarray(out), np.asarray(found), counters(kv.stats())

    got, found, _ = twin(restore)
    assert found.all() and np.array_equal(got, _pages(keys))


def _fallback_past_torn(p, tmp):
    registry = {"server": _server(p)}
    rc = _client(p, registry)
    keys = _keys(96, seed=22)
    pages = _pages(keys)
    rc.put(keys[:64], pages[:64])
    durable = str(tmp / f"{p.name}-durable.npz")
    registry["server"].checkpoint(durable)
    rc.put(keys[64:], pages[64:])
    newest = str(tmp / f"{p.name}-newest.npz")
    registry["server"].checkpoint(newest)
    data = open(newest, "rb").read()
    open(newest, "wb").write(data[: len(data) // 2])
    _kill(registry)
    with pytest.raises(p.ckpt.CheckpointCorruptError):
        p.load(newest, _cfg(p))
    registry["server"] = _restored(p, durable)
    try:
        out = [rc.get(keys[:1])]  # trips dead-backend detection
        out.append(rc.get(keys))
        out.append(_client_stats(rc))
        out.append(_served(p, registry["server"]))
    finally:
        registry["server"].stop()
    return out


def test_kill_restore_falls_back_past_torn_snapshot(tmp_path):
    out = twin(_fallback_past_torn, tmp_path)
    keys = _keys(96, seed=22)
    got, found = out[1]
    assert found[:64].all() and np.array_equal(got[:64], _pages(keys)[:64])
    assert not found[64:].any(), "post-durable writes resurrected"
    assert out[3]["serve_errors"] == 0


def _snapshot_served(p, tmp) -> str:
    """Package `p` serves a client's puts, takes a durable
    `KVServer.checkpoint`, serves more puts and is killed -> the path."""
    registry = {"server": _server(p)}
    rc = _client(p, registry)
    keys = _keys(96, seed=23)
    pages = _pages(keys)
    rc.put(keys[:64], pages[:64])
    rc.get(keys[:48])
    path = str(tmp / f"{p.name}-served.npz")
    registry["server"].checkpoint(path)
    rc.put(keys[64:], pages[64:])
    rc.close()
    _kill(registry)
    return path


def _restore_and_read(p, path):
    """Package `p` restores `path` behind its engine and serves the
    drill's reads through a fresh client."""
    registry = {"server": _restored(p, path)}
    rc = _client(p, registry)
    keys = _keys(96, seed=23)
    try:
        out = [rc.get(keys), rc.get(keys[32:])]
        out.append(_client_stats(rc))
        out.append(_served(p, registry["server"]))
    finally:
        rc.close()
        registry["server"].stop()
    return out


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_served_snapshot_restores_in_the_other_package(src, dst, tmp_path):
    """One package's server takes the durable snapshot under load; the
    other restores it and serves the reads: the same pages and stats as
    the package that took it restoring it itself."""
    path = _snapshot_served(src, tmp_path)
    want = _restore_and_read(src, path)
    got = _restore_and_read(dst, path)
    same(want, got, "cross restore")
    keys = _keys(96, seed=23)
    out, found = got[0]
    assert found[:64].all() and not found[64:].any()
    assert np.array_equal(out[:64], _pages(keys)[:64])


# --- the drills that depend on timing, under their own invariants --------


def _restart_under_load(p, tmp):
    registry = {"server": _server(p)}
    rc = _client(p, registry)
    keys = _keys(256, seed=2)
    pages = _pages(keys)
    path = str(tmp / f"{p.name}.npz")
    wrong, founds = 0, []
    for step, lo in enumerate(range(0, 256, 32)):
        rc.put(keys[lo:lo + 32], pages[lo:lo + 32])
        if step == 3:
            p.ckpt.save(registry["server"].kv.state, path)
            _kill(registry)
        if step == 5:
            registry["server"] = _restored(p, path)
        sel = np.arange(0, lo + 32)
        out, found = rc.get(keys[sel])
        wrong += int((out[found] != pages[sel][found]).any(axis=1).sum())
        assert not out[~found].any()
        founds.append(found)
    try:
        served = _served(p, registry["server"])
    finally:
        registry["server"].stop()
    return wrong, founds, served


def test_restart_under_load_never_serves_wrong_data(tmp_path):
    runs = []
    for p in PKGS:
        wrong, founds, served = _restart_under_load(p, tmp_path)
        assert wrong == 0, p.name
        assert served["serve_errors"] == 0
        # down at step 4 (and at step 5's put, before the restart): the
        # server's keys all miss; after the restore the snapshot's 128
        # keys and every later put serve again
        assert not founds[4].any()
        assert founds[7][:128].all() and founds[7][192:].all()
        assert not founds[7][128:192].any()
        runs.append(founds)
    same(runs[0], runs[1], "found masks")


def _dropped_completions(p, launches=None):
    fi = p.failure.FaultInjector()
    registry = {"server": _server(p, fi=fi)}
    rc = _client(p, registry, timeout_us=300_000, slice_pages=64)
    try:
        keys = _keys(64, seed=3)
        pages = _pages(keys)
        _warm(p, registry, keys[:32], pages[:32])
        rc.put(keys[:32], pages[:32])
        fi.drop_next(3)  # swallow everything for a while
        t0 = time.perf_counter()
        rc.put(keys[32:], pages[32:])
        took = time.perf_counter() - t0
        assert took < 5.0, f"{p.name}: timeout must be bounded ({took})"
        assert rc.stats()["dropped_puts"] >= 32
        assert fi.stats["dropped_batches"] >= 1
        deadline = time.time() + 10
        while fi._drop_left > 0 and time.time() < deadline:
            rc.get(keys[:1])
            time.sleep(0.01)
        out, found = rc.get(keys[:32])
        assert found.all() and np.array_equal(out, pages[:32])
        s = rc.stats()
        # every loss counted: each stalled verb is a dropped put or a
        # missed get, and the client went down once per dropped verb
        assert s["disconnects"] >= 1
        assert s["dropped_puts"] + s["missed_gets"] >= 32
        srv = registry["server"]
        st = counters(srv.kv.stats())
        assert st["misses"] == cause_sum(p, st)
        assert srv.health()["serve_errors"] == 0
        if launches is not None:
            # a dropped flush launches nothing: one fused GET per GET
            # flush the driver launched, none for the dropped ones
            assert launches and launches == [srv.op_batches["get"]]
        return int(fi.stats["dropped_batches"])
    finally:
        registry["server"].stop()


def test_dropped_completions_timeout_then_recover(monkeypatch):
    from pmdfc_tpu_torch.ops import fused

    plain, launches = fused.fused_get, [0]

    def counted(*args, **kw):
        launches[0] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(fused, "fused_get", counted)
    # not timing: the armed drops all drain, each one flush
    assert _dropped_completions(JAX) == 3
    assert _dropped_completions(PORT, launches) == 3


def _stalled_driver(p):
    fi = p.failure.FaultInjector()
    registry = {"server": _server(p, fi=fi, queue_cap=1 << 6, batch=32,
                                  timeout_us=100)}
    rc = _client(p, registry, timeout_us=200_000, slice_pages=64)
    try:
        keys = _keys(192, seed=4)
        pages = _pages(keys)
        _warm(p, registry, keys[:32], pages[:32])
        fi.stall_next(6, seconds=0.25)
        for lo in range(0, 192, 32):
            rc.put(keys[lo:lo + 32], pages[lo:lo + 32])
        out, found = rc.get(keys[:64])
        assert (out[found] == pages[:64][found]).all()
        assert not out[~found].any()
        dropped = rc.stats()["dropped_puts"]
        deadline = time.time() + 10
        while time.time() < deadline:
            rc.put(keys[:32], pages[:32])
            out, found = rc.get(keys[:32])
            if found.all():
                break
            time.sleep(0.1)
        assert found.all() and np.array_equal(out, pages[:32])
        assert dropped <= 192  # every loss is accounted, none silent
        assert fi.stats["stalled_batches"] >= 1
        assert registry["server"].health()["serve_errors"] == 0
    finally:
        registry["server"].stop()


def test_stalled_driver_backpressure_is_bounded_loss():
    for p in PKGS:
        _stalled_driver(p)


def _paging_sim_restart(p, tmp):
    registry = {"server": _server(p)}
    rb = _client(p, registry)
    cc = p.cleancache.CleanCacheClient(rb)
    sim = p.paging.PagingSim(cc, ram_pages=32, page_words=W)
    path = str(tmp / f"{p.name}.npz")
    try:
        p.paging.run_job(sim, "rand_rw", file_pages=128, ops=400, seed=5)
        p.ckpt.save(registry["server"].kv.state, path)
        _kill(registry)
        # downtime: cleancache misses fall back to "disk"
        p.paging.run_job(sim, "rand_read", file_pages=128, ops=100, seed=6)
        registry["server"] = _restored(p, path, pad=None)
        out = p.paging.run_job(sim, "rand_rw", file_pages=128, ops=400,
                               seed=7)
        return timeless(out, {"secs", "pages_per_sec", "mib_per_sec"})
    finally:
        if registry["server"]:
            registry["server"].stop()


def test_paging_sim_survives_restart(tmp_path):
    # the hit counts move by a few between runs of one package (the
    # mirror's timed refresh): each package is held to the invariants
    for p in PKGS:
        out = _paging_sim_restart(p, tmp_path)
        assert out["verify_failures"] == 0, p.name
        assert out["cc_hits"] > 0, p.name  # the recovered cache serves
        assert out["reads"] + out["writes"] == 900, p.name


def _backoff(p):
    alive = {"up": False}

    def factory():
        if not alive["up"]:
            raise ConnectionError("down")
        return p.backends.LocalBackend(page_words=W)

    rc = p.failure.ReconnectingClient(factory, page_words=W,
                                      retry_delay_s=0.01,
                                      max_retry_delay_s=0.2, backoff=2.0,
                                      jitter=0.25, seed=7)
    keys = _keys(4, seed=23)
    t0 = time.monotonic()
    ops = 0
    while time.monotonic() - t0 < 0.5:
        rc.get(keys)
        ops += 1
    backoffs = rc.stats()["reconnect_backoffs"]
    assert backoffs >= 2
    assert backoffs < ops / 2, "backoff did not gate reconnect attempts"
    assert rc._cur_delay > 0.01, "delay never widened"
    assert rc._cur_delay <= 0.2 * 1.25 + 1e-9, "cap not applied"
    assert rc.stats()["missed_gets"] == ops * 4
    alive["up"] = True
    deadline = time.time() + 5
    while not rc.connected and time.time() < deadline:
        rc.get(keys)
        time.sleep(0.02)
    assert rc.connected
    assert rc._cur_delay == 0.01, "a successful reconnect resets backoff"
    assert rc.stats()["reconnects"] >= 1


def _down():
    raise ConnectionError("down")


def test_reconnect_backoff_widens_and_resets():
    for p in PKGS:
        _backoff(p)
    # the seeded jitter is the same draw in both packages: the first
    # widenings of one schedule, stepped by hand, are equal
    widened = []
    for p in PKGS:
        rc = p.failure.ReconnectingClient(
            _down, page_words=W, retry_delay_s=0.01, max_retry_delay_s=0.2,
            backoff=2.0, jitter=0.25, seed=7)
        steps = []
        for _ in range(8):
            rc._last_attempt = -1e9
            rc.get(_keys(4, seed=23))
            steps.append(rc._cur_delay)
        widened.append(steps)
    assert widened[0] == widened[1]
