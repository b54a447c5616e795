"""PyTorch port: `tests/test_analyze.py`'s runtime-sanitizer drills on both
sanitizers.

Each drill builds the same lock names in the same sequence on JAX's
`runtime/sanitizer.py` and on the port's, and the two `violations()`
transcripts must be equal once the measured hold times are taken out
(`held_ms`: a clock reading). The port ranks two locks JAX has not
(`KVServer._bf_push_lock`, `engine._lib_lock`); every lock named here has
the same rank in both tables. Then violations reaching telemetry
(`rung.sanitizer_violation` and the `sanitizer*.inversions` counter),
deferred until the thread holds no lock, on each package's own fresh
registry. Last, JAX's `slow` acceptance soak as a tier-1 twin at the
smallest size that keeps its invariants: a coalescing `NetServer` behind a
seeded `ChaosProxy` (flip 0.01, duplicate 0.005, delay 0.01 at 2 ms),
four `ReconnectingClient` workers for about 1 s a package (JAX: 3 s),
every lock instrumented: zero wrong bytes and no report on either
package. Its card counterpart is `chip_smoke.py`'s phase 19 (a).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import (JAX, PORT, fresh_jax_registry,  # noqa: F401
                        registries, stop)

import pmdfc_tpu.runtime.sanitizer as jsan
import pmdfc_tpu_torch.runtime.sanitizer as tsan

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

SANS = ((JAX, jsan), (PORT, tsan))
W = 16


@pytest.fixture
def san_on():
    """Both sanitizers on (strict off, JAX's 200 ms), empty, and put back
    off after the test."""
    for _, s in SANS:
        s.configure(on=True, strict=False, hold_ms=200.0)
        s.reset()
    yield
    for _, s in SANS:
        s.reset()
        s.configure(on=False)


def transcript(s) -> list[dict]:
    """`violations()` without the clock's readings."""
    return [{k: v for k, v in rec.items() if k != "held_ms"}
            for rec in s.violations()]


def on_both(drill):
    """`drill(sanitizer)` on JAX's sanitizer, then the port's -> both
    (its result, the violation transcript); the pairs must be equal."""
    out = []
    for _, s in SANS:
        s.reset()
        out.append((drill(s), transcript(s)))
    assert out[0] == out[1], out
    return out[1]


def test_named_locks_rank_alike():
    for name in ("NetServer.op_lock", "KV._lock", "NetServer._flush_cv"):
        assert jsan.HIERARCHY[name] == tsan.HIERARCHY[name]
    assert jsan.HOLD_WATCH == tsan.HOLD_WATCH


def test_sanitizer_off_returns_plain_primitives():
    def drill(s):
        s.configure(on=False)
        return (type(s.lock("x")) is type(threading.Lock()),
                isinstance(s.condition("y"), type(threading.Condition())),
                type(s.rlock("z")) is type(threading.RLock()))

    assert on_both(drill) == ((True, True, True), [])


def test_sanitizer_detects_ab_ba_inversion(san_on):
    def drill(s):
        a = s.lock("NetServer.op_lock")       # rank 30
        b = s.lock("KV._lock")                # rank 65 (inner)
        with a:
            with b:
                pass
        clean = s.violations() == []
        with b:
            with a:
                pass
        return clean

    ok, v = on_both(drill)
    assert ok
    assert len(v) == 1 and v[0]["kind"] == "inversion"
    assert v[0]["acquired"] == "NetServer.op_lock"
    assert v[0]["while_holding"] == "KV._lock"


def test_sanitizer_refuses_self_deadlock(san_on):
    def drill(s):
        lk = s.lock("NetServer.op_lock")
        with lk:
            with pytest.raises(RuntimeError, match="re-acquired"):
                lk.acquire()
        with lk:  # still works after the refusal
            pass
        return lk.locked()

    held, v = on_both(drill)
    assert held is False and [r["kind"] for r in v] == ["reacquire"]


def test_sanitizer_rlock_reentry_is_legal(san_on):
    def drill(s):
        rl = s.rlock("KV._lock")
        with rl:
            with rl:
                pass

    assert on_both(drill) == (None, [])


def test_sanitizer_times_long_holds_on_watched_locks(san_on):
    def drill(s):
        s.configure(hold_ms=20.0)
        cv = s.condition("NetServer._flush_cv")   # in HOLD_WATCH
        with cv:
            time.sleep(0.06)
        v = s.violations()
        first = (len(v), v[0]["kind"], v[0]["held_ms"] >= 20.0)
        s.reset()
        lk = s.rlock("KV._lock")   # unwatched: may hold long
        with lk:
            time.sleep(0.06)
        s.configure(hold_ms=200.0)
        return first

    first, v = on_both(drill)
    assert first == (1, "long_hold", True) and v == []


def test_long_hold_record_matches_after_its_reading(san_on):
    """The long-hold record itself, its measured hold aside."""
    def drill(s):
        s.configure(hold_ms=20.0)
        lk = s.lock("_ConnState.out_cv")
        with lk:
            time.sleep(0.05)
        s.configure(hold_ms=200.0)

    _, v = on_both(drill)
    assert v == [{"kind": "long_hold", "thread": "MainThread",
                  "lock": "_ConnState.out_cv", "limit_ms": 20.0}]


def test_sanitizer_condition_wait_does_not_count_as_holding(san_on):
    def drill(s):
        s.configure(hold_ms=20.0)
        cv = s.condition("NetServer._flush_cv")
        with cv:
            cv.wait(0.06)      # parked, not holding
        s.configure(hold_ms=200.0)

    assert on_both(drill) == (None, [])


def test_sanitizer_condition_is_reentrant_like_the_primitive(san_on):
    def drill(s):
        cv = s.condition("NetServer._flush_cv")
        with cv:
            with cv:
                cv.wait(0.01)
            cv.notify_all()    # still held after the nested exit
        got = []
        t = threading.Thread(target=lambda: (cv.acquire(), got.append(1),
                                             cv.release()))
        t.start()
        t.join(2.0)
        return got

    assert on_both(drill) == ([1], [])


def test_sanitizer_nonblocking_self_probe_returns_false(san_on):
    def drill(s):
        lk = s.lock("NetServer.op_lock")
        with lk:
            probe = lk.acquire(blocking=False)
        with lk:       # still usable, no leaked state
            pass
        return probe

    assert on_both(drill) == (False, [])


def test_sanitizer_flush_runs_after_the_physical_release(san_on,
                                                         monkeypatch):
    def drill(s):
        s.configure(hold_ms=5.0)
        lk = s.lock("NetServer._flush_cv")  # in HOLD_WATCH
        seen = []
        orig = s._flush_pending

        def spy():
            seen.append(lk._inner.locked())
            orig()

        monkeypatch.setattr(s, "_flush_pending", spy)
        try:
            with lk:
                time.sleep(0.02)            # trips the long-hold report
        finally:
            monkeypatch.setattr(s, "_flush_pending", orig)
            s.configure(hold_ms=200.0)
        return seen

    seen, v = on_both(drill)
    assert [r["kind"] for r in v] == ["long_hold"]
    assert seen == [False]                  # inner lock already released


def test_sanitizer_violations_reach_telemetry(san_on):
    """The violation is recorded at once; its telemetry and rung half waits
    until the thread holds no lock, then lands in that package's fresh
    registry."""
    out = []
    for pkg, s in SANS:
        s.reset()
        pkg.tele.configure()
        b = s.lock("KV._lock")
        a = s.lock("NetServer.op_lock")
        with b, a:
            mid_v = len(s.violations())
            mid = pkg.tele.snapshot()["counters"]
        snap = pkg.tele.snapshot()["counters"]
        inv = {k: v for k, v in snap.items() if k.endswith(".inversions")}
        out.append((mid_v, mid.get("rung.sanitizer_violation", 0),
                    snap.get("rung.sanitizer_violation", 0), inv,
                    pkg.tele.get()._rungs["sanitizer_violation"],
                    transcript(s)))
    assert out[0] == out[1]
    mid_v, mid_rung, rung, inv, rungs, v = out[1]
    assert (mid_v, mid_rung, rung, rungs) == (1, 0, 1, 1)
    assert inv == {"sanitizer.inversions": 1}
    assert [r["kind"] for r in v] == ["inversion"]


def test_engine_locks_are_instrumented_like_jax(san_on):
    """Both engines build their call and slice gates through the sanitizer
    (the port's were plain `threading.Lock`s that `PMDFC_SAN` never saw),
    and the port's module-level library lock is instrumented when the
    switch is on at import."""
    import subprocess
    import sys

    import pmdfc_tpu.runtime.engine as jengine
    import pmdfc_tpu_torch.runtime.engine as tengine

    kinds = []
    for mod in (jengine, tengine):
        e = mod.Engine(num_queues=2, arena_pages=64, page_bytes=64)
        try:
            kinds.append((type(e._call_lock).__name__, e._call_lock._name,
                          type(e._slice_lock).__name__, e._slice_lock._name))
        finally:
            e.close()
    assert kinds[0] == kinds[1] == ("SanLock", "Engine._call_lock",
                                    "SanLock", "Engine._slice_lock")
    code = ("import pmdfc_tpu_torch.runtime.engine as e; "
            "print(type(e._lib_lock).__name__, e._lib_lock._name)")
    env = {**os.environ, "PMDFC_SAN": "on"}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.split()
    assert out == ["SanLock", "engine._lib_lock"]


# --- JAX's slow acceptance soak, as a tier-1 twin ----------------------------


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 22, size=n, replace=False)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 0] * 7 + keys[:, 1])[:, None] + np.arange(
        W, dtype=np.uint32)


SOAK_WORKERS = 4
SOAK_S = 1.0


def soak(pkg, s) -> dict:
    """JAX's `test_chaos_soak_under_sanitizer_reports_nothing` on `pkg`:
    -> its counts (what the invariants read)."""
    s.reset()
    shared = pkg.backends.LocalBackend(page_words=W, capacity=1 << 12)
    srv = pkg.net.NetServer(lambda: shared, net=pkg.config.NetConfig(
        flush_ops=64, flush_timeout_us=500, settle_us=100)).start()
    proxy = pkg.failure.ChaosProxy(
        "127.0.0.1", srv.port, seed=7,
        rates={"flip": 0.01, "duplicate": 0.005, "delay": 0.01},
        delay_s=0.002)
    halt = threading.Event()
    errors: list[BaseException] = []
    done = [0] * SOAK_WORKERS
    hits = [0] * SOAK_WORKERS

    def worker(t):
        rc = pkg.failure.ReconnectingClient(
            lambda: pkg.net.TcpBackend("127.0.0.1", proxy.port,
                                       page_words=W, op_timeout_s=2.0,
                                       keepalive_s=None),
            page_words=W, retry_delay_s=0.01, seed=t)
        rng = np.random.default_rng(100 + t)
        try:
            while not halt.is_set():
                keys = _keys(int(rng.integers(1, 32)),
                             seed=int(rng.integers(1 << 16)))
                rc.put(keys, _pages(keys))
                out, found = rc.get(keys)
                if found.any():   # zero wrong bytes
                    assert np.array_equal(out[found], _pages(keys)[found])
                    hits[t] += int(found.sum())
                done[t] += 1
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
        finally:
            rc.close()

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(SOAK_WORKERS)]
    try:
        with proxy:
            for t in threads:
                t.start()
            time.sleep(SOAK_S)
            halt.set()
            for t in threads:
                t.join(timeout=10)
    finally:
        stop(srv)
    return {"errors": errors, "alive": [t.is_alive() for t in threads],
            "rounds": done, "hits": hits, "violations": s.violations(),
            "faults": sum(v for k, v in proxy.stats.items()
                          if k.endswith("_frames")
                          and k != "forwarded_frames")}


def test_chaos_soak_under_sanitizer_reports_nothing(san_on):
    runs = [soak(pkg, s) for pkg, s in SANS]
    for r in runs:
        assert not r["errors"], r["errors"]
        assert not any(r["alive"])
        assert r["violations"] == [], r["violations"]
        # every worker got verbs through, and hits were served and checked
        assert all(n > 0 for n in r["rounds"]) and sum(r["hits"]) > 0, r
