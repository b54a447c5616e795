"""Where the test suite's worker time goes: a pytest plugin and its reports.

The plugin, loaded with `-p torch_testtime` (with `tests/` on
`PYTHONPATH`, so every xdist worker finds it), samples each worker's main
thread every 5 ms and files each sample under the side whose code is
innermost on the stack: `jax` (`pmdfc_tpu`, `jax`, `jaxlib`, a JAX test
suite), `port` (`pmdfc_tpu_torch`, `torch`) or `other` (test code, setup,
waits on child processes and sockets, sleeps). It also records JAX's own
trace, lowering and compile durations (`jax.monitoring`) and the cache
key of every program JAX compiles. Each worker appends one JSON line per
test to `$TORCH_TESTTIME_DIR/<worker>-<pid>.jsonl`.

    TORCH_TESTTIME_DIR=OUT PYTHONPATH=tests python -m pytest tests/... \\
        -p xdist -n 6 --dist loadfile -p torch_testtime

Reports (no JAX or torch needed):

    python tests/torch_testtime.py junit RUN.xml   # worker s per file
    python tests/torch_testtime.py split OUT       # JAX / port / other
    python tests/torch_testtime.py keys OUT [JAX_SUITES_OUT]  # compiles

Sampling holds the GIL for a moment every 5 ms in each worker, so the
timed drills see a little more contention than without it.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import sys
import threading
import time
import xml.etree.ElementTree as ET

import pytest

_SIDES = ("jax", "port", "other")
_state: dict = {"samples": collections.Counter(), "mon": {}, "keys": []}
_lock = threading.Lock()
_side_of_file: dict = {}


def _side(path: str) -> str:
    side = _side_of_file.get(path)
    if side is None:
        name = os.path.basename(path)
        if "/pmdfc_tpu_torch/" in path or "/site-packages/torch/" in path:
            side = "port"
        elif ("/pmdfc_tpu/" in path or "/site-packages/jax/" in path
              or "/site-packages/jaxlib/" in path
              or ("/tests/" in path and name.startswith("test_")
                  and not name.startswith("test_torch_"))):
            side = "jax"
        else:
            side = ""
        _side_of_file[path] = side
    return side


def _sample(main: int) -> None:
    while True:
        time.sleep(0.005)
        frame = sys._current_frames().get(main)
        side = "other"
        while frame is not None:
            if _side(frame.f_code.co_filename):
                side = _side(frame.f_code.co_filename)
                break
            frame = frame.f_back
        with _lock:
            _state["samples"][side] += 1


def _on_duration(event: str, secs: float, **_) -> None:
    with _lock:
        _state["mon"][event] = _state["mon"].get(event, 0.0) + secs


def _hook_compiles() -> None:
    """Record (module, cache key, seconds) of every compile that missed
    the persistent cache."""
    import jax._src.compiler as jc

    real = jc._compile_and_write_cache

    def compile_and_write(backend, computation, devices, options,
                          callbacks, module_name, cache_key):
        t0 = time.perf_counter()
        try:
            return real(backend, computation, devices, options, callbacks,
                        module_name, cache_key)
        finally:
            with _lock:
                _state["keys"].append(
                    (module_name, cache_key, time.perf_counter() - t0))

    jc._compile_and_write_cache = compile_and_write


def pytest_configure(config):
    if getattr(config.option, "numprocesses", None) \
            and not hasattr(config, "workerinput"):
        return  # the xdist controller runs no test
    import jax.monitoring

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    _hook_compiles()
    out = os.environ.get("TORCH_TESTTIME_DIR", "testtime")
    os.makedirs(out, exist_ok=True)
    worker = getattr(config, "workerinput", {}).get("workerid", "main")
    _state["file"] = open(os.path.join(out, f"{worker}-{os.getpid()}.jsonl"),
                          "a")
    threading.Thread(target=_sample, args=(threading.main_thread().ident,),
                     daemon=True).start()


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_protocol(item, nextitem):
    """Zero the counters before each test (its own protocol runs after
    this hook returns None)."""
    with _lock:
        _state.update(samples=collections.Counter(), mon={}, keys=[])
        _state["t0"] = time.perf_counter()


def pytest_runtest_logfinish(nodeid, location):
    if "file" not in _state:
        return
    with _lock:
        dur = time.perf_counter() - _state["t0"]
        samples, mon, keys = _state["samples"], _state["mon"], _state["keys"]
        n = max(1, sum(samples.values()))
        rec = {"id": nodeid, "dur": dur,
               **{s: dur * samples[s] / n for s in _SIDES},
               "mon": {k.rsplit("/", 1)[-1]: v for k, v in mon.items()},
               "keys": keys}
    _state["file"].write(json.dumps(rec) + "\n")
    _state["file"].flush()


# -- reports -----------------------------------------------------------------


def _file_of(nodeid: str) -> str:
    return nodeid.split("::")[0].rsplit("/", 1)[-1]


def _records(out: str) -> list[dict]:
    return [json.loads(line) for p in sorted(glob.glob(f"{out}/*.jsonl"))
            for line in open(p)]


def junit(path: str, top: int = 5) -> None:
    """Worker seconds summed per test file from a junit xml, the port's
    files (`test_torch_*`) apart, and the run's own wall time."""
    per: dict = collections.defaultdict(float)
    root = ET.parse(path).getroot()
    for case in root.iter("testcase"):
        per[case.get("classname", "").rsplit(".", 1)[-1] + ".py"] += float(
            case.get("time", 0))
    port = {f: s for f, s in per.items() if f.startswith("test_torch_")}
    suite = next(root.iter("testsuite"))
    print(f"worker s: all {sum(per.values()):.1f}, port files "
          f"{sum(port.values()):.1f} ({len(port)} files); wall "
          f"{suite.get('time')} s; tests {suite.get('tests')}, failures "
          f"{suite.get('failures')}, errors {suite.get('errors')}, skipped "
          f"{suite.get('skipped')}")
    for f, s in sorted(port.items(), key=lambda kv: -kv[1])[:int(top)]:
        print(f"  {s:8.1f} {f}")


def split(out: str, top: int = 10) -> None:
    """Per file: worker seconds, JAX side, port side, other; JAX's trace,
    lowering and compile seconds."""
    mon = ("jaxpr_trace_duration", "jaxpr_to_mlir_module_duration",
           "backend_compile_duration")
    per: dict = collections.defaultdict(collections.Counter)
    for r in _records(out):
        c = per[_file_of(r["id"])]
        c["dur"] += r["dur"]
        for s in _SIDES:
            c[s] += r[s]
        for m in mon:
            c[m] += r["mon"].get(m, 0.0)
    rows = sorted(per.items(), key=lambda kv: -kv[1]["dur"])
    total = sum((c for _, c in rows), collections.Counter())
    for name, c in [(f"all {len(rows)} files", total)] + rows[:int(top)]:
        print(f"{name}: {c['dur']:.1f} s = jax {c['jax']:.1f} + port "
              f"{c['port']:.1f} + other {c['other']:.1f}; trace / lower / "
              f"compile {c[mon[0]]:.1f} / {c[mon[1]]:.1f} / {c[mon[2]]:.1f}")


def keys(out: str, jax_out: str | None = None, top: int = 8) -> None:
    """Compiles, distinct programs, recompiles; with the JAX suites' run,
    the compile seconds the port's files spend on the suites' programs."""
    comp = [(_file_of(r["id"]), k, s) for r in _records(out)
            for _, k, s in r["keys"]]
    first: dict = {}
    for f, k, s in comp:
        first.setdefault(k, s)
    total = sum(s for _, _, s in comp)
    print(f"{len(comp)} compiles, {len(first)} programs, {total:.1f} s; "
          f"recompiles {total - sum(first.values()):.1f} s")
    if jax_out is None:
        return
    suite_of = {}
    for r in _records(jax_out):
        for _, k, _ in r["keys"]:
            suite_of.setdefault(k, _file_of(r["id"]))
    shared = [(suite_of[k], s) for _, k, s in comp if k in suite_of]
    print(f"on the JAX suites' programs {sum(s for _, s in shared):.1f} s, "
          f"{sum(s for _, s in shared if s >= 0.5):.1f} s of it at >= 0.5 s")
    by = collections.Counter()
    for suite, s in shared:
        by[suite] += s
    for suite, s in by.most_common(int(top)):
        print(f"  {s:7.1f} {suite}")


if __name__ == "__main__":
    {"junit": junit, "split": split, "keys": keys}[sys.argv[1]](*sys.argv[2:])
