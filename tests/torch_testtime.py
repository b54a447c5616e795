"""Where the test suite's worker time goes: a pytest plugin and its reports.

The plugin, loaded with `-p torch_testtime` (with `tests/` on
`PYTHONPATH`, so every xdist worker finds it), samples each worker's main
thread every 5 ms and files each sample under the side whose code is
innermost on the stack: `jax` (`pmdfc_tpu`, `jax`, `jaxlib`, a JAX test
suite), `port` (`pmdfc_tpu_torch`, `torch`) or `other` (test code, setup,
waits on child processes and sockets, sleeps). It also records JAX's own
trace, lowering and compile durations (`jax.monitoring`) and, for every
program JAX asks the persistent cache for, its cache key, whether the
cache held it, the seconds of its read or compile, the trace and lowering
seconds spent since the program before it, and the wall clock of its
start. Each worker appends one JSON line per test, with the test's wall
clock start and end, to `$TORCH_TESTTIME_DIR/<worker>-<pid>.jsonl`.

    TORCH_TESTTIME_DIR=OUT PYTHONPATH=tests python -m pytest tests/... \\
        -p xdist -n 6 --dist loadfile -p torch_testtime

Reports (no JAX or torch needed):

    python tests/torch_testtime.py junit RUN.xml     # worker s per file
    python tests/torch_testtime.py schedule RUN.xml  # loadfile's queue
    python tests/torch_testtime.py split OUT         # JAX / port / other
    python tests/torch_testtime.py keys OUT [JAX_SUITES_OUT]  # compiles
    python tests/torch_testtime.py compare PARENT.xml CHANGE.xml  # ratios
    python tests/torch_testtime.py overlap RUN.xml   # twin and suite at once?
    python tests/torch_testtime.py contention FULL.xml ALONE_DIR GROUP.xml...

`sample` watches the host while a run goes (it only reads `/proc`): once
a second, the load average and, for every process descending from PID
(the run's `pytest` or the `timeout` around it), the CPU seconds and the
run-queue wait (`schedstat`) of each of its threads, grouped by process
and thread name; `load` reports it, and with the plugin's OUT also for
the seconds in which a worker was compiling a JAX program:

    python tests/torch_testtime.py sample SAMPLES.jsonl PID [OUT] &
    python tests/torch_testtime.py load SAMPLES.jsonl [OUT]

Sampling holds the GIL for a moment every 5 ms in each worker, so the
timed drills see a little more contention than without it.
"""

from __future__ import annotations

import ast
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
    names = os.path.join(os.environ.get("TORCH_TESTTIME_DIR", "testtime"),
                         f"threads-{os.getpid()}.json")
    tick = 0
    while True:
        time.sleep(0.005)
        tick += 1
        if tick % 200 == 0:   # once a second: the Python threads' ids
            with open(names + ".tmp", "w") as fh:
                json.dump({str(t.native_id): t.name
                           for t in threading.enumerate()}, fh)
            os.replace(names + ".tmp", names)
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
        if event.endswith(("jaxpr_trace_duration",
                           "jaxpr_to_mlir_module_duration")):
            _state["pending"] = _state.get("pending", 0.0) + secs


def _hook_compiles() -> None:
    """Record every program JAX asks the persistent cache for: its module
    and cache key, whether the cache held it, the seconds of the read or
    of the compile, the trace and lowering seconds since the program
    before it, and the wall clock at the start of the read."""
    import jax._src.compiler as jc

    real_read, real_compile = jc._cache_read, jc._compile_and_write_cache

    def note(module_name, cache_key, hit, t_wall, secs):
        with _lock:
            _state["keys"].append({
                "m": module_name, "k": cache_key, "hit": hit, "s": secs,
                "tl": _state.pop("pending", 0.0), "t": t_wall})

    def cache_read(module_name, cache_key, *args):
        t_wall, t0 = time.time(), time.perf_counter()
        out = real_read(module_name, cache_key, *args)
        if out[0] is not None:
            note(module_name, cache_key, True, t_wall,
                 time.perf_counter() - t0)
        return out

    def compile_and_write(backend, computation, devices, options,
                          callbacks, module_name, cache_key):
        t_wall, t0 = time.time(), time.perf_counter()
        try:
            return real_compile(backend, computation, devices, options,
                                callbacks, module_name, cache_key)
        finally:
            note(module_name, cache_key, False, t_wall,
                 time.perf_counter() - t0)

    jc._cache_read = cache_read
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
        _state["wall0"] = time.time()


def pytest_runtest_logfinish(nodeid, location):
    if "file" not in _state:
        return
    with _lock:
        dur = time.perf_counter() - _state["t0"]
        samples, mon, keys = _state["samples"], _state["mon"], _state["keys"]
        n = max(1, sum(samples.values()))
        rec = {"id": nodeid, "dur": dur, "t0": _state["wall0"],
               "t1": time.time(),
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
    per = {f: sum(secs) for f, secs in _junit_files(path).items()}
    port = {f: s for f, s in per.items() if f.startswith("test_torch_")}
    suite = next(ET.parse(path).getroot().iter("testsuite"))
    print(f"worker s: all {sum(per.values()):.1f}, port files "
          f"{sum(port.values()):.1f} ({len(port)} files); wall "
          f"{suite.get('time')} s; tests {suite.get('tests')}, failures "
          f"{suite.get('failures')}, errors {suite.get('errors')}, skipped "
          f"{suite.get('skipped')}")
    for f, s in sorted(port.items(), key=lambda kv: -kv[1])[:int(top)]:
        print(f"  {s:8.1f} {f}")


def _junit_files(path: str) -> dict:
    """{file: [test seconds in run order]} from a junit xml, files in the
    order pytest collects them (by name: `tests/` holds no subfolder)."""
    per: dict = collections.defaultdict(list)
    for case in ET.parse(path).getroot().iter("testcase"):
        per[case.get("classname", "").rsplit(".", 1)[-1] + ".py"].append(
            float(case.get("time", 0)))
    return dict(sorted(per.items()))


def replay(files: dict, workers: int = 6) -> list[tuple]:
    """Replays per-test seconds through pytest-xdist 3.8's loadfile queue
    (`xdist/scheduler/loadscope.py`, `schedule` and `_reschedule`): files
    queued by test count, most first, ties in collection order; each
    worker is handed one file, then one more at the start and after each
    of its tests whenever at most two of its tests are left -> [(file,
    worker, start, end)] in the order the files were handed out."""
    queue = sorted(files, key=lambda f: -len(files[f]))
    pending: list[list] = [[] for _ in range(workers)]   # (row, secs)
    clock = [0.0] * workers
    rows: list = []

    def hand(w: int) -> None:
        row = [queue.pop(0), w, None, None]
        rows.append(row)
        pending[w].extend((row, s) for s in files[row[0]])

    for w in range(min(workers, len(queue))):
        hand(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            hand(w)
    while any(pending):
        w = min((w for w in range(workers) if pending[w]),
                key=lambda w: clock[w] + pending[w][0][1])
        row, s = pending[w].pop(0)
        if row[2] is None:
            row[2] = clock[w]
        clock[w] += s
        row[3] = clock[w]
        if queue and len(pending[w]) <= 2:
            hand(w)
    return [tuple(r) for r in rows]


def schedule(path: str, workers: int = 6, last: int = 8) -> None:
    """Projected wall of a junit's tests replayed through loadfile's queue
    on `workers` workers, the mean per worker, and the last files to
    start (few-test files are queued last, whatever their seconds)."""
    files = _junit_files(path)
    rows = replay(files, int(workers))
    print(f"{len(rows)} files on {workers} workers: projected wall "
          f"{max(r[3] for r in rows):.1f} s, mean per worker "
          f"{sum(map(sum, files.values())) / int(workers):.1f} s")
    for f, w, t0, t1 in sorted(rows, key=lambda r: r[2])[-int(last):]:
        print(f"  starts {t0:7.1f} ends {t1:7.1f} gw{w} {len(files[f]):4d} "
              f"tests {sum(files[f]):7.1f} s {f}")


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
    port = [c for f, c in rows if _is_port(f)]
    for name, c in [(f"all {len(rows)} files", total),
                    (f"{len(port)} port files",
                     sum(port, collections.Counter()))] + rows[:int(top)]:
        print(f"{name}: {c['dur']:.1f} s = jax {c['jax']:.1f} + port "
              f"{c['port']:.1f} + other {c['other']:.1f}; trace / lower / "
              f"compile {c[mon[0]]:.1f} / {c[mon[1]]:.1f} / {c[mon[2]]:.1f}")


def _programs(r: dict) -> list[dict]:
    """A record's programs as dicts (records of the older plugin hold
    `(module, key, compile seconds)` of the cache's misses only)."""
    return [k if isinstance(k, dict) else
            {"m": k[0], "k": k[1], "hit": False, "s": k[2], "tl": 0.0}
            for k in r["keys"]]


def keys(out: str, jax_out: str | None = None, top: int = 8) -> None:
    """The port files' programs (`test_torch_*`; a whole-suite run holds
    the JAX suites' too): compiles, distinct programs, recompiles; the
    programs two or more port files trace, with their trace, lowering
    and compile or read seconds; with a run of the JAX suites alone, the
    compile seconds spent on the suites' programs, by suite, and each
    port file's compile seconds split into shared with a JAX suite,
    unique to the port's files, and recompiled (a program the port's
    files compiled before, in any worker)."""
    progs = [(_file_of(r["id"]), p) for r in _records(out)
             if _file_of(r["id"]).startswith("test_torch_")
             for p in _programs(r)]
    comp = [(f, p["k"], p["s"]) for f, p in progs if not p["hit"]]
    first: dict = {}
    for f, k, s in comp:
        first.setdefault(k, s)
    total = sum(s for _, _, s in comp)
    print(f"{len(comp)} compiles, {len(first)} programs, {total:.1f} s; "
          f"recompiles {total - sum(first.values()):.1f} s")
    files_of: dict = collections.defaultdict(set)
    cost: collections.Counter = collections.Counter()
    for f, p in progs:
        files_of[p["k"]].add(f)
        cost[p["k"]] += p["s"] + p["tl"]
    multi = {k for k, fs in files_of.items() if len(fs) >= 2}
    print(f"{len(files_of)} programs asked for (hit or miss), "
          f"{len(multi)} of them by two or more port files: "
          f"{sum(cost[k] for k in multi):.1f} s of trace, lowering and "
          f"compile or read in all their files")
    pairs: collections.Counter = collections.Counter()
    for k in multi:
        pairs[" + ".join(sorted(files_of[k]))] += cost[k]
    for fs, s in pairs.most_common(int(top)):
        print(f"  {s:7.1f} {fs}")
    _cache_flows(out, int(top))
    if jax_out is None:
        return
    suite_of = {}
    for r in _records(jax_out):
        for p in _programs(r):
            suite_of.setdefault(p["k"], _file_of(r["id"]))
    shared = [(suite_of[k], s) for _, k, s in comp if k in suite_of]
    print(f"on the JAX suites' programs {sum(s for _, s in shared):.1f} s, "
          f"{sum(s for _, s in shared if s >= 0.5):.1f} s of it at >= 0.5 s")
    by = collections.Counter()
    for suite, s in shared:
        by[suite] += s
    for suite, s in by.most_common(int(top)):
        print(f"  {s:7.1f} {suite}")
    per: dict = collections.defaultdict(collections.Counter)
    seen: set = set()
    for f, k, s in comp:
        group = ("recompiled" if k in seen
                 else "shared" if k in suite_of else "unique")
        seen.add(k)
        per[f][group] += s
    print("per port file: compile s = shared with a JAX suite + unique + "
          "recompiled")
    for f, c in sorted(per.items(), key=lambda kv: -sum(kv[1].values()))[
            :int(top)]:
        print(f"  {sum(c.values()):7.1f} = {c['shared']:6.1f} + "
              f"{c['unique']:6.1f} + {c['recompiled']:6.1f} {f}")


def _cache_flows(out: str, top: int) -> None:
    """Compiles one file handed another through the persistent cache: a
    hit on a program some file compiled (missed) earlier in the run, by
    wall clock, saved the reader that compile's seconds. Printed by
    (writer -> reader) where either is a port file."""
    progs = sorted(((p["t"], _file_of(r["id"]), p) for r in _records(out)
                    for p in _programs(r) if "t" in p), key=lambda x: x[0])
    writer: dict = {}
    flows: collections.Counter = collections.Counter()
    for _, f, p in progs:
        if not p["hit"]:
            writer.setdefault(p["k"], (f, p["s"]))
        elif p["k"] in writer and writer[p["k"]][0] != f:
            w, secs = writer[p["k"]]
            if _is_port(w) or _is_port(f):
                flows[f"{w} -> {f}"] += secs
    print(f"compiles handed between files through the cache: "
          f"{sum(flows.values()):.1f} s saved")
    for pair, secs in flows.most_common(top):
        print(f"  {secs:7.1f} {pair}")


def _is_port(f: str) -> bool:
    return f.startswith("test_torch_")


def _groups(files) -> dict:
    """The port's files by kind: the smoke rehearsals, the harness twins,
    the drill twins, the other twins."""
    out: dict = collections.defaultdict(list)
    for f in files:
        if not _is_port(f):
            out["jax suites"].append(f)
        elif f.startswith("test_torch_smoke"):
            out["port: smoke rehearsals"].append(f)
        elif f.startswith(("test_torch_bench_", "test_torch_workloads")):
            out["port: harness twins"].append(f)
        elif f.endswith("_drills.py"):
            out["port: drill twins"].append(f)
        else:
            out["port: other"].append(f)
    return dict(out)


def compare(parent: str, change: str, top: int = 25) -> None:
    """Worker seconds per group and per port file in two junits, with the
    ratio change / parent, and the host factor: the ratio of the JAX
    suites' worker seconds, which is what the same JAX code cost in the
    second run against the first (1.0 on one host, if nothing beside it
    changed)."""
    runs = []
    for path in (parent, change):
        per = {f: sum(s) for f, s in _junit_files(path).items()}
        suite = next(ET.parse(path).getroot().iter("testsuite"))
        runs.append((per, float(suite.get("time")), int(suite.get("tests"))))
    (a, wa, na), (b, wb, nb) = runs

    def row(name, x, y):
        ratio = f"{y / x:6.3f}" if x else "     -"
        print(f"  {x:9.1f} {y:9.1f} {ratio} {name}")

    print(f"wall {wa:.1f} -> {wb:.1f} s ({wb / wa:.3f}); tests {na} -> {nb}")
    print("  parent s  change s  ratio")
    row("all files", sum(a.values()), sum(b.values()))
    ga, gb = _groups(a), _groups(b)
    for g in sorted(set(ga) | set(gb)):
        row(f"{g} ({len(ga.get(g, ()))} -> {len(gb.get(g, ()))} files)",
            sum(a[f] for f in ga.get(g, ())), sum(b[f] for f in gb.get(g, ())))
    row("port files", sum(s for f, s in a.items() if _is_port(f)),
        sum(s for f, s in b.items() if _is_port(f)))
    jax = [sum(s for f, s in r.items() if not _is_port(f)) for r in (a, b)]
    print(f"host factor (JAX suites, change / parent): "
          f"{jax[1] / jax[0]:.3f}" if jax[0] else "host factor: -")
    port = sorted({f for f in a | b if _is_port(f)},
                  key=lambda f: -max(a.get(f, 0.0), b.get(f, 0.0)))
    for f in port[:int(top)]:
        row(f, a.get(f, 0.0), b.get(f, 0.0))


def contention(full: str, alone: str, *groups: str, top: int = 20) -> None:
    """Each of the `top` heaviest port files of the run `full`: its worker
    seconds alone (the junit `alone/<file>.xml` of a run of that file on
    one worker), in its group (the junits `groups`, each a run of a few
    files on six workers) and in the full run, and the factors full /
    alone and group / alone."""
    per = {f: sum(s) for f, s in _junit_files(full).items() if _is_port(f)}
    grp: dict = {}
    for path in groups:
        name = os.path.basename(path).rsplit(".", 1)[0]
        for f, secs in _junit_files(path).items():
            grp[f] = (name, sum(secs))
    print("   alone   group    full  full/alone  group/alone  file (group)")
    sums = collections.Counter()
    for f in sorted(per, key=lambda f: -per[f])[:int(top)]:
        path = os.path.join(alone, f + ".xml")
        one = sum(sum(v) for v in _junit_files(path).values()) \
            if os.path.exists(path) else 0.0
        g, gs = grp.get(f, ("-", 0.0))
        sums.update(alone=one, group=gs, full=per[f])
        ratio = (f"{per[f] / one:10.2f}  {gs / one:11.2f}" if one
                 else f"{'-':>10}  {'-':>11}")
        print(f"{one:8.1f}{gs:8.1f}{per[f]:8.1f}  {ratio}  {f} ({g})")
    if sums["alone"]:
        print(f"{sums['alone']:8.1f}{sums['group']:8.1f}{sums['full']:8.1f}"
              f"  {sums['full'] / sums['alone']:10.2f}  "
              f"{sums['group'] / sums['alone']:11.2f}  all {int(top)}")


def _drill_pairs(twins_py: str) -> dict:
    """{JAX suite: [port files]} from the `DRILLS` map of
    `tests/test_torch_twins.py`: the port files that hold each suite's
    drills, read with `ast` (the module imports torch)."""
    tree = ast.parse(open(twins_py).read())
    ns: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and (
                    node.targets[0].id.startswith("_")
                    or node.targets[0].id == "DRILLS"):
            try:
                exec(compile(ast.Module([node], []), twins_py, "exec"),
                     {"__builtins__": {}}, ns)
            except (NameError, TypeError):
                continue  # built from something other than strings
    pairs = {}
    for suite, drills in ns.get("DRILLS", {}).items():
        files = {t.split("::")[0] for targets in drills.values()
                 for t in targets}
        pairs[suite] = sorted(files)
    return pairs


def _finish_order(path: str) -> dict:
    """{file: [positions in the junit]}: the junit lists tests in the
    order they finished, across all workers."""
    pos: dict = collections.defaultdict(list)
    for i, case in enumerate(ET.parse(path).getroot().iter("testcase")):
        pos[case.get("classname", "").rsplit(".", 1)[-1] + ".py"].append(i)
    return dict(pos)


def overlap(path: str, twins_py: str | None = None) -> None:
    """For each JAX suite of `DRILLS` and each port file holding its
    drills: the positions at which their tests finished in the junit, and
    whether the two files ran at the same time (their spans of finishing
    positions interleave)."""
    twins_py = twins_py or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "test_torch_twins.py")
    pos = _finish_order(path)
    for suite, files in sorted(_drill_pairs(twins_py).items()):
        for f in files:
            if suite not in pos or f not in pos:
                continue
            s, p = pos[suite], pos[f]
            both = max(s[0], p[0]) <= min(s[-1], p[-1])
            print(f"{'overlap' if both else 'apart  '} {suite} "
                  f"{s[0]}-{s[-1]}  {f} {p[0]}-{p[-1]}")


# -- the host while a run goes -------------------------------------------------


def _read(path: str) -> str | None:
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return None


def _stat(path: str):
    """(name, state, ppid, cpu ticks) from a `/proc/.../stat`."""
    s = _read(path)
    if not s:
        return None
    name = s[s.find("(") + 1:s.rfind(")")]
    rest = s[s.rfind(")") + 2:].split()
    return name, rest[0], int(rest[1]), int(rest[11]) + int(rest[12])


def _label(pid: int) -> str:
    """A short name for a process from its command line."""
    argv = (_read(f"/proc/{pid}/cmdline") or "").split("\0")
    argv = [a for a in argv if a]
    if not argv:
        return "?"
    if any("sys.stdin.readline" in a for a in argv):
        return "worker"
    if "-m" in argv[:-1]:
        return argv[argv.index("-m") + 1].rsplit(".", 1)[-1]
    if "-c" in argv[:-1]:
        code = argv[argv.index("-c") + 1]
        return "spawn" if "multiprocessing" in code else "python -c"
    names = [os.path.basename(a) for a in argv[:3]]
    return " ".join(n for n in names if not n.startswith("-"))[:40]


def _python_threads(where: str | None) -> dict:
    """{native thread id: name} of the Python threads of each worker, as
    the plugin last wrote them under its OUT."""
    names: dict = {}
    for path in glob.glob(f"{where}/threads-*.json") if where else ():
        try:
            names.update(json.load(open(path)))
        except (OSError, ValueError):
            pass
    return names


def sample(out: str, root: str, testtime: str | None = None,
           every: float = 1.0) -> None:
    """Once a second until process `root` ends: the load average and, per
    process descending from `root` and per kind of thread in it, the CPU
    seconds and the run-queue wait seconds since the sample before. A
    worker's threads are `main` (its own), the thread names XLA gives
    (`tf_XLAEigen`, `llvm-worker`), `py-thread` (a Python thread: with the
    plugin's OUT as `testtime`, which lists them), and the other native
    threads: `native-early` (there within 60 s of the worker's start:
    the pools of XLA, JAX and torch) or `native-late` (started by a test:
    the engine's own threads, among others). One JSON line a sample."""
    root = int(root)
    tck = os.sysconf("SC_CLK_TCK")
    last: dict = {}
    labels: dict = {}
    born: dict = {}
    with open(out, "a") as fh:
        while os.path.exists(f"/proc/{root}"):
            time.sleep(every)
            now_t = time.time()
            parent = {}
            for d in os.listdir("/proc"):
                if d.isdigit():
                    st = _stat(f"/proc/{d}/stat")
                    if st:
                        parent[int(d)] = st[2]
            kids: dict = collections.defaultdict(list)
            for pid, pp in parent.items():
                kids[pp].append(pid)
            owner = {root: None}
            todo = [root]
            while todo:
                pid = todo.pop()
                if pid not in labels:
                    labels[pid] = _label(pid)
                if labels[pid] == "worker":
                    owner[pid] = pid
                for k in kids.get(pid, ()):
                    owner[k] = owner[pid]
                    todo.append(k)
            pynames = _python_threads(testtime)
            cpu: collections.Counter = collections.Counter()
            wait: collections.Counter = collections.Counter()
            running: collections.Counter = collections.Counter()
            seen = {}
            for pid, own in owner.items():
                where = f"w{own}" if own else "run"
                kind = labels[pid]
                try:
                    tids = os.listdir(f"/proc/{pid}/task")
                except OSError:
                    continue
                born.setdefault(pid, now_t)
                for tid in tids:
                    st = _stat(f"/proc/{pid}/task/{tid}/stat")
                    sch = (_read(f"/proc/{pid}/task/{tid}/schedstat")
                           or "0 0").split()
                    if not st:
                        continue
                    born.setdefault(int(tid), now_t)
                    name = st[0]
                    if tid == str(pid):
                        name = "main"
                    elif name.startswith("llvm-worker"):
                        name = "llvm-worker"
                    elif tid in pynames:
                        name = "py-thread"
                    elif name in ("python", "python3", "pytest"):
                        name = ("native-early" if born[int(tid)] - born[pid]
                                < 60 else "native-late")
                    key = f"{where}/{kind}/{name}"
                    now = (st[3] / tck, int(sch[1]) / 1e9)
                    seen[tid] = now
                    prev = last.get(tid, now)
                    cpu[key] += now[0] - prev[0]
                    wait[key] += now[1] - prev[1]
                    running[key] += st[1] == "R"
            last = seen
            load = (_read("/proc/loadavg") or "0 0 0 0/0").split()
            fh.write(json.dumps({
                "t": now_t, "load1": float(load[0]),
                "runnable": int(load[3].split("/")[0]),
                "cpu": {k: round(v, 3) for k, v in cpu.items() if v},
                "wait": {k: round(v, 3) for k, v in wait.items() if v},
                "running": {k: v for k, v in running.items() if v}}) + "\n")
            fh.flush()


def _kind(key: str) -> str:
    """A sampled thread's kind, whatever worker it belongs to."""
    where, kind, name = key.split("/", 2)
    if kind == "worker":
        return f"worker {name}"
    if where == "run":
        return f"pytest {kind}"
    return f"child {kind} {'main' if name == 'main' else 'threads'}"


def _compiling(out: str) -> list[tuple]:
    """[(start, end)] of every JAX compile (a cache miss) in a plugin
    run's records, by wall clock."""
    return sorted((p["t"], p["t"] + p["s"]) for r in _records(out)
                  for p in _programs(r) if not p["hit"] and "t" in p)


def load(samples: str, out: str | None = None, top: int = 14) -> None:
    """The sampled host: mean runnable threads and load, the cores each
    kind of thread used (CPU seconds per second), its run-queue wait
    (threads waiting for a core, on average) and its share of the
    demand (cores used plus waiting, all kinds);
    with a plugin run's records, the same over the seconds in which some
    worker was compiling a JAX program, beside the rest."""
    rows = [json.loads(line) for line in open(samples)]
    windows = _compiling(out) if out else []
    # the whole seconds in which some compile ran: a sample at t covers
    # the second before it
    seconds = {int(t) for s, e in windows
               for t in range(int(s), int(e) + 1)}

    def busy(t: float) -> bool:
        return int(t) in seconds or int(t - 1.0) in seconds

    parts = {"all samples": rows}
    if windows:
        parts["a worker compiling"] = [r for r in rows if busy(r["t"])]
        parts["no compile"] = [r for r in rows if not busy(r["t"])]
    for name, part in parts.items():
        n = max(1, len(part))
        cpu: collections.Counter = collections.Counter()
        wait: collections.Counter = collections.Counter()
        for r in part:
            for k, v in r["cpu"].items():
                cpu[_kind(k)] += v
            for k, v in r["wait"].items():
                wait[_kind(k)] += v
        demand = sum(cpu.values()) + sum(wait.values())
        print(f"{name}: {len(part)} s, load1 "
              f"{sum(r['load1'] for r in part) / n:.2f}, runnable "
              f"{sum(r['runnable'] for r in part) / n:.2f}, cores used "
              f"{sum(cpu.values()) / n:.2f}, demand {demand / n:.2f}")
        print("    cores  waiting  share  kind")
        for k, v in cpu.most_common(int(top)):
            share = 100 * (v + wait[k]) / demand if demand else 0.0
            print(f"  {v / n:7.3f} {wait[k] / n:8.3f} {share:5.1f}%  {k}")


if __name__ == "__main__":
    {"junit": junit, "split": split, "keys": keys, "schedule": schedule,
     "compare": compare, "overlap": overlap, "sample": sample,
     "load": load, "contention": contention}[sys.argv[1]](*sys.argv[2:])
