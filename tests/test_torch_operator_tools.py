"""PyTorch port: the port's own operator tools held against the originals.

`pmdfc_tpu_torch.tools.check_teledump`, `.tracetool` and `.proftool` are
the port's copies of the repo's `tools/check_teledump.py`,
`tools/tracetool.py` and `tools/proftool.py` (the JAX system's operator
tools), kept so that the port imports nothing of that system. Each copy
and its original run here on the same inputs and must give the same
output:

- every schema rule (`check`, `check_flight` and each `check_*`) over a
  conforming document pulled from a port server (a 2-shard tiered plane
  with the admission gate, the profiler attached), over the port's flight
  dump, and over each planted fault the JAX tests use on those rules;
- tracetool's load, join, clock offsets, Chrome export, breakdown and
  table over a pair of port flight dumps;
- proftool's merge, breakdown, report and device lanes over a port
  profiler snapshot.

A source check holds every function and table of each copy to its
original's syntax tree (the CLIs excepted: the port's pulls over its own
wire).
"""

from __future__ import annotations

import ast
import contextlib
import copy
import io
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)

import pmdfc_tpu_torch.config as tconfig
from pmdfc_tpu_torch.parallel import plane as tplane
from pmdfc_tpu_torch.parallel import shard as tshard
from pmdfc_tpu_torch.runtime import profiler as tprof
from pmdfc_tpu_torch.runtime import telemetry as ttele
from pmdfc_tpu_torch.runtime import timeseries as tts
from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend
from pmdfc_tpu_torch.tools import check_teledump as pcheck
from pmdfc_tpu_torch.tools import proftool as pprof
from pmdfc_tpu_torch.tools import tracetool as ptrace
from tools import check_teledump as rcheck
from tools import proftool as rprof
from tools import tracetool as rtrace

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
W = 16
PAIRS = {"check_teledump": (rcheck, pcheck), "tracetool": (rtrace, ptrace),
         "proftool": (rprof, pprof)}


def _defs(mod) -> dict:
    """{name: syntax tree} of a module's top-level functions, classes and
    assignments, docstrings dropped (the copies' module docstrings name
    their own package)."""
    tree = ast.parse(Path(mod.__file__).read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            out[ast.unparse(node.targets[0])] = node
    return {k: ast.dump(v) for k, v in out.items()}


@pytest.mark.parametrize("tool", sorted(PAIRS))
def test_the_copy_is_its_original_function_for_function(tool):
    orig, port = (_defs(m) for m in PAIRS[tool])
    cli = {"main"} if tool == "check_teledump" else set()
    assert set(orig) == set(port), set(orig) ^ set(port)
    differ = sorted(k for k in orig if orig[k] != port[k] and k not in cli)
    assert not differ, f"{tool}: {differ} differ from the original"


# -- a conforming document, two flight dumps, a profiler snapshot -----------


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 20, size=n, replace=False)
    return np.stack([flat >> 10, flat & 0x3FF], -1).astype(np.uint32)


def _pages(keys):
    return ((keys[:, 0] * np.uint32(31) + keys[:, 1])[:, None]
            + np.arange(1, W + 1, dtype=np.uint32)[None, :])


@pytest.fixture(scope="module")
def port_docs(tmp_path_factory):
    """A port server's MSG_STATS document and two of its flight dumps (one
    after the first verbs, one after more), with the profiler attached:
    {"doc", "dumps": [path, path], "snap": the profiler's flight doc}."""
    root = tmp_path_factory.mktemp("operator_tools")
    ttele.configure(tconfig.TelemetryConfig(
        ring_capacity=1 << 15, dump_dir=str(root), dump_min_interval_s=0.0))
    try:
        tprof.install()
        # the server's sampler, at a cadence that fills windows here
        tts.ensure_collector(interval_s=0.01, capacity=64)
        cfg = tconfig.KVConfig(
            index=tconfig.IndexConfig(capacity=1 << 10),
            bloom=tconfig.BloomConfig(num_bits=1 << 15), page_words=W,
            tier=tconfig.TierConfig(
                ghost_rows=32, promote_touches=1,
                admit=tconfig.AdmitConfig(sketch_width=1 << 10,
                                          door_bits=1 << 11, reset_ops=64)))
        plane = tplane.PlaneBackend(tshard.ShardedKV(
            cfg, mesh=tshard.make_mesh(["cpu"] * 2)))
        srv = NetServer(lambda: plane, net=tconfig.NetConfig(
            flush_timeout_us=0, settle_us=0)).start()
        dumps = []
        try:
            with TcpBackend("127.0.0.1", srv.port, page_words=W,
                            keepalive_s=None) as be:
                for seed in (1, 2):
                    keys = _keys(64, seed)
                    be.put(keys, _pages(keys))
                    be.get(keys)
                    be.get(_keys(16, seed + 10))
                    be.get(keys)
                    dumps.append(ttele.dump_now(f"tools{seed}"))
                time.sleep(0.05)
                doc = be.server_stats()
        finally:
            srv.stop()
        reg = ttele.get()
        snap = {"schema": "pmdfc-flight-v2", "rung": "manual", "detail": {},
                "ts_unix": 0.0, "telemetry": reg.snapshot(),
                "records": reg.ring_tail()}
        path = root / "profile.json"
        path.write_text(json.dumps(snap))
    finally:
        ttele.configure()
    doc = json.loads(json.dumps(doc))
    assert rcheck.check(doc) == [] and doc["telemetry"]["profile"]
    assert doc["telemetry"]["series"]["windows"]
    return {"doc": doc, "dumps": dumps, "profile": str(path)}


# -- the schema rules over the planted faults -------------------------------

def _qos_snap(ops=10, staged=7, shed_edge=3, shed_ladder=2, shed_gets=4,
              shed_puts=1, weight=3, rate=100.0):
    """`tests/test_qos.py`'s lane snapshot."""
    pfx = "net.server.qos.t2."
    return {"counters": {pfx + "ops": ops, pfx + "staged": staged,
                         pfx + "shed_edge": shed_edge,
                         pfx + "shed_ladder": shed_ladder,
                         pfx + "shed_gets": shed_gets,
                         pfx + "shed_puts": shed_puts},
            "gauges": {pfx + "weight": weight, pfx + "rate": rate}}


def _ctl_snap():
    """`tests/test_autotune.py`'s controller snapshot."""
    return {"gauges": {"ctl0.knob_dwell_us": 150.0,
                       "ctl0.knob_dwell_us_lo": 100.0,
                       "ctl0.knob_dwell_us_hi": 20000.0, "ctl0.frozen": 0},
            "counters": {"ctl0.decisions": 3, "ctl0.reverts": 1}}


def _fast_snap(doc):
    """The server's snapshot with a consistent fast-lane scope (the
    lanes `tests/test_fastpath.py` reads off a live fast reader)."""
    snap = copy.deepcopy(doc["telemetry"])
    snap["counters"].update({"net9.fastpath_hits": 5,
                             "net9.fastpath_stale": 2,
                             "net9.fastpath_reads": 7})
    snap["gauges"]["net9.dir_epoch"] = 3
    return snap


def _set(d, path, value):
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value


def _drop(d, path):
    for k in path[:-1]:
        d = d[k]
    del d[path[-1]]


def _flight_span_not_an_id(dump):
    for r in dump["records"]:
        if r.get("kind") == "span":
            r["span"] = "not-an-id"
            return


def _flight_v1(dump):
    for r in dump["records"]:
        for k in ("span", "parent", "t0_ns", "t1_ns"):
            r.pop(k, None)


def _shard_cause_drift(doc):
    zeros = [0, 0]
    doc["shard_report"] = {"n_shards": 2, "stats": {
        "misses": [2, 2], "miss_cold": [2, 1], **{
            c: zeros for c in rcheck._MISS_CAUSES if c != "miss_cold"}}}


# (name, the input it starts from, its planted fault, the rule it must
# trip); the base inputs: "doc" the server's document, "snap" its
# telemetry snapshot, "flight" its first flight dump, "qos", "ctl",
# "fast" the JAX tests' own snapshots
FAULTS = [
    ("conforming-doc", "doc", None, None),
    ("conforming-flight", "flight", None, None),
    ("conforming-qos", "qos", None, None),
    ("conforming-ctl", "ctl", None, None),
    ("conforming-fast", "fast", None, None),
    # tests/test_telemetry.py
    ("counter-not-an-int", "doc",
     lambda d: _set(d, ("telemetry", "counters", next(iter(
         d["telemetry"]["counters"]))), "three"), "check"),
    ("empty-document", "empty", None, "check"),
    # tests/test_admit.py
    ("admit-override-past-readmits", "doc",
     lambda d: _set(d, ("admit_ghost_override",), d["ghost_readmits"] + 1),
     "check_admission"),
    ("admit-torn-lanes", "doc", lambda d: _drop(d, ("admit_victim_kept",)),
     "check_admission"),
    ("admit-shard-drift", "doc",
     lambda d: _set(d, ("shard_report",), {"tier": {
         "admit_denied": [d["admit_denied"] + 1]}}), "check_admission"),
    # tests/test_xray.py
    ("cause-sum-drift", "doc", lambda d: _set(d, ("miss_cold",), 99),
     "check_causes"),
    ("shard-cause-drift", "doc", _shard_cause_drift, "check_causes"),
    ("workload-skew", "doc",
     lambda d: _set(d, ("workload", "heat", "skew"), 7.0), "check"),
    ("series-dt-not-a-number", "doc",
     lambda d: _set(d, ("telemetry", "series", "windows", 0, "dt_s"),
                    "fast"), "check"),
    ("series-missing", "doc", lambda d: _drop(d, ("telemetry", "series")),
     "check"),
    ("telemetry-v1", "v1", None, None),
    # tests/test_tracing.py
    ("flight-span-not-an-id", "flight", _flight_span_not_an_id,
     "check_flight"),
    ("flight-v1-shaped", "flight", _flight_v1, None),
    # tests/test_qos.py
    ("qos-conservation", "qos", lambda s: _set(
        s, ("counters", "net.server.qos.t2.ops"), 11), "check_qos"),
    ("qos-shed", "qos", lambda s: _set(
        s, ("counters", "net.server.qos.t2.shed_ladder"), 8), "check_qos"),
    ("qos-shed-gets", "qos", lambda s: _set(
        s, ("counters", "net.server.qos.t2.shed_gets"), 1), "check_qos"),
    ("qos-weight", "qos", lambda s: _set(
        s, ("gauges", "net.server.qos.t2.weight"), 0), "check_qos"),
    ("qos-rate", "qos", lambda s: _set(
        s, ("gauges", "net.server.qos.t2.rate"), -1.0), "check_qos"),
    ("qos-straggler", "qos", lambda s: _drop(
        s, ("counters", "net.server.qos.t2.shed_ladder")), "check_qos"),
    # tests/test_autotune.py
    ("ctl-out-of-envelope", "ctl", lambda s: _set(
        s, ("gauges", "ctl0.knob_dwell_us"), 50.0), "check_autotune"),
    ("ctl-reverts-past-decisions", "ctl", lambda s: _set(
        s, ("counters", "ctl0.reverts"), 9), "check_autotune"),
    ("ctl-lo-missing", "ctl", lambda s: _drop(
        s, ("gauges", "ctl0.knob_dwell_us_lo")), "check_autotune"),
    ("ctl-hi-missing", "ctl", lambda s: _drop(
        s, ("gauges", "ctl0.knob_dwell_us_hi")), "check_autotune"),
    ("ctl-orphan-envelope", "ctl", lambda s: _drop(
        s, ("gauges", "ctl0.knob_dwell_us")), "check_autotune"),
    ("ctl-frozen", "ctl", lambda s: _set(
        s, ("gauges", "ctl0.frozen"), 7), "check_autotune"),
    # tests/test_fastpath.py
    ("fast-reads-drift", "fast", lambda s: _set(
        s, ("counters", "net9.fastpath_reads"), 8), "check_fastpath"),
    ("fast-stale-missing", "fast", lambda s: _drop(
        s, ("counters", "net9.fastpath_stale")), "check_fastpath"),
    ("fast-epoch-missing", "fast", lambda s: _drop(
        s, ("gauges", "net9.dir_epoch")), "check_fastpath"),
]

DOC_RULES = ("check", "check_causes", "check_admission", "check_replica")
SNAP_RULES = ("check_fastpath", "check_migration", "check_autotune",
              "check_durability", "check_qos", "check_containment",
              "check_profile")


def _base(port_docs, kind):
    if kind == "empty":
        return {}
    if kind == "flight":
        with open(port_docs["dumps"][0]) as f:
            return json.load(f)
    if kind == "v1":  # a v1 snapshot: no series, no profile
        snap = copy.deepcopy(port_docs["doc"]["telemetry"])
        snap["schema"] = "pmdfc-telemetry-v1"
        del snap["series"], snap["profile"]
        return {"telemetry": snap}
    return {"doc": lambda: copy.deepcopy(port_docs["doc"]),
            "qos": _qos_snap, "ctl": _ctl_snap,
            "fast": lambda: _fast_snap(port_docs["doc"])}[kind]()


def _verdicts(mod, kind, x) -> dict:
    """Every rule of `mod` that takes this kind of input -> its errors."""
    if kind == "flight":
        return {"check_flight": mod.check_flight(x)}
    snap = x.get("telemetry") if kind in ("doc", "empty", "v1") else x
    out = {}
    if kind in ("doc", "empty", "v1"):
        out.update({r: getattr(mod, r)(x) for r in DOC_RULES})
        if "series" in (snap or {}):
            out["check_series"] = mod.check_series(snap["series"])
        if "workload" in x:
            out["check_workload"] = mod.check_workload(x["workload"])
    if isinstance(snap, dict):
        out.update({r: getattr(mod, r)(snap) for r in SNAP_RULES})
    return out


@pytest.mark.parametrize("name,kind,fault,rule", FAULTS,
                         ids=[f[0] for f in FAULTS])
def test_rules_agree_with_the_original_on_each_planted_fault(
        port_docs, name, kind, fault, rule):
    x = _base(port_docs, kind)
    if fault is not None:
        fault(x)
    orig = _verdicts(rcheck, kind, copy.deepcopy(x))
    port = _verdicts(pcheck, kind, copy.deepcopy(x))
    assert orig == port, name
    if rule is None:
        assert not any(orig.values()), orig
    else:
        assert orig[rule], f"{name}: {rule} did not trip"


# -- tracetool over a pair of flight dumps, proftool over a snapshot -------


def _cli(main, argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _tree(nodes) -> dict:
    return {k: (n.pid, n.rec, [c.rec for c in n.children],
                [c.rec for c in n.linked]) for k, n in nodes.items()}


def test_tracetool_copy_joins_a_pair_of_port_dumps_like_the_original(
        port_docs, tmp_path):
    paths = port_docs["dumps"]
    recs = [m.load_dumps(paths) for m in (rtrace, ptrace)]
    assert recs[0] == recs[1] and recs[0]
    records = recs[0]
    assert rtrace.clock_offsets(records) == ptrace.clock_offsets(records)
    trees = [m.build_tree(records) for m in (rtrace, ptrace)]
    assert _tree(trees[0]) == _tree(trees[1])
    traces = sorted({r["trace"] for _, r in records
                     if r.get("kind") == "span" and r.get("trace")})
    assert traces, "no traced verb in the dumps"
    for t in traces[:4]:
        a, b = (m.trace_tree(tr, t) for m, tr in zip((rtrace, ptrace), trees))
        assert [n.rec for n in a] == [n.rec for n in b]
        assert rtrace.chrome_trace(records, t) == ptrace.chrome_trace(
            records, t)
    assert rtrace.chrome_trace(records) == ptrace.chrome_trace(records)
    rows = rtrace.breakdown(records)
    assert rows and rows == ptrace.breakdown(records)
    assert rtrace.render_table(rows) == ptrace.render_table(rows)
    assert _cli(rtrace.main, [*paths, "--table"]) == _cli(
        ptrace.main, [*paths, "--table"])
    outs = [tmp_path / "orig.json", tmp_path / "port.json"]
    for m, out in zip((rtrace, ptrace), outs):
        assert _cli(m.main, [*paths, "--out", str(out)])[0] == 0
    assert outs[0].read_text() == outs[1].read_text()


def test_proftool_copy_breaks_down_a_port_snapshot_like_the_original(
        port_docs):
    path = [port_docs["profile"]]
    docs = rprof.load_docs(path)
    assert docs == pprof.load_docs(path)
    agg = rprof._merge(docs)
    assert agg == pprof._merge(docs)
    table = rprof.breakdown(agg)
    assert table["rows"] and table == pprof.breakdown(agg)
    assert rprof.render_report(table) == pprof.render_report(table)
    assert rprof.device_lane_trace(path) == pprof.device_lane_trace(path)
    for flag in ("--table", "--json"):
        assert _cli(rprof.main, [*path, flag]) == _cli(pprof.main,
                                                       [*path, flag])
