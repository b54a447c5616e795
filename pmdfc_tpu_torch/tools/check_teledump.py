"""check_teledump — validate a teledump document or a flight dump, or a
live server's document pulled over the port's wire.

    python -m pmdfc_tpu_torch.tools.check_teledump snap.json
    python -m pmdfc_tpu_torch.tools.check_teledump flight_get_00001.json
    python -m pmdfc_tpu_torch.tools.check_teledump --live HOST PORT

The port's own copy of the telemetry wire schema (`pmdfc-telemetry-v1`/
`-v2`/`-v3`) and of the flight schema (`pmdfc-flight-v1`/`-v2`): the
same rules, word for word, as the JAX package's operator tool, so a
document either package writes passes or fails both alike
(`tests/test_torch_operator_tools.py` holds the two against each other).
v2 documents also pin the windowed `series` block, the workload
sketches, `misses == Σ miss_*` wherever KV counters appear (top level and
per shard), the migration, admission, fast-lane, controller, durability,
replica, QoS and containment lanes; v3 the device-time `profile` block.
Flight dumps (a `rung` and a flight `schema` key) are checked as such:
v2 also pins the span records (32-bit ids, start <= end, bool ok) and
the clock and recompile records.

The pull goes over `pmdfc_tpu_torch.runtime.net.TcpBackend`, so this
runs where JAX and the JAX package are absent. Importable: `check(doc)`
and `check_flight(doc) -> list[str]` return the violations (empty =
conformant). Exit 0 = conformant.
"""

from __future__ import annotations

import argparse
import json
import numbers
import sys

_HIST_KEYS = ("count", "sum", "max", "p50", "p95", "p99")
_TELEMETRY_SCHEMAS = ("pmdfc-telemetry-v1", "pmdfc-telemetry-v2",
                      "pmdfc-telemetry-v3")
_MISS_CAUSES = ("miss_cold", "miss_evicted", "miss_parked",
                "miss_stale", "miss_digest", "miss_routed",
                "miss_recovering", "miss_shed", "miss_quarantined",
                "miss_deadline")


def _num(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def check_series(series) -> list[str]:
    """Violations in a `series` block (the windowed ring's wire form)."""
    errs: list[str] = []
    if not isinstance(series, dict):
        return ["'series' is not an object"]
    for k in ("interval_s", "capacity"):
        if not _num(series.get(k)):
            errs.append(f"series.{k}: missing or non-numeric")
    windows = series.get("windows")
    if not isinstance(windows, list):
        return errs + ["series.windows missing or not a list"]
    for i, w in enumerate(windows):
        if not isinstance(w, dict):
            errs.append(f"series.windows[{i}]: not an object")
            continue
        for k in ("t", "dt_s"):
            if not _num(w.get(k)):
                errs.append(f"series.windows[{i}].{k}: non-numeric")
        if _num(w.get("dt_s")) and w["dt_s"] < 0:
            errs.append(f"series.windows[{i}].dt_s: negative")
        for sec, want in (("counters", numbers.Integral),
                          ("gauges", numbers.Real)):
            blk = w.get(sec)
            if not isinstance(blk, dict):
                errs.append(f"series.windows[{i}].{sec}: missing")
                continue
            for name, v in blk.items():
                if not isinstance(v, want) or isinstance(v, bool):
                    errs.append(
                        f"series.windows[{i}].{sec}.{name}: {v!r}")
        hists = w.get("hists")
        if not isinstance(hists, dict):
            errs.append(f"series.windows[{i}].hists: missing")
            continue
        for name, h in hists.items():
            for k in ("count", "p50", "p95", "p99"):
                if not _num(h.get(k)):
                    errs.append(
                        f"series.windows[{i}].hists.{name}.{k}: "
                        f"{h.get(k)!r}")
    return errs


def check_workload(wl) -> list[str]:
    """Violations in a `workload` block (sketch shape + bounds)."""
    errs: list[str] = []
    if not isinstance(wl, dict):
        return ["'workload' is not an object"]
    ops = wl.get("ops")
    ws = wl.get("working_set")
    if not _num(ops) or ops < 0:
        errs.append(f"workload.ops: {ops!r}")
    if not _num(ws) or ws < 0:
        errs.append(f"workload.working_set: {ws!r}")
    # a KMV estimate can never exceed the ops that fed it (bounds gate)
    if _num(ops) and _num(ws) and ws > max(ops, 1) * 1.5:
        errs.append(f"workload.working_set {ws} exceeds ops {ops}")
    win = wl.get("window")
    if not isinstance(win, dict) or not _num(win.get("working_set")) \
            or not _num(win.get("dt_s")):
        errs.append("workload.window: missing or malformed")
    heat = wl.get("heat")
    if not isinstance(heat, dict):
        return errs + ["workload.heat: missing"]
    for k in ("depth", "width", "total"):
        if not isinstance(heat.get(k), numbers.Integral) \
                or heat.get(k) < 0:
            errs.append(f"workload.heat.{k}: {heat.get(k)!r}")
    skew = heat.get("skew")
    if not _num(skew) or not (0.0 <= skew <= 1.0):
        errs.append(f"workload.heat.skew: {skew!r} not in [0, 1]")
    top = heat.get("top")
    if not isinstance(top, list):
        errs.append("workload.heat.top: missing or not a list")
    else:
        for i, row in enumerate(top):
            if (not isinstance(row, list) or len(row) != 3
                    or not all(_num(x) for x in row)
                    or not (0.0 <= row[2] <= 1.0)):
                errs.append(f"workload.heat.top[{i}]: {row!r}")
    return errs


def check_causes(doc: dict) -> list[str]:
    """The miss-cause sum invariant, everywhere the document carries KV
    counters: top level and per shard in `shard_report.stats`."""
    errs: list[str] = []
    if all(k in doc for k in ("misses", *_MISS_CAUSES)):
        total = sum(int(doc[k]) for k in _MISS_CAUSES)
        if int(doc["misses"]) != total:
            errs.append(f"miss-cause drift: misses={doc['misses']} but "
                        f"Σ causes={total}")
    st = (doc.get("shard_report") or {}).get("stats") or {}
    if all(k in st for k in ("misses", *_MISS_CAUSES)):
        for i, m in enumerate(st["misses"]):
            total = sum(int(st[k][i]) for k in _MISS_CAUSES)
            if int(m) != total:
                errs.append(f"shard {i} miss-cause drift: misses={m} "
                            f"but Σ causes={total}")
    return errs


_ADMIT_LANES = ("admit_denied", "admit_victim_kept",
                "admit_ghost_override", "admit_age_epochs")


def check_admission(doc: dict) -> list[str]:
    """TinyLFU admission-gate pins, bound when the document carries the
    admission counters (a tiered server with the gate on — PMDFC_ADMIT
    =off ships no admission keys at all, which tests pin; this checker
    binds what is present): the four lanes travel together as
    non-negative integers alongside the live `admit_threshold`,
    `admit_ghost_override` never exceeds `ghost_readmits` (an override
    IS a ghost readmission the frequency evidence alone would have
    refused — a strict subset), and when a `shard_report` rides along
    its per-shard admission lanes sum exactly to the top-level counters
    (admission lanes live only in the device tier vector, so no host
    plane can fork the fold). The `misses == Σ causes` invariant is
    re-asserted by `check_causes` on every document, admission on or
    off."""
    errs: list[str] = []
    if "admit_denied" not in doc:
        return errs
    for k in _ADMIT_LANES:
        v = doc.get(k)
        if not isinstance(v, numbers.Integral) or isinstance(v, bool) \
                or v < 0:
            errs.append(f"{k}: {v!r} is not a non-negative integer "
                        "(admission lanes travel together)")
    th = doc.get("admit_threshold")
    if not isinstance(th, numbers.Integral) or isinstance(th, bool) \
            or th < 0:
        errs.append(f"admit_threshold: {th!r} missing or negative")
    gr = doc.get("ghost_readmits")
    ov = doc.get("admit_ghost_override")
    if isinstance(gr, numbers.Integral) and isinstance(ov, numbers.Integral) \
            and ov > gr:
        errs.append(f"admission drift: admit_ghost_override={ov} > "
                    f"ghost_readmits={gr} (overrides are a subset)")
    tier = (doc.get("shard_report") or {}).get("tier") or {}
    for k in _ADMIT_LANES:
        lanes = tier.get(k)
        if lanes is None:
            continue
        if not isinstance(lanes, list) or not all(
                isinstance(x, numbers.Integral) and not isinstance(x, bool)
                and x >= 0 for x in lanes):
            errs.append(f"shard_report.tier.{k}: {lanes!r}")
            continue
        if isinstance(doc.get(k), numbers.Integral) \
                and sum(lanes) != int(doc[k]):
            errs.append(f"admission drift: Σ shard {k}={sum(lanes)} != "
                        f"top-level {doc[k]}")
    return errs


def check_fastpath(snap: dict) -> list[str]:
    """One-sided fast-lane pins, bound wherever a scope reports the
    fast-path counters: every FASTREAD lane is exactly one of hit or
    stale, and total reads are DERIVED as `hits + stale` (a stored
    reads counter would race the two lanes under live pulls). The pin:
    both lanes travel together, the scope gauges its directory epoch,
    and any producer that DOES store a reads counter must agree with
    the lanes bit-exactly."""
    errs: list[str] = []
    ctr = snap.get("counters")
    gauges = snap.get("gauges")
    if not isinstance(ctr, dict) or not isinstance(gauges, dict):
        return errs  # the section checks in check() already flag this
    for name, hits in list(ctr.items()):
        if not name.endswith(".fastpath_hits"):
            continue
        scope = name[:-len("fastpath_hits")]
        stale = ctr.get(scope + "fastpath_stale")
        if stale is None:
            errs.append(f"{scope}: fastpath_hits without its stale lane")
            continue
        reads = ctr.get(scope + "fastpath_reads")
        if reads is not None and int(hits) + int(stale) != int(reads):
            errs.append(f"{scope}: fast-lane drift — hits={hits} + "
                        f"stale={stale} != reads={reads}")
        ep = gauges.get(scope + "dir_epoch")
        if not isinstance(ep, numbers.Real) or isinstance(ep, bool) \
                or ep < 0:
            errs.append(f"{scope}: dir_epoch gauge missing or negative "
                        f"({ep!r})")
    return errs


def check_migration(snap: dict) -> list[str]:
    """Elastic-membership pins, bound wherever a scope reports the
    live-migration counters (`cluster/migrate.py`): the total
    `moved_pages` must equal the sum of its per-transition-kind lanes
    (join/leave/replace — pages can only move inside a transition of
    exactly one kind), the `lag` gauge must be present and non-negative
    (the dual-read window's backlog), and a settled engine
    (`active == 0`) must report zero lag — a nonzero lag with no open
    window means the transition bookkeeping leaked."""
    errs: list[str] = []
    ctr = snap.get("counters")
    gauges = snap.get("gauges")
    if not isinstance(ctr, dict) or not isinstance(gauges, dict):
        return errs  # the section checks in check() already flag this
    for name, moved in list(ctr.items()):
        if not name.endswith(".moved_pages"):
            continue
        scope = name[:-len("moved_pages")]
        lanes = {k: ctr.get(f"{scope}moved_{k}")
                 for k in ("join", "leave", "replace")}
        missing = [k for k, v in lanes.items() if v is None]
        if missing:
            errs.append(f"{scope}: moved_pages without per-kind "
                        f"lane(s) {missing}")
            continue
        total = sum(int(v) for v in lanes.values())
        if int(moved) != total:
            errs.append(f"{scope}: migration drift — moved_pages="
                        f"{moved} != Σ per-transition moves={total}")
        lag = gauges.get(scope + "lag")
        if not _num(lag) or lag < 0:
            errs.append(f"{scope}: lag gauge missing or negative "
                        f"({lag!r})")
        active = gauges.get(scope + "active")
        if active not in (0, 1):
            errs.append(f"{scope}: active gauge {active!r} not in "
                        "{0, 1}")
        if active == 0 and _num(lag) and lag != 0:
            errs.append(f"{scope}: settled engine (active=0) reports "
                        f"lag={lag}")
    return errs


def check_autotune(snap: dict) -> list[str]:
    """Closed-loop controller pins (`runtime/autotune.py`), bound
    wherever a scope reports knob gauges (the scope exists IFF the
    controller is enabled — PMDFC_AUTOTUNE=off registers nothing, which
    tests pin; this checker binds what is present): every `knob_<name>`
    gauge ships its `_lo`/`_hi` envelope siblings and sits INSIDE them
    (a knob outside its declared bounds means the clamp was bypassed),
    the `decisions` counter dominates `reverts` (a revert IS knob
    moves), and the `frozen` gauge is a 0/1 flag."""
    errs: list[str] = []
    gauges = snap.get("gauges")
    ctr = snap.get("counters")
    if not isinstance(gauges, dict) or not isinstance(ctr, dict):
        return errs  # the section checks in check() already flag this
    scopes = set()
    for name, v in list(gauges.items()):
        if ".knob_" not in name or name.endswith(("_lo", "_hi")):
            continue
        # discovery keys on the VALUE gauge (teletop's filter), so a
        # knob shipped without an envelope sibling is an ERROR here —
        # keying on `_hi` made a missing `_hi` render the whole knob
        # invisible to every pin, the exact bypassed-clamp shape this
        # checker exists to catch
        scopes.add(name.split(".knob_", 1)[0])
        lo = gauges.get(name + "_lo")
        hi = gauges.get(name + "_hi")
        if lo is None or hi is None:
            errs.append(f"{name}: knob gauge missing its lo/hi "
                        "envelope siblings")
        elif not (lo <= v <= hi):
            errs.append(f"{name}: knob value {v} outside its declared "
                        f"envelope [{lo}, {hi}]")
    for name in list(gauges):
        # the symmetric orphan: an envelope gauge whose knob value
        # gauge is absent
        if ".knob_" in name and name.endswith(("_lo", "_hi")) \
                and gauges.get(name[:-3]) is None:
            errs.append(f"{name}: envelope gauge without its knob "
                        "value gauge")
    for s in sorted(scopes):
        d = ctr.get(f"{s}.decisions")
        r = ctr.get(f"{s}.reverts")
        if d is None or r is None:
            errs.append(f"{s}: knob gauges without decisions/reverts "
                        "counters")
        elif int(d) < int(r):
            errs.append(f"{s}: controller drift — decisions={d} < "
                        f"reverts={r}")
        fz = gauges.get(f"{s}.frozen")
        if fz not in (0, 1):
            errs.append(f"{s}: frozen gauge {fz!r} not in {{0, 1}}")
    return errs


_JOURNAL_COUNTERS = ("syncs", "rotations", "replayed_records",
                     "truncated_tails")
_JOURNAL_GAUGES = ("depth_ops", "depth_bytes", "fsync_lag_ms", "segments")


def check_durability(snap: dict) -> list[str]:
    """Write-ahead-journal and warm-restart pins, bound wherever the
    scopes report (`runtime/journal.py` registers a `journal<N>` scope
    per instance; `KV.begin_recovering` the shared `recovery` scope —
    a server without durability ships neither, which tests pin; this
    checker binds what is present): the journal lanes travel together,
    the pending-depth gauge never exceeds the cumulative appends (a
    deeper-than-appended queue means the fsync ledger raced the
    writer), and completed recoveries never exceed warm restarts (a
    completion IS a warm restart reaching caught-up)."""
    errs: list[str] = []
    ctr = snap.get("counters")
    gauges = snap.get("gauges")
    if not isinstance(ctr, dict) or not isinstance(gauges, dict):
        return errs  # the section checks in check() already flag this
    for name, appends in list(ctr.items()):
        if not name.endswith(".appends"):
            continue
        scope = name[:-len("appends")]
        if not scope.startswith("journal"):
            continue
        for k in _JOURNAL_COUNTERS:
            if ctr.get(scope + k) is None:
                errs.append(f"{scope}: appends without its {k} lane "
                            "(journal lanes travel together)")
        for k in _JOURNAL_GAUGES:
            v = gauges.get(scope + k)
            if not isinstance(v, numbers.Real) or isinstance(v, bool) \
                    or v < 0:
                errs.append(f"{scope}{k}: gauge missing or negative "
                            f"({v!r})")
        depth = gauges.get(scope + "depth_ops")
        if isinstance(depth, numbers.Real) and depth > int(appends):
            errs.append(f"{scope}: durability drift — pending depth_ops="
                        f"{depth} exceeds appends={appends}")
    wr = ctr.get("recovery.warm_restarts")
    done = ctr.get("recovery.completed")
    if wr is not None or done is not None:
        if wr is None or done is None:
            errs.append("recovery: warm_restarts/completed must travel "
                        "together")
        elif int(done) > int(wr):
            errs.append(f"recovery drift: completed={done} > "
                        f"warm_restarts={wr}")
        flag = gauges.get("recovery.recovering")
        if flag not in (0, 1):
            errs.append(f"recovery.recovering gauge {flag!r} not in "
                        "{0, 1}")
    return errs


def check_replica(doc: dict) -> list[str]:
    """Device-replica plane pins, bound when the document carries the
    `replica` block (a 2-D serving mesh behind the endpoint): the three
    per-lane attribution lists agree on the advertised lane count and
    every count is a non-negative integer — a negative lane would mean
    the host fold raced the device attribution."""
    errs: list[str] = []
    rep = doc.get("replica")
    if rep is None:
        return errs
    if not isinstance(rep, dict):
        return ["'replica' is not an object"]
    n = rep.get("n_replicas")
    if not isinstance(n, int) or isinstance(n, bool) or n < 2:
        return [f"replica.n_replicas={n!r}, expected int >= 2"]
    for k in ("served", "digest_refused", "repaired"):
        lanes = rep.get(k)
        if not isinstance(lanes, list) or len(lanes) != n:
            errs.append(f"replica.{k}: expected {n} lanes, got {lanes!r}")
            continue
        for i, x in enumerate(lanes):
            if not isinstance(x, numbers.Integral) \
                    or isinstance(x, bool) or x < 0:
                errs.append(f"replica.{k}[{i}]: {x!r} is not a "
                            "non-negative integer")
    return errs


_QOS_LANES = ("staged", "shed_edge", "shed_ladder",
              "shed_gets", "shed_puts")


def check_qos(snap: dict) -> list[str]:
    """Multi-tenant QoS pins (`runtime/qos.py`), bound wherever a
    tenant scope reports (scopes exist IFF the plane is on —
    PMDFC_QOS=off registers nothing, which tests pin; this checker
    binds what is present): the per-tenant lanes travel together as
    non-negative integers, every op the edge saw either staged or was
    edge-shed (`ops == staged + shed_edge` — conservation, nothing
    vanishes unattributed), the ladder can only shed what actually
    staged (`shed_ladder <= staged`, the shed ⊆ staged pin), the two
    shed sources decompose exactly into the per-verb shed lanes
    (`shed_edge + shed_ladder == shed_gets + shed_puts`), and the
    declared weight/rate gauges ride along (weight >= 1 — a zero-weight
    lane could never drain; rate >= 0, 0 = unlimited)."""
    errs: list[str] = []
    ctr = snap.get("counters")
    gauges = snap.get("gauges")
    if not isinstance(ctr, dict) or not isinstance(gauges, dict):
        return errs  # the section checks in check() already flag this
    for name, ops in list(ctr.items()):
        if ".qos.t" not in name or not name.endswith(".ops"):
            continue
        scope = name[:-len("ops")]
        lanes = {k: ctr.get(scope + k) for k in _QOS_LANES}
        missing = [k for k, v in lanes.items() if v is None]
        if missing:
            errs.append(f"{scope}: ops without lane(s) {missing} "
                        "(tenant lanes travel together)")
            continue
        bad = [k for k, v in lanes.items()
               if not isinstance(v, numbers.Integral)
               or isinstance(v, bool) or v < 0]
        if bad:
            errs.append(f"{scope}: non-integer/negative lane(s) {bad}")
            continue
        if int(lanes["staged"]) + int(lanes["shed_edge"]) != int(ops):
            errs.append(
                f"{scope}: qos drift — staged={lanes['staged']} + "
                f"shed_edge={lanes['shed_edge']} != ops={ops}")
        if int(lanes["shed_ladder"]) > int(lanes["staged"]):
            errs.append(
                f"{scope}: qos drift — shed_ladder={lanes['shed_ladder']}"
                f" exceeds staged={lanes['staged']} (shed ⊆ staged)")
        if int(lanes["shed_edge"]) + int(lanes["shed_ladder"]) \
                != int(lanes["shed_gets"]) + int(lanes["shed_puts"]):
            errs.append(
                f"{scope}: qos drift — shed_edge+shed_ladder="
                f"{int(lanes['shed_edge']) + int(lanes['shed_ladder'])} "
                f"!= shed_gets+shed_puts="
                f"{int(lanes['shed_gets']) + int(lanes['shed_puts'])}")
        w = gauges.get(scope + "weight")
        if not _num(w) or w < 1:
            errs.append(f"{scope}: weight gauge missing or < 1 ({w!r})")
        r = gauges.get(scope + "rate")
        if not _num(r) or r < 0:
            errs.append(f"{scope}: rate gauge missing or negative "
                        f"({r!r})")
    return errs


_CONTAIN_LANES = ("nacks_sent", "poison_refused", "poison_ops",
                  "bisect_launches", "bisect_failures", "deadline_shed")


def check_containment(snap: dict) -> list[str]:
    """Blast-radius containment pins (`runtime/net.py` NACK/bisection,
    `runtime/failure.py` ShardQuarantine), bound wherever the scopes
    report (PMDFC_CONTAINMENT=off still registers the net counters —
    they just never move): the six containment lanes travel together on
    every `net` scope as non-negative integers; each bisection split
    launches exactly its two halves (`bisect_launches == 2 *
    bisect_failures` — a drifted ratio means a relaunch escaped its
    bound accounting); a quarantine scope can only re-admit shards that
    tripped (`readmits <= trips`) and only replay invalidations that
    were journaled (`replayed_invals <= journaled_invals`)."""
    errs: list[str] = []
    ctr = snap.get("counters")
    if not isinstance(ctr, dict):
        return errs  # the section checks in check() already flag this
    for name in list(ctr):
        if name.endswith(".net.nacks_sent") or name == "net.nacks_sent":
            scope = name[:-len("nacks_sent")]
            lanes = {k: ctr.get(scope + k) for k in _CONTAIN_LANES}
            missing = [k for k, v in lanes.items() if v is None]
            if missing:
                errs.append(f"{scope}: containment lane(s) {missing} "
                            "missing (lanes travel together)")
                continue
            bad = [k for k, v in lanes.items()
                   if not isinstance(v, numbers.Integral)
                   or isinstance(v, bool) or v < 0]
            if bad:
                errs.append(f"{scope}: non-integer/negative "
                            f"containment lane(s) {bad}")
                continue
            if int(lanes["bisect_launches"]) \
                    != 2 * int(lanes["bisect_failures"]):
                errs.append(
                    f"{scope}: bisect drift — launches="
                    f"{lanes['bisect_launches']} != 2 x failures="
                    f"{lanes['bisect_failures']} (each split launches "
                    "exactly its two halves)")
        if name.endswith(".quarantine.trips") \
                or name == "quarantine.trips":
            scope = name[:-len("trips")]
            trips = ctr.get(scope + "trips", 0)
            readmits = ctr.get(scope + "readmits", 0)
            if isinstance(readmits, numbers.Integral) \
                    and isinstance(trips, numbers.Integral) \
                    and int(readmits) > int(trips):
                errs.append(f"{scope}: readmits={readmits} exceeds "
                            f"trips={trips}")
            j = ctr.get(scope + "journaled_invals", 0)
            r = ctr.get(scope + "replayed_invals", 0)
            if isinstance(j, numbers.Integral) \
                    and isinstance(r, numbers.Integral) and int(r) > int(j):
                errs.append(f"{scope}: replayed_invals={r} exceeds "
                            f"journaled_invals={j}")
    return errs


def check_profile(snap: dict) -> list[str]:
    """Device-time profiler pins (`runtime/profiler.py`), bound when
    the snapshot carries a `profile` block — which is ALSO the v3
    declaration gate: a profile block rides only on documents declaring
    `pmdfc-telemetry-v3`, and a v3 declaration without the block means
    the sink detached mid-snapshot. Inside the block: the attribution
    rows carry (phase, program, shard >= -1, non-negative ops /
    device_us), the per-shard lane vectors agree with the advertised
    `n_shards`, the windowed imbalance gauge is either 0 (no window
    completed yet) or inside its algebraic range [1, n_shards] —
    max/mean over n non-negative lanes can land nowhere else — and any
    captured `cost.*` entries ship numeric flops/bytes pairs."""
    errs: list[str] = []
    prof = snap.get("profile")
    declared_v3 = snap.get("schema") == "pmdfc-telemetry-v3"
    if prof is None:
        if declared_v3:
            errs.append("v3 snapshot lacks the 'profile' block")
        return errs
    if not declared_v3:
        errs.append(f"profile block on a {snap.get('schema')!r} snapshot "
                    "(v3 declares the profiler sink)")
    if not isinstance(prof, dict):
        return errs + ["'profile' is not an object"]
    if prof.get("schema") != "pmdfc-prof-v1":
        errs.append(f"profile.schema is {prof.get('schema')!r}, "
                    "expected 'pmdfc-prof-v1'")
    for k in ("launches", "rows_dropped", "n_shards"):
        v = prof.get(k)
        if not isinstance(v, numbers.Integral) or isinstance(v, bool) \
                or v < 0:
            errs.append(f"profile.{k}: {v!r} is not a non-negative int")
    n = prof.get("n_shards") if isinstance(
        prof.get("n_shards"), numbers.Integral) else 0
    rows = prof.get("rows")
    if not isinstance(rows, list):
        errs.append("profile.rows: missing or not a list")
    else:
        for i, r in enumerate(rows):
            if not isinstance(r, dict):
                errs.append(f"profile.rows[{i}]: not an object")
                continue
            for k in ("phase", "program"):
                if not isinstance(r.get(k), str) or not r.get(k):
                    errs.append(f"profile.rows[{i}].{k}: {r.get(k)!r}")
            s = r.get("shard")
            if not isinstance(s, numbers.Integral) or isinstance(s, bool) \
                    or s < -1 or (n and s >= n):
                errs.append(f"profile.rows[{i}].shard: {s!r} outside "
                            f"[-1, {n})")
            for k in ("ops", "device_us"):
                v = r.get(k)
                if not _num(v) or v < 0:
                    errs.append(f"profile.rows[{i}].{k}: {v!r}")
    for k, want in (("shard_device_us", numbers.Real),
                    ("shard_ops", numbers.Integral)):
        lanes = prof.get(k)
        if not isinstance(lanes, list) or len(lanes) != n:
            errs.append(f"profile.{k}: expected {n} lanes, got {lanes!r}")
            continue
        for i, x in enumerate(lanes):
            if not isinstance(x, want) or isinstance(x, bool) or x < 0:
                errs.append(f"profile.{k}[{i}]: {x!r}")
    imb = prof.get("imbalance")
    if not _num(imb) or not (imb == 0 or (1.0 <= imb <= max(n, 1))):
        errs.append(f"profile.imbalance: {imb!r} not 0 or in "
                    f"[1, {max(n, 1)}]")
    cost = prof.get("cost")
    if not isinstance(cost, dict):
        errs.append("profile.cost: missing or not an object")
    else:
        for prog, c in cost.items():
            if not isinstance(c, dict) or not _num(c.get("flops")) \
                    or not _num(c.get("bytes")) or c["flops"] < 0 \
                    or c["bytes"] < 0:
                errs.append(f"profile.cost.{prog}: {c!r}")
    return errs


def check(doc: dict) -> list[str]:
    """Schema violations in a teledump document (server_stats pull or a
    bare `{"telemetry": ...}` local dump)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, expected object"]
    snap = doc.get("telemetry")
    if snap is None:
        return ["missing 'telemetry' section (server running with "
                "PMDFC_TELEMETRY=off?)"]
    if not isinstance(snap, dict):
        return ["'telemetry' is not an object"]
    if snap.get("schema") not in _TELEMETRY_SCHEMAS:
        errs.append(f"schema is {snap.get('schema')!r}, expected one "
                    f"of {_TELEMETRY_SCHEMAS}")
    if not isinstance(snap.get("enabled"), bool):
        errs.append("'enabled' missing or not a bool")
    for section, want in (("counters", numbers.Integral),
                          ("gauges", numbers.Real)):
        block = snap.get(section)
        if not isinstance(block, dict):
            errs.append(f"'{section}' missing or not an object")
            continue
        for name, v in block.items():
            if not isinstance(name, str) or not name:
                errs.append(f"{section}: non-string metric name {name!r}")
            if not isinstance(v, want) or isinstance(v, bool):
                errs.append(f"{section}.{name}: {v!r} is not "
                            f"{want.__name__}")
    hists = snap.get("histograms")
    if not isinstance(hists, dict):
        errs.append("'histograms' missing or not an object")
    else:
        for name, h in hists.items():
            if not isinstance(h, dict):
                errs.append(f"histograms.{name}: not an object")
                continue
            for k in _HIST_KEYS:
                v = h.get(k)
                if not isinstance(v, numbers.Real) or isinstance(v, bool):
                    errs.append(f"histograms.{name}.{k}: {v!r} is not "
                                "numeric")
            c = h.get("count")
            if isinstance(c, numbers.Real) and c < 0:
                errs.append(f"histograms.{name}.count: negative")
    ring = snap.get("ring")
    if not isinstance(ring, dict) or not isinstance(
            ring.get("len"), numbers.Integral) or not isinstance(
            ring.get("capacity"), numbers.Integral):
        errs.append("'ring' missing or malformed (needs int len/capacity)")
    # v2 sections (bound only when present/declared — v1 docs still parse)
    if "series" in snap:
        errs.extend(check_series(snap["series"]))
    elif snap.get("schema") in ("pmdfc-telemetry-v2",
                                "pmdfc-telemetry-v3") \
            and doc.get("workload") is not None:
        # a serving snapshot (workload present ⇒ a live NetServer built
        # it) must ship the windowed series alongside
        errs.append("v2 serving snapshot lacks the 'series' block")
    if doc.get("workload") is not None:
        errs.extend(check_workload(doc["workload"]))
    errs.extend(check_causes(doc))
    errs.extend(check_admission(doc))
    errs.extend(check_fastpath(snap))
    errs.extend(check_migration(snap))
    errs.extend(check_autotune(snap))
    errs.extend(check_qos(snap))
    errs.extend(check_containment(snap))
    errs.extend(check_durability(snap))
    errs.extend(check_replica(doc))
    errs.extend(check_profile(snap))
    return errs


_FLIGHT_SCHEMAS = ("pmdfc-flight-v1", "pmdfc-flight-v2")


def _check_span_v2(i: int, rec: dict) -> list[str]:
    errs = []
    for k in ("span", "parent"):
        v = rec.get(k)
        if not isinstance(v, numbers.Integral) or isinstance(v, bool) \
                or not (0 <= v <= 0xFFFFFFFF):
            errs.append(f"records[{i}].{k}: {v!r} is not a 32-bit id")
    if not isinstance(rec.get("ok"), bool):
        errs.append(f"records[{i}].ok: missing or not a bool")
    t0, t1 = rec.get("t0_ns"), rec.get("t1_ns")
    if t0 is not None or t1 is not None:
        for k, v in (("t0_ns", t0), ("t1_ns", t1)):
            if not isinstance(v, numbers.Integral) or isinstance(v, bool):
                errs.append(f"records[{i}].{k}: {v!r} is not an int")
        if isinstance(t0, numbers.Integral) \
                and isinstance(t1, numbers.Integral) and t1 < t0:
            errs.append(f"records[{i}]: t1_ns < t0_ns")
    return errs


def check_flight(doc: dict) -> list[str]:
    """Schema violations in a flight-recorder dump. v1 documents are
    held only to the v1 shape (rung/detail/telemetry/records); the span
    tree + clock record requirements bind documents declaring v2."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, expected object"]
    schema = doc.get("schema")
    if schema not in _FLIGHT_SCHEMAS:
        errs.append(f"schema is {schema!r}, expected one of "
                    f"{_FLIGHT_SCHEMAS}")
    if not isinstance(doc.get("rung"), str) or not doc.get("rung"):
        errs.append("'rung' missing or not a string")
    if not isinstance(doc.get("detail"), dict):
        errs.append("'detail' missing or not an object")
    errs.extend(check({"telemetry": doc.get("telemetry")}))
    records = doc.get("records")
    if not isinstance(records, list):
        return errs + ["'records' missing or not a list"]
    v2 = schema == "pmdfc-flight-v2"
    for i, rec in enumerate(records):
        if not isinstance(rec, dict) or not isinstance(
                rec.get("kind"), str):
            errs.append(f"records[{i}]: not an object with a 'kind'")
            continue
        if not v2:
            continue
        if rec["kind"] == "span" and "span" in rec:
            errs.extend(_check_span_v2(i, rec))
        elif rec["kind"] == "clock":
            for k in ("offset_ns", "rtt_ns"):
                if not isinstance(rec.get(k), numbers.Integral):
                    errs.append(f"records[{i}].{k}: missing or non-int")
        elif rec["kind"] == "recompile":
            if not isinstance(rec.get("program"), str):
                errs.append(f"records[{i}].program: missing or non-str")
    if "series" in doc:
        errs.extend(check_series(doc["series"]))
    # the SLO watchdog's breach dumps must stay attributable
    if v2 and doc.get("rung") == "slo_breach":
        det = doc.get("detail") or {}
        for k in ("target", "stage", "metric", "threshold", "value"):
            if k not in det:
                errs.append(f"slo_breach detail lacks {k!r}")
    return errs



def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path", nargs="?", help="teledump JSON file")
    p.add_argument("--live", nargs=2, metavar=("HOST", "PORT"),
                   help="pull from a live server instead of a file")
    p.add_argument("--page-words", type=int, default=1024)
    args = p.parse_args(argv)

    if args.live:
        from pmdfc_tpu_torch.tools.teledump import pull

        doc = pull(args.live[0], int(args.live[1]), args.page_words)
    elif args.path:
        with open(args.path) as f:
            doc = json.load(f)
    else:
        p.error("need a PATH or --live HOST PORT")

    is_flight = (isinstance(doc, dict) and "rung" in doc
                 and str(doc.get("schema", "")).startswith("pmdfc-flight"))
    errs = check_flight(doc) if is_flight else check(doc)
    if errs:
        for e in errs:
            print(f"[check_teledump] FAIL: {e}", file=sys.stderr)
        return 1
    snap = doc["telemetry"]
    kind = (f"flight dump ({doc['schema']}, rung {doc['rung']}, "
            f"{len(doc['records'])} records)" if is_flight
            else "telemetry snapshot")
    print(f"[check_teledump] OK: {kind} — {len(snap['counters'])} "
          f"counters, {len(snap['gauges'])} gauges, "
          f"{len(snap['histograms'])} histograms, "
          f"ring {snap['ring']['len']}/{snap['ring']['capacity']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
