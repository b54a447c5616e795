"""proftool — roll profiler teledumps into device-time breakdowns.

Consumes any document that embeds a telemetry snapshot with the
profiler's `profile` block (schema `pmdfc-telemetry-v3`):

- flight-recorder dumps (`flight_*.json`, the `telemetry` key),
- `pmdfc_tpu_torch.tools.teledump` pulls / raw `MSG_STATS` replies
  (same shape),
- bare `Registry.snapshot()` documents.

Surfaces:

    python -m pmdfc_tpu_torch.tools.proftool dump.json --table
        The phase x program x shard device-time breakdown (ops,
        device_us, share of the shard axis), followed by the per-shard
        lane totals RECONCILED against the `mesh.shard{i}_ops` span
        counters — the cross-check that the profiler's proportional
        split and the plane's routed-op accounting agree — plus the
        windowed imbalance gauge and any captured `cost.*` roofline
        context (FLOPs / bytes per program signature).

    python -m pmdfc_tpu_torch.tools.proftool dump.json --json
        The same aggregation as a machine-readable document.

    python -m pmdfc_tpu_torch.tools.proftool dump*.json --perfetto trace.json
        tracetool's Chrome-trace export with the profiler's `device`
        span records lifted onto their own per-program lanes
        (`tid = "device:<program>"`), so the blocked-fetch windows
        read as a device-occupancy track under the host span tree.

Aggregation is additive across input documents (counters and the
attribution table are cumulative), so feeding several dumps from ONE
process yields the latest totals via max-merge, while dumps from
DIFFERENT processes simply sum.
"""
from __future__ import annotations

import argparse
import json
import sys

from pmdfc_tpu_torch.tools import tracetool

_ROW_COLS = ("phase", "program", "shard", "ops", "device_us", "share")
_SHARD_COLS = ("shard", "device_us", "prof_ops", "mesh_ops", "match")


def load_docs(paths) -> list[dict]:
    """Each input file -> the embedded telemetry snapshot (flight dumps
    and stats replies nest it under `telemetry`; bare snapshots pass
    through). Files without one are kept (they may still carry ring
    `records` for --perfetto) but contribute no profile rows."""
    docs = []
    for path in paths:
        with open(path) as f:
            raw = json.load(f)
        snap = raw.get("telemetry", raw)
        docs.append({"path": path, "raw": raw, "snap": snap,
                     "profile": snap.get("profile")})
    return docs


def _merge(docs: list[dict]) -> dict:
    """Aggregate profile blocks + mesh counters across documents.

    Same-process dumps carry cumulative state, so identical row keys
    max-merge (the later dump supersedes); distinct processes occupy
    distinct keys only by luck, so cross-process feeds should pass one
    dump per process — the common workflows (one teledump, or a rolling
    window from one server) are both exact."""
    table: dict = {}
    shard_us: list[float] = []
    shard_ops: list[int] = []
    mesh_ops: dict[int, int] = {}
    cost: dict = {}
    launches = 0
    dropped = 0
    imbalance = 0.0
    n_docs = 0
    for d in docs:
        prof = d["profile"]
        if not prof:
            continue
        n_docs += 1
        launches = max(launches, int(prof.get("launches", 0)))
        dropped = max(dropped, int(prof.get("rows_dropped", 0)))
        imbalance = prof.get("imbalance", imbalance) or imbalance
        for r in prof.get("rows", ()):
            key = (r.get("phase", "?"), r.get("program", "?"),
                   int(r.get("shard", -1)))
            row = table.setdefault(key, [0, 0.0])
            row[0] = max(row[0], int(r.get("ops", 0)))
            row[1] = max(row[1], float(r.get("device_us", 0.0)))
        us = prof.get("shard_device_us", ())
        ops = prof.get("shard_ops", ())
        while len(shard_us) < len(us):
            shard_us.append(0.0)
            shard_ops.append(0)
        for i, v in enumerate(us):
            shard_us[i] = max(shard_us[i], float(v))
        for i, v in enumerate(ops):
            shard_ops[i] = max(shard_ops[i], int(v))
        for prog, c in prof.get("cost", {}).items():
            cost[prog] = dict(c)
        for name, v in d["snap"].get("counters", {}).items():
            if name.startswith("mesh.shard") and name.endswith("_ops"):
                try:
                    i = int(name[len("mesh.shard"):-len("_ops")])
                except ValueError:
                    continue
                mesh_ops[i] = max(mesh_ops.get(i, 0), int(v))
    return {"table": table, "shard_us": shard_us, "shard_ops": shard_ops,
            "mesh_ops": mesh_ops, "cost": cost, "launches": launches,
            "rows_dropped": dropped, "imbalance": imbalance,
            "docs_with_profile": n_docs}


def breakdown(agg: dict) -> dict:
    """The merged state as the report document (--json payload)."""
    total_us = sum(us for _ops, us in agg["table"].values()) or 1.0
    rows = [
        {"phase": ph, "program": pr, "shard": s, "ops": ops,
         "device_us": round(us, 1), "share": round(us / total_us, 4)}
        for (ph, pr, s), (ops, us) in sorted(
            agg["table"].items(), key=lambda kv: -kv[1][1])
    ]
    shards = []
    for i, us in enumerate(agg["shard_us"]):
        mesh = agg["mesh_ops"].get(i)
        prof = agg["shard_ops"][i]
        shards.append({
            "shard": i, "device_us": round(us, 1), "prof_ops": prof,
            "mesh_ops": mesh,
            # mesh counters cover EVERY routed launch since process
            # start; the profiler only attributes while attached AND
            # tracing — equality holds on the from-boot workflows the
            # acceptance drill runs, subset otherwise
            "match": (mesh is None and "n/a")
                     or ("yes" if prof == mesh else "no"),
        })
    return {
        "schema": "pmdfc-proftable-v1",
        "launches": agg["launches"],
        "rows_dropped": agg["rows_dropped"],
        "imbalance": agg["imbalance"],
        "rows": rows,
        "shards": shards,
        "cost": agg["cost"],
    }


def _render(rows: list[dict], cols: tuple) -> str:
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              if rows else len(c) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols),
             "  ".join("-" * widths[c] for c in cols)]
    for r in rows:
        lines.append("  ".join(
            str(r.get(c, "")).ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def render_report(rep: dict) -> str:
    out = [_render(rep["rows"], _ROW_COLS)]
    if rep["shards"]:
        out.append("")
        out.append("per-shard lanes (vs mesh.shard{i}_ops):")
        out.append(_render(rep["shards"], _SHARD_COLS))
    out.append("")
    out.append(f"launches={rep['launches']} "
               f"rows_dropped={rep['rows_dropped']} "
               f"imbalance={rep['imbalance']}")
    if rep["cost"]:
        out.append("")
        out.append("static cost (lowered.cost_analysis):")
        out.append(_render(
            [{"program": k, "flops": v.get("flops", 0.0),
              "bytes": v.get("bytes", 0.0)}
             for k, v in sorted(rep["cost"].items())],
            ("program", "flops", "bytes")))
    return "\n".join(out)


def device_lane_trace(paths) -> dict:
    """tracetool's Chrome-trace export with src=prof `device` spans
    re-homed onto per-program lanes. Host spans keep their conn tids;
    every profiler window lands on `device:<program>` so Perfetto draws
    a device-occupancy track."""
    records = tracetool.load_dumps(paths)
    doc = tracetool.chrome_trace(records)
    for ev in doc["traceEvents"]:
        if ev.get("cat") == "prof" and ev.get("name") == "device":
            prog = ev.get("args", {}).get("program", "?")
            ev["tid"] = f"device:{prog}"
            ev["name"] = prog
    return doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dumps", nargs="+",
                   help="flight dumps / teledump pulls / snapshots")
    p.add_argument("--table", action="store_true",
                   help="print the phase x program x shard breakdown")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the breakdown as JSON")
    p.add_argument("--perfetto", default=None, metavar="OUT",
                   help="write a Chrome-trace with device lanes merged")
    args = p.parse_args(argv)

    docs = load_docs(args.dumps)
    agg = _merge(docs)
    if args.perfetto:
        doc = device_lane_trace(args.dumps)
        with open(args.perfetto, "w") as f:
            json.dump(doc, f)
        n_dev = sum(1 for e in doc["traceEvents"]
                    if str(e.get("tid", "")).startswith("device:"))
        print(f"[proftool] {len(doc['traceEvents'])} events "
              f"({n_dev} device-lane) -> {args.perfetto}")
    if not agg["docs_with_profile"]:
        if args.perfetto:
            return 0
        print("[proftool] no `profile` block in the given documents "
              "(profiler not attached? PMDFC_PROF=off?)", file=sys.stderr)
        return 1
    rep = breakdown(agg)
    if args.as_json:
        print(json.dumps(rep, indent=2, sort_keys=True))
    elif args.table or not args.perfetto:
        print(render_report(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
