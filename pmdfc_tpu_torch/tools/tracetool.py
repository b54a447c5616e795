"""tracetool — merge flight dumps into a causal timeline.

Reads one or more flight-recorder dumps (`pmdfc-flight-v2` JSON, from
rung firings, the SLO watchdog, or `telemetry.dump_now()`) — typically
one from the CLIENT process and one from the SERVER — and reconstructs
each traced op's walk through the serving plane as a nested tree:

    group get
    └─ attempt (endpoint 0, hedge=False)
       └─ get (client wire span)
          └─ get (server op span)          <- linked by the 32-bit trace id
             ├─ queue_wait                 <- staging -> flush pickup
             └─ phase                      <- the op's slice of the flush
                └─ flush:get               <- linked by flush seq
                   ├─ shard_program s0     <- per-shard program windows
                   └─ shard_program s3

Clock domains: server spans carry the SERVER's monotonic_ns. The client
records a `clock` event per connection during the HOLA exchange (the
server stamps its HOLASI; the midpoint of the client's send/recv
brackets it, so the offset error is bounded by rtt/2). Server-side span
times are shifted by that offset onto the client timeline — per conn
when a matching clock record exists, the median offset otherwise, zero
(with a warning) when no clock record was captured at all.

Outputs:
- `--out trace.json`: Chrome-trace / Perfetto JSON (`chrome://tracing`,
  https://ui.perfetto.dev — "X" complete events, µs timestamps).
- `--table` (default when no --out): per-stage latency breakdown
  (count / p50 / p95 / max / total µs per stage).
- `--trace ID` restricts both to one traced op.

Importable: `load_dumps`, `build_tree` (returns `Node`s with resolved
children across the process boundary), `chrome_trace`, `breakdown` —
`tests/test_torch_operator_tools.py` holds this copy against the JAX
package's tool on the same dumps.

    python -m pmdfc_tpu_torch.tools.tracetool client.json server.json \
        [--table] [--out trace.json] [--trace ID]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

# ops that name one wire verb (client+server op spans cross-link on the
# trace id at THIS level; everything else links by parent id or flush)
_VERB_OPS = ("put", "get", "invalidate", "keepalive", "bfpull",
             "ins_ext", "get_ext", "stats")


class Node:
    """One completed span as a tree node (children resolved across the
    in-process parent ids AND the cross-process/cross-flush links)."""

    __slots__ = ("pid", "rec", "children", "linked")

    def __init__(self, pid: int, rec: dict):
        self.pid = pid
        self.rec = rec
        self.children: list = []    # via in-process parent ids
        self.linked: list = []      # via trace-id / flush-seq joins

    @property
    def sid(self):
        return self.rec.get("span", 0)

    @property
    def op(self):
        return self.rec.get("op", "?")

    def all_children(self) -> list:
        return self.children + self.linked

    def depth(self) -> int:
        """Longest nesting chain rooted here (this node counts as 1)."""
        kids = self.all_children()
        return 1 + (max((k.depth() for k in kids), default=0))


def load_dumps(paths) -> list:
    """[(pid, record)] across dumps; pid = dump index (span ids are
    process-local, so records never join by id across dumps)."""
    out = []
    for pid, path in enumerate(paths):
        with open(path) as f:
            doc = json.load(f)
        for rec in doc.get("records", []):
            out.append((pid, rec))
    return out


def clock_offsets(records) -> tuple[dict, int]:
    """({conn: offset_ns}, fallback offset). The fallback is the median
    captured offset (0 when none were captured)."""
    per_conn: dict = {}
    all_offsets = []
    for _pid, rec in records:
        if rec.get("kind") != "clock":
            continue
        off = int(rec.get("offset_ns", 0))
        per_conn[rec.get("conn")] = off
        all_offsets.append(off)
    fallback = int(statistics.median(all_offsets)) if all_offsets else 0
    return per_conn, fallback


def _adjusted(rec: dict, offsets: dict, fallback: int) -> dict:
    """Server-side spans shifted onto the client clock (peer_t - offset
    = local_t). Client/group spans pass through untouched."""
    if rec.get("src") != "server" or "t0_ns" not in rec:
        return rec
    off = offsets.get(rec.get("conn"), fallback)
    if not off:
        return rec
    rec = dict(rec)
    rec["t0_ns"] -= off
    rec["t1_ns"] -= off
    return rec


def build_tree(records) -> dict:
    """{(pid, span_id): Node} with children resolved three ways:

    1. in-process parent ids (same dump);
    2. trace-id joins: a server VERB span with trace T becomes a child
       of the client verb span carrying the same T (the wire hop);
    3. flush joins: the per-op `phase` span adopts the `flush:<ph>`
       span with the same flush seq (and through it the shard_program
       children) — the op's view into the shared fused flush.

    Roots are the nodes with no resolved parent (`roots` key holds
    them under the synthetic key (-1, 0))."""
    per_conn, fallback = clock_offsets(records)
    nodes: dict = {}
    by_trace_client: dict = {}
    by_flush: dict = {}
    for pid, rec in records:
        if rec.get("kind") != "span" or not rec.get("span"):
            continue
        rec = _adjusted(rec, per_conn, fallback)
        n = Node(pid, rec)
        nodes[(pid, n.sid)] = n
        if (rec.get("src") == "client" and rec.get("trace")
                and rec.get("op") in _VERB_OPS):
            # hedged ops share one trace across two wire verbs: prefer
            # the exact (trace, conn) pairing, keep a bare-trace fallback
            by_trace_client.setdefault((rec["trace"], rec.get("conn")), n)
            by_trace_client.setdefault(rec["trace"], n)
        if rec.get("op", "").startswith("flush:"):
            by_flush[(pid, rec.get("flush"), rec.get("phase"))] = n

    roots = []
    for (pid, _sid), n in nodes.items():
        rec = n.rec
        parent = nodes.get((pid, rec.get("parent", 0)))
        if parent is not None:
            parent.children.append(n)
            continue
        # cross-process wire hop: server verb span -> client verb span
        if (rec.get("src") == "server" and rec.get("trace")
                and rec.get("op") in _VERB_OPS):
            cl = (by_trace_client.get((rec["trace"], rec.get("conn")))
                  or by_trace_client.get(rec["trace"]))
            if cl is not None and cl is not n:
                cl.linked.append(n)
                continue
        roots.append(n)
    # flush joins: the op's phase slice adopts the shared flush span
    for n in nodes.values():
        if n.op == "phase" and n.rec.get("flush") is not None:
            for pid in {p for p, _ in nodes}:
                fl = by_flush.get((pid, n.rec["flush"], n.rec.get("phase")))
                if fl is not None:
                    n.linked.append(fl)
    nodes[(-1, 0)] = rootholder = Node(-1, {"op": "<roots>"})
    rootholder.children = roots
    return nodes


def trace_tree(nodes: dict, trace: int) -> list:
    """The root nodes whose subtree carries `trace` (group/client op
    spans for that traced verb)."""
    def carries(n: Node) -> bool:
        if n.rec.get("trace") == trace:
            return True
        return any(carries(k) for k in n.all_children())

    return [n for n in nodes[(-1, 0)].children if carries(n)]


def chrome_trace(records, trace: int | None = None) -> dict:
    """Chrome-trace JSON (Perfetto-compatible 'X' complete events)."""
    per_conn, fallback = clock_offsets(records)
    spans = []
    for pid, rec in records:
        if rec.get("kind") != "span" or "t0_ns" not in rec:
            continue
        if trace is not None and rec.get("trace") != trace:
            continue
        spans.append((pid, _adjusted(rec, per_conn, fallback)))
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_base = min(rec["t0_ns"] for _pid, rec in spans)
    events = []
    for pid, rec in spans:
        args = {k: v for k, v in rec.items()
                if k not in ("kind", "t", "t0_ns", "t1_ns", "dur_us",
                             "op", "src")}
        events.append({
            "name": rec.get("op", "?"),
            "cat": rec.get("src", "?"),
            "ph": "X",
            "ts": (rec["t0_ns"] - t_base) / 1e3,
            "dur": max((rec["t1_ns"] - rec["t0_ns"]) / 1e3, 0.001),
            "pid": pid,
            "tid": rec.get("conn", rec.get("src", 0)),
            "args": args,
        })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _stage_name(rec: dict) -> str:
    op = rec.get("op", "?")
    if op == "phase":
        # one op's view of the shared flush window — kept as its own
        # row so the shared flush:<ph> span's wall isn't multiplied by
        # the op count in the table
        return f"op_phase:{rec.get('phase', '?')}"
    if op.startswith("flush:"):
        return f"flush:{rec.get('phase', op.split(':', 1)[-1])}"
    if op == "shard_program":
        return f"shard:{rec.get('phase', '?')}"
    if op == "attempt":
        return "hedge" if rec.get("hedge") else "attempt"
    return f"{rec.get('src', '?')}:{op}"


def breakdown(records) -> list[dict]:
    """Per-stage latency rows: [{stage, count, p50_us, p95_us, max_us,
    total_us}] sorted by total, the tuning table the per-stage
    visibility argument (RDMAbox) asks for."""
    durs: dict[str, list] = {}
    for _pid, rec in records:
        if rec.get("kind") != "span" or rec.get("dur_us") is None:
            continue
        durs.setdefault(_stage_name(rec), []).append(rec["dur_us"])
    rows = []
    for stage, vs in durs.items():
        vs.sort()
        rows.append({
            "stage": stage,
            "count": len(vs),
            "p50_us": round(vs[len(vs) // 2], 1),
            "p95_us": round(vs[min(len(vs) - 1, int(0.95 * len(vs)))], 1),
            "max_us": round(vs[-1], 1),
            "total_us": round(sum(vs), 1),
        })
    rows.sort(key=lambda r: -r["total_us"])
    return rows


def render_table(rows: list[dict]) -> str:
    cols = ("stage", "count", "p50_us", "p95_us", "max_us", "total_us")
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) if rows
              else len(c) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols),
             "  ".join("-" * widths[c] for c in cols)]
    for r in rows:
        lines.append("  ".join(str(r[c]).ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dumps", nargs="+",
                   help="flight dump JSON files (client and/or server)")
    p.add_argument("--out", default=None,
                   help="write Chrome-trace/Perfetto JSON here")
    p.add_argument("--trace", type=lambda s: int(s, 0), default=None,
                   help="restrict to one 32-bit trace id")
    p.add_argument("--table", action="store_true",
                   help="print the per-stage latency breakdown")
    args = p.parse_args(argv)

    records = load_dumps(args.dumps)
    spans = [r for _p, r in records if r.get("kind") == "span"]
    if not spans:
        print("[tracetool] no span records in the given dumps "
              "(telemetry off, or ring rolled over?)", file=sys.stderr)
        return 1
    _per_conn, fallback = clock_offsets(records)
    if len(args.dumps) > 1 and not _per_conn:
        print("[tracetool] WARNING: multiple dumps but no clock records "
              "— server spans placed with zero offset", file=sys.stderr)

    if args.out:
        doc = chrome_trace(records, trace=args.trace)
        with open(args.out, "w") as f:
            json.dump(doc, f)
        print(f"[tracetool] {len(doc['traceEvents'])} events -> "
              f"{args.out} (open in chrome://tracing or ui.perfetto.dev)")
    if args.table or not args.out:
        sel = records
        if args.trace is not None:
            sel = [(p_, r) for p_, r in records
                   if r.get("trace") == args.trace]
        print(render_table(breakdown(sel)))
    if args.trace is not None:
        nodes = build_tree(records)
        roots = trace_tree(nodes, args.trace)
        depth = max((n.depth() for n in roots), default=0)
        print(f"[tracetool] trace {args.trace:#010x}: "
              f"{len(roots)} root(s), max nesting depth {depth}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
