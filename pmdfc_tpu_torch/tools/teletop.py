"""teletop — "top for the fleet": a curses-free live console over MSG_STATS
(twin of `tools/teletop.py`, over the port's `TcpBackend`).

Fans out to N serving endpoints (a `ReplicaGroup`'s endpoint list, or any
`host:port` set), pulls each server's `pmdfc-telemetry-v2` snapshot over
the existing op channel (`tools/teledump.py`'s verb — no second port, no
agent), and renders per-server / per-shard:

- op RATES from the server-side windowed series (`runtime/timeseries.py`
  — a single `--once` poll still yields rates, no second sample needed),
- p95/p99 of the GET flush phase (per-shard `phase_get_us_s{i}` families
  when the mesh plane is up),
- hit-rate and the MISS-CAUSE breakdown (`miss_cold/evicted/parked/
  stale/digest/routed` — the taxonomy whose sums reconcile with `misses`
  on every surface),
- working-set estimate vs table capacity and keyspace heat skew
  (`runtime/workload.py` sketches),
- shard balance (max/mean routed gets across the shard_report),
- the tiered store's placement counters, with the TinyLFU admission
  block (denied/override rates, sketch age, live threshold) when the
  gate is on,
- the GET kernel-path indicator (fused vs composed GET, from the
  `serving.fused_get` gauge) and — when a profiler is attached
  (v3 snapshots) — the DEVICE-TIME lanes: per-shard blocked-fetch
  p95s and the windowed shard-imbalance gauge.

Plain ANSI repaint, poll-based (`--interval`), and a `--once --json`
mode that emits one machine-readable document for scripts — the form
`tools/check_teledump.py`-style gates consume.

    python -m pmdfc_tpu_torch.tools.teletop HOST:PORT [HOST:PORT ...]
    python -m pmdfc_tpu_torch.tools.teletop HOST:PORT --once --json

A port server publishes `serving.fused_get` = 1 where its GETs take the
fused route (the CUDA kernel on the card, its plain version on the
CPU), else 0, and its rows read
`kernel: "pallas_fused"` as a JAX server's do: the label names the route,
and both tools give one document the same rows.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor

_SHARD_HIST = re.compile(r"\.phase_get_us_s(\d+)$")
# the profiler's per-shard device-time lanes (`runtime/profiler.py`
# hist family on the shared `prof` scope — present IFF a profiler is
# attached, the v3 teledump pin)
_PROF_SHARD_HIST = re.compile(r"^prof\.device_us_s(\d+)$")
# per-tenant QoS lanes (`runtime/qos.py` scope families): the lane
# counters and the declared-policy gauges share one `.qos.t<tid>.`
# namespace under the server's stats prefix
_QOS_CTR = re.compile(
    r"\.qos\.t(\d+)\.(ops|staged|shed_edge|shed_ladder"
    r"|shed_gets|shed_puts)$")
_QOS_GAUGE = re.compile(r"\.qos\.t(\d+)\.(weight|rate|priority)$")


def pull(endpoint: str, page_words: int, timeout_s: float) -> dict:
    """One MSG_STATS snapshot from `host:port` ({"error": ...} on any
    transport failure — a dead server must not kill the console)."""
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    host, port = endpoint.rsplit(":", 1)
    try:
        with TcpBackend(host, int(port), page_words=page_words,
                        keepalive_s=None, op_timeout_s=timeout_s) as be:
            return be.server_stats()
    except Exception as e:  # noqa: BLE001 — console, not serving path
        return {"error": f"{type(e).__name__}: {e}"}


def _series_rate(doc: dict, suffix: str) -> float | None:
    """Per-second rate of every counter ending `suffix`, from the last
    closed series window (None when the server ships no series)."""
    windows = ((doc.get("telemetry") or {}).get("series")
               or {}).get("windows") or []
    if not windows:
        return None
    w = windows[-1]
    dt = w.get("dt_s") or 0
    if dt <= 0:
        return None
    total = sum(v for k, v in (w.get("counters") or {}).items()
                if k.endswith(suffix))
    return total / dt


def _hist(doc: dict, suffix: str) -> dict | None:
    """The busiest histogram whose full name ends `suffix`."""
    hists = (doc.get("telemetry") or {}).get("histograms") or {}
    best = None
    for name, h in hists.items():
        if name.endswith(suffix):
            if best is None or h.get("count", 0) > best.get("count", 0):
                best = h
    return best


def miss_causes(stats: dict) -> dict:
    from pmdfc_tpu_torch.kv import MISS_CAUSE_NAMES

    return {k: int(stats.get(k, 0)) for k in MISS_CAUSE_NAMES}


def summarize(endpoint: str, doc: dict) -> dict:
    """One server's console row from its MSG_STATS document."""
    if "error" in doc:
        return {"endpoint": endpoint, "ok": False, "error": doc["error"]}
    gets = int(doc.get("gets", 0))
    hits = int(doc.get("hits", 0))
    tele_snap = doc.get("telemetry") or {}
    get_hist = _hist(doc, ".phase_get_us")
    wl = doc.get("workload") or {}
    win = wl.get("window") or {}
    row = {
        "endpoint": endpoint,
        "ok": True,
        "gets": gets,
        "hits": hits,
        "misses": int(doc.get("misses", 0)),
        "hit_rate": round(hits / gets, 4) if gets else None,
        "ops_rate": _series_rate(doc, ".ops"),
        "get_rate": _series_rate(doc, ".coalesced_ops"),
        "p95_us": get_hist.get("p95") if get_hist else None,
        "p99_us": get_hist.get("p99") if get_hist else None,
        "miss_causes": miss_causes(doc),
        "capacity": doc.get("capacity"),
        "working_set": wl.get("working_set"),
        "window_working_set": win.get("working_set"),
        "heat_skew": (wl.get("heat") or {}).get("skew"),
        "telemetry_schema": tele_snap.get("schema"),
    }
    # kernel-path indicator: which GET program this server actually
    # runs (`ops/fused.py resolve()` publishes its construction-time
    # decision as the serving.fused_get gauge; absent = pre-gauge
    # server, unknown)
    fg = (tele_snap.get("gauges") or {}).get("serving.fused_get")
    row["kernel"] = (None if fg is None
                     else ("pallas_fused" if fg else "xla_composed"))
    # device-time lanes (profiler attached ⇒ v3 snapshot): per-shard
    # blocked-fetch p95s + the windowed imbalance gauge — the on-chip
    # complement to the host-side phase histograms above
    prof_p95 = {}
    for name, h in (tele_snap.get("histograms") or {}).items():
        m = _PROF_SHARD_HIST.match(name)
        if m:
            prof_p95[int(m.group(1))] = h.get("p95")
    if prof_p95 or (tele_snap.get("profile") is not None):
        row["device"] = {
            "imbalance": (tele_snap.get("gauges") or {}).get(
                "prof.shard_imbalance"),
            "shard_p95_us": [prof_p95.get(i)
                             for i in range(max(prof_p95, default=-1)
                                            + 1)],
            "launches": (tele_snap.get("profile") or {}).get("launches"),
        }
    # one-sided fast lane: share of served reads that bypassed the
    # dispatch path entirely (reads land in the net scope counters, not
    # the KV stats vector — zero device work by construction)
    ctr = tele_snap.get("counters") or {}
    fp_hits = sum(v for k, v in ctr.items()
                  if k.endswith(".fastpath_hits"))
    fp_stale = sum(v for k, v in ctr.items()
                   if k.endswith(".fastpath_stale"))
    row["fastpath"] = {
        # reads are DERIVED (hits + stale): the server stores only the
        # two exclusive lanes, so the sum can never drift mid-pull
        "reads": int(fp_hits + fp_stale), "hits": int(fp_hits),
        "stale": int(fp_stale),
        # fast-lane hit share of ALL served read lanes (fast + verb)
        "share": (round(fp_hits / (fp_hits + gets), 4)
                  if fp_hits + gets else None),
    }
    # tiered store: hot/cold placement counters, and the TinyLFU
    # admission block when the gate is on (denied/override RATES are
    # normalized against the decisions that could have gone the other
    # way — denied vs granted promotions, overrides vs ghost
    # readmissions — so a long-lived server's rates stay readable)
    if "hot_hits" in doc:
        tier = {k: int(doc.get(k, 0))
                for k in ("hot_hits", "cold_hits", "promotions",
                          "demotions", "ghost_readmits")}
        if "admit_denied" in doc:
            denied = int(doc.get("admit_denied", 0))
            granted = int(doc.get("promotions", 0))
            override = int(doc.get("admit_ghost_override", 0))
            readmits = int(doc.get("ghost_readmits", 0))
            tier["admit"] = {
                "denied": denied,
                "victim_kept": int(doc.get("admit_victim_kept", 0)),
                "ghost_override": override,
                "age_epochs": int(doc.get("admit_age_epochs", 0)),
                "threshold": int(doc.get("admit_threshold", 0)),
                "denied_rate": (round(denied / (denied + granted), 4)
                                if denied + granted else None),
                "override_rate": (round(override / readmits, 4)
                                  if readmits else None),
            }
        row["tier"] = tier
    # elastic membership: the last announced ring epoch (gauge) and how
    # many of this server's arrived pages were migration handoffs — a
    # transition mid-flight shows here before the hit-rate dip does
    gg = tele_snap.get("gauges") or {}
    row["ring"] = {
        "epoch": next((int(v) for k, v in gg.items()
                       if k.endswith(".ring_epoch") and v), None),
        "handoff_pages": int(sum(v for k, v in ctr.items()
                                 if k.endswith(".handoff_pages"))),
        "migration_lag": next((int(v) for k, v in gg.items()
                               if k.startswith("migration")
                               and k.endswith(".lag")), None),
    }
    # closed-loop controller (`runtime/autotune.py`): the live knob
    # vector + decision/revert counters, present only when a controller
    # is enabled in the serving process (the scope-iff-enabled pin)
    knobs = {k.split(".knob_", 1)[1]: v for k, v in gg.items()
             if ".knob_" in k and not k.endswith(("_lo", "_hi"))}
    if knobs:
        row["ctl"] = {
            "knobs": knobs,
            "decisions": int(sum(v for k, v in ctr.items()
                                 if k.endswith(".decisions"))),
            "reverts": int(sum(v for k, v in ctr.items()
                               if k.endswith(".reverts"))),
            "frozen": next((int(v) for k, v in gg.items()
                            if k.endswith(".frozen")), 0),
        }
    # multi-tenant QoS plane (`runtime/qos.py`): per-tenant lane
    # counters + declared weight/rate/priority gauges, present only
    # when the plane is on (the scope-iff-enabled pin). Keys are
    # stringified tids so the --json form round-trips unchanged.
    qos: dict[int, dict] = {}
    for k, v in ctr.items():
        m = _QOS_CTR.search(k)
        if m:
            qos.setdefault(int(m.group(1)), {})[m.group(2)] = int(v)
    for k, v in gg.items():
        m = _QOS_GAUGE.search(k)
        if m:
            qos.setdefault(int(m.group(1)), {})[m.group(2)] = v
    if qos:
        row["qos"] = {str(t): qos[t] for t in sorted(qos)}
    # blast-radius containment (`runtime/failure.py` + net NACKs): the
    # server's nack/bisect/deadline lanes ride the net scope counters;
    # the quarantine tier (when on) ships its own report block with the
    # live quarantined-shard list — a tripped shard shows here before
    # its hit-rate dip does
    cont = {k: int(sum(v for c, v in ctr.items()
                       if c.endswith("." + k)))
            for k in ("nacks_sent", "poison_refused", "poison_ops",
                      "bisect_failures", "deadline_shed")}
    q = doc.get("quarantine")
    if q:
        qs = q.get("stats") or {}
        cont["quarantined"] = [int(s) for s in q.get("quarantined", [])]
        cont["trips"] = int(qs.get("trips", 0))
        cont["readmits"] = int(qs.get("readmits", 0))
    if q or any(cont.values()):
        row["containment"] = cont
    rep = doc.get("shard_report")
    if rep:
        shards = []
        p99 = {}
        for name, h in (tele_snap.get("histograms") or {}).items():
            m = _SHARD_HIST.search(name)
            if m:
                p99[int(m.group(1))] = h.get("p99")
        st = rep.get("stats", {})
        n = int(rep.get("n_shards", 0))
        dev = (row.get("device") or {}).get("shard_p95_us") or []
        for i in range(n):
            shards.append({
                "shard": i,
                "gets": int(st.get("gets", [0] * n)[i]),
                "hits": int(st.get("hits", [0] * n)[i]),
                "misses": int(st.get("misses", [0] * n)[i]),
                "miss_causes": {k: int(st.get(k, [0] * n)[i])
                                for k in row["miss_causes"]},
                "utilization": rep.get("utilization", [None] * n)[i],
                "p99_us": p99.get(i),
                "device_p95_us": dev[i] if i < len(dev) else None,
            })
        sg = [s["gets"] for s in shards]
        mean = sum(sg) / len(sg) if sg else 0
        row["shards"] = shards
        row["shard_balance"] = (round(max(sg) / mean, 3)
                                if mean else None)
    return row


def poll(endpoints: list, page_words: int, timeout_s: float) -> list:
    with ThreadPoolExecutor(max_workers=max(1, len(endpoints))) as ex:
        docs = list(ex.map(
            lambda ep: pull(ep, page_words, timeout_s), endpoints))
    return [summarize(ep, doc) for ep, doc in zip(endpoints, docs)]


def _fmt(v, unit: str = "", nd: int = 1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}{unit}"
    return f"{v}{unit}"


def render(rows: list) -> str:
    """The human console frame (plain text; the loop repaints it)."""
    out = [f"teletop — {len(rows)} server(s) @ "
           f"{time.strftime('%H:%M:%S')}"]
    hdr = (f"{'endpoint':<22} {'ops/s':>9} {'p95us':>8} {'p99us':>8} "
           f"{'hit%':>6} {'fast%':>6} {'wset':>8} {'cap':>8} {'bal':>5}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in rows:
        if not r.get("ok"):
            out.append(f"{r['endpoint']:<22} DOWN  {r.get('error', '')}")
            continue
        hr = r.get("hit_rate")
        fp = (r.get("fastpath") or {}).get("share")
        out.append(
            f"{r['endpoint']:<22} {_fmt(r.get('ops_rate')):>9} "
            f"{_fmt(r.get('p95_us'), nd=0):>8} "
            f"{_fmt(r.get('p99_us'), nd=0):>8} "
            f"{_fmt(hr * 100 if hr is not None else None):>6} "
            f"{_fmt(fp * 100 if fp is not None else None):>6} "
            f"{_fmt(r.get('working_set'), nd=0):>8} "
            f"{_fmt(r.get('capacity')):>8} "
            f"{_fmt(r.get('shard_balance'), nd=2):>5}")
        mc = r.get("miss_causes") or {}
        live = {k.replace('miss_', ''): v for k, v in mc.items() if v}
        kern = {"pallas_fused": " kernel=fused",
                "xla_composed": " kernel=composed"}.get(
                    r.get("kernel"), "")
        out.append(f"    misses={r.get('misses')} causes={live or '{}'}"
                   f"{kern}")
        dev = r.get("device")
        if dev:
            lanes = " ".join(
                f"s{i}={_fmt(v, nd=0)}"
                for i, v in enumerate(dev.get("shard_p95_us") or []))
            out.append(
                f"    device: imbalance="
                f"{_fmt(dev.get('imbalance'), nd=2)}"
                f"{' p95us[' + lanes + ']' if lanes else ''}")
        tier = r.get("tier")
        if tier:
            line = (f"    tier: hot={tier['hot_hits']} "
                    f"cold={tier['cold_hits']} "
                    f"promo={tier['promotions']} "
                    f"demo={tier['demotions']}")
            adm = tier.get("admit")
            if adm:
                dr, orate = adm.get("denied_rate"), adm.get("override_rate")
                line += (f" | admit: thresh={adm['threshold']} "
                         f"denied={adm['denied']}"
                         f" ({_fmt(dr * 100 if dr is not None else None)}%)"
                         f" override={adm['ghost_override']}"
                         f" ({_fmt(orate * 100 if orate is not None else None)}%)"
                         f" age={adm['age_epochs']}")
            out.append(line)
        ctl = r.get("ctl")
        if ctl:
            ks = " ".join(f"{k}={_fmt(v, nd=0)}"
                          for k, v in sorted(ctl["knobs"].items()))
            out.append(
                f"    ctl: {ks} decisions={ctl['decisions']} "
                f"reverts={ctl['reverts']}"
                f"{' FROZEN' if ctl.get('frozen') else ''}")
        for t, d in (r.get("qos") or {}).items():
            shed = d.get("shed_edge", 0) + d.get("shed_ladder", 0)
            out.append(
                f"    qos t{t}: w={_fmt(d.get('weight'), nd=0)} "
                f"prio={_fmt(d.get('priority'), nd=0)} "
                f"rate={_fmt(d.get('rate'), nd=0)} "
                f"ops={d.get('ops', 0)} staged={d.get('staged', 0)} "
                f"shed={shed}")
        cont = r.get("containment")
        if cont:
            line = (f"    containment: nacks={cont.get('nacks_sent', 0)} "
                    f"refused={cont.get('poison_refused', 0)} "
                    f"poison={cont.get('poison_ops', 0)} "
                    f"bisects={cont.get('bisect_failures', 0)} "
                    f"deadline_shed={cont.get('deadline_shed', 0)}")
            if "quarantined" in cont:
                line += (f" | quarantined={cont['quarantined'] or '[]'} "
                         f"trips={cont.get('trips', 0)} "
                         f"readmits={cont.get('readmits', 0)}")
            out.append(line)
        for s in r.get("shards") or []:
            dp = s.get("device_p95_us")
            out.append(
                f"    shard{s['shard']}: gets={s['gets']} "
                f"hits={s['hits']} misses={s['misses']} "
                f"p99={_fmt(s.get('p99_us'), nd=0)}us "
                f"util={_fmt(s.get('utilization'), nd=3)}"
                + (f" dev_p95={_fmt(dp, nd=0)}us"
                   if dp is not None else ""))
    return "\n".join(out)


def run_loop(endpoints: list, page_words: int, interval_s: float,
             timeout_s: float) -> int:
    try:
        while True:
            rows = poll(endpoints, page_words, timeout_s)
            sys.stdout.write("\x1b[H\x1b[2J" + render(rows) + "\n")
            sys.stdout.flush()
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("endpoints", nargs="*", metavar="HOST:PORT")
    p.add_argument("--interval", type=float, default=2.0,
                   help="poll/repaint period (loop mode)")
    p.add_argument("--once", action="store_true",
                   help="one poll, print, exit")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (with --once)")
    p.add_argument("--page-words", type=int, default=1024,
                   help="must match the servers (HOLA negotiation)")
    p.add_argument("--timeout-s", type=float, default=10.0)
    args = p.parse_args(argv)

    if not args.endpoints:
        p.error("need at least one HOST:PORT")
    if not args.once:
        return run_loop(args.endpoints, args.page_words, args.interval,
                        args.timeout_s)
    rows = poll(args.endpoints, args.page_words, args.timeout_s)
    if args.json:
        json.dump({"ts": time.time(), "servers": rows}, sys.stdout,
                  indent=1)
        sys.stdout.write("\n")
    else:
        print(render(rows))
    return 0 if all(r.get("ok") for r in rows) else 3


if __name__ == "__main__":
    raise SystemExit(main())
