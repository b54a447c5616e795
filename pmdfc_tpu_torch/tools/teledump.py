"""teledump — pull a telemetry snapshot from a live server over the wire
(twin of `tools/teledump.py`, over the port's `TcpBackend`).

The `MSG_STATS` verb ships the serving backend's counter snapshot with
the process-wide telemetry registry riding under the `telemetry` key
(`runtime/net.py`); this CLI is the operator's one-shot pull: no second
port, no agent, just the op channel a monitoring client already speaks.
It imports neither JAX nor the JAX package, so it runs on a host that
has only the port.

    python -m pmdfc_tpu_torch.tools.teledump HOST PORT                 # JSON
    python -m pmdfc_tpu_torch.tools.teledump HOST PORT --format prom   # text
    python -m pmdfc_tpu_torch.tools.teledump HOST PORT --out snap.json
    python -m pmdfc_tpu_torch.tools.teledump --local   # this process

Schema: `python -m pmdfc_tpu_torch.tools.check_teledump` validates the
pulled document (the `pmdfc-telemetry-v2` contract and its v3 profile
block; v1 documents from older servers still parse).
"""

from __future__ import annotations

import argparse
import json
import sys


def pull(host: str, port: int, page_words: int,
         timeout_s: float = 10.0) -> dict:
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    with TcpBackend(host, port, page_words=page_words,
                    keepalive_s=None, op_timeout_s=timeout_s) as be:
        return be.server_stats()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("host", nargs="?", default="127.0.0.1")
    p.add_argument("port", nargs="?", type=int)
    p.add_argument("--page-words", type=int, default=1024,
                   help="must match the server (HOLA negotiation)")
    p.add_argument("--format", choices=("json", "prom"), default="json")
    p.add_argument("--out", default=None, help="write the document here "
                   "instead of stdout (JSON regardless of --format)")
    p.add_argument("--local", action="store_true",
                   help="dump THIS process's registry (no wire pull)")
    p.add_argument("--timeout-s", type=float, default=10.0)
    args = p.parse_args(argv)

    from pmdfc_tpu_torch.runtime import telemetry

    if args.local:
        doc = {"telemetry": telemetry.snapshot()}
    else:
        if args.port is None:
            p.error("PORT is required unless --local")
        doc = pull(args.host, args.port, args.page_words, args.timeout_s)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"[teledump] wrote {args.out}", file=sys.stderr)
        return 0
    if args.format == "prom":
        snap = doc.get("telemetry")
        if snap is None:
            print("[teledump] server reported no telemetry section "
                  "(PMDFC_TELEMETRY=off on the server?)", file=sys.stderr)
            return 2
        sys.stdout.write(telemetry.render_snapshot(snap))
        return 0
    json.dump(doc, sys.stdout, indent=1)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
