"""check_teledump — validate a teledump document or a flight dump, or a
live server's document pulled over the port's wire.

    python -m pmdfc_tpu_torch.tools.check_teledump snap.json
    python -m pmdfc_tpu_torch.tools.check_teledump flight_get_00001.json
    python -m pmdfc_tpu_torch.tools.check_teledump --live HOST PORT

The schemas are the repo's `tools/check_teledump.py` (`check`,
`check_flight`: stdlib only, shared by both packages); this CLI adds
only the pull, over `pmdfc_tpu_torch.runtime.net.TcpBackend`, so it runs
where JAX and the JAX package are absent. Exit 0 = conformant.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _schemas():
    """The repo's `tools.check_teledump`, found beside this package."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if root not in sys.path:
        sys.path.insert(0, root)
    import tools.check_teledump as schemas

    return schemas


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path", nargs="?", help="teledump JSON file")
    p.add_argument("--live", nargs=2, metavar=("HOST", "PORT"),
                   help="pull from a live server instead of a file")
    p.add_argument("--page-words", type=int, default=1024)
    args = p.parse_args(argv)
    schemas = _schemas()

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
    errs = schemas.check_flight(doc) if is_flight else schemas.check(doc)
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
