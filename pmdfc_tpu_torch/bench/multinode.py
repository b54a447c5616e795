"""Multi-node orchestration — concurrent client processes vs one server
(twin of `pmdfc_tpu/bench/multinode.py`).

Reference: `script.sh:3-41` drives three libvirt VMs (zombie1-3) over ssh to
build, insmod, and run fio concurrently against one memory server, capturing
per-VM results as `out_zombie{1,2,3}`; `virsh.sh` resets them. There are no
VMs here, but the structure is preserved with REAL process isolation: one
server process hosting the KV behind the TCP messenger (`runtime/net.py`),
N client subprocesses each running the paging-pressure workload
(`bench/paging_sim.py`) through its own `TcpBackend` + `ReconnectingClient`,
results captured per client as `out_client{N}` JSON plus an aggregate line.

The server's KV is the port's, through `bench/common.build_backend` on
`--device` (default `cuda`); the children hold no KV. The exit code is 1
when a client failed or any read failed its content check.

Run:  python -m pmdfc_tpu_torch.bench.multinode --clients 3 --job rand_read \
          --ops 20000 --out-dir DIR
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def run_child(args) -> None:
    from pmdfc_tpu_torch.bench.paging_sim import PagingSim, run_job
    from pmdfc_tpu_torch.client.cleancache import CleanCacheClient
    from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    def factory():
        # --transport lockstep must pin BOTH halves of the wire: the
        # server's serialized loop AND non-pipelined clients (a windowed
        # client against a lockstep server is not the legacy baseline)
        return TcpBackend("127.0.0.1", args.port,
                          page_words=args.page_words,
                          pipeline=args.transport == "coalesced")

    be = ReconnectingClient(factory, page_words=args.page_words,
                            retry_delay_s=0.1)
    client = CleanCacheClient(be)
    sim = PagingSim(client, args.ram_pages, args.page_words,
                    put_batch=args.put_batch)
    # disjoint oid per client — each "VM" pages its own files
    out = run_job(sim, args.job, args.file_pages, args.ops,
                  oid=100 + args.child, seed=args.child)
    out["client_idx"] = args.child
    out["net"] = be.stats()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--clients", type=int, default=3)
    p.add_argument("--job", default="rand_read")
    p.add_argument("--file-pages", type=int, default=2048)
    p.add_argument("--ram-pages", type=int, default=512)
    p.add_argument("--ops", type=int, default=10000)
    p.add_argument("--page-words", type=int, default=1024)
    p.add_argument("--put-batch", type=int, default=64)
    p.add_argument("--capacity", type=int, default=1 << 16)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="server-side index device (the children hold no KV)")
    p.add_argument("--transport", default="coalesced",
                   choices=("coalesced", "lockstep"),
                   help="coalesced = cross-connection batch scheduler + "
                        "pipelined clients (the serving tier); lockstep = "
                        "the serialized legacy wire (PMDFC_NET_PIPE=off "
                        "forces it regardless)")
    p.add_argument("--out-dir", default=None,
                   help="write per-client out_client{N} files here")
    p.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.child is not None:
        run_child(args)
        return 0

    from pmdfc_tpu_torch.bench.common import build_backend
    from pmdfc_tpu_torch.config import NetConfig
    from pmdfc_tpu_torch.runtime.net import NetServer

    shared, closer = build_backend("direct", args.page_words, args.capacity,
                                   device=args.device)
    net = NetConfig() if args.transport == "coalesced" else None
    srv = NetServer(lambda: shared, bf_push_s=1.0, net=net).start()

    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "pmdfc_tpu_torch.bench.multinode",
             "--child", str(i), "--port", str(srv.port),
             "--job", args.job, "--file-pages", str(args.file_pages),
             "--ram-pages", str(args.ram_pages), "--ops", str(args.ops),
             "--page-words", str(args.page_words),
             "--put-batch", str(args.put_batch),
             "--transport", args.transport],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(args.clients)
    ]
    results, errors = [], []
    for i, proc in enumerate(procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append({"client": i, "rc": proc.returncode,
                           "stderr": err[-2000:]})
            continue
        line = out.strip().splitlines()[-1]
        res = json.loads(line)
        results.append(res)
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            with open(os.path.join(args.out_dir, f"out_client{i}"),
                      "w") as f:
                f.write(line + "\n")
    wall = time.perf_counter() - t0
    srv.stop()
    closer()

    agg = {
        "metric": "multinode_paging",
        "clients": args.clients,
        "job": args.job,
        "ok": len(results),
        "errors": errors,
        "wall_secs": round(wall, 3),
        "total_pages_per_sec": round(
            float(np.sum([r["pages_per_sec"] for r in results])), 1
        ) if results else 0.0,
        "total_mib_per_sec": round(
            float(np.sum([r["mib_per_sec"] for r in results])), 1
        ) if results else 0.0,
        "verify_failures": int(
            np.sum([r["verify_failures"] for r in results])
        ) if results else -1,
        "server": dict(srv.stats),  # Scope is a Mapping, not JSON-serializable
    }
    from pmdfc_tpu_torch.bench.common import stamp_live_device

    stamp_live_device(agg, "direct", args.device)
    print(json.dumps(agg))
    return 1 if errors or not results or agg["verify_failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
