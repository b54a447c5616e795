"""Multi-process ShardedKV benchmark (twin of
`pmdfc_tpu/bench/multihost_bench.py`).

The reference scales out by driving one RDMA server from N client VMs
(`script.sh:3-41`); this framework scales the SERVER across processes:
P OS processes x D devices each join one `torch.distributed` group
(`connect_multihost`), hold one global grid, and run the same a2a
dispatch the single-process path uses, its exchange on
`all_to_all_single`. This driver measures insert/get throughput THROUGH
that multi-process grid and reports per-shard balance.

`--device` (default `cuda`) is each process's device, named
`--devices-per-proc` times (several shards on one card); `--backend` is
`gloo` (collectives on host buffers; CUDA tensors stage through pinned
memory) or `nccl` (on the cards; NCCL refuses two ranks on one card).
Rows carry the JAX harness's keys (`metric` = `multihost_get_mops`,
`insert_mops`, `hits`, `procs`, `devices`, `shards`,
`shard_occupancy_*`) and the exchange's collectives, bytes and seconds.

Run: `python -m pmdfc_tpu_torch.bench.multihost_bench --procs 2 --n 131072`
(add `--device cpu` without a GPU).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time


def _free_port() -> int:
    # SO_REUSEADDR so the probe never trips over a TIME_WAIT remnant of a
    # previous drill; the cross-process TOCTOU between this probe and the
    # coordinator's actual bind is closed by `_connect_with_retry` below.
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _read_port_file(args, attempt: int, timeout_s: float = 30.0) -> int:
    """Non-coordinator workers follow the port the coordinator PUBLISHED
    (it may have moved down its retry ladder); two stable reads in a row
    guard against catching a mid-rewrite value."""
    if not args.port_file:
        return args.port
    deadline = time.monotonic() + timeout_s
    prev = None
    while time.monotonic() < deadline:
        try:
            with open(args.port_file) as f:
                content = f.read().strip()
        except OSError:
            content = ""
        if content and content == prev:
            return int(content)
        prev = content or None
        time.sleep(0.05 * (attempt + 1))
    raise RuntimeError("coordinator never published a port")


def _connect_with_retry(args, attempts: int = 4) -> int:
    """Join the group with a bounded bind-retry ladder: worker 0 re-probes
    a port AT BIND TIME on each retry and publishes the winning port via
    --port-file; the other workers follow the file and re-read it on
    their own bounded retries."""
    from pmdfc_tpu_torch.parallel.shard import (
        SharedDeviceError, connect_multihost, shutdown_multihost)

    last: Exception | None = None
    for attempt in range(attempts):
        if args.worker == 0:
            port = args.port if attempt == 0 else _free_port()
            if args.port_file:
                tmp = f"{args.port_file}.tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    f.write(str(port))
                os.replace(tmp, args.port_file)
        else:
            port = _read_port_file(args, attempt)
        try:
            return connect_multihost(
                f"localhost:{port}", args.procs, args.worker, timeout_s=120,
                backend=args.backend,
                devices=[args.device] * args.devices_per_proc)
        except SharedDeviceError:
            raise  # a refused layout, not a bind race
        except Exception as e:  # noqa: BLE001 — bind race / join timeout
            last = e
            print(f"[multihost w{args.worker}] join attempt {attempt} on "
                  f"port {port} failed: {e!r}", file=sys.stderr)
            shutdown_multihost()
    raise RuntimeError(
        f"could not join the coordinator after {attempts} attempts"
    ) from last


def worker(args) -> int:
    import numpy as np

    from pmdfc_tpu_torch.bench.common import stamp_live_device
    from pmdfc_tpu_torch.config import IndexConfig, IndexKind, KVConfig
    from pmdfc_tpu_torch.parallel.shard import (
        ShardedKV, make_mesh, shutdown_multihost)

    ndev = _connect_with_retry(args)
    try:
        cfg = KVConfig(
            index=IndexConfig(kind=IndexKind(args.index),
                              capacity=args.capacity),
            bloom=None, paged=False,
        )
        kv = ShardedKV(cfg, mesh=make_mesh(), dispatch="a2a")

        # distinct keys without materializing a permutation: an affine
        # bijection over u32 keeps them unique in ~n bytes
        lo = (np.arange(args.n, dtype=np.uint64) * np.uint64(2654435761)
              % np.uint64(1 << 32)).astype(np.uint32)
        keys = np.stack([lo >> 16, lo], axis=-1)
        vals = np.stack([lo ^ np.uint32(0xF00D), lo], axis=-1)

        # warm both paths (insert + lean get) out of the timed window
        w = keys[: args.batch]
        kv.insert(w, vals[: args.batch])
        kv.get(w)

        t0 = time.perf_counter()
        for i in range(0, args.n, args.batch):
            kv.insert(keys[i: i + args.batch], vals[i: i + args.batch])
        t_ins = time.perf_counter() - t0

        t0 = time.perf_counter()
        hits = 0
        wrong = 0
        for i in range(0, args.n, args.batch):
            got, found = kv.get(keys[i: i + args.batch])
            hits += int(found.sum())
            wrong += int((got[found] != vals[i: i + args.batch][found])
                         .any(-1).sum())
        t_get = time.perf_counter() - t0

        # shard_report runs collectives: EVERY process must call it, only
        # the print is rank 0's
        rep = kv.shard_report()
        xch = kv.exchange_report()
        if args.worker == 0:
            occ = rep["occupancy"]
            out = {
                "metric": "multihost_get_mops",
                "value": round(args.n / t_get / 1e6, 4),
                "unit": "Mops/s",
                "insert_mops": round(args.n / t_ins / 1e6, 4),
                "hits": hits,
                "wrong_values": wrong,
                "n": args.n,
                "batch": args.batch,
                "procs": args.procs,
                "devices": ndev,
                "shards": rep["n_shards"],
                "shard_occupancy_min": min(occ),
                "shard_occupancy_max": max(occ),
                "transport": f"torch.distributed ({args.backend}/localhost)",
                "backend": args.backend,
                "exchange_calls": xch["calls"],
                "exchange_bytes": xch["bytes"],
                "exchange_seconds": xch["seconds"],
            }
            stamp_live_device(out, "direct", args.device)
            print(json.dumps(out), flush=True)
    finally:
        shutdown_multihost()
    return 0 if hits == args.n and wrong == 0 else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--devices-per-proc", type=int, default=2)
    p.add_argument("--n", type=int, default=1 << 17)
    p.add_argument("--batch", type=int, default=1 << 14)
    p.add_argument("--capacity", type=int, default=1 << 19)
    p.add_argument("--index", default="linear")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--worker", type=int, default=None,
                   help="(internal) run as worker with this process id")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--port-file", default=None,
                   help="(internal) coordinator-published port path for "
                        "the bind-retry ladder")
    args = p.parse_args(argv)

    if args.worker is not None:
        return worker(args)

    port = args.port or _free_port()
    # the coordinator publishes its ACTUAL port here (it may abandon the
    # probed one if another process grabs it first)
    pf = tempfile.NamedTemporaryFile("w", suffix=".port", delete=False)
    pf.close()
    os.unlink(pf.name)  # workers poll for its (re)appearance
    port_file = pf.name

    # per-worker stderr to files (a PIPE would wedge a chatty worker once
    # the 64 KB buffer fills)
    errs = [tempfile.NamedTemporaryFile("w+", suffix=f".w{i}.err",
                                        delete=False)
            for i in range(args.procs)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "pmdfc_tpu_torch.bench.multihost_bench",
             "--worker", str(i), "--port", str(port),
             "--port-file", port_file,
             "--procs", str(args.procs),
             "--devices-per-proc", str(args.devices_per_proc),
             "--n", str(args.n), "--batch", str(args.batch),
             "--capacity", str(args.capacity), "--index", args.index,
             "--device", args.device, "--backend", args.backend],
            stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
            stderr=errs[i], text=True)
        for i in range(args.procs)
    ]

    def _err_tails() -> str:
        tails = []
        for i, f in enumerate(errs):
            try:
                f.flush()
                with open(f.name) as g:
                    txt = g.read()[-1500:]
            except OSError:
                txt = "<unreadable>"
            tails.append(f"--- worker {i} stderr tail ---\n{txt}")
        return "\n".join(tails)

    line = ""
    try:
        try:
            out, _ = procs[0].communicate(timeout=args.timeout)
            for q in procs[1:]:
                q.wait(timeout=30)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            print(_err_tails(), file=sys.stderr)
            print(json.dumps({"error": "multihost bench timed out"}))
            return 1
        rcs = [q.returncode for q in procs]
        # the record is the last line that parses to the metric dict
        for ln in reversed(out.strip().splitlines() if out.strip() else []):
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) \
                    and rec.get("metric") == "multihost_get_mops":
                line = ln
                break
        ok = all(r == 0 for r in rcs) and bool(line)
        if not ok:
            print(_err_tails(), file=sys.stderr)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
        for f in errs:
            try:
                f.close()
                os.unlink(f.name)
            except OSError:
                pass
        try:
            os.unlink(port_file)
        except OSError:
            pass
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
