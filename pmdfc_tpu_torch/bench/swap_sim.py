"""Frontswap pressure simulator — the juleeswap / fio 4K-randread analog
(twin of `pmdfc_tpu/bench/swap_sim.py`).

Reference: `client/juleeswap.c` registers frontswap ops so ANONYMOUS pages
swap to the remote store instead of disk; the recorded workload is fio 4K
randread under a memory cgroup (BASELINE.md row "juleeswap/fio 4K randread
IOPS"). Frontswap semantics differ from cleancache in one crucial way: a
STORED page is authoritative — on store failure the kernel falls back to
the swap device, and a load miss of a successfully stored page would be
data loss, not a legal miss (`juleeswap.c:15-38` returns the store result
so the kernel knows which case it is).

The simulator models an anonymous working set larger than "RAM": touches
fault pages in LRU order; evicted pages swap out through
`SwapClient.store` in **writethrough** mode (the `frontswap_writethrough`
discipline: the swap device gets a copy too) — the only safe pairing with
a clean-cache KV underneath, whose eviction may drop a stored page at any
later moment. Faults try `SwapClient.load` first (the fast path), then
the swap device. Every faulted page verifies content, so `verify_failures`
is a true data-loss detector on the load path. Reports end-to-end IOPS
(faults served per second) and the remote-hit fraction.

The KV behind the client is the port's, reached through
`bench/common.build_backend` on `--device` (default `cuda`). Rows carry
the JAX harness's keys; the exit code is 1 when `verify_failures` is not
0.

Run: `python -m pmdfc_tpu_torch.bench.swap_sim --ops 20000 --device cpu`
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import OrderedDict

import numpy as np

from pmdfc_tpu_torch.bench.paging_sim import page_content


class SwapSim:
    def __init__(self, swap_client, ram_pages: int, page_words: int,
                 swap_type: int = 0):
        self.client = swap_client
        self.ram_pages = ram_pages
        self.page_words = page_words
        self.swap_type = swap_type
        self.ram: OrderedDict[int, np.ndarray] = OrderedDict()
        self.disk: dict[int, np.ndarray] = {}  # the fallback swap device
        self.versions: dict[int, int] = {}
        self.stats = {
            "touches": 0, "ram_hits": 0, "faults": 0, "swap_hits": 0,
            "disk_hits": 0, "swap_outs": 0, "disk_writes": 0,
            "verify_failures": 0,
        }

    def _evict_if_full(self) -> None:
        # drain ALL overflow as one batched store: anonymous pages are
        # always dirty at swap-out, and the transport batches under the
        # per-page kernel hook exactly like the reference's 4-pages/verb
        # fused sends (writethrough: the device copy stays the truth)
        n_over = len(self.ram) - self.ram_pages
        if n_over <= 0:
            return
        offs, pages = [], []
        for _ in range(n_over):
            off, page = self.ram.popitem(last=False)
            offs.append(off)
            pages.append(page)
            self.disk[off] = page
        self.client.store_batch(
            self.swap_type, np.asarray(offs, np.uint32), np.stack(pages)
        )
        self.stats["swap_outs"] += n_over
        self.stats["disk_writes"] += n_over

    def warm(self, working_pages: int, batch: int = 4096) -> None:
        """Touch the whole set once, batched: fill RAM to cap and swap the
        remainder out in device-deep batches (steady state then has real
        swap traffic without paying one dispatch per warm page)."""
        for lo in range(0, working_pages, batch):
            hi = min(lo + batch, working_pages)
            for off in range(lo, hi):
                self.versions[off] = 1
                self.ram[off] = page_content(1, off, self.page_words, 1)
            self._evict_if_full()

    def touch(self, off: int, write: bool) -> None:
        self.stats["touches"] += 1
        if off in self.ram:
            self.stats["ram_hits"] += 1
            self.ram.move_to_end(off)
            page = self.ram[off]
        else:
            self.stats["faults"] += 1
            page = self.client.load(self.swap_type, off)
            if page is not None:
                self.stats["swap_hits"] += 1
            elif off in self.disk:
                self.stats["disk_hits"] += 1
                page = self.disk[off]
            else:
                page = self._expected(off)  # genuinely never touched
            # swap-in frees the slot (frontswap invalidate_page); both
            # copies die together so a stale version can never serve
            self.client.invalidate(self.swap_type, off)
            self.disk.pop(off, None)
            self.ram[off] = page
            self._evict_if_full()
        if not np.array_equal(page, self._expected(off)):
            self.stats["verify_failures"] += 1
        if write:
            v = self.versions.get(off, 0) + 1
            self.versions[off] = v
            self.ram[off] = page_content(1, off, self.page_words, v)
            self.ram.move_to_end(off)

    def _expected(self, off: int) -> np.ndarray:
        return page_content(1, off, self.page_words,
                            self.versions.get(off, 0))

    def touch_batch(self, offs: np.ndarray, write_mask: np.ndarray) -> None:
        """Service `iodepth` outstanding touches at once — the fio async
        engine model (the recorded reference run is libaio iodepth=16,
        `client/fio_test/out:1-8`): all missing pages fault as ONE batched
        load, invalidations and swap-outs batch the same way. Duplicate
        offsets in the window count as RAM hits after their first service
        (they would be resident by completion).
        """
        self.stats["touches"] += len(offs)
        uniq = np.unique(np.asarray(offs))
        dup_hits = len(offs) - len(uniq)
        in_ram = np.array([o in self.ram for o in uniq])
        for o in (int(x) for x in uniq[in_ram]):
            # RAM hits verify too, same as touch(): the batched path must
            # not narrow the data-loss detector the per-touch path carries
            if not np.array_equal(self.ram[o], self._expected(o)):
                self.stats["verify_failures"] += 1
            self.ram.move_to_end(o)
        self.stats["ram_hits"] += int(in_ram.sum()) + dup_hits
        missing = uniq[~in_ram]
        if len(missing):
            self.stats["faults"] += len(missing)
            pages, found = self.client.load_batch(self.swap_type, missing)
            self.client.invalidate_batch(self.swap_type, missing)
            for i, off in enumerate(int(o) for o in missing):
                if found[i]:
                    self.stats["swap_hits"] += 1
                    page = pages[i]
                elif off in self.disk:
                    self.stats["disk_hits"] += 1
                    page = self.disk[off]
                else:
                    page = self._expected(off)
                self.disk.pop(off, None)
                self.ram[off] = page
                if not np.array_equal(page, self._expected(off)):
                    self.stats["verify_failures"] += 1
            self._evict_if_full()
        woffs = np.asarray(offs)[np.asarray(write_mask, bool)]
        for off in (int(o) for o in woffs):
            v = self.versions.get(off, 0) + 1
            self.versions[off] = v
            self.ram[off] = page_content(1, off, self.page_words, v)
            self.ram.move_to_end(off)
        # a write can re-insert a page the fault service just evicted;
        # RAM must never end a window above its cgroup-model cap
        self._evict_if_full()


def run(sim: SwapSim, ops: int, working_pages: int, write_frac: float,
        seed: int = 0, iodepth: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    # warm: touch the whole set once so steady state has real swap traffic
    sim.warm(working_pages)
    for k in sim.stats:
        sim.stats[k] = 0
    t0 = time.perf_counter()
    if iodepth <= 1:
        for _ in range(ops):
            off = int(rng.integers(working_pages))
            sim.touch(off, write=rng.random() < write_frac)
    else:
        for _ in range(ops // iodepth):
            offs = rng.integers(working_pages, size=iodepth)
            sim.touch_batch(offs, rng.random(iodepth) < write_frac)
        ops = (ops // iodepth) * iodepth
    dt = time.perf_counter() - t0
    out = dict(sim.stats)
    out.update(
        metric="swap_4k_randread",
        ops=ops,
        secs=round(dt, 3),
        iops=round(ops / dt, 1),
        fault_iops=round(out["faults"] / dt, 1),
        swap_hit_frac=round(
            out["swap_hits"] / max(1, out["faults"]), 3
        ),
    )
    return out


def run_jobs(make_sim, n_jobs: int, ops: int, working_pages: int,
             write_frac: float, seed: int = 0, iodepth: int = 1) -> dict:
    """fio-style parallel jobs (the recorded reference run used 8,
    `client/fio_test/out:1-8`): each job owns its own swap area
    (swap_type = job id) and working set, all sharing ONE backend/KV —
    concurrent faults coalesce in the serving path the way concurrent
    fio jobs share the one remote store."""
    import threading

    sims = [make_sim(j) for j in range(n_jobs)]
    per = working_pages // n_jobs
    for sim in sims:
        sim.warm(per)
        for k in sim.stats:
            sim.stats[k] = 0
    errs: list[BaseException] = []

    def job(j):
        try:
            rng = np.random.default_rng(seed + j)
            sim = sims[j]
            if iodepth <= 1:
                for _ in range(ops // n_jobs):
                    off = int(rng.integers(per))
                    sim.touch(off, write=rng.random() < write_frac)
            else:
                for _ in range(ops // n_jobs // iodepth):
                    offs = rng.integers(per, size=iodepth)
                    sim.touch_batch(offs, rng.random(iodepth) < write_frac)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=job, args=(j,))
               for j in range(n_jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errs:
        raise errs[0]
    out = {k: sum(s.stats[k] for s in sims) for k in sims[0].stats}
    done = (n_jobs * (ops // n_jobs) if iodepth <= 1
            else n_jobs * (ops // n_jobs // iodepth) * iodepth)
    out.update(
        metric="swap_4k_randread",
        jobs=n_jobs,
        iodepth=iodepth,
        ops=done,
        secs=round(dt, 3),
        iops=round(done / dt, 1),
        fault_iops=round(out["faults"] / dt, 1),
        swap_hit_frac=round(out["swap_hits"] / max(1, out["faults"]), 3),
    )
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ops", type=int, default=20000)
    p.add_argument("--working-pages", type=int, default=2048)
    p.add_argument("--ram-pages", type=int, default=512)
    p.add_argument("--page-words", type=int, default=1024)
    p.add_argument("--write-frac", type=float, default=0.0,
                   help="0.0 = pure randread (the fio job)")
    p.add_argument("--backend", default="direct",
                   choices=("direct", "local", "engine"))
    p.add_argument("--capacity", type=int, default=1 << 15)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--jobs", type=int, default=1,
                   help="parallel fio-style jobs (ref run used 8)")
    p.add_argument("--iodepth", type=int, default=1,
                   help="outstanding touches serviced per batch (the "
                        "recorded ref run is libaio iodepth=16)")
    p.add_argument("--history", default=None,
                   help="append the result row (+timestamp/backend) to "
                        "this jsonl evidence log")
    args = p.parse_args(argv)

    from pmdfc_tpu_torch.bench.common import build_backend
    from pmdfc_tpu_torch.client.cleancache import SwapClient

    backend, closer = build_backend(args.backend, args.page_words,
                                    args.capacity, device=args.device)
    client = SwapClient(backend)
    if args.jobs > 1:
        ebs = []
        if args.backend == "engine":
            # EngineBackend stages through a fixed per-INSTANCE arena
            # slice; concurrent jobs must each own one (the per-client
            # staging discipline, `server/rdma_svr.cpp:873-886`) or they
            # corrupt each other's pages mid-flight. The default probe
            # backend's slice is returned first so the job slices fit.
            from pmdfc_tpu_torch.client import EngineBackend

            server = backend.server
            backend.close()
            ebs = [EngineBackend(server, queue=j % 8,
                                 timeout_us=120_000_000)
                   for j in range(args.jobs)]
            clients = [SwapClient(eb) for eb in ebs]
            make = lambda j: SwapSim(clients[j],
                                     args.ram_pages // args.jobs,
                                     args.page_words, swap_type=j)
        else:
            make = lambda j: SwapSim(client, args.ram_pages // args.jobs,
                                     args.page_words, swap_type=j)
        try:
            out = run_jobs(
                make, args.jobs, args.ops, args.working_pages,
                args.write_frac, iodepth=args.iodepth,
            )
        finally:
            for eb in ebs:
                eb.close()
    else:
        sim = SwapSim(client, args.ram_pages, args.page_words)
        out = run(sim, args.ops, args.working_pages, args.write_frac,
                  iodepth=args.iodepth)
    closer()
    from pmdfc_tpu_torch.bench.common import stamp_live_device

    stamp_live_device(out, args.backend, args.device)
    out["backend"] = args.backend
    out["working_pages"] = args.working_pages
    out["ram_pages"] = args.ram_pages
    out["mbs_4k"] = round(out["iops"] * 4096 / 1e6, 1)
    from pmdfc_tpu_torch.bench.common import append_history

    append_history(args.history, out)
    print(json.dumps(out), file=sys.stdout)
    if args.history and out["device"] != "cuda":
        # --history is an on-card evidence request: a run off the card
        # exits 3 (the guard above already refused the row)
        return 3
    return 1 if out["verify_failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
