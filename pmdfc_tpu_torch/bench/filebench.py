"""Filebench personalities over the paging simulator (twin of
`pmdfc_tpu/bench/filebench.py`).

Reference: `client/filebench/*.f` runs filebench personalities inside a
memory-limited cgroup as macro pressure workloads (`run_cgroup.sh`):

- `fileserver.f` — 10 k files, gamma-distributed sizes (mean 128 KB,
  gamma 1.5), per-loop create→write-whole, open→append (~16 KB),
  open→read-whole, delete, stat.
- `mywebserver.f` / `dgwebserver.f` — a readonly fileset (1 k × mean 16 KB /
  80 k × mean 160 KB), per-loop TEN whole-file reads + one ~16 KB append to
  a shared log file.
- `randomread.f` — one large file, 8 KB random reads, optional working-set
  restriction.

The flowop vocabulary maps onto the page-cache simulator (`paging_sim.py`):
whole-file read = sequential page reads; append = writes past EOF; delete =
`PagingSim.trim` (the cleancache invalidate-inode path); the memory cgroup =
the bounded RAM cache. File sizes use the same gamma(mean, 1.5) shape.
Every read self-verifies content, so a personality run is also a
correctness drill for the whole client⇄server stack under churn.

The KV is the port's, through `bench/common.build_backend` on `--device`
(default `cuda`); the exit code is 1 when a read failed its content
check.

Run: `python -m pmdfc_tpu_torch.bench.filebench --personality fileserver ...`
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

PERSONALITIES = ("fileserver", "webserver", "dgwebserver", "randomread")


class Fileset:
    """file_id -> size in pages, gamma-distributed like the .f cvar."""

    def __init__(self, rng: np.random.Generator, nfiles: int,
                 mean_pages: float, first_id: int = 1):
        self.rng = rng
        self.sizes: dict[int, int] = {}
        self._next_id = first_id
        for _ in range(nfiles):
            self.create(mean_pages)
        self.mean_pages = mean_pages

    def _sample_pages(self, mean_pages: float) -> int:
        # gamma with shape 1.5, mean `mean_pages` (filebench cvar-gamma)
        return max(1, int(round(self.rng.gamma(1.5, mean_pages / 1.5))))

    def create(self, mean_pages: float | None = None) -> tuple[int, int]:
        fid = self._next_id
        self._next_id += 1
        size = self._sample_pages(mean_pages or self.mean_pages)
        self.sizes[fid] = size
        return fid, size

    def pick(self) -> int:
        ids = list(self.sizes)
        return ids[int(self.rng.integers(len(ids)))]


def _read_whole(sim, fid: int, size: int) -> int:
    for i in range(size):
        sim.read(fid, i)
    return size


def _write_whole(sim, fid: int, size: int) -> int:
    for i in range(size):
        sim.write(fid, i)
    return size


def _append(sim, fs: Fileset, fid: int, pages: int) -> int:
    base = fs.sizes[fid]
    for i in range(base, base + pages):
        sim.write(fid, i)
    fs.sizes[fid] = base + pages
    return pages


def run_personality(sim, personality: str, loops: int, *,
                    nfiles: int = 64, mean_pages: int = 32,
                    append_pages: int = 4, reads_per_loop: int = 10,
                    working_set: float = 0.0, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    pages_read = pages_written = files_created = files_deleted = 0
    t0 = time.perf_counter()

    if personality in ("webserver", "dgwebserver"):
        # dgwebserver is the same flow over a bigger, colder fileset
        if personality == "dgwebserver":
            nfiles, mean_pages = nfiles * 4, mean_pages * 2
        fs = Fileset(rng, nfiles, mean_pages, first_id=2)
        log_fid, log_size = 1, 1
        fs.sizes[log_fid] = log_size
        for fid, size in fs.sizes.items():
            pages_written += _write_whole(sim, fid, size)  # prealloc
        for _ in range(loops):
            for _ in range(reads_per_loop):
                fid = fs.pick()
                pages_read += _read_whole(sim, fid, fs.sizes[fid])
            pages_written += _append(sim, fs, log_fid, append_pages)
    elif personality == "fileserver":
        fs = Fileset(rng, nfiles, mean_pages)
        for fid, size in fs.sizes.items():
            pages_written += _write_whole(sim, fid, size)  # prealloc=80
        for _ in range(loops):
            fid, size = fs.create()
            files_created += 1
            pages_written += _write_whole(sim, fid, size)
            pages_written += _append(sim, fs, fs.pick(), append_pages)
            rf = fs.pick()
            pages_read += _read_whole(sim, rf, fs.sizes[rf])
            victim = fs.pick()
            sim.trim(victim, range(fs.sizes.pop(victim)))
            files_deleted += 1
    elif personality == "randomread":
        file_pages = nfiles * mean_pages  # one large file
        fid = 1
        for i in range(file_pages):
            sim.write(fid, i)
        span = (max(1, int(file_pages * working_set))
                if working_set > 0 else file_pages)
        for _ in range(loops):
            sim.read(fid, int(rng.integers(span)))
            pages_read += 1
    else:
        raise ValueError(f"unknown personality {personality}")

    sim.flush_evictions()
    dt = time.perf_counter() - t0
    out = dict(sim.stats)
    out.update(
        personality=personality, loops=loops, secs=round(dt, 3),
        pages_read=pages_read, pages_written=pages_written,
        files_created=files_created, files_deleted=files_deleted,
        read_mib_per_sec=round(
            pages_read * sim.page_words * 4 / dt / 2**20, 2
        ),
    )
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--personality", default="fileserver",
                   choices=PERSONALITIES)
    p.add_argument("--loops", type=int, default=50)
    p.add_argument("--nfiles", type=int, default=64)
    p.add_argument("--mean-pages", type=int, default=32)
    p.add_argument("--ram-pages", type=int, default=1024)
    p.add_argument("--page-words", type=int, default=1024)
    p.add_argument("--working-set", type=float, default=0.0)
    p.add_argument("--backend", default="direct",
                   choices=("direct", "local", "engine"))
    p.add_argument("--capacity", type=int, default=1 << 15)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = p.parse_args(argv)

    from pmdfc_tpu_torch.bench.common import build_backend
    from pmdfc_tpu_torch.bench.paging_sim import PagingSim
    from pmdfc_tpu_torch.client import CleanCacheClient

    backend, closer = build_backend(args.backend, args.page_words,
                                    args.capacity, device=args.device)
    client = CleanCacheClient(backend)
    sim = PagingSim(client, args.ram_pages, args.page_words)
    out = run_personality(
        sim, args.personality, args.loops, nfiles=args.nfiles,
        mean_pages=args.mean_pages, working_set=args.working_set,
    )
    out["client"] = client.stats()
    closer()
    from pmdfc_tpu_torch.bench.common import stamp_live_device

    stamp_live_device(out, args.backend, args.device)
    print(json.dumps(out), file=sys.stdout)
    return 1 if out["verify_failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
