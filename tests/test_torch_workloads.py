"""PyTorch port: the reference's workload harnesses against their JAX
twins (`pmdfc_tpu_torch/bench/` vs `pmdfc_tpu/bench/`).

Each harness runs next to its JAX twin with the same seed, at a tiny size,
on the CPU (the port's KV with `device="cpu"`, JAX on its CPU backend).
The two KVs agree bit for bit, so every counter the harnesses report must
be equal: the `gen_input` datasets and their files, test_kv's found count
and `failedSearch`, paging_sim's hits, disk reads and evictions per job
(the scan_mix arm's tier and admission counters too). Timing fields
(`secs`, rates, latencies) are exempt: they are host clocks of two
different programs. swap_sim, filebench, replay, the `multinode` smoke and
the harness mains are in `test_torch_workloads_io.py`, which shares this
file's helpers.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import timeless

from pmdfc_tpu.bench import common as jcommon
from pmdfc_tpu.bench import gen_input as jgi
from pmdfc_tpu.bench import paging_sim as jps
from pmdfc_tpu.bench import tier_sweep as jts
from pmdfc_tpu_torch.bench import common as tcommon
from pmdfc_tpu_torch.bench import gen_input as tgi
from pmdfc_tpu_torch.bench import paging_sim as tps

pytestmark = pytest.mark.torch
# the harnesses run their JAX programs for many steps: XLA's optimized
# code pays for its compile here
KEEP_XLA_DEFAULTS = True

ROOT = Path(__file__).resolve().parents[1]
TRACE = ROOT / "tests" / "data" / "fileserver.trace"
PW, CAP = 64, 1 << 11  # page words, slots: small enough to evict
# host clocks of two different programs: never compared
TIMING = {"secs", "pages_per_sec", "mib_per_sec", "iops", "fault_iops",
          "read_mib_per_sec", "value", "mbs_4k"}


def _untimed(d: dict) -> dict:
    return timeless(d, TIMING)


def _kv_stats(backend) -> dict:
    """The KV's counters (its uptime is a host clock)."""
    return timeless(backend.kv.stats())


@pytest.mark.parametrize("pattern", ["uniform", "one_to_n", "sequential",
                                     "repeated", "zipf"])
def test_gen_input_datasets_are_byte_identical(pattern, tmp_path):
    make = {"uniform": lambda m: m.uniform(5000, seed=7),
            "one_to_n": lambda m: m.one_to_n(5000, 6),
            "sequential": lambda m: m.sequential(5000, start=3),
            "repeated": lambda m: m.repeated(5000, 4, seed=9),
            "zipf": lambda m: m.zipf(5000, seed=11)}[pattern]
    a, b = make(jgi), make(tgi)
    assert a.dtype == b.dtype == np.uint32 and a.tobytes() == b.tobytes()
    jgi.save(str(tmp_path / "j.txt"), a)
    tgi.save(str(tmp_path / "t.txt"), b)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    assert tgi.load(str(tmp_path / "t.txt")).tobytes() == a.tobytes()


def _run_main(main, argv, monkeypatch, capsys):
    """A harness main -> (rc, its JSON row, its stderr); the JAX mains
    read `sys.argv`."""
    monkeypatch.setattr(sys, "argv", ["test_kv", *argv])
    rc = main() if main.__module__.startswith("pmdfc_tpu.") else main(argv)
    cap = capsys.readouterr()
    row = json.loads([ln for ln in cap.out.splitlines()
                      if ln.startswith("{")][-1])
    return rc, row, cap.err


@pytest.mark.parametrize("index", ["linear", "cceh"])
def test_test_kv_found_and_failed_search_match_jax(index, monkeypatch,
                                                   capsys):
    from pmdfc_tpu.bench import test_kv as jtk
    from pmdfc_tpu_torch.bench import test_kv as ttk

    # the JAX harness's strict compile-cache pin is for its bench rows
    monkeypatch.setenv("PMDFC_JAX_PIN", "loose")
    args = ["--n", "6000", "--batch", "1024", "--capacity", "4096",
            "--index", index, "--no-engine"]
    _, jrow, jerr = _run_main(jtk.main, ["--cpu", *args], monkeypatch,
                              capsys)
    rc, trow, _ = _run_main(ttk.main, ["--device", "cpu", *args],
                            monkeypatch, capsys)
    bad = int(jerr.split(" raw misses")[0].rsplit("(", 1)[1])
    assert bad > 0  # 6144 keys into 4096 slots: evictions
    assert trow["found"] == jrow["n"] - bad
    for k in ("failed_search", "n", "batch", "index", "insert_path"):
        assert trow[k] == jrow[k], k
    assert set(jrow) - {"engine_error"} <= set(trow), set(jrow) - set(trow)
    assert rc == 0 and trow["failed_search"] == 0


def _paging_pair(tier=None):
    return [m.build_backend("direct", PW, CAP, device="cpu", tier=tier)
            for m in (jcommon, tcommon)]


@pytest.mark.parametrize("job,iodepth", [
    ("seq_read", 1), ("rand_read", 1), ("rand_rw", 1), ("seq_rw", 1),
    ("seq_write", 1), ("rand_read", 16), ("seq_read", 16)])
def test_paging_sim_jobs_count_like_jax(job, iodepth):
    from pmdfc_tpu.client import CleanCacheClient as JClient
    from pmdfc_tpu_torch.client import CleanCacheClient as TClient

    out = []
    for (be, closer), mod, client in zip(_paging_pair(), (jps, tps),
                                         (JClient, TClient)):
        try:
            cl = client(be)
            sim = mod.PagingSim(cl, 96, PW)
            row = mod.run_job(sim, job, CAP // 4, 1200, seed=3,
                              iodepth=iodepth)
            out.append((_untimed(row), cl.stats(), _kv_stats(be)))
        finally:
            closer()
    (jr, jc, jk), (tr, tc_, tk) = out
    assert jr == tr and jc == tc_ and jk == tk
    assert tr["verify_failures"] == 0 and tr["cc_puts"] > 0
    if job != "seq_write":
        assert tr["cc_hits"] > 0 and tr["disk_reads"] > 0


def test_paging_sim_scan_mix_arm_counts_like_jax():
    """One scan_mix arm (the admission gate on, a pressure pulse) on the
    tiered store: the deterministic counters are equal."""
    from pmdfc_tpu.client import CleanCacheClient as JClient
    from pmdfc_tpu.config import AdmitConfig as JA, TierConfig as JT
    from pmdfc_tpu_torch.client import CleanCacheClient as TClient
    from pmdfc_tpu_torch.config import AdmitConfig as TA, TierConfig as TT

    rng = np.random.default_rng(5)
    assert np.array_equal(jts._zipf_stream(rng, 300, 500, 0.99),
                          tps._zipf_stream(np.random.default_rng(5), 300,
                                           500, 0.99))
    out = []
    for m, client, T, A in ((jcommon, JClient, JT, JA),
                            (tcommon, TClient, TT, TA)):
        tier = T(promote_touches=1, admit=A(
            sketch_width=CAP, door_bits=2 * CAP, reset_ops=512,
            threshold=2))
        be, closer = m.build_backend("direct", PW, CAP, device="cpu",
                                     tier=tier)
        try:
            mod = jps if m is jcommon else tps
            sim = mod.PagingSim(client(be), 48, PW)
            res = mod.run_scan_mix_arm(
                sim, be, hot_pages=96, scan_pages=400, rounds=24,
                theta=0.99, iodepth=16, seed=7, shrink_every=8,
                shrink_rows=64)
            for k in ("_lat_us", "_pure_lat_s"):
                res.pop(k)
            out.append((res, _kv_stats(be)))
        finally:
            closer()
    assert out[0] == out[1]
    assert out[1][0]["verify_failures"] == 0 and out[1][0]["admit"]
