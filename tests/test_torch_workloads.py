"""PyTorch port: the reference's workload harnesses against their JAX
twins (`pmdfc_tpu_torch/bench/` vs `pmdfc_tpu/bench/`).

Each harness runs next to its JAX twin with the same seed, at a tiny size,
on the CPU (the port's KV with `device="cpu"`, JAX on its CPU backend).
The two KVs agree bit for bit, so every counter the harnesses report must
be equal: the `gen_input` datasets and their files, test_kv's found count
and `failedSearch`, paging_sim's hits, disk reads and evictions per job
(the scan_mix arm's tier and admission counters too), swap_sim's remote
hits and `verify_failures`, filebench's counters, replay's outputs on the
bundled `tests/data/fileserver.trace` and on a synthetic trace. Timing
fields (`secs`, rates, latencies) are exempt: they are host clocks of two
different programs. Then a `multinode` smoke: 2 client processes against
one `NetServer` over the port's KV.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import timeless

from pmdfc_tpu.bench import common as jcommon
from pmdfc_tpu.bench import filebench as jfb
from pmdfc_tpu.bench import gen_input as jgi
from pmdfc_tpu.bench import paging_sim as jps
from pmdfc_tpu.bench import replay as jrp
from pmdfc_tpu.bench import swap_sim as jss
from pmdfc_tpu.bench import tier_sweep as jts
from pmdfc_tpu_torch.bench import common as tcommon
from pmdfc_tpu_torch.bench import filebench as tfb
from pmdfc_tpu_torch.bench import gen_input as tgi
from pmdfc_tpu_torch.bench import paging_sim as tps
from pmdfc_tpu_torch.bench import replay as trp
from pmdfc_tpu_torch.bench import swap_sim as tss

pytestmark = pytest.mark.torch

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


@pytest.mark.parametrize("iodepth", [1, 16])
def test_swap_sim_counts_like_jax(iodepth):
    from pmdfc_tpu.client.cleancache import SwapClient as JSwap
    from pmdfc_tpu_torch.client.cleancache import SwapClient as TSwap

    out = []
    for (be, closer), mod, swap in zip(_paging_pair(), (jss, tss),
                                       (JSwap, TSwap)):
        try:
            sim = mod.SwapSim(swap(be), 96, PW)
            row = mod.run(sim, 640, 3 * CAP // 2, 0.2, seed=4,
                          iodepth=iodepth)
            out.append((_untimed(row), _kv_stats(be)))
        finally:
            closer()
    assert out[0] == out[1]
    row = out[1][0]
    assert row["verify_failures"] == 0 and row["swap_hits"] > 0


@pytest.mark.parametrize("personality", ["fileserver", "webserver",
                                         "dgwebserver", "randomread"])
def test_filebench_counts_like_jax(personality):
    from pmdfc_tpu.client import CleanCacheClient as JClient
    from pmdfc_tpu_torch.client import CleanCacheClient as TClient

    out = []
    for (be, closer), mod, client in zip(_paging_pair(), (jfb, tfb),
                                         (JClient, TClient)):
        try:
            cl = client(be)
            sim = (jps if mod is jfb else tps).PagingSim(cl, 64, PW)
            row = mod.run_personality(sim, personality, 12, nfiles=12,
                                      mean_pages=8, seed=2,
                                      working_set=0.5)
            out.append((_untimed(row), cl.stats(), _kv_stats(be)))
        finally:
            closer()
    assert out[0] == out[1]
    assert out[1][0]["verify_failures"] == 0 and out[1][0]["pages_read"] > 0


@pytest.mark.parametrize("trace", ["bundled", "synthetic"])
def test_replay_matches_jax(trace, tmp_path):
    from pmdfc_tpu import config as jc
    from pmdfc_tpu.kv import KV as JKV
    from pmdfc_tpu_torch import config as tc
    from pmdfc_tpu_torch.kv import KV as TKV

    if trace == "bundled":
        (jo, jk), (to, tk) = (jrp.parse_trace(str(TRACE)),
                              trp.parse_trace(str(TRACE)))
    else:
        (jo, jk), (to, tk) = (jrp.synthetic_trace(6000, seed=3),
                              trp.synthetic_trace(6000, seed=3))
    assert jo.tobytes() == to.tobytes() and jk.tobytes() == tk.tobytes()
    rows = []
    for m, kv in ((jc, lambda c: JKV(c)), (tc, lambda c: TKV(c, device="cpu"))):
        cfg = m.KVConfig(index=m.IndexConfig(capacity=1 << 12), bloom=None,
                         paged=False)
        rows.append(_untimed((jrp if m is jc else trp).replay(
            kv(cfg), jo, jk, batch=1024)))
    jrow, trow = rows
    assert trow.pop("wrong_values") == 0
    assert jrow == trow and trow["read_hits"] > 0
    # the trace writer: the same file for the same seed
    jrp.write_fileserver_trace(str(tmp_path / "j.trace"), 300, seed=1)
    trp.write_fileserver_trace(str(tmp_path / "t.trace"), 300, seed=1)
    assert (tmp_path / "j.trace").read_bytes() == \
        (tmp_path / "t.trace").read_bytes()


def test_multinode_two_clients_against_one_server(capsys):
    from pmdfc_tpu_torch.bench import multinode

    rc = multinode.main(["--device", "cpu", "--clients", "2", "--ops", "400",
                         "--file-pages", "256", "--ram-pages", "64",
                         "--page-words", "64", "--capacity", "4096"])
    row = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    assert rc == 0 and row["ok"] == 2 and not row["errors"]
    assert row["verify_failures"] == 0 and row["server"]["serve_errors"] == 0
    assert row["device"] == "cpu"


@pytest.mark.parametrize("name,argv", [
    ("paging_sim", ["--job", "rand_read", "--ops", "600", "--file-pages",
                    "256", "--ram-pages", "64", "--page-words", "64",
                    "--capacity", "2048", "--iodepth", "16"]),
    ("swap_sim", ["--ops", "600", "--working-pages", "256", "--ram-pages",
                  "64", "--page-words", "64", "--capacity", "2048"]),
    ("filebench", ["--personality", "fileserver", "--loops", "6",
                   "--nfiles", "8", "--mean-pages", "6", "--ram-pages", "32",
                   "--page-words", "64", "--capacity", "2048"]),
    ("replay", ["--trace", str(TRACE), "--capacity", "65536", "--batch",
                "1024"]),
])
def test_harness_mains_run_on_the_cpu(name, argv, capsys):
    import importlib

    mod = importlib.import_module(f"pmdfc_tpu_torch.bench.{name}")
    assert mod.main(["--device", "cpu", *argv]) == 0
    row = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    assert row["device"] == "cpu" and row.get("verify_failures", 0) == 0
