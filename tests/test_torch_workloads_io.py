"""PyTorch port: the reference's swap, file and trace workloads against
their JAX twins (`pmdfc_tpu_torch/bench/` vs `pmdfc_tpu/bench/`), with
`test_torch_workloads.py`'s helpers and sizes.

Each harness runs next to its JAX twin with the same seed, at a tiny size,
on the CPU; every counter the harnesses report must be equal: swap_sim's
remote hits and `verify_failures`, filebench's counters, replay's outputs
on the bundled `tests/data/fileserver.trace` and on a synthetic trace.
Timing fields are exempt. Then a `multinode` smoke (2 client processes
against one `NetServer` over the port's KV) and each harness's main on
the CPU.
"""

from __future__ import annotations

import json

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu.bench import filebench as jfb
from pmdfc_tpu.bench import paging_sim as jps
from pmdfc_tpu.bench import replay as jrp
from pmdfc_tpu.bench import swap_sim as jss
from pmdfc_tpu_torch.bench import filebench as tfb
from pmdfc_tpu_torch.bench import paging_sim as tps
from pmdfc_tpu_torch.bench import replay as trp
from pmdfc_tpu_torch.bench import swap_sim as tss
from test_torch_workloads import (CAP, PW, TRACE, _kv_stats, _paging_pair,
                                  _untimed)

pytestmark = pytest.mark.torch
# the harnesses run their JAX programs for many steps: XLA's optimized
# code pays for its compile here
KEEP_XLA_DEFAULTS = True


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
