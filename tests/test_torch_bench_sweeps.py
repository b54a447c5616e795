"""PyTorch port: the bench tail's sweeps against their JAX twins
(`pmdfc_tpu_torch/bench/{tier_sweep,fused_get,fill_sweep,insert_profile,
train_pressure,mesh_sweep}.py` vs `pmdfc_tpu/bench/`).

Each harness runs next to its JAX twin with the same seed, at a small
size, on the CPU (the port with `device="cpu"`, where the fused GET's
wrapper runs the kernel's plain version; JAX's fused GET in Pallas
interpret mode). The two KVs agree bit for bit, so the deterministic
counters are equal: tier_sweep's hits and tier counters per skew,
fused_get's hits per (family, zipf, batch) and all four KVs' stats,
fill_sweep's rows, train_pressure's paging counters and its loss over
the first 20 steps (relative 1e-4 of JAX's, from JAX's initial weights
through `params_from_jax`). Exempt, as host clocks of two programs:
`stream_mops_*`, `hot_gather_us_*`, `hot_gather_speedup`, `mops_*`,
`ms_*`, `speedup_*`, `worst_speedup`, `fill_s`, `ns_per_key` values,
`secs`, `steps_per_sec`, `fetch_frac` and every rate of mesh_sweep,
whose rows keep only their identities to compare. The JAX harnesses run
with `PMDFC_COMPILE_CACHE=0` (their strict compile-cache pin refuses
this host's jax).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import timeless

from pmdfc_tpu.bench import fill_sweep as jfs
from pmdfc_tpu.bench import fused_get as jfg
from pmdfc_tpu.bench import insert_profile as jip
from pmdfc_tpu.bench import mesh_sweep as jms
from pmdfc_tpu.bench import tier_sweep as jts
from pmdfc_tpu.bench import train_pressure as jtp
from pmdfc_tpu_torch.bench import fill_sweep as tfs
from pmdfc_tpu_torch.bench import fused_get as tfg
from pmdfc_tpu_torch.bench import insert_profile as tip
from pmdfc_tpu_torch.bench import mesh_sweep as tms
from pmdfc_tpu_torch.bench import paging_sim as tps
from pmdfc_tpu_torch.bench import tier_sweep as tts
from pmdfc_tpu_torch.bench import train_pressure as ttp

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("PMDFC_COMPILE_CACHE", "0")


def _json_objects(text: str) -> list:
    """Every JSON object a harness printed (one-line or indented)."""
    dec, out, i = json.JSONDecoder(), [], 0
    while (i := text.find("{", i)) >= 0:
        if i == 0 or text[i - 1] == "\n":
            try:
                obj, end = dec.raw_decode(text, i)
                out.append(obj)
                i = end
                continue
            except ValueError:
                pass
        i += 1
    return out


def _jax_main(main, argv, monkeypatch, capsys):
    """A JAX harness main (it reads `sys.argv`) -> (rc, printed objects)."""
    monkeypatch.setattr(sys, "argv", ["harness", *argv])
    rc = main()
    return rc, _json_objects(capsys.readouterr().out)


def run_twin_mains(jax_main, jax_argv, port_main, port_argv) -> dict:
    """A JAX harness main (it reads `sys.argv`), then its port twin's
    (`main(argv)`), with `PMDFC_COMPILE_CACHE=0` and each one's printout
    captured -> {"jax": (rc, printed objects), "port": (...)}; a main
    that exits reports its exit code. A module-scoped fixture runs the
    pair once and each of the twin's checks is a test of its own over
    the result."""
    import contextlib
    import io

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PMDFC_COMPILE_CACHE", "0")
        mp.setattr(sys, "argv", ["harness", *jax_argv])
        for side, call in (("jax", jax_main),
                           ("port", lambda: port_main(port_argv))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                try:
                    rc = call()
                except SystemExit as ex:
                    rc = ex.code
            out[side] = (rc, _json_objects(buf.getvalue()))
    return out


def test_the_shared_stream_keys_and_pages_are_jax_draw_for_draw():
    for a in (0.0, 0.6, 0.99, 1.2):
        assert np.array_equal(
            jts._zipf_stream(np.random.default_rng(3), 500, 700, a),
            tts._zipf_stream(np.random.default_rng(3), 500, 700, a))
    los = np.arange(0, 1 << 18, 997)
    assert np.array_equal(jts._keys(los), tts._keys(los))
    keys = tts._keys(los)
    assert np.array_equal(jts._pages(keys, 64), tts._pages(keys, 64))
    assert tps._zipf_stream is tts._zipf_stream


def _tier_args(**kw):
    return argparse.Namespace(**{
        "capacity": 1 << 13, "page_words": 64, "batch": 128,
        "gets": 1 << 12, "hot_fraction": 16, "zipfs": [0.99, 0.6],
        "seed": 0, "device": "cpu", "out": None, "history": None,
        "smoke": True, **kw})


def test_tier_sweep_counts_like_jax():
    """Hits, tier counters and the hot batch's share per skew equal JAX's
    (the second skew's stream follows the first's hot-gather draws)."""
    j, t = jts.run(_tier_args()), tts.run(_tier_args())
    assert len(j["sweeps"]) == len(t["sweeps"]) == 2
    for a, b in zip(j["sweeps"], t["sweeps"]):
        assert b["tier"]["promotions"] > 0
        for k in ("zipf", "hits_tier", "hits_flat", "tier",
                  "hot_batch_frac_in_hot_tier"):
            assert a[k] == b[k], k
        assert b["hot_gather_us_tier"] is not None
    assert set(j) == set(t)


def test_tier_sweep_fails_on_a_wrong_byte():
    out = tts._pages(tts._keys(np.arange(1, 9)), 16)
    found = np.ones(8, bool)
    assert tts.check_served(tts._keys(np.arange(1, 9)), out, found, 16,
                            "x") == 8
    bad = out.copy()
    bad[3, 5] ^= 1
    with pytest.raises(AssertionError, match="wrong bytes"):
        tts.check_served(tts._keys(np.arange(1, 9)), bad, found, 16, "x")
    found[2] = False
    with pytest.raises(AssertionError, match="not zeroed"):
        tts.check_served(tts._keys(np.arange(1, 9)), out, found, 16, "x")


def _fused_args(**kw):
    return argparse.Namespace(**{
        "capacity": 1 << 11, "page_words": 64, "batches": [128, 512],
        "gets": 1 << 10, "zipfs": [0.99, 0.0], "families": ["linear",
                                                            "cceh"],
        "fill": None, "seed": 0, "device": "cpu", "out": None,
        "history": None, "smoke": True, **kw})


def test_fused_get_sweep_serves_like_jax_interpret_mode():
    """Per (family, zipf, batch) both port sides agree bit for bit (the
    harness raises otherwise) and serve JAX's hits; JAX's own run holds
    its kernel (interpret mode) to its composed chain."""
    j, t = jfg.run(_fused_args()), tfg.run(_fused_args())
    ident = ("family", "zipf", "batch", "gets", "hits")
    assert [{k: r[k] for k in ident} for r in j["sweeps"]] \
        == [{k: r[k] for k in ident} for r in t["sweeps"]]
    assert all(r["parity"] == "ok" for r in t["sweeps"])


@pytest.mark.parametrize("kind", ["linear", "cceh"])
def test_fused_get_sides_and_jax_agree_on_every_lane(kind):
    """One seeded stream through JAX's kernel and composed KVs and the
    port's kernel and composed sides: pages, found and every stats lane
    equal across all four."""
    from pmdfc_tpu.config import IndexKind as JK
    from pmdfc_tpu_torch.config import IndexKind as TK

    cap, w = 1 << 11, 64
    keys = tts._keys(np.arange(1, cap // 2 + 1))
    jf, jc = (jfg._mk_kv(JK(kind), cap, w, m) for m in ("on", "off"))
    tf, tc = (tfg._mk_kv(TK(kind), cap, w, "cpu") for _ in range(2))
    for kv in (jf, jc, tf, tc):
        kv.insert(keys[:-40], tts._pages(keys[:-40], w))
    stream = keys[tts._zipf_stream(np.random.default_rng(5), len(keys),
                                   600, 0.99)]
    jfg._stream_pair(jf, jc, stream, 128, check=True)
    tfg._stream_pair(tf, tc, stream, 128, w, per_get=0)
    q = np.concatenate([stream[:160], keys[-40:]])  # 40 never inserted
    out_j, f_j = jf.get(q)
    assert not f_j[-40:].any()
    for kv in (jc, tf, tc):
        out, f = kv.get(q)
        assert np.array_equal(out, out_j) and np.array_equal(f, f_j)
    sj = timeless(jf.stats())
    for kv in (jc, tf, tc):
        assert timeless(kv.stats()) == sj


@pytest.mark.parametrize("kind", ["cuckoo", "level", "linear", "cceh",
                                  "hotring"])
def test_fill_sweep_rows_match_jax(kind):
    for fill in (0.7, 1.2):
        a = jfs.run_point(kind, 1 << 11, fill, 1 << 9)
        b = tfs.run_point(kind, 1 << 11, fill, 1 << 9, device="cpu")
        assert a == b
        assert b["conformance_ok"]


def test_fill_sweep_main_reports_every_point(capsys):
    rc = tfs.main(["--device", "cpu", "--smoke", "--indexes",
                   "linear,static", "--fills", "0.5,1.2"])
    rows = _json_objects(capsys.readouterr().out)
    assert rc == 0 and len(rows) == 5
    assert rows[-1]["points"] == 4 and rows[-1]["conformance_violations"] \
        == 0 and rows[-1]["device"] == "cpu"


def test_insert_profile_reports_jaxs_pieces(monkeypatch, capsys):
    argv = ["--n", "4096", "--capacity", "8192", "--device", "cpu",
            "--reps", "1"]
    monkeypatch.setattr(sys, "argv", ["insert_profile", *argv])
    jip.main()
    jrec = _json_objects(capsys.readouterr().out)[-1]
    assert tip.main(argv) == 0
    trec = _json_objects(capsys.readouterr().out)[-1]
    assert set(jrec) == set(trec)
    assert set(jrec["ns_per_key"]) == set(trec["ns_per_key"])
    for k in ("metric", "device", "n", "capacity"):
        assert jrec[k] == trec[k], k
    assert all(v > 0 for v in trec["ns_per_key"].values())


TP = dict(steps=20, batch=64, corpus_pages=256, ram_pages=64,
          page_words=256, feat_dim=128, hidden=256, lr=0.05,
          capacity=1 << 14)


def test_train_pressure_pages_and_loss_match_jax(monkeypatch, capsys):
    """From JAX's initial weights the port's MLP trains on the same paged
    batches: every paging counter equal, the loss of each of the first 20
    steps within a relative 1e-4 of JAX's train step on those batches."""
    import jax

    argv = [f"--{k.replace('_', '-')}={v}" for k, v in TP.items()]
    monkeypatch.setattr(sys, "argv", ["train_pressure", *argv,
                                      "--device", "cpu"])
    jtp.main()
    jrow = _json_objects(capsys.readouterr().out)[-1]
    init, step = jtp._build_train_step(TP["feat_dim"], TP["hidden"],
                                       TP["lr"])
    params = init(jax.random.PRNGKey(0))
    trow = ttp.run(argparse.Namespace(**TP, seed=0, device="cpu"),
                   init_params={k: np.asarray(v)
                                for k, v in params.items()})
    for k in ("reads", "writes", "ram_hits", "cc_hits", "disk_reads",
              "disk_writes", "verify_failures", "cc_puts", "steps"):
        assert trow[k] == jrow[k], k
    assert trow["client"] == jrow["client"]
    assert trow["verify_failures"] == 0
    # JAX's loss per step on the batches JAX's loop draws
    rng = np.random.default_rng(0)
    for s in range(TP["steps"]):
        idxs = rng.integers(TP["corpus_pages"], size=TP["batch"])
        xb = np.empty((TP["batch"], TP["feat_dim"]), np.float32)
        yb = np.empty((TP["batch"],), np.int32)
        for j, i in enumerate(idxs):
            # the corpus pages as written (version 1)
            page = tps.page_content(42, int(i), TP["page_words"], 1)
            xb[j], yb[j] = jtp.features_and_label(page, 42, int(i),
                                                  TP["feat_dim"])
        params, loss, _ = step(params, xb, yb)
        assert trow["losses"][s] == pytest.approx(float(loss), rel=1e-4), s
    assert trow["loss_first"] == pytest.approx(jrow["loss_first"],
                                               rel=1e-4, abs=1e-4)


def test_mlp_defaults_to_cuda(monkeypatch):
    """Without `device=` the model asks for CUDA, which raises where there
    is no GPU; `device="cpu"` builds it here."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        ttp.MLP(8, 4)
    assert ttp.MLP(8, 4, device="cpu").w1.device.type == "cpu"


def test_train_pressure_learns_from_a_seeded_start(capsys):
    assert ttp.main(["--device", "cpu", "--smoke"]) == 0
    row = _json_objects(capsys.readouterr().out)[-1]
    assert row["verify_failures"] == 0 and row["learned"]
    assert row["loss_last"] < row["loss_first"]


MESH = ["--shards", "1,2", "--connections", "2", "--window", "2",
        "--gets", "6", "--rounds", "1", "--verb", "32", "--preload",
        "1024", "--capacity", str(1 << 12)]


def test_mesh_sweep_rows_match_jax(monkeypatch, capsys):
    """Both sweeps serve every preloaded key through the off path and
    the 1- and 2-shard planes (content-verified, no miss) and report the
    same rows; the port also holds its launch and cause checks."""
    _, jout = _jax_main(jms.main, MESH, monkeypatch, capsys)
    assert tms.main(["--device", "cpu", *MESH, "--out", "/dev/null"]) == 0
    tout = _json_objects(capsys.readouterr().out)
    assert set(jout[-1]) - {"ratio_plane_vs_off", "ratio_2shard_vs_1shard"} \
        <= set(tout[-1])
    assert tout[-1]["launch_checks"] == 2 * 2  # two planes, two rounds


@pytest.mark.parametrize("per_call", [1, 2])
def test_mesh_sweep_counts_one_launch_per_shard_per_phase(monkeypatch,
                                                          per_call):
    """With the wrapper's calls counted as launches (the card's rule), the
    sweep holds one launch per shard per plane GET phase, and a shard GET
    that launches twice fails it."""
    from pmdfc_tpu_torch.bench import common as tcommon
    from pmdfc_tpu_torch.ops import fused

    plain = fused.fused_get

    def counted(keys, *a, **kw):
        fused.launches["fused_get_linear_flat"] += per_call
        return plain(keys, *a, **kw)

    monkeypatch.setattr(fused, "fused_get", counted)
    monkeypatch.setattr(tcommon, "launches_per_get", lambda device: 1)
    if per_call == 1:
        assert tms.main(["--device", "cpu", *MESH]) == 0
    else:
        with pytest.raises(AssertionError, match="fused-GET launches"):
            tms.main(["--device", "cpu", *MESH])
