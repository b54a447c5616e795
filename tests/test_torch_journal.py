"""PyTorch port: the write-ahead journal, warm restart and the crashbox
against the JAX package.

- The segment files of a JAX `Journal` and a port `Journal` over the same
  put / delete / extent / mark sequence are byte-identical, directly and
  through each `KV`'s journal hooks (the port's numpy and tensor callers
  alike), and each package's journal replays into the other's `KV` to the
  same state.
- The JAX journal drills' twins on the port: the bounded `KeyJournal`, seq
  resume in a fresh segment, idempotent replay (no resurrection), the
  torn tail (truncated and counted), corrupt history (refused).
- `warm_restart` from one chain and journal (chain + tail, and an empty
  chain) gives the same state, replay report and int32[19] stats vector
  as JAX's, `miss_recovering` and `misses == Σ miss_*` included.
- `KVServer.checkpoint` and `health`, `MSG_RECOVERY` over the port's wire,
  and the crashbox's real SIGKILL drill on the CPU.

Tolerance 0 throughout.
"""

from __future__ import annotations

import functools
import os
import shutil
import threading
import types

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
import torch

import pmdfc_tpu.client.backends as jbe
import pmdfc_tpu.runtime.engine as jeng
import pmdfc_tpu.runtime.failure as jfail
import pmdfc_tpu.runtime.net as jnet
import pmdfc_tpu.runtime.server as jsrv
import pmdfc_tpu_torch.client.backends as tbe
import pmdfc_tpu_torch.runtime.engine as teng
import pmdfc_tpu_torch.runtime.failure as tfail
import pmdfc_tpu_torch.runtime.net as tnet
import pmdfc_tpu_torch.runtime.server as tsrv
from pmdfc_tpu import checkpoint as jck
from pmdfc_tpu import kv as jkv
from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import JournalConfig as JJournalConfig
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu.runtime import journal as jj
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import checkpoint as tck
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import JournalConfig as TJournalConfig
from pmdfc_tpu_torch.config import KVConfig as TKVConfig
from pmdfc_tpu_torch.runtime import journal as tj
from pmdfc_tpu_torch.tools import crashbox as tbox
from pmdfc_tpu_torch.utils import u32
from torch_twin import jax_registry, same, stop  # noqa: F401
from tools import crashbox as jbox

pytestmark = pytest.mark.torch

W = 16
JCFG_J = JKVConfig(index=JIndexConfig(capacity=1 << 10), paged=True,
                   page_words=W)
CFG = TKVConfig(index=TIndexConfig(capacity=1 << 10), paged=True,
                page_words=W)
# rpo_ms=0: no flusher thread — syncs happen at the rpo_ops bound
JOUR_J = JJournalConfig(rpo_ops=8, rpo_ms=0.0)
JOUR = TJournalConfig(rpo_ops=8, rpo_ms=0.0)


# each package's journal, KV, server, wire and crashbox under one name
JAX = types.SimpleNamespace(
    name="jax", j=jj, cfg=JCFG_J, jcfg=JJournalConfig, KV=jkv.KV,
    KVServer=jsrv.KVServer, Engine=jeng.Engine, be=jbe, net=jnet,
    failure=jfail, Crashbox=jbox.Crashbox)
PORT = types.SimpleNamespace(
    name="port", j=tj, cfg=CFG, jcfg=TJournalConfig,
    KV=functools.partial(tkv.KV, device="cpu"),
    KVServer=functools.partial(tsrv.KVServer, device="cpu"),
    Engine=teng.Engine, be=tbe, net=tnet, failure=tfail,
    Crashbox=functools.partial(tbox.Crashbox, device="cpu"))
PAIR = (JAX, PORT)


def _untimed(p, report) -> dict:
    """A warm restart's replay report without the port's `timings_s` (a
    recorded difference: the port adds the seconds of each restore
    step)."""
    report = dict(report)
    timings = report.pop("timings_s", None)
    assert (timings is not None) == (p.name == "port")
    return report


def _side_by_side(drill, *args) -> tuple:
    """`drill(p, *args)` for both packages at once, each in its own
    thread (the drills wait on child processes and sockets) -> JAX's and
    the port's transcripts."""
    out, errs = [None, None], []

    def run(i, p):
        try:
            out[i] = drill(p, *args)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i, p))
          for i, p in enumerate(PAIR)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return tuple(out)


def _keys(lo, n):
    flat = np.arange(lo, lo + n, dtype=np.uint32)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 1:2].astype(np.uint32) * 3 + 1) * np.arange(
        1, W + 1, dtype=np.uint32)


def _stats_vec(st) -> list:
    return [int(st[k]) for k in tkv.STAT_NAMES]


def _assert_ledger(st):
    assert int(st["misses"]) == sum(int(st[k])
                                    for k in tkv.MISS_CAUSE_NAMES)


def _jleaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(getattr(p, "name", None) or str(p).strip(".[]")
                     for p in path): np.asarray(x) for path, x in flat}


def _same_state(jstate, tstate, what):
    a, b = _jleaves(jstate), carry.state_to_numpy(tstate)
    assert list(a) == list(b), what
    for n in a:
        assert np.array_equal(a[n], b[n]), f"{what}: leaf {n} differs"


def _segments(d) -> list:
    return [open(p, "rb").read() for p in tj.segment_paths(d)]


def _script(j):
    """One put / delete / extent / mark sequence through a Journal."""
    ka, kb = _keys(0, 12), _keys(12, 5)
    j.append_put(ka, _pages(ka))
    j.append_delete(ka[:3])
    j.append_extent(np.array([7, 0x100], np.uint32),
                    np.array([0, 0x4000], np.uint32), 9)
    j.mark({"chain_id": "00ff", "seq": 0, "crc": 12345, "path": "x.npz",
            "kind": "full"})
    j.append_put(kb, _pages(kb))


def test_segment_bytes_identical_to_jax(tmp_path):
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    # tiny segments: rotation lands at the same record in both
    jjour = jj.Journal(dj, JJournalConfig(rpo_ops=2, rpo_ms=0.0,
                                          segment_bytes=4096))
    tjour = tj.Journal(dt, TJournalConfig(rpo_ops=2, rpo_ms=0.0,
                                          segment_bytes=4096))
    for j in (jjour, tjour):
        for _ in range(6):
            _script(j)
        j.close()
    sj, st = _segments(dj), _segments(dt)
    assert len(sj) == len(st) > 1
    assert sj == st
    assert [r[:4] for r in tj.read_records(dt)[0]] == \
        [r[:4] for r in jj.read_records(dj)[0]]
    assert dict(tjour.counters)["syncs"] == dict(jjour.counters)["syncs"]


def test_kv_hooks_journal_the_same_bytes_as_jax(tmp_path):
    """Every mutating verb journals before its dispatch, the same record
    as JAX's; a tensor caller's rows cross once and read the same."""
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jk = jkv.KV(JCFG_J, journal=jj.Journal(dj, JOUR_J))
    tk = tkv.KV(CFG, device="cpu", journal=tj.Journal(dt, JOUR))
    ka, kb, kc = _keys(0, 40), _keys(40, 24), _keys(64, 8)
    jk.insert(ka, _pages(ka))
    tk.insert(ka, _pages(ka))
    jk.insert_async(kb, _pages(kb))
    tk.insert_async(u32.from_numpy(kb, "cpu"), u32.from_numpy(_pages(kb),
                                                              "cpu"))
    jk.delete(ka[:5])
    tk.delete(ka[:5])
    jk.delete_async(kb[:3])
    tk.delete_async(u32.from_numpy(kb[:3], "cpu"))
    key, val = np.array([9, 0x200], np.uint32), np.array([1, 0x8000],
                                                           np.uint32)
    jk.insert_extent(key, val, 17)
    tk.insert_extent(key, val, 17)
    jk.insert(kc, _pages(kc))
    tk.insert(kc.astype(np.int64), _pages(kc))  # converted, same words
    jk._journal.close()
    tk._journal.close()
    assert _segments(dj) == _segments(dt)
    recs = tj.read_records(dt)[0]
    assert [r[0] for r in recs] == [tj.REC_PUT, tj.REC_PUT, tj.REC_DELETE,
                                    tj.REC_DELETE, tj.REC_EXTENT, tj.REC_PUT]
    _same_state(jk.state, tk.state, "journaled KVs")


def test_journals_replay_across_packages(tmp_path):
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    for mod, d, cfg in ((jj, dj, JOUR_J), (tj, dt, JOUR)):
        j = mod.Journal(d, cfg)
        _script(j)
        j.close()
    for after_mark in (False, True):
        jk, tk = jkv.KV(JCFG_J), tkv.KV(CFG, device="cpu")
        rj = jj.replay(dt, jk, after_mark=after_mark)  # port's into JAX
        rt = tj.replay(dj, tk, after_mark=after_mark)  # JAX's into port
        assert rj == rt
        _same_state(jk.state, tk.state, f"replay after_mark={after_mark}")
    assert rt["records"] == 1 and rt["pages"] == 5


def test_keyjournal_bounded_set():
    kj = tj.KeyJournal(4)
    for i in range(6):
        kj.note((i, i))
    assert len(kj) == 4
    assert (0, 0) not in kj and (5, 5) in kj
    kj.note((2, 2))
    kj.note((9, 9))
    assert (2, 2) in kj and (3, 3) not in kj
    kj.discard((9, 9))
    kj.discard((9, 9))
    assert (9, 9) not in kj
    arr = kj.keys_array()
    assert arr.dtype == np.uint32 and arr.shape == (len(kj), 2)
    ref = jj.KeyJournal(4)
    for kk in [(i, i) for i in range(6)] + [(2, 2), (9, 9)]:
        ref.note(kk)
    ref.discard((9, 9))
    np.testing.assert_array_equal(arr, ref.keys_array())


def test_journal_seq_resumes_in_fresh_segment(tmp_path):
    d = str(tmp_path)
    j = tj.Journal(d, JOUR)
    j.append_put(_keys(0, 4), _pages(_keys(0, 4)))
    j.append_delete(_keys(0, 2))
    j.close()
    j2 = tj.Journal(d, JOUR)
    j2.append_put(_keys(8, 2), _pages(_keys(8, 2)))
    j2.close()
    assert len(tj.segment_paths(d)) == 2
    recs, torn = tj.read_records(d)
    assert torn == 0
    assert [r[0] for r in recs] == [tj.REC_PUT, tj.REC_DELETE, tj.REC_PUT]
    assert [r[2] for r in recs] == [0, 1, 2]
    # a JAX journal reopened over the port's segments resumes the same seq
    j3 = jj.Journal(d, JOUR_J)
    assert j3.append_delete(_keys(0, 1)) == 3
    j3.close()


def _replay_twice(p, tmp_path):
    d = str(tmp_path / p.name)
    j = p.j.Journal(d, p.jcfg(rpo_ops=8, rpo_ms=0.0))
    ka, kb = _keys(0, 16), _keys(16, 8)
    j.append_put(ka, _pages(ka))
    j.append_put(kb, _pages(kb))
    j.append_delete(ka[:4])       # deleted AFTER the put: must stay dead
    j.close()

    def state_of(kv):
        got, found = kv.get(_keys(0, 24))
        return np.array(found), np.array(got)

    kv = p.KV(p.cfg)
    rep1 = p.j.replay(d, kv, after_mark=False)
    assert rep1["puts"] == 2 and rep1["deletes"] == 1
    f1, g1 = state_of(kv)
    assert not f1[:4].any() and f1[4:].all()
    rep2 = p.j.replay(d, kv, after_mark=False)  # twice is once
    assert rep2["records"] == rep1["records"]
    f2, g2 = state_of(kv)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(g1[f1], g2[f2])
    return rep1, rep2, f1, g1[f1], f2, g2[f2]


def test_journal_replay_idempotent_no_resurrection(tmp_path):
    a, b = (_replay_twice(p, tmp_path) for p in PAIR)
    same(a, b, "replay twice")


def test_replay_never_journals_itself(tmp_path):
    d, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    j = tj.Journal(d, JOUR)
    _script(j)
    j.close()
    mine = tj.Journal(d2, JOUR)
    kv = tkv.KV(CFG, device="cpu", journal=mine)
    tj.replay(d, kv, after_mark=False)
    assert kv._journal is mine  # re-attached after the replay
    mine.close()
    assert tj.read_records(d2) == ([], 0)


def test_torn_tail_truncated_and_counted(tmp_path):
    d = str(tmp_path)
    j = tj.Journal(d, JOUR)
    for lo in range(0, 12, 4):
        j.append_put(_keys(lo, 4), _pages(_keys(lo, 4)))
    j.close()
    seg = tj.segment_paths(d)[-1]
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 3)
    recs, torn = tj.read_records(d)
    assert torn > 0 and len(recs) == 2
    assert (recs, torn) == jj.read_records(d)
    kv = tkv.KV(CFG, device="cpu")
    rep = tj.replay(d, kv, after_mark=False)
    assert rep["truncated_bytes"] > 0 and rep["puts"] == 2
    _, found = kv.get(_keys(0, 8))
    assert found.all()


def test_corrupt_history_refused(tmp_path):
    d = str(tmp_path)
    j = tj.Journal(d, TJournalConfig(rpo_ops=8, rpo_ms=0.0,
                                     segment_bytes=4096))
    for lo in range(0, 120, 8):
        j.append_put(_keys(lo, 8), _pages(_keys(lo, 8)))
    j.close()
    segs = tj.segment_paths(d)
    assert len(segs) > 1
    with open(segs[0], "r+b") as f:
        f.truncate(os.path.getsize(segs[0]) - 3)
    with pytest.raises(tj.JournalCorruptError) as et:
        tj.read_records(d)
    with pytest.raises(jj.JournalCorruptError) as ej:
        jj.read_records(d)
    assert str(et.value) == str(ej.value)


def test_miss_recovering_attribution_matches_jax():
    jk, tk = jkv.KV(JCFG_J), tkv.KV(CFG, device="cpu")
    ka = _keys(0, 16)
    for kv in (jk, tk):
        kv.insert(ka, _pages(ka))
        kv.begin_recovering()
        assert kv.recovery_info()["recovering"] is True
        assert not kv.get(_keys(1024, 16))[1].any()
        assert kv.get(ka)[1].all()
        assert kv.mark_recovered() is True
        assert kv.mark_recovered() is False
        kv.get(_keys(2048, 8))
    sj, st = jk.stats(), tk.stats()
    _assert_ledger(st)
    assert _stats_vec(sj) == _stats_vec(st)
    assert st["miss_recovering"] == 16 and st["miss_cold"] == 8


def _history(tmp_path, chain: bool):
    """A JAX KV with a journal: a full and a delta (if `chain`), then a
    tail of puts and deletes past the newest mark."""
    jdir = str(tmp_path / "wal")
    kv = jkv.KV(JCFG_J, journal=jj.Journal(jdir, JOUR_J))
    ka, kb, kc = _keys(0, 64), _keys(64, 16), _keys(80, 8)
    kv.insert(ka, _pages(ka))
    paths = []
    if chain:
        paths = [str(tmp_path / "full.npz"), str(tmp_path / "d1.npz")]
        kv.snapshot(paths[0])
        kv.insert(kb, _pages(kb))
        kv.snapshot(paths[1], delta=True)
    else:
        kv.insert(kb, _pages(kb))
    kv.insert(kc, _pages(kc))
    kv.delete(ka[:4])
    kv._journal.close()
    return paths, jdir


@pytest.mark.parametrize("chain", [True, False], ids=["chain", "empty"])
def test_warm_restart_matches_jax(tmp_path, chain):
    paths, jdir = _history(tmp_path, chain)
    # each restart attaches a fresh journal segment: give each its copy
    dj, dt = str(tmp_path / "wal_j"), str(tmp_path / "wal_t")
    shutil.copytree(jdir, dj)
    shutil.copytree(jdir, dt)
    jk, rj = jj.warm_restart(JCFG_J, paths, dj, journal_config=JOUR_J)
    tk, rt = tj.warm_restart(CFG, paths, dt, journal_config=JOUR,
                             device="cpu")
    timings = rt.pop("timings_s")
    assert set(timings) == {"read", "fold", "to_device", "recovery",
                            "replay"}
    assert rj == rt
    assert rt["puts"] >= 1 and rt["deletes"] == 1
    _same_state(jk.state, tk.state, "warm restart")
    ij, it = jk.recovery_info(), tk.recovery_info()
    assert it["recovering"] is ij["recovering"] is True
    assert it.get("chain") == ij.get("chain")
    if chain:
        assert it["chain"]["seq"] == 1
    # the same GETs: restored, replayed, deleted and never-inserted keys
    probe = _keys(0, 128)
    gj, fj = jk.get(probe)
    gt, ft = tk.get(probe)
    np.testing.assert_array_equal(fj, ft)
    np.testing.assert_array_equal(gj, gt)
    assert not ft[:4].any() and ft[4:88].all() and not ft[88:].any()
    np.testing.assert_array_equal(gt[4:88], _pages(probe)[4:88])
    sj, st = jk.stats(), tk.stats()
    _assert_ledger(st)
    assert _stats_vec(sj) == _stats_vec(st)
    assert st["miss_recovering"] == 44 and st["miss_cold"] == 0
    # the restarted journal takes new mutations; the next delta extends
    # the restored chain
    kd = _keys(96, 4)
    tk.insert(kd, _pages(kd))
    if chain:
        rep = tk.snapshot(str(tmp_path / "d2.npz"), delta=True)
        assert rep["kind"] == "delta" and rep["seq"] == 2
        chain3 = paths + [str(tmp_path / "d2.npz")]
        _same_state(jck.load_chain(chain3, JCFG_J),
                    tck.load_chain(chain3, CFG, device="cpu"),
                    "extended chain")
    assert tk.mark_recovered() is True
    tk._journal.close()
    jk._journal.close()
    recs, torn = tj.read_records(dt)
    # the fresh segment holds the new put (and the delta's MARK)
    assert torn == 0 and [r[0] for r in recs][-2:] == (
        [tj.REC_PUT, tj.REC_MARK] if chain else [tj.REC_DELETE, tj.REC_PUT])


def _link(report) -> dict:
    """A checkpoint report's chain fields (its path, random chain id and
    clocks aside)."""
    return {k: report[k] for k in ("kind", "seq") if k in report}


def _server_checkpoints(p, tmp_path):
    d = tmp_path / p.name
    d.mkdir()
    srv = p.KVServer(p.cfg, engine=p.Engine(
        num_queues=1, queue_cap=64, batch=64, arena_pages=64,
        page_bytes=W * 4))
    try:
        ka = _keys(0, 24)
        srv.kv.insert(ka, _pages(ka))
        r0 = srv.checkpoint(str(d / "full.npz"))
        assert r0["kind"] == "full"
        srv.kv.insert(_keys(24, 8), _pages(_keys(24, 8)))
        r1 = srv.checkpoint(str(d / "d1.npz"), delta=True)
        assert r1["kind"] == "delta" and r1["seq"] == 1
        assert r1["dirty_rows"] == 8
        h = srv.health()["recovery"]
        assert h["recovering"] is False and h["chain"]["seq"] == 1
        srv.kv.begin_recovering()
        h2 = srv.health()["recovery"]
        assert h2["recovering"] is True
        return (_link(r0), _link(r1), r1["dirty_rows"], h["recovering"],
                h["chain"]["seq"], {k: v for k, v in h2.items()
                                    if k != "chain"})
    finally:
        srv.stop()


def test_server_checkpoint_delta_and_health(tmp_path):
    a, b = (_server_checkpoints(p, tmp_path) for p in PAIR)
    same(a, b, "server checkpoints")


def _recovery_wire(p):
    kv = p.KV(p.cfg)
    kv.begin_recovering()
    srv = p.net.NetServer(lambda: p.be.DirectBackend(kv)).start()
    out = []
    try:
        with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W) as be:
            out.append(be.recovery_info())
            assert out[-1]["recovering"] is True
            out.append(be.mark_recovered())
            assert out[-1] is True
            out.append(be.recovery_info())
            assert out[-1]["recovering"] is False
            out.append(be.mark_recovered())
            assert out[-1] is False
        port = srv.port
    finally:
        stop(srv)
    # the endpoint is down: the queries degrade to not-recovering / no-op
    rc = p.failure.ReconnectingClient(
        lambda: p.net.TcpBackend("127.0.0.1", port, page_words=W,
                                 op_timeout_s=0.2),
        page_words=W, retry_delay_s=0.005, max_retry_delay_s=0.01)
    try:
        out.append(rc.recovery_info())
        assert out[-1] == {"recovering": False}
        out.append(rc.mark_recovered())
        assert out[-1] is False
    finally:
        rc.close()
    return out


def test_recovery_state_travels_the_wire(jax_registry):
    a, b = _side_by_side(_recovery_wire)
    same(a, b, "MSG_RECOVERY")


def _crash(p, tmp_path):
    """A real child process (spawn), a real SIGKILL between two acked
    RPCs -> the warm restart's replay report (untimed), the found mask of
    every key and the pages found, the server's counters and the
    recovering flag. The port's box also reports its snapshots' cost and
    the child's serving counters (port-only surface)."""
    d = tmp_path / p.name
    jdir = str(d / "wal")
    full, delta = str(d / "full.npz"), str(d / "d1.npz")
    jcfg = p.jcfg(rpo_ops=64, rpo_ms=0.0)
    box = p.Crashbox(p.cfg, jdir, jcfg)
    hello = box.start()
    assert hello["replay"]["records"] == 0
    be = p.net.TcpBackend("127.0.0.1", box.port, page_words=W)
    ka, kb, kc = _keys(0, 128), _keys(128, 32), _keys(160, 32)
    be.put(ka, _pages(ka))
    assert box.snapshot(full)["kind"] == "full"
    be.put(kb, _pages(kb))
    r1 = box.snapshot(delta, delta=True)
    assert r1["kind"] == "delta" and r1["dirty_rows"] == 32
    be.put(kc, _pages(kc))                 # acked, journal tail only
    be.get(ka[:16])
    if p.name == "port":
        assert hello["device"] == "cpu"
        assert r1["seconds"] > 0 and r1["peak_rss_bytes"] > 0
        sv = box.serving()
        assert len(sv["get_phases"]) >= 1
        assert sv["server"]["serve_errors"] == 0
        assert sv["journal"]["appends"] == 3 + 2  # puts and the two marks
    be.close()
    box.kill()
    assert not box.alive()

    box2 = p.Crashbox(p.cfg, jdir, jcfg, chain_paths=[full, delta])
    hello = box2.start()
    try:
        replay = _untimed(p, hello["replay"])
        if p.name == "port":
            assert set(hello["replay"]["timings_s"]) >= {"read", "replay"}
        assert replay["pages"] == 32
        be2 = p.net.TcpBackend("127.0.0.1", box2.port, page_words=W)
        allk = _keys(0, 192)
        got, found = be2.get(allk)
        lost = int((~found).sum())
        assert lost <= (jcfg.rpo_ops + 1) * 192, lost
        good = _pages(allk)
        assert int((got[found] != good[found]).any(axis=1).sum()) == 0
        st = be2.server_stats()
        _assert_ledger(st)
        recovering = box2.recovery_info()["recovering"]
        assert recovering is True
        assert be2.mark_recovered() is True
        be2.close()
        return (replay, np.asarray(found), np.asarray(got)[found],
                {k: int(st[k]) for k in tkv.STAT_NAMES}, recovering)
    finally:
        box2.stop()


def test_crashbox_sigkill_torn_tail_drill(tmp_path):
    """Both packages' boxes, side by side: zero wrong bytes, acked pages
    lost within the RPO bound, the journal tail visible in the warm
    restart's report; the reports, masks, pages and counters equal."""
    a, b = _side_by_side(_crash, tmp_path)
    same(a, b, "crashbox")


def test_crashbox_child_failure_raises_in_the_parent(tmp_path):
    """A child that cannot start (here: a chain that does not exist) sends
    its traceback; `start` raises it and leaves no process behind."""
    from pmdfc_tpu_torch.tools.crashbox import Crashbox

    box = Crashbox(CFG, str(tmp_path / "wal"), JOUR,
                   chain_paths=[str(tmp_path / "missing.npz")],
                   device="cpu")
    with pytest.raises(RuntimeError, match="CheckpointCorruptError"):
        box.start()
    assert not box.alive()


def test_dirty_basis_is_a_copy_on_the_cpu():
    """The delta basis is a copy: on the CPU a leaf's numpy view would
    follow the live pool and every delta would come out empty."""
    kv = tkv.KV(CFG, device="cpu")
    ka = _keys(0, 8)
    kv.insert(ka, _pages(ka))
    with kv._lock:
        sums, _ = kv._dirty_basis()
    kv.insert(_keys(8, 8), _pages(_keys(8, 8)))
    assert int((sums != u32.to_numpy(kv.state.pool.sums)).sum()) == 8
    assert isinstance(kv.state.pool.sums, torch.Tensor)


def test_every_mutation_is_journaled_before_its_dispatch(tmp_path,
                                                        monkeypatch):
    """The record is appended before the device op runs: a dispatch that
    fails leaves its record in the journal (replay redoes it), never an
    acknowledged mutation without one."""
    j = tj.Journal(str(tmp_path), JOUR)
    kv = tkv.KV(CFG, device="cpu", journal=j)
    seen = []

    def failing(name):
        def run(*a, **k):
            seen.append((name, dict(j.counters)["appends"]))
            raise RuntimeError("device dispatch failed")
        return run

    for name in ("insert", "delete", "insert_extent"):
        monkeypatch.setattr(tkv, name, failing(name))
    ka = _keys(0, 4)
    for verb in (lambda: kv.insert(ka, _pages(ka)),
                 lambda: kv.insert_async(ka, _pages(ka)),
                 lambda: kv.delete(ka), lambda: kv.delete_async(ka),
                 lambda: kv.insert_extent(np.array([1, 2], np.uint32),
                                          np.array([0, 8], np.uint32), 3)):
        with pytest.raises(RuntimeError, match="dispatch failed"):
            verb()
    assert [a for _, a in seen] == [1, 2, 3, 4, 5]
    j.close()
    assert [r[0] for r in tj.read_records(str(tmp_path))[0]] == [
        tj.REC_PUT, tj.REC_PUT, tj.REC_DELETE, tj.REC_DELETE, tj.REC_EXTENT]


def test_crashbox_children_are_spawned():
    """CUDA cannot be forked: the crashbox starts its child from the
    `spawn` context, and everything it hands over pickles."""
    import pickle

    from pmdfc_tpu_torch.tools.crashbox import Crashbox

    box = Crashbox(CFG, "/nonexistent", JOUR, device="cuda")
    assert box._ctx.get_start_method() == "spawn"
    assert box._proc._start_method is None or \
        box._proc._start_method == "spawn"
    pickle.dumps((CFG, JOUR, "cuda"))
    box._parent.close()
    box._child.close()
