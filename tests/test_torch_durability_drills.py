"""PyTorch port: the `tests/test_durability.py` drills that no twin of the
same name ran, one by one, on both packages.

Each test carries the name of the JAX drill it twins and runs the drill's
script through the JAX package and through the port (`device="cpu"`),
each over its own journal directory and snapshot files: the recovering
window's `miss_recovering` attribution and ledger, the warm restart from a
full-and-delta chain and from an empty chain (journal replay from the
start), a ring member's rejoin, and a 4-shard full-and-delta chain
restored onto 2 shards. Both are held to the drill's own asserts, and
what each returns must be equal (tolerance 0: integer arithmetic): GET
pages and found masks, the stats counters, replay reports, recovery
state, journal records, ring owners and epochs (the port's restore
report also carries `timings_s`, a recorded difference the twins pin).
The drills of the suite
that have same-named twins run in `tests/test_torch_journal.py` and
`tests/test_torch_checkpoint.py`.
"""

from __future__ import annotations

import copy
import json
import time
import types

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import counters, same

import pmdfc_tpu.cluster.ring as jring
import pmdfc_tpu.config as jconf
import pmdfc_tpu.kv as jkv
import pmdfc_tpu.parallel.shard as jshard
import pmdfc_tpu.runtime.journal as jjournal
import pmdfc_tpu_torch.cluster.ring as tring
import pmdfc_tpu_torch.config as tconf
import pmdfc_tpu_torch.kv as tkv
import pmdfc_tpu_torch.parallel.shard as tshard
import pmdfc_tpu_torch.runtime.journal as tjournal

pytestmark = pytest.mark.torch

W = 16

JAX = types.SimpleNamespace(
    name="jax", conf=jconf, kv_mod=jkv, journal=jjournal, ring=jring,
    KV=lambda cfg, **kw: jkv.KV(cfg, **kw), dev={},
    mesh=lambda n: jshard.make_mesh(jax.devices()[:n]),
    ShardedKV=jshard.ShardedKV)
PORT = types.SimpleNamespace(
    name="port", conf=tconf, kv_mod=tkv, journal=tjournal, ring=tring,
    KV=lambda cfg, **kw: tkv.KV(cfg, device="cpu", **kw),
    dev=dict(device="cpu"), mesh=lambda n: tshard.make_mesh(["cpu"] * n),
    ShardedKV=tshard.ShardedKV)


def twin(drill, *args):
    a, b = drill(JAX, *args), drill(PORT, *args)
    same(a, b, drill.__name__)
    return b


def _cfg(p):
    return p.conf.KVConfig(index=p.conf.IndexConfig(capacity=1 << 10),
                           paged=True, page_words=W)


def _jcfg(p, rpo_ops=8):
    return p.conf.JournalConfig(rpo_ops=rpo_ops, rpo_ms=0.0)


def _keys(lo, n):
    flat = np.arange(lo, lo + n, dtype=np.uint32)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _pages(keys):
    return (keys[:, 1:2].astype(np.uint32) * 3 + 1) * np.arange(
        1, W + 1, dtype=np.uint32)


def _ledger(p, stats) -> dict:
    causes = {k: int(stats[k]) for k in p.kv_mod.MISS_CAUSE_NAMES}
    assert int(stats["misses"]) == sum(causes.values()), causes
    return counters(stats)


def _dir(tmp_path, p, name):
    d = tmp_path / p.name / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def _untimed(p, report) -> dict:
    """The replay report without the port's `timings_s` (a recorded
    difference: the port's `warm_restart` adds the seconds of each
    restore step, which JAX's report does not carry)."""
    timings = report.pop("timings_s", None)
    if p is PORT:
        assert set(timings) == {"read", "fold", "to_device", "recovery",
                                "replay"}
    else:
        assert timings is None
    return report


def _field(x):
    """One field of a journal record, comparable across the packages'
    directories: arrays as lists, a snapshot mark without its random
    chain id and its path."""
    if hasattr(x, "shape"):
        return np.asarray(x).tolist()
    if isinstance(x, bytes) and x.startswith(b"{"):
        mark = json.loads(x)
        return {k: v for k, v in mark.items() if k not in ("chain_id",
                                                         "path")}
    return x


def _records(recs) -> list:
    return [tuple(_field(x) for x in r) for r in recs]


def _recovery_drill(p):
    """`test_miss_recovering_attribution_and_ledger`'s script -> its
    transcript; the first `recovery_info` carries the recovering window's
    age, `recovering_s` (a clock: `same` holds it by presence and type)."""
    kv = p.KV(_cfg(p))
    ka = _keys(0, 16)
    kv.insert(ka, _pages(ka))
    kv.begin_recovering()
    info = kv.recovery_info()
    assert info["recovering"] is True
    _, f1 = kv.get(_keys(1024, 16))
    assert not f1.any()
    st1 = kv.stats()
    _ledger(p, st1)
    assert st1["miss_recovering"] == 16 and st1["miss_cold"] == 0
    out, f2 = kv.get(ka)
    assert f2.all()
    assert kv.mark_recovered() is True
    assert kv.mark_recovered() is False
    _, f3 = kv.get(_keys(2048, 8))
    st = kv.stats()
    assert st["miss_cold"] == 8 and st["miss_recovering"] == 16
    return (info, np.asarray(f1), _ledger(p, st1), np.asarray(out),
            np.asarray(f3), _ledger(p, st), kv.recovery_info())


def test_miss_recovering_attribution_and_ledger():
    twin(_recovery_drill)


class _LateClock:
    """The `time` module, but each `monotonic()` reads 5 ms later than the
    one before: the port's side stalls between any two readings."""

    def __init__(self):
        self.calls = 0

    def monotonic(self):
        self.calls += 1
        return time.monotonic() + 0.005 * self.calls

    def __getattr__(self, name):
        return getattr(time, name)


def test_the_recovery_twin_holds_under_a_skewed_port_clock(monkeypatch):
    """A port clock that runs ahead between `begin_recovering` and
    `recovery_info` gives another `recovering_s` than JAX's; the twin
    still agrees, since a clock is compared by presence and type."""
    monkeypatch.setattr(tkv, "time", _LateClock())
    a, b = _recovery_drill(JAX), _recovery_drill(PORT)
    assert b[0]["recovering_s"] >= 0.005 > a[0]["recovering_s"]
    same(a, b, "skewed clock")


@pytest.fixture(scope="module")
def recovery_pair():
    """The recovery drill's two transcripts, read only."""
    return _recovery_drill(JAX), _recovery_drill(PORT)


def _flip_recovering(t):
    t[0]["recovering"] = False


def _bump_miss_recovering(t):
    t[2]["miss_recovering"] += 1


def _drop_clock(t):
    del t[0]["recovering_s"]


def _int_clock(t):
    t[0]["recovering_s"] = 0


def _negative_clock(t):
    t[0]["recovering_s"] = -0.001


def _nan_clock(t):
    t[0]["recovering_s"] = float("nan")


@pytest.mark.parametrize("plant", [
    _flip_recovering, _bump_miss_recovering, _drop_clock, _int_clock,
    _negative_clock, _nan_clock], ids=lambda f: f.__name__.strip("_"))
def test_the_recovery_twin_still_fails_on_a_wrong_transcript(recovery_pair,
                                                             plant):
    """Only a clock's value goes uncompared: a wrong `recovering` flag or
    `miss_recovering` count, a missing clock, or one that is no finite
    float >= 0 fails the twin."""
    a, b = recovery_pair
    same(a, b, "as read")
    bad = copy.deepcopy(b)
    plant(bad)
    with pytest.raises(AssertionError):
        same(a, bad, plant.__name__)


def test_warm_restart_end_to_end(tmp_path):
    def drill(p):
        snap = _dir(tmp_path, p, "snap")
        jdir = str(_dir(tmp_path, p, "wal"))
        jc = _jcfg(p)
        kv = p.KV(_cfg(p), journal=p.journal.Journal(jdir, jc))
        ka, kb, kc = _keys(0, 64), _keys(64, 16), _keys(80, 8)
        kv.insert(ka, _pages(ka))
        full, delta = str(snap / "full.npz"), str(snap / "d1.npz")
        kv.snapshot(full)
        kv.insert(kb, _pages(kb))
        kv.snapshot(delta, delta=True)
        kv.insert(kc, _pages(kc))
        kv.delete(ka[:4])
        kv._journal.close()
        kv2, report = p.journal.warm_restart(_cfg(p), [full, delta], jdir,
                                             journal_config=jc, **p.dev)
        report = _untimed(p, report)
        assert report["puts"] >= 1 and report["deletes"] >= 1
        got, found = kv2.get(_keys(0, 88))
        assert not found[:4].any(), "deleted keys resurrected by replay"
        assert found[4:].all(), "journal tail lost"
        np.testing.assert_array_equal(got[4:], _pages(_keys(0, 88))[4:])
        info = kv2.recovery_info()
        assert info["recovering"] is True
        assert info["chain"]["seq"] == 1
        st = _ledger(p, kv2.stats())
        kd = _keys(96, 4)
        kv2.insert(kd, _pages(kd))
        assert kv2.mark_recovered() is True
        kv2._journal.close()
        recs, torn = p.journal.read_records(jdir)
        assert torn == 0 and any(r[0] == p.journal.REC_PUT for r in recs)
        chain = {k: v for k, v in info["chain"].items()
                 if k not in ("id", "prev_crc")}
        return (report, np.asarray(got), np.asarray(found), chain,
                info["recovering"], st, _records(recs))
    twin(drill)


def test_warm_restart_empty_chain_replays_from_start(tmp_path):
    def drill(p):
        jdir = str(_dir(tmp_path, p, "wal"))
        jc = _jcfg(p)
        kv = p.KV(_cfg(p), journal=p.journal.Journal(jdir, jc))
        ka = _keys(0, 12)
        kv.insert(ka, _pages(ka))
        kv._journal.close()
        kv2, report = p.journal.warm_restart(_cfg(p), [], jdir,
                                             journal_config=jc, **p.dev)
        report = _untimed(p, report)
        assert report["puts"] == 1
        got, found = kv2.get(ka)
        assert found.all()
        kv2._journal.close()
        return (report, np.asarray(got), kv2.recovery_info()["recovering"],
                _ledger(p, kv2.stats()))
    twin(drill)


def test_ring_rejoin_bumps_epoch_same_members():
    def drill(p):
        r = p.ring.HashRing([3, 5, 9])
        r2 = r.rejoin(5)
        assert r2.epoch == r.epoch + 1
        assert r2.members == r.members
        keys = _keys(0, 64)
        owners = np.asarray(r.owners_np(keys, 2))
        np.testing.assert_array_equal(owners, r2.owners_np(keys, 2))
        with pytest.raises(ValueError) as e:
            r.rejoin(4)
        return (r2.epoch - r.epoch, tuple(r2.members), owners,
                str(e.value))
    twin(drill)


# slow in JAX: phases 10 and 12 (a) restore a full-and-delta chain with
# `restore_chain` onto as many shards as wrote it; no phase restores a
# chain onto fewer (ROADMAP Queue 1)
def test_reshard_after_restore_chain(tmp_path):
    def drill(p):
        cfg = _cfg(p)
        s4 = p.ShardedKV(cfg, mesh=p.mesh(4))
        ka, kb = _keys(0, 96), _keys(96, 32)
        s4.insert(ka, _pages(ka))
        d = _dir(tmp_path, p, "snap")
        full, d1 = str(d / "full.npz"), str(d / "d1.npz")
        s4.save(full)
        s4.insert(kb, _pages(kb))
        r1 = s4.snapshot(d1, delta=True)
        assert r1["kind"] == "delta"
        s2 = p.ShardedKV(cfg, mesh=p.mesh(2))
        s2.restore_chain([full, d1])
        got, found = s2.get(_keys(0, 128))
        assert found.all()
        np.testing.assert_array_equal(got, _pages(_keys(0, 128)))
        return (r1["kind"], r1["seq"], np.asarray(got),
                counters(s2.stats()), s2.shard_report()["stats"])
    twin(drill)
