"""PyTorch port: `tests/test_admit.py`'s drills, one by one, on both packages.

Each test carries the name of the JAX drill it twins and runs the drill's
script through the JAX package and through the port (`device="cpu"`) on
the same seeded keys: the sketch lanes (doorkeeper, count-min, aging) on
`tier`'s admission leaves, the scan flood, the ghost override, put as a
touch, the restore matrix, the sharded restore and reshard, the stats
surfaces and the wire's schema pins, the autotune admit knob, the axis
rules. Both packages are held to the drill's own asserts, and what each
returns must be equal (tolerance 0: integer arithmetic): estimates,
sketch and doorkeeper leaves, hot residency, GET pages and found masks,
`tier_stats`, `admit_state`, the stats counters, controller decisions and
knob values. The two `PMDFC_ADMIT` drills have their twins of the same
names in `tests/test_torch_env_switches.py`.

One more test pins a behaviour both packages share (ROADMAP Queue 3): a
gate whose aging epoch (`reset_ops`) is shorter than one GET ages inside
every GET, so at such widths the fast-aging gate denies every zipf
promotion; the card's phase 18 (e) promotes its zipf set through the live
threshold knob for that reason.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import (bits, counters, fresh_jax_registry,  # noqa: F401
                        registries, same, stop)
from torch_twin import walk_in_reverse

import pmdfc_tpu.checkpoint as jckpt
import pmdfc_tpu.client.backends as jbackends
import pmdfc_tpu.config as jconf
import pmdfc_tpu.kv as jkv
import pmdfc_tpu.parallel.partitioning as jpt
import pmdfc_tpu.parallel.shard as jshard
import pmdfc_tpu.runtime.autotune as jautotune
import pmdfc_tpu.runtime.net as jnet
import pmdfc_tpu.runtime.telemetry as jtele
import pmdfc_tpu.runtime.timeseries as jts
import pmdfc_tpu.tier as jtier
import pmdfc_tpu_torch.checkpoint as tckpt
import pmdfc_tpu_torch.client.backends as tbackends
import pmdfc_tpu_torch.config as tconf
import pmdfc_tpu_torch.kv as tkv
import pmdfc_tpu_torch.parallel.partitioning as tpt
import pmdfc_tpu_torch.parallel.shard as tshard
import pmdfc_tpu_torch.runtime.autotune as tautotune
import pmdfc_tpu_torch.runtime.net as tnet
import pmdfc_tpu_torch.runtime.telemetry as ttele
import pmdfc_tpu_torch.runtime.timeseries as tts
import pmdfc_tpu_torch.tier as ttier
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch.tools import check_teledump as tcheck
from pmdfc_tpu_torch.tools import teletop as tteletop
from pmdfc_tpu_torch.utils import u32
from tools import check_teledump as jcheck
from tools import teletop as jteletop

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures(
    "fresh_jax_registry")]

W = 32
INV = 0xFFFFFFFF
ADMIT = dict(sketch_width=1 << 10, door_bits=1 << 11, reset_ops=4096,
             threshold=2)
ADMIT_FAST = dict(sketch_width=1 << 10, door_bits=1 << 11, reset_ops=64,
                  threshold=2)


def _jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


JAX = types.SimpleNamespace(
    name="jax", conf=jconf, kv_mod=jkv, tier=jtier, ckpt=jckpt,
    backends=jbackends, net=jnet, tele=jtele, ts=jts, autotune=jautotune,
    pt=jpt, check=jcheck, teletop=jteletop, KV=jkv.KV,
    arr=jnp.asarray, leaves=lambda kv: _jax_leaves(kv.state),
    load=lambda path, cfg: jckpt.load(path, cfg),
    KV_state=lambda cfg, st: jkv.KV(cfg, state=st),
    tier_init=lambda n, w, cfg: jtier.init(n, w, cfg),
    mask=lambda m: jnp.asarray(np.asarray(m, bool)),
    sharded=lambda cfg, n: jshard.ShardedKV(
        cfg, mesh=jshard.make_mesh(jax.devices("cpu")[:n]),
        dispatch="broadcast"))
PORT = types.SimpleNamespace(
    name="port", conf=tconf, kv_mod=tkv, tier=ttier, ckpt=tckpt,
    backends=tbackends, net=tnet, tele=ttele, ts=tts, autotune=tautotune,
    pt=tpt, check=tcheck, teletop=tteletop,
    KV=lambda cfg: tkv.KV(cfg, device="cpu"),
    arr=lambda a: u32.from_numpy(np.asarray(a, np.uint32), "cpu"),
    leaves=lambda kv: carry.state_to_numpy(kv.state),
    load=lambda path, cfg: tckpt.load(path, cfg, device="cpu"),
    KV_state=lambda cfg, st: tkv.KV(cfg, state=st, device="cpu"),
    tier_init=lambda n, w, cfg: ttier.init(n, w, cfg, device="cpu"),
    mask=lambda m: torch.from_numpy(np.asarray(m, bool)),
    sharded=lambda cfg, n: tshard.ShardedKV(
        cfg, mesh=tshard.make_mesh(["cpu"] * n), dispatch="broadcast"))


def twin(drill, *args):
    a, b = drill(JAX, *args), drill(PORT, *args)
    same(a, b, drill.__name__)
    return b


def _admit(p, **kw):
    return p.conf.AdmitConfig(**kw)


def _cfg(p, capacity=1 << 8, admit="slow", **tkw):
    tkw.setdefault("promote_touches", 1)
    a = {"slow": ADMIT, "fast": ADMIT_FAST}[admit] \
        if isinstance(admit, str) else admit
    return p.conf.KVConfig(
        index=p.conf.IndexConfig(capacity=capacity), bloom=None, paged=True,
        page_words=W, tier=p.conf.TierConfig(
            admit=None if a is None else _admit(p, **a), **tkw))


def _keys(los):
    los = np.asarray(los, np.uint32)
    return np.stack([los >> 16, los], axis=-1).astype(np.uint32)


def _pages(keys):
    lo = np.asarray(keys, np.uint32)[:, 1]
    return (lo[:, None] * np.uint32(2654435761)
            + np.arange(W, dtype=np.uint32)[None, :])


def _cause_sum(p, kv) -> dict:
    s = kv.stats()
    assert s["misses"] == sum(s[k] for k in p.kv_mod.MISS_CAUSE_NAMES)
    return counters(s)


def _hot_resident(kv, keys) -> int:
    hk = bits(kv.state.pool.hot_keys)
    occ = hk[~np.all(hk == INV, axis=-1)]
    have = {tuple(k) for k in occ}
    return sum(tuple(k) in have for k in np.asarray(keys, np.int64))


def _est(p, ts, acfg, keys):
    return bits(p.tier.admit_estimate(ts, acfg, p.arr(keys)))


def _observe(p, ts, acfg, keys, mask):
    out = p.tier.admit_observe(ts, acfg, p.arr(keys), p.mask(mask))
    return ts if out is None else out


def _sketch(ts) -> dict:
    return {k: bits(getattr(ts, k)) for k in
            ("admit_cm", "admit_door", "admit_ops", "admit_stats")}


# -- sketch mechanics -------------------------------------------------------


def test_sketch_doorkeeper_then_cm_and_invalid_lanes():
    def drill(p):
        acfg = _admit(p, sketch_width=256, door_bits=512,
                      reset_ops=1 << 20)
        ts = p.tier_init(64, W, p.conf.TierConfig(admit=acfg))
        keys = _keys([5, 9])
        mask = [True, True]
        ts = _observe(p, ts, acfg, keys, mask)
        e1 = _est(p, ts, acfg, keys)
        assert list(e1) == [1, 1]
        assert int(bits(ts.admit_cm).sum()) == 0
        s1 = _sketch(ts)
        ts = _observe(p, ts, acfg, keys, mask)
        e2 = _est(p, ts, acfg, keys)
        assert list(e2) == [2, 2]
        assert int(bits(ts.admit_cm).sum()) > 0
        inv = np.full((2, 2), INV, np.uint32)
        einv = _est(p, ts, acfg, inv)
        assert not einv.any()
        before = int(bits(ts.admit_ops))
        ts = _observe(p, ts, acfg, keys, [False, False])
        assert int(bits(ts.admit_ops)) == before
        return e1, s1, e2, einv, _sketch(ts)
    twin(drill)


def test_sketch_aging_halves_cm_and_clears_doorkeeper():
    def drill(p):
        acfg = _admit(p, sketch_width=256, door_bits=512, reset_ops=8)
        ts = p.tier_init(64, W, p.conf.TierConfig(admit=acfg))
        keys = _keys([5, 9])
        mask = [True, True]
        for _ in range(3):
            ts = _observe(p, ts, acfg, keys, mask)
        est_before = _est(p, ts, acfg, keys)
        assert list(est_before) == [3, 3]
        assert int(bits(ts.admit_door).sum()) > 0
        ts = _observe(p, ts, acfg, keys, mask)
        assert int(bits(ts.admit_ops)) == 0
        a = p.tier.admit_counters_dict(ts.admit_stats)
        assert a["admit_age_epochs"] == 1
        assert not bits(ts.admit_door).any()
        est_after = _est(p, ts, acfg, keys)
        assert (est_after < est_before).all()
        ts = _observe(p, ts, acfg, keys, mask)
        est_again = _est(p, ts, acfg, keys)
        assert (est_again > est_after).all()
        return est_before, a, est_after, est_again, _sketch(ts)
    twin(drill)


# -- scan resistance --------------------------------------------------------


def _promote_zipf_set(kv, zipf_keys, zipf_pages):
    kv.insert(zipf_keys, zipf_pages)
    for _ in range(3):
        out, found = kv.get(zipf_keys)
        assert found.all() and (out == zipf_pages).all()


def test_scan_flood_denied_and_zipf_residency_holds():
    def drill(p):
        zipf_keys = _keys(np.arange(1, 25))
        zipf_pages = _pages(zipf_keys)
        scan_keys = _keys(np.arange(1000, 1128))
        scan_pages = _pages(scan_keys)
        obs = {}
        for arm, admit in (("gated", "fast"), ("naive", None)):
            kv = p.KV(_cfg(p, admit=admit))
            _promote_zipf_set(kv, zipf_keys, zipf_pages)
            assert _hot_resident(kv, zipf_keys) == len(zipf_keys)
            kv.insert(scan_keys, scan_pages)
            for _ in range(2):
                for lo in range(0, len(scan_keys), 32):
                    out, found = kv.get(scan_keys[lo:lo + 32])
                    if arm == "gated":
                        assert found.all()
            obs[arm] = dict(resident=_hot_resident(kv, zipf_keys),
                            tier=kv.tier_stats(), admit=kv.admit_state(),
                            stats=_cause_sum(p, kv), leaves=p.leaves(kv))
        g, n = obs["gated"], obs["naive"]
        assert g["admit"]["admit_denied"] > 0
        assert g["resident"] >= len(zipf_keys) * 3 // 4
        assert g["tier"]["admit_ghost_override"] \
            <= g["tier"]["ghost_readmits"]
        assert n["resident"] < g["resident"]
        assert n["tier"]["demotions"] > g["tier"]["demotions"]
        return obs
    twin(drill)


def test_scan_flood_at_a_get_wider_than_the_epoch_shared_by_both():
    """Phase 18 (e)'s shape at 2^12 slots (512 hot rows), GETs of 128
    keys against the fast gate's 64-touch epoch: the observe that folds a
    GET's keys ages the sketch inside the GET, so no estimate reaches the
    threshold and every zipf promotion is denied, in JAX as in the port.
    Opened through the live knob (threshold 0) for the zipf set and
    closed again (2), the gate then denies the scan and the zipf set
    keeps its hot rows, while a gateless `KV` lets the scan take them."""
    verb = 128

    def gets(kv, keys):
        out = []
        for i in range(0, len(keys), verb):
            o, f = kv.get(keys[i:i + verb])
            out.append((np.asarray(o), np.asarray(f)))
        return out

    def drill(p):
        obs = {}
        for arm, admit in (("gated", "fast"), ("naive", None)):
            kv = p.KV(_cfg(p, capacity=1 << 12, admit=admit,
                           max_promotes_per_batch=verb))
            h = p.tier.num_hot_rows(kv.capacity(), kv.config.tier)
            zipf = _keys(np.arange(1, h // 2 + 1))
            scan = _keys(np.arange(1 << 20, (1 << 20) + 4 * h))
            kv.insert(zipf, _pages(zipf))
            first = None
            if admit:
                first = gets(kv, zipf)
                assert kv.tier_stats()["promotions"] == 0
                assert kv.admit_state()["admit_denied"] == len(zipf)
                assert kv.set_admit_threshold(0)
            for _ in range(3):
                gets(kv, zipf)
            if admit:
                assert kv.set_admit_threshold(2)
            before = _hot_resident(kv, zipf)
            assert before == len(zipf)
            kv.insert(scan, _pages(scan))
            scanned = [gets(kv, scan) for _ in range(2)]
            for out, found in scanned[1]:
                assert found.all()
            obs[arm] = dict(first=first, scanned=scanned,
                            resident=_hot_resident(kv, zipf),
                            tier=kv.tier_stats(), admit=kv.admit_state(),
                            stats=_cause_sum(p, kv))
        g, n = obs["gated"], obs["naive"]
        assert g["admit"]["admit_denied"] > len(g["first"]) * verb // 2
        assert g["resident"] >= (len(g["first"]) * verb) * 3 // 4
        assert n["resident"] < g["resident"]
        assert n["tier"]["demotions"] > g["tier"]["demotions"]
        return obs
    twin(drill)


def test_ghost_override_readmits_below_threshold():
    def drill(p):
        kv = p.KV(_cfg(p, admit="fast", hot_fraction=64, ghost_rows=64))
        h = p.tier.num_hot_rows(1 << 8, kv.config.tier)
        keys = _keys(np.arange(1, 3 * h + 2))
        kv.insert(keys, _pages(keys))
        a = keys[:1]
        for _ in range(3):
            kv.get(a)
        assert _hot_resident(kv, a) == 1
        assert kv.set_admit_threshold(0)
        rest = keys[1:2 * h + 1]
        rounds = 0
        for _ in range(6):
            kv.get(rest)
            kv.get(rest)
            rounds += 1
            if _hot_resident(kv, a) == 0:
                break
        assert _hot_resident(kv, a) == 0
        assert kv.tier_stats()["demotions"] >= 1
        assert kv.set_admit_threshold(2)
        est_a = int(_est(p, kv.state.pool, _admit(p, **ADMIT_FAST), a)[0])
        assert est_a < 2, est_a
        before = kv.tier_stats()
        out, found = kv.get(a)
        assert found.all() and (out == _pages(a)).all()
        after = kv.tier_stats()
        assert after["ghost_readmits"] > before["ghost_readmits"]
        assert after["admit_ghost_override"] > before["admit_ghost_override"]
        assert after["admit_ghost_override"] <= after["ghost_readmits"]
        return (h, rounds, est_a, before, after, _cause_sum(p, kv),
                p.leaves(kv))
    twin(drill)


def test_put_is_a_touch():
    def drill(p):
        kv = p.KV(_cfg(p, admit=dict(ADMIT, threshold=3)))
        hot, cold = _keys([7]), _keys([9])
        for _ in range(4):
            kv.insert(hot, _pages(hot))
        kv.insert(cold, _pages(cold))
        out_h, found_h = kv.get(hot)
        assert found_h.all() and _hot_resident(kv, hot) == 1
        out_c, found_c = kv.get(cold)
        assert found_c.all() and _hot_resident(kv, cold) == 0
        assert kv.admit_state()["admit_denied"] >= 1
        return (np.asarray(out_h), np.asarray(out_c), kv.admit_state(),
                kv.tier_stats(), p.leaves(kv))
    twin(drill)


# -- restore / reshard ------------------------------------------------------


def test_restore_restart_empty_matrix(tmp_path):
    def drill(p):
        d = tmp_path / p.name
        d.mkdir()
        cfg_g, cfg_n = _cfg(p), _cfg(p, admit=None)
        keys = _keys(np.arange(1, 33))
        pages = _pages(keys)
        kv = p.KV(cfg_g)
        kv.insert(keys, pages)
        kv.get(keys)
        kv.set_admit_threshold(9)
        assert kv.admit_state()["ops"] > 0
        p_g = str(d / "gate.ckpt")
        kv.snapshot(p_g)
        kv2 = p.KV_state(cfg_g, p.load(p_g, cfg_g))
        a = kv2.admit_state()
        assert a["threshold"] == ADMIT["threshold"] and a["epochs"] == 0
        assert a["ops"] == 0 and a["admit_denied"] == 0
        out2, found2 = kv2.get(keys)
        assert found2.all() and (out2 == pages).all()
        kv3 = p.KV_state(cfg_n, p.load(p_g, cfg_n))
        assert kv3.admit_state() is None
        out3, found3 = kv3.get(keys)
        assert found3.all() and (out3 == pages).all()
        kvn = p.KV(cfg_n)
        kvn.insert(keys, pages)
        p_n = str(d / "plain.ckpt")
        kvn.snapshot(p_n)
        kv4 = p.KV_state(cfg_g, p.load(p_n, cfg_g))
        assert kv4.admit_state() is not None
        assert kv4.admit_state()["epochs"] == 0
        out4, found4 = kv4.get(keys)
        assert found4.all() and (out4 == pages).all()
        return (a, p.leaves(kv2), p.leaves(kv3), kv4.admit_state(),
                p.leaves(kv4), counters(kv4.stats()))
    twin(drill)


# slow in JAX; no phase on the card restores a gated sharded plane
# (ROADMAP Queue 1 names it)
def test_sharded_restore_and_reshard_restart_empty(tmp_path):
    def drill(p):
        d = tmp_path / p.name
        d.mkdir()
        cfg = _cfg(p)
        keys = _keys(np.arange(1, 49))
        pages = _pages(keys)
        skv = p.sharded(cfg, 2)
        skv.insert(keys, pages)
        skv.get(keys)
        path = str(d / "s.ckpt")
        skv.save(path)
        s2 = p.sharded(cfg, 2)
        s2.restore(path)
        out2, found2 = skv_get = s2.get(keys)
        assert found2.all() and (out2 == pages).all()
        a2 = s2.admit_state()
        assert a2 is not None and a2["epochs"] == 0
        s3 = p.sharded(cfg, 3)
        s3.restore(path)
        out3, found3 = s3.get(keys)
        assert found3.all() and (out3 == pages).all()
        assert s3.admit_state() is not None
        rep = s3.shard_report()
        assert len(rep["tier"]["admit_denied"]) == 3
        return (tuple(np.asarray(x) for x in skv_get), a2, s3.admit_state(),
                rep["tier"], counters(s3.stats()))
    twin(drill)


# -- stats surfaces and schema pins -----------------------------------------


def test_stats_surfaces_and_wire_pins():
    """Each package's `KV` behind its own `NetServer`; the MSG_STATS
    documents carry the same admission lanes and counters, pass both
    schema checkers (the root's and the port's copy), trip them alike on
    the drill's three planted faults, and render the same teletop row."""
    def drill(p):
        p.tele.configure(p.conf.TelemetryConfig(enabled=True))
        kv = p.KV(_cfg(p))
        keys = _keys(np.arange(1, 33))
        kv.insert(keys, _pages(keys))
        kv.get(keys)
        kv.get(_keys(np.arange(900, 916)))
        srv = p.net.NetServer(lambda: p.backends.DirectBackend(kv),
                              net=p.conf.NetConfig(flush_timeout_us=0,
                                                   settle_us=0)).start()
        try:
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None) as be:
                doc = be.server_stats()
        finally:
            stop(srv)
        for k in list(p.tier.ADMIT_STAT_NAMES) + ["admit_threshold"]:
            assert k in doc, k
        assert doc["misses"] == sum(doc[k] for k in
                                    p.kv_mod.MISS_CAUSE_NAMES)
        verdicts = []
        for chk in (jcheck, tcheck):
            assert chk.check(doc) == []
            bad = dict(doc)
            bad["admit_ghost_override"] = bad["ghost_readmits"] + 1
            e1 = chk.check_admission(bad)
            assert any("subset" in e for e in e1)
            bad = dict(doc)
            del bad["admit_victim_kept"]
            e2 = chk.check_admission(bad)
            assert e2
            bad = dict(doc)
            bad["shard_report"] = {"tier": {
                "admit_denied": [bad["admit_denied"] + 1]}}
            e3 = chk.check_admission(bad)
            assert any("drift" in e for e in e3)
            verdicts.append((e1, e2, e3))
        assert verdicts[0] == verdicts[1]
        row = p.teletop.summarize("x:0", doc)
        assert row["tier"]["admit"]["threshold"] == ADMIT["threshold"]
        lanes = {k: doc[k] for k in doc if k.startswith("admit")
                 or k in p.kv_mod.STAT_NAMES}
        return lanes, verdicts[0], row["tier"]
    twin(drill)


# -- the autotune admit knob ------------------------------------------------


class _FakeGatedKV:
    """The drill's host-only stand-in: balloon and admission surfaces with
    scripted stats deltas."""

    def __init__(self, ghost_per_k=0, churn_per_k=0, gate=True):
        self.n, self.th = 0, 8
        self.g, self.c, self.gate = ghost_per_k, churn_per_k, gate

    def balloon_state(self):
        return {"cold_rows": 1024, "circulating": 1024, "parked": 0,
                "free": 64, "step": 64}

    def balloon_grow(self, rows):
        return True

    def balloon_shrink(self, rows):
        return True

    def admit_state(self):
        return {"threshold": self.th} if self.gate else None

    def set_admit_threshold(self, v):
        self.th = v
        return True

    def stats(self):
        self.n += 1
        return {"gets": 1000 * self.n, "ghost_readmits": self.g * self.n,
                "demotions": self.c * self.n, "miss_evicted": 0,
                "miss_parked": 0}


def _drive_ctl(p, fk, rounds, cfg=None):
    reg = p.tele.configure(p.conf.TelemetryConfig())
    ring = p.ts.SeriesRing(capacity=256, interval_s=1.0)
    reg.series_sink = ring
    srv = p.net.NetServer(lambda: p.backends.LocalBackend(page_words=8),
                          net=p.conf.NetConfig())
    ctl = p.autotune.AutotuneController(
        cfg or p.conf.AutotuneConfig(balloon_every=1, hysteresis_windows=1))
    ctl.bind_server(srv)
    ctl.bind_balloon(fk)
    pfx = srv.stats.prefix + "."
    t = [0.0]

    def win():
        t[0] += 1.0
        return {"t": t[0], "dt_s": 1.0,
                "counters": {pfx + "coalesced_ops": 100},
                "gauges": {pfx + "staging_depth": 1},
                "hists": {pfx + "flush_ops_hist":
                          {"count": 100, "sum": 105, "p50": 1,
                           "p95": 2, "p99": 2}}}

    decs = []
    for _ in range(rounds):
        ring.push(win())
        decs += ctl.tick()
    return ctl, [{k: v for k, v in d.items() if k != "t"} for d in decs]


def test_autotune_admit_knob_registration_and_walks():
    def drill(p):
        ctl, _ = _drive_ctl(p, _FakeGatedKV(), 1)
        knobs = ctl.knob_values()
        assert knobs["admit_thresh"] == 8.0
        out = [knobs]
        for kw, rounds in ((dict(ghost_per_k=100), 6),
                           (dict(churn_per_k=100), 6), ({}, 6),
                           (dict(churn_per_k=500), 60)):
            fk = _FakeGatedKV(**kw)
            ctl, decs = _drive_ctl(p, fk, rounds)
            out.append((fk.th, ctl.knob_values(),
                        [d for d in decs if d.get("knob") == "admit_thresh"]))
        (_, (th_g, _, moves_g), (th_c, _, _), (th_q, _, _),
         (th_hi, knobs_hi, _)) = out
        assert th_g < 8 and moves_g
        assert all("ghost" in d["why"] for d in moves_g)
        assert th_c > 8 and th_q == 8
        assert th_hi == int(p.conf.AutotuneConfig().admit_hi)
        assert knobs_hi["admit_thresh"] == p.conf.AutotuneConfig().admit_hi
        return out
    twin(drill)


def test_autotune_admit_knob_cadence_exemption():
    def drill(p):
        fk = _FakeGatedKV(ghost_per_k=100)
        ctl, decs = _drive_ctl(p, fk, 8, p.conf.AutotuneConfig(
            balloon_every=2, hysteresis_windows=2))
        assert fk.th < 8
        return fk.th, ctl.knob_values(), decs
    twin(drill)


def test_autotune_no_gate_no_knob():
    def drill(p):
        ctl, decs = _drive_ctl(p, _FakeGatedKV(gate=False), 1)
        knobs = ctl.knob_values()
        assert "admit_thresh" not in knobs and "balloon_x" in knobs
        return knobs, decs
    twin(drill)


# -- partitioning coverage --------------------------------------------------


def test_axis_rules_cover_admit_leaves():
    def drill(p):
        rows = p.pt.describe(_cfg(p))
        leaves = {r["leaf"] for r in rows}
        for name in ("admit_cm", "admit_door", "admit_ops", "admit_thresh",
                     "admit_stats"):
            assert f".pool.{name}" in leaves
        for r in rows:
            assert r["axes"][0] == p.pt.SHARD
            assert "kv" in r["spec"], r
        return [(r["leaf"], tuple(r["axes"]), tuple(
            p.pt.spec_for(r["axes"], p.pt.DEFAULT_AXIS_RULES)))
            for r in rows]
    twin(drill)


walk_in_reverse(globals())
