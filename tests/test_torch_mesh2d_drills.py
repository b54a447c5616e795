"""PyTorch port: `tests/test_mesh2d.py`'s drills, one by one, on both packages.

Each test carries the name of the JAX drill it twins and runs that drill's
script through JAX's `make_serving_backend(cfg, MeshConfig(n_shards,
replica_axis))` on its eight forced CPU devices and through the port's
same call with eight CPU devices standing in for the host's GPUs (the
port's factory otherwise takes the local GPUs). Ten of the thirteen JAX
drills are `slow` and run in neither package's tier-1; their twins run
here at the JAX drills' own sizes (16-word pages, 2^10 slots over 2
shards x 2 lanes, verbs of at most 32 keys), each held to the JAX drill's
asserts, and the two packages' observables must be equal: every verb's
result, the per-lane served / refused / repaired counts, `stats()` and
the shard report's sums, the `MSG_STATS` document's counters, the group
counters and each server's puts. The JAX planes count their 2-D
programs by name (`skv._jits`); the port has no compiled programs, so its
side of those asserts is the grid's lane count.

Their card counterparts are phase 10's 2 x 2 plane and phase 18 (c) of
`chip_smoke.py`: the mid-soak lane corruption behind the coalescing
`NetServer`, `MSG_RREPAIR` and the `PMDFC_MESH2D=off` transcript.
"""

from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
import torch
from torch_twin import (counters, fresh_jax_registry,  # noqa: F401
                        registries, same, stop)

from pmdfc_tpu import config as jconf
from pmdfc_tpu import kv as jkv
from pmdfc_tpu.client import replica as jrep
from pmdfc_tpu.parallel import partitioning as jpt
from pmdfc_tpu.parallel import plane as jplane
from pmdfc_tpu.parallel import shard as jshard
from pmdfc_tpu.runtime import net as jnet
from pmdfc_tpu.runtime import telemetry as jtele
from pmdfc_tpu_torch import config as tconf
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.client import replica as trep
from pmdfc_tpu_torch.parallel import partitioning as tpt
from pmdfc_tpu_torch.parallel import plane as tplane
from pmdfc_tpu_torch.parallel import shard as tshard
from pmdfc_tpu_torch.runtime import net as tnet
from pmdfc_tpu_torch.runtime import telemetry as ttele
from tools.check_teledump import check as check_doc

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures(
    "fresh_jax_registry")]

W = 16
CPUS = 8


@pytest.fixture(autouse=True)
def eight_devices(monkeypatch):
    """The port's factory and `make_mesh2d` see eight CPU devices, as
    JAX's see its eight forced host devices."""
    devs = lambda: [torch.device("cpu")] * CPUS  # noqa: E731
    monkeypatch.setattr(tshard, "_local_devices", devs)
    monkeypatch.setattr(tplane, "_local_devices", devs)


JAX = types.SimpleNamespace(
    conf=jconf, kv_mod=jkv, KV=jkv.KV, plane=jplane, shard=jshard, pt=jpt,
    net=jnet, ReplicaGroup=jrep.ReplicaGroup, tele=jtele,
    mesh1=lambda: jshard.make_mesh(np.array(jax.devices()[:2])),
    mesh2=lambda: jshard.make_mesh2d(2, 2),
    two_d=lambda skv: any(k[0].endswith("2") for k in skv._jits),
    programs=lambda skv: {k[0] for k in skv._jits},
    ndim=lambda skv: skv.mesh.devices.ndim)
PORT = types.SimpleNamespace(
    conf=tconf, kv_mod=tkv, KV=lambda cfg: tkv.KV(cfg, device="cpu"),
    plane=tplane, shard=tshard, pt=tpt, net=tnet,
    ReplicaGroup=trep.ReplicaGroup, tele=ttele,
    mesh1=lambda: tshard.make_mesh(["cpu"] * 2),
    mesh2=lambda: tshard.make_mesh2d(2, 2),
    two_d=lambda skv: skv.n_replicas > 1,
    programs=None, ndim=lambda skv: skv.mesh.devices.ndim)


def twin(drill, *args):
    """`drill(pkg, *args)` on JAX, then on the port; equal observables."""
    a, b = drill(JAX, *args), drill(PORT, *args)
    same(a, b, drill.__name__)
    return b


def _cfg(p, capacity=1 << 10, bloom=True, paged=True):
    c = p.conf
    return c.KVConfig(index=c.IndexConfig(capacity=capacity),
                      bloom=c.BloomConfig(num_bits=1 << 15) if bloom
                      else None, paged=paged, page_words=W)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 20, size=n, replace=False)
    return np.stack([flat >> 10, flat & 0x3FF], -1).astype(np.uint32)


def _pages(keys):
    return ((keys[:, 0] * np.uint32(31) + keys[:, 1])[:, None]
            + np.arange(1, W + 1, dtype=np.uint32)[None, :])


def _plane(p, n_shards=2, lanes=2, cfg=None):
    return p.plane.make_serving_backend(
        cfg or _cfg(p), p.conf.MeshConfig(n_shards=n_shards,
                                          replica_axis=lanes))


def _cause_sum(p, st) -> int:
    return sum(int(st[c]) for c in p.kv_mod.MISS_CAUSE_NAMES)


def _report(skv) -> dict:
    rep = skv.replica_report()
    return {k: [int(x) for x in v] if isinstance(v, (list, tuple)) else v
            for k, v in rep.items()}


def _sums(skv) -> dict:
    st = skv.shard_report()["stats"]
    return {k: int(sum(v)) for k, v in st.items()}


def _net(p):
    return p.conf.NetConfig(flush_timeout_us=2000, settle_us=200)


# --- 1. partitioning -------------------------------------------------------


def test_mesh2d_rules_and_replicated_markers():
    def drill(p):
        pt = p.pt
        mesh1, mesh2 = p.mesh1(), p.mesh2()
        pt.validate_rules(pt.MESH2D_AXIS_RULES, mesh2)
        with pytest.raises(ValueError, match="names a mesh axis"):
            pt.validate_rules(pt.MESH2D_AXIS_RULES, mesh1)
        assert pt.rules_for_mesh(mesh2) == pt.MESH2D_AXIS_RULES
        assert pt.rules_for_mesh(mesh1) == pt.DEFAULT_AXIS_RULES
        spec = tuple(pt.spec_for((pt.SHARD, pt.REPLICA_LANE),
                                 pt.MESH2D_AXIS_RULES))
        assert spec == ("kv", "replica")
        rows = []
        for cfg in (_cfg(p), _cfg(p, bloom=False), _cfg(p, paged=False)):
            for row in pt.describe(cfg, pt.MESH2D_AXIS_RULES):
                named = pt.REPLICA_MESH_AXIS in row["spec"]
                marked = pt.REPLICA_MESH_AXIS in row["replicated_along"]
                assert named or marked, row
                rows.append((row["leaf"], row["shape"], row["axes"],
                             tuple(row["replicated_along"]), named))
        with pytest.raises(ValueError, match="replicated-along"):
            pt.replicated_along(".nonsense.leaf")
        return {"rules": [tuple(r) for r in pt.MESH2D_AXIS_RULES],
                "spec": spec, "rows": sorted(rows)}
    twin(drill)


def test_mesh2d_construction_gates():
    def drill(p):
        c = p.conf
        with pytest.raises(ValueError, match="devices"):
            p.shard.make_mesh2d(8, 2)
        with pytest.raises(ValueError, match="tiered"):
            p.shard.ShardedKV(c.KVConfig(index=c.IndexConfig(
                capacity=1 << 9), page_words=W, tier=c.TierConfig()),
                mesh=p.mesh2())
        return {}
    twin(drill)


# --- 2. plane semantics ----------------------------------------------------


def test_mesh2d_matches_single_device_results():
    def drill(p):
        keys = _keys(300, seed=11)
        pages = _pages(keys)
        be = _plane(p, 2, 2)
        assert be.replica_lanes == 2 and be.skv.n_replicas == 2
        ref = p.KV(_cfg(p))
        be.put(keys, pages)
        ref.insert(keys, pages)
        out, found = be.get(keys)
        rout, rfound = ref.get(keys)
        np.testing.assert_array_equal(found, np.asarray(rfound))
        np.testing.assert_array_equal(out, np.asarray(rout))
        hit = be.invalidate(keys[:64])
        np.testing.assert_array_equal(hit, np.asarray(ref.delete(keys[:64])))
        assert be.insert_extent(np.array([3, 0], np.uint32),
                                np.array([0, 4096], np.uint32), 32) == 0
        ref.insert_extent(np.array([3, 0], np.uint32),
                          np.array([0, 4096], np.uint32), 32)
        ekeys = np.array([[3, 5], [3, 40]], np.uint32)
        evals, ef = be.get_extent(ekeys)
        assert ef[0] and not ef[1]
        np.testing.assert_array_equal(ef, np.asarray(ref.get_extent(ekeys)[1]))
        s, r = be.skv.stats(), ref.stats()
        for k in ("puts", "gets", "hits", "misses", "deletes"):
            assert s[k] == r[k], (k, s, r)
        assert s["misses"] == _cause_sum(p, s)
        rep = _report(be.skv)
        assert rep["n_replicas"] == 2
        assert rep["served"] == [300, 0] and rep["digest_refused"] == [0, 0]
        return {"out": out, "found": found, "hit": hit, "evals": evals,
                "ef": ef, "stats": counters(s), "rep": rep}
    twin(drill)


def test_mesh2d_unpaged_plane_serves_values():
    def drill(p):
        be = _plane(p, 2, 2, cfg=_cfg(p, bloom=False, paged=False))
        keys = _keys(64, seed=13)
        vals = np.stack([keys[:, 0] ^ 7, keys[:, 1] + 1],
                        -1).astype(np.uint32)
        be.put(keys, vals)
        out, found = be.get(keys)
        assert found.all()
        np.testing.assert_array_equal(out, vals)
        assert be.replica_repair() == 0
        return {"out": out, "stats": counters(be.skv.stats())}
    twin(drill)


def test_mesh2d_hedged_read_routes_around_corrupt_lane():
    def drill(p):
        keys = _keys(256, seed=17)
        pages = _pages(keys)
        be = _plane(p, 2, 2)
        be.put(keys, pages)
        skv = be.skv
        obs = {}
        skv.corrupt_replica_lane(1)
        out, found = be.get(keys)
        assert found.all()
        np.testing.assert_array_equal(out, pages)
        rep = obs["lane1"] = _report(skv)
        assert rep["served"] == [256, 0] and rep["digest_refused"][1] == 256
        obs["repaired"] = skv.replica_repair()
        assert obs["repaired"] >= 256
        skv.corrupt_replica_lane(0)
        out, found = be.get(keys)
        assert found.all()
        np.testing.assert_array_equal(out, pages)
        rep = obs["lane0"] = _report(skv)
        assert rep["served"][1] == 256 and rep["digest_refused"][0] >= 256
        s = skv.stats()
        assert s["misses"] == _cause_sum(p, s) == 0
        skv.corrupt_replica_lane(1)
        out, found = be.get(keys)
        assert not found.any() and not out.any()
        s = skv.stats()
        assert s["misses"] == _cause_sum(p, s) == 256 == s["miss_digest"]
        sums = _sums(skv)
        assert sums["misses"] == s["misses"]
        assert skv.shard_report()["replica"]["digest_refused"][0] >= 512
        obs.update(stats=counters(s), sums=sums, both=_report(skv))
        return obs
    twin(drill)


def test_mesh2d_repair_is_attributed_per_lane():
    def drill(p):
        keys = _keys(128, seed=19)
        be = _plane(p, 2, 2)
        be.put(keys, _pages(keys))
        be.skv.corrupt_replica_lane(1)
        n = be.replica_repair()
        assert n >= 128
        rep = _report(be.skv)
        assert rep["repaired"][1] >= 128 and rep["repaired"][0] == 0
        out, found = be.get(keys)
        assert found.all()
        after = _report(be.skv)
        assert after["digest_refused"][1] == 0
        return {"n": n, "rep": rep, "after": after, "out": out}
    twin(drill)


def test_mesh2d_warmup_counts_nothing():
    def drill(p):
        be = _plane(p, 2, 2)
        n = be.warmup(32)
        assert n > 0
        s = be.skv.stats()
        assert s["gets"] == 0 and s["puts"] == 0, s
        if p.programs is not None:
            assert {"plane_insert2", "plane_delete2",
                    "plane_get_ro2"} <= p.programs(be.skv)
        else:
            assert p.two_d(be.skv)
        return {"n": n, "stats": counters(s)}
    twin(drill)


# --- 3. conformance --------------------------------------------------------


def _verb_transcript(be, seed=77, steps=36):
    rng = np.random.default_rng(seed)
    universe = _keys(256, seed=seed)
    out = []
    for _ in range(steps):
        op = int(rng.integers(5))
        lo = int(rng.integers(0, 240))
        n = int(rng.integers(1, 16))
        sel = universe[lo:lo + n]
        if op == 0:
            be.put(sel, _pages(sel))
            out.append(("put", n))
        elif op in (1, 2):
            pages, found = be.get(sel)
            out.append(("get", found.tolist(), pages[found].tolist()))
        elif op == 3:
            out.append(("inval", be.invalidate(sel).tolist()))
        else:
            vals, ef = be.get_extent(sel)
            out.append(("gext", ef.tolist(), vals[ef].tolist()))
    be.insert_extent(np.array([3, 0], np.uint32),
                     np.array([0, 4096], np.uint32), 32)
    vals, ef = be.get_extent(np.array([[3, 5], [3, 40]], np.uint32))
    out.append(("ext", ef.tolist(), vals.tolist()))
    return out


def test_mesh2d_off_kill_switch_is_conformant(monkeypatch):
    def drill(p):
        monkeypatch.setenv("PMDFC_MESH2D", "off")
        off = _plane(p, 2, 2)
        assert off.replica_lanes == 1 and off.skv.n_replicas == 1
        assert p.ndim(off.skv) == 1
        got_off = _verb_transcript(off)
        assert not p.two_d(off.skv), "2-D programs under the kill switch"
        srv = p.net.NetServer(lambda: off, net=_net(p)).start()
        try:
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None) as tb:
                assert tb.replica_lanes == 1
                assert tb.replica_repair() == 0
        finally:
            stop(srv)
        monkeypatch.delenv("PMDFC_MESH2D")
        got_plain = _verb_transcript(_plane(p, 2, 1))
        assert got_off == got_plain, "kill switch is not conformant"
        return got_off
    twin(drill)


# --- 4. the wire fault drill -----------------------------------------------


def test_mesh2d_wire_soak_corrupt_lane_mid_flight():
    def drill(p):
        be = _plane(p, 2, 2)
        be.warmup(64)
        keys = _keys(256, seed=23)
        pages = _pages(keys)
        srv = p.net.NetServer(lambda: be, net=_net(p)).start()
        wrong, steps = 0, []
        try:
            with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                  keepalive_s=None, window=8) as tb:
                assert tb.replica_lanes == 2
                tb.put(keys, pages)
                rng = np.random.default_rng(29)
                for step in range(18):
                    if step == 7:
                        be.skv.corrupt_replica_lane(0)  # mid-soak fault
                    lo = int(rng.integers(0, len(keys) - 32))
                    sel = slice(lo, lo + int(rng.integers(4, 32)))
                    if rng.integers(4) == 0:
                        tb.put(keys[sel], pages[sel])
                        steps.append(("put", sel.start, sel.stop))
                    else:
                        out, found = tb.get(keys[sel])
                        wrong += int((out[found] != pages[sel][found])
                                     .any(axis=1).sum())
                        steps.append(("get", found.tolist()))
                assert wrong == 0, f"{wrong} wrong pages served"
                rep = _report(be.skv)
                assert rep["digest_refused"][0] > 0 and rep["served"][1] > 0
                s = be.skv.stats()
                assert s["misses"] == _cause_sum(p, s)
                sums = _sums(be.skv)
                assert sums["misses"] == s["misses"]
                for name in ("miss_cold", "miss_digest"):
                    assert sums[name] == s[name]
                wire = tb.server_stats()
                assert wire["misses"] == _cause_sum(p, wire) == s["misses"]
                assert list(wire["replica"]["digest_refused"]) \
                    == rep["digest_refused"]
                if p.tele.enabled():
                    assert not check_doc(wire), check_doc(wire)
                repaired = tb.replica_repair()
                assert repaired > 0
                out, found = tb.get(keys)
                assert found.all()
                np.testing.assert_array_equal(out, pages)
        finally:
            stop(srv)
        return {"steps": steps, "rep": rep, "stats": counters(s),
                "sums": sums, "repaired": repaired,
                "wire": {k: int(wire[k]) for k in ("misses", "hits", "puts")}}
    twin(drill)


# --- 5. ReplicaGroup delegation --------------------------------------------


def _fused_fleet(p, n_servers, lanes=2):
    planes = [_plane(p, 2, lanes) for _ in range(n_servers)]
    servers = [p.net.NetServer(lambda b=b: b, net=_net(p)).start()
               for b in planes]
    eps = [p.net.TcpBackend("127.0.0.1", s.port, page_words=W,
                            keepalive_s=None) for s in servers]
    return planes, servers, eps


def _group(p, eps, **kw):
    return p.ReplicaGroup(eps, page_words=W, cfg=p.conf.ReplicaConfig(
        repair_interval_s=0, **kw))


def _close(g, servers) -> None:
    g.close()
    for s in servers:
        stop(s)


def test_mesh2d_group_delegates_fanout_to_fused_plane():
    def drill(p):
        planes, servers, eps = _fused_fleet(p, 2)
        g = _group(p, eps, n_replicas=2, rf=2)
        try:
            keys = _keys(96, seed=31)
            pages = _pages(keys)
            g.put(keys, pages)
            delegated = dict(g.counters)["fused_delegated"]
            assert delegated >= 96
            per = [int(pl.skv.stats()["puts"]) for pl in planes]
            assert sum(per) == 96 and all(n > 0 for n in per), per
            out, found = g.get(keys)
            assert found.all()
            np.testing.assert_array_equal(out, pages)
            assert dict(g.counters)["hedges_fired"] == 0
        finally:
            _close(g, servers)
        return {"delegated": delegated, "per": per, "out": out}
    twin(drill)


def test_mesh2d_group_fused_plane_off_keeps_host_loops():
    def drill(p):
        planes, servers, eps = _fused_fleet(p, 2)
        g = _group(p, eps, n_replicas=2, rf=2, fused_plane=False)
        try:
            keys = _keys(64, seed=37)
            g.put(keys, _pages(keys))
            assert dict(g.counters)["fused_delegated"] == 0
            per = [int(pl.skv.stats()["puts"]) for pl in planes]
            assert per == [64, 64], per
        finally:
            _close(g, servers)
        return per
    twin(drill)


def test_mesh2d_off_group_keeps_host_fanout(monkeypatch):
    def drill(p):
        monkeypatch.setenv("PMDFC_MESH2D", "off")
        planes, servers, eps = _fused_fleet(p, 2)
        g = _group(p, eps, n_replicas=2, rf=2)
        try:
            assert all(ep.replica_lanes == 1 for ep in eps)
            assert all(pl.replica_lanes == 1 for pl in planes)
            keys = _keys(48, seed=43)
            g.put(keys, _pages(keys))
            assert dict(g.counters)["fused_delegated"] == 0
            per = [int(pl.skv.stats()["puts"]) for pl in planes]
            assert per == [48, 48], per
        finally:
            _close(g, servers)
        return per
    twin(drill)


def test_mesh2d_group_device_repair_rides_repair_cadence():
    def drill(p):
        planes, servers, eps = _fused_fleet(p, 1)
        g = _group(p, eps, n_replicas=1, rf=1, device_repair_ticks=2)
        try:
            keys = _keys(48, seed=41)
            g.put(keys, _pages(keys))
            planes[0].skv.corrupt_replica_lane(1)
            g.repair_tick()
            assert dict(g.counters)["device_repair_rows"] == 0
            moved = g.repair_tick()
            assert moved >= 48
            rows = dict(g.counters)["device_repair_rows"]
            assert rows >= 48
            rep = _report(planes[0].skv)
            assert rep["repaired"][1] >= 48
        finally:
            _close(g, servers)
        return {"moved": moved, "rows": rows, "rep": rep}
    twin(drill)
