"""PyTorch port: `tests/test_mesh.py`'s drills, one by one, on both packages.

Each test carries the name of the JAX drill it twins and runs the drill's
script on JAX's plane (its forced CPU devices) and on the port's (a grid
that names the CPU once per shard; the port's serving factory and
`KVServer(mesh=MeshConfig(...))`, which take local GPUs, see eight CPU
devices here, hazard (bu)). Both are held to the drill's own asserts, and
what each returns must be equal (tolerance 0: integer arithmetic): the
axis rules and their refusals, the router's bins, every plane verb's
result, `stats()` and `shard_report()`, the serving transcripts through
each package's `NetServer` (the 4-shard plane, the single-device path and
`PMDFC_MESH=off`), the engine-backed server's replies, and each reshard
restore's pages, misses and carried counters at the JAX drill's own size.
"""

from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import (counters, fresh_jax_registry,  # noqa: F401
                        registries, same, stop)

import pmdfc_tpu.client.backends as jbackends
import pmdfc_tpu.config as jconf
import pmdfc_tpu.kv as jkv
import pmdfc_tpu.parallel.partitioning as jpt
import pmdfc_tpu.parallel.plane as jplane
import pmdfc_tpu.parallel.shard as jshard
import pmdfc_tpu.runtime as jruntime
import pmdfc_tpu.runtime.net as jnet
import pmdfc_tpu_torch.client.backends as tbackends
import pmdfc_tpu_torch.config as tconf
import pmdfc_tpu_torch.kv as tkv
import pmdfc_tpu_torch.parallel.partitioning as tpt
import pmdfc_tpu_torch.parallel.plane as tplane
import pmdfc_tpu_torch.parallel.shard as tshard
import pmdfc_tpu_torch.runtime as truntime
import pmdfc_tpu_torch.runtime.net as tnet
from pmdfc_tpu.client import EngineBackend as JEngineBackend
from pmdfc_tpu_torch.client import EngineBackend as TEngineBackend

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures(
    "fresh_jax_registry")]

W = 16


@pytest.fixture(autouse=True)
def eight_devices(monkeypatch):
    """The port's factory sees eight CPU devices, as JAX's sees its eight
    forced host devices."""
    devs = lambda: [torch.device("cpu")] * 8  # noqa: E731
    monkeypatch.setattr(tshard, "_local_devices", devs)
    monkeypatch.setattr(tplane, "_local_devices", devs)


JAX = types.SimpleNamespace(
    name="jax", conf=jconf, pt=jpt, plane=jplane, shard=jshard, net=jnet,
    runtime=jruntime, backends=jbackends, EngineBackend=JEngineBackend,
    KV=jkv.KV, mesh=lambda n: jshard.make_mesh(np.array(jax.devices()[:n])),
    server_kw={})
PORT = types.SimpleNamespace(
    name="port", conf=tconf, pt=tpt, plane=tplane, shard=tshard, net=tnet,
    runtime=truntime, backends=tbackends, EngineBackend=TEngineBackend,
    KV=lambda cfg: tkv.KV(cfg, device="cpu"),
    mesh=lambda n: tshard.make_mesh(["cpu"] * n),
    server_kw=dict(device="cpu"))


def twin(drill, *args):
    a, b = drill(JAX, *args), drill(PORT, *args)
    same(a, b, drill.__name__)
    return b


def _cfg(p, capacity=1 << 10, tier=None, bloom=True, paged=True):
    c = p.conf
    return c.KVConfig(
        index=c.IndexConfig(capacity=capacity),
        bloom=c.BloomConfig(num_bits=1 << 15) if bloom else None,
        paged=paged, page_words=W,
        tier=None if tier is None else c.TierConfig(**tier))


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(1 << 20, size=n, replace=False)
    return np.stack([flat >> 10, flat & 0x3FF], -1).astype(np.uint32)


def _pages(keys):
    return ((keys[:, 0] * np.uint32(31) + keys[:, 1])[:, None]
            + np.arange(1, W + 1, dtype=np.uint32)[None, :])


def _a(x):
    """A result of either package as numpy (a tensor's u32 bits as the
    JAX package's uint32)."""
    if isinstance(x, torch.Tensor):
        from pmdfc_tpu_torch.utils import u32

        return x.numpy() if x.dtype == torch.bool else u32.to_numpy(x)
    return np.asarray(x)


def _report(skv) -> tuple:
    return counters(skv.stats()), skv.shard_report()


# --- 1. partitioning subsystem ---------------------------------------------

CFGS = {"flat": {}, "tiered": dict(tier=dict(ghost_rows=32)),
        "no-bloom": dict(bloom=False), "unpaged": dict(paged=False)}


@pytest.mark.parametrize("case", list(CFGS))
def test_axis_rules_cover_every_leaf(case):
    def drill(p):
        rows = p.pt.describe(_cfg(p, **CFGS[case]))
        assert rows, "empty state?"
        for r in rows:
            assert r["axes"][0] == p.pt.SHARD
            assert "kv" in r["spec"], r
        return [(r["leaf"], tuple(r["axes"]), tuple(p.pt.spec_for(
            r["axes"], p.pt.DEFAULT_AXIS_RULES))) for r in rows]
    twin(drill)


def test_rules_validate_against_mesh():
    def drill(p):
        mesh = p.mesh(2)
        p.pt.validate_rules(p.pt.DEFAULT_AXIS_RULES, mesh)
        with pytest.raises(ValueError, match="names a mesh axis") as e1:
            p.pt.validate_rules((("shard", "model"),), mesh)
        with pytest.raises(ValueError, match="no axis rule") as e2:
            p.pt.leaf_axes(".nonsense.leaf", 1)
        return str(e1.value), str(e2.value)
    twin(drill)


def test_sharded_kv_rejects_bad_rules():
    def drill(p):
        with pytest.raises(ValueError, match="names a mesh axis") as e:
            p.shard.ShardedKV(_cfg(p), mesh=p.mesh(2),
                              axis_rules=(("page_word", "nope"),))
        return str(e.value)
    twin(drill)


def test_router_binning_is_loss_free_and_stable():
    def drill(p):
        keys = _keys(500, seed=3)
        router = p.pt.ShardRouter(4, pad_floor=8)
        rb = router.build(keys, _pages(keys))
        assert rb.b == 500 and len(np.unique(rb.pos)) == 500
        assert rb.counts.sum() == 500
        np.testing.assert_array_equal(rb.scatter(rb.keys), keys)
        np.testing.assert_array_equal(rb.scatter(rb.values), _pages(keys))
        skv = p.shard.ShardedKV(_cfg(p), mesh=p.mesh(4))
        owners = router.owners(keys)
        np.testing.assert_array_equal(owners, _a(skv.node_of(keys)))
        for s in range(4):
            assert (np.diff(rb.pos[owners == s]) > 0).all()
        return (np.asarray(rb.pos), np.asarray(rb.counts),
                np.asarray(rb.keys), np.asarray(rb.values),
                np.asarray(owners))
    twin(drill)


# --- 2. plane verbs --------------------------------------------------------


def _res(r) -> dict:
    return {f: _a(getattr(r, f)) for f in r._fields}


def test_plane_matches_single_device_results():
    def drill(p):
        keys = _keys(300, seed=11)
        pages = _pages(keys)
        skv = p.shard.ShardedKV(_cfg(p), mesh=p.mesh(4))
        ref = p.KV(_cfg(p))
        res = skv.plane_insert(keys, pages).fetch()
        rres = ref.insert(keys, pages)
        np.testing.assert_array_equal(_a(res.dropped), _a(rres.dropped))
        g = skv.plane_get(keys).fetch()
        rout, rfound = ref.get(keys)
        np.testing.assert_array_equal(g.found, np.asarray(rfound))
        np.testing.assert_array_equal(g.dense()[g.found],
                                      np.asarray(rout)[rfound])
        np.testing.assert_array_equal(g.hit_rows(50, 200),
                                      g.dense()[50:200][g.found[50:200]])
        hit = skv.plane_delete(keys[:64]).fetch()
        rhit = ref.delete(keys[:64])
        np.testing.assert_array_equal(_a(hit), np.asarray(rhit))
        s, r = skv.stats(), ref.stats()
        for k in ("puts", "gets", "hits", "misses", "deletes"):
            assert s[k] == r[k], (k, s, r)
        return (_res(res), g.found, g.dense(), _a(hit), _report(skv),
                counters(r))
    twin(drill)


def test_plane_per_shard_attribution_sums_to_truth():
    def drill(p):
        keys = _keys(400, seed=7)
        skv = p.shard.ShardedKV(_cfg(p), mesh=p.mesh(4))
        skv.plane_insert(keys, _pages(keys)).fetch()
        h = skv.plane_get(keys)
        counts = np.asarray(h.counts)
        assert counts.sum() == 400 and (counts > 0).all()
        g = h.fetch()
        rep = skv.shard_report()
        assert sum(rep["stats"]["gets"]) == 400
        assert sum(rep["stats"]["hits"]) == 400
        assert sum(rep["stats"]["puts"]) == 400
        return counts, g.dense(), _report(skv)
    twin(drill)


def test_plane_backend_telemetry_and_warmup_are_stat_clean():
    """Both warmups run and count nothing as traffic; how many programs
    each warms is its own (JAX traces a jit program per rung, the port
    runs its verbs once per rung), so only `> 0` is compared."""
    def drill(p):
        skv = p.shard.ShardedKV(_cfg(p), mesh=p.mesh(2))
        be = p.plane.PlaneBackend(skv)
        assert be.warmup(32) > 0
        s = skv.stats()
        assert s["gets"] == 0 and s["puts"] == 0, s
        keys = _keys(100, seed=9)
        be.put(keys, _pages(keys))
        out, found = be.get(keys)
        assert found.all()
        np.testing.assert_array_equal(out, _pages(keys))
        st = be.stats()
        assert st["shard_report"]["n_shards"] == 2
        ops = [be._tele.get(f"shard{i}_ops", 0) for i in range(2)]
        assert sum(ops) > 0
        return counters(s), out, st["shard_report"], ops
    twin(drill)


def test_plane_counting_path_still_migrates_tier():
    def drill(p):
        cfg = _cfg(p, capacity=1 << 9, tier=dict(
            ghost_rows=32, promote_touches=1, max_promotes_per_batch=32))
        skv = p.shard.ShardedKV(cfg, mesh=p.mesh(2))
        keys = _keys(64, seed=13)
        skv.plane_insert(keys, _pages(keys)).fetch()
        outs = []
        for _ in range(4):
            g = skv.plane_get(keys).fetch()
            assert g.found.all()
            outs.append(g.dense())
        t = skv.tier_stats()
        assert t is not None and t["promotions"] > 0, t
        return outs, t, _report(skv)
    twin(drill)


# --- 3. the serving drill --------------------------------------------------


def _serve_workload(p, backend_factory, coalesced=True):
    """The drill's seeded mixed workload through package `p`'s NetServer
    -> the result transcript."""
    srv = p.net.NetServer(backend_factory,
                          net=p.conf.NetConfig(flush_timeout_us=5000,
                                               settle_us=200)
                          if coalesced else None,
                          serialize_ops=not coalesced).start()
    results = []
    try:
        with p.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                              keepalive_s=None, pipeline=coalesced) as be:
            rng = np.random.default_rng(77)
            universe = _keys(256, seed=77)
            for _ in range(100):
                op = int(rng.integers(5))
                lo = int(rng.integers(0, 240))
                n = int(rng.integers(1, 16))
                sel = universe[lo:lo + n]
                if op == 0:
                    be.put(sel, _pages(sel))
                    results.append(("put", n))
                elif op in (1, 2):
                    out, found = be.get(sel)
                    results.append(("get", found.tolist(),
                                    out[found].tolist()))
                elif op == 3:
                    results.append(("inval", be.invalidate(sel).tolist()))
                else:
                    vals, ef = be.get_extent(sel)
                    results.append(("gext", ef.tolist(),
                                    vals[ef].tolist()))
            be.insert_extent(np.array([3, 0], np.uint32),
                             np.array([0, 4096], np.uint32), 32)
            vals, ef = be.get_extent(np.array([[3, 5], [3, 40]], np.uint32))
            results.append(("ext", ef.tolist(), vals.tolist()))
    finally:
        stop(srv)
    return results


# slow in JAX: phase 8 serves the single-device wire and phase 10 the
# 4-shard plane behind the coalescing NetServer, every hit byte-exact
def test_mesh_plane_bit_identical_to_single_device_serving():
    def drill(p):
        plane = p.plane.make_serving_backend(_cfg(p),
                                             p.conf.MeshConfig(n_shards=4))
        single = p.backends.DirectBackend(p.KV(_cfg(p)))
        got = _serve_workload(p, lambda: plane)
        want = _serve_workload(p, lambda: single)
        assert got == want, "mesh plane diverged from the single device"
        return got
    twin(drill)


def test_mesh_off_kill_switch_is_conformant(monkeypatch):
    def drill(p):
        monkeypatch.setenv("PMDFC_MESH", "off")
        off = p.plane.make_serving_backend(
            _cfg(p), p.conf.MeshConfig(n_shards=4), **p.server_kw)
        assert isinstance(off, p.backends.DirectBackend)
        got_off = _serve_workload(p, lambda: off)
        monkeypatch.delenv("PMDFC_MESH")
        on = p.plane.make_serving_backend(
            _cfg(p), p.conf.MeshConfig(n_shards=4), **p.server_kw)
        assert isinstance(on, p.plane.PlaneBackend)
        got_on = _serve_workload(p, lambda: on)
        assert got_off == got_on, "kill switch is not conformant"
        return got_on
    twin(drill)


def test_kvserver_mesh_mode_serves_engine_verbs():
    def drill(p):
        cfg = _cfg(p)
        keys = _keys(128, seed=21)
        pages = _pages(keys)
        srv = p.runtime.KVServer(
            cfg, engine=p.runtime.Engine(page_bytes=W * 4),
            mesh=p.conf.MeshConfig(n_shards=4, pad_floor=16),
            **p.server_kw)
        assert srv._plane is not None and srv.kv.n_shards == 4
        assert srv.kv._router.pad_floor == 16
        srv.warmup(256)
        with srv.start():
            eb = p.EngineBackend(srv, timeout_us=60_000_000)
            eb.put(keys, pages)
            out, found = eb.get(keys)
            assert found.all()
            np.testing.assert_array_equal(out, pages)
            inval = eb.invalidate(keys[:16])
            assert inval.all()
            _, f2 = eb.get(keys[:16])
            assert not f2.any()
            assert eb.insert_extent(np.array([9, 0], np.uint32),
                                    np.array([0, 4096], np.uint32), 8) == 0
            vals, fe = eb.get_extent(np.array([[9, 2]], np.uint32))
            assert fe[0]
            h = srv.health()
            assert h["kv"]["hits"] >= 128
            eb.close()
        return (out, found, inval, f2, vals, fe,
                {k: h["kv"][k] for k in ("puts", "gets", "hits", "misses",
                                         "deletes")})
    twin(drill)


def test_kvserver_mesh_respects_kill_switch(monkeypatch):
    def drill(p):
        monkeypatch.setenv("PMDFC_MESH", "off")
        srv = p.runtime.KVServer(_cfg(p), mesh=4, **p.server_kw)
        assert srv._plane is None
        srv.engine.close()
        return type(srv.kv).__name__
    twin(drill)


# --- 4. reshard restore ----------------------------------------------------


def _snap(p, tmp_path, src) -> str:
    d = tmp_path / p.name
    d.mkdir(exist_ok=True)
    path = str(d / "snap.ckpt")
    src.save(path)
    return path


# (2, 3) and (8, 4) slow in JAX: the card reshards 4 -> 8 (phase 10),
# 2 -> 4 (phase 12 (a)) and 4 -> 2 (phase 16); no phase reshards 2 -> 3 or
# 8 -> 4 (ROADMAP Queue 1)
@pytest.mark.parametrize("n_from,n_to", [(4, 2), (2, 3), (8, 4)],
                         ids=["4-2", "2-3", "8-4"])
def test_reshard_restore_loses_nothing(tmp_path, n_from, n_to):
    def drill(p):
        cfg = _cfg(p)
        keys = _keys(400, seed=31)
        pages = _pages(keys)
        src = p.shard.ShardedKV(cfg, mesh=p.mesh(n_from))
        src.plane_insert(keys, pages).fetch()
        assert _a(src.plane_delete(keys[:50]).fetch()).all()
        src.insert_extent(np.array([5, 0], np.uint32),
                          np.array([0, 8192], np.uint32), 16)
        stats_before = src.stats()
        path = _snap(p, tmp_path, src)
        dst = p.shard.ShardedKV(cfg, mesh=p.mesh(n_to))
        dst.restore(path)
        g = dst.plane_get(keys[50:]).fetch()
        assert g.found.all(), f"{int((~g.found).sum())} live pages lost"
        np.testing.assert_array_equal(g.dense(), pages[50:])
        gdel = dst.plane_get(keys[:50]).fetch()
        assert not gdel.found.any(), "deleted keys resurrected"
        vals, ef = dst.get_extent(np.array([[5, 7]], np.uint32))
        assert ef[0]
        after = dst.stats()
        for k in ("puts", "deletes", "extent_puts"):
            assert after[k] == stats_before[k], (k, after, stats_before)
        return g.dense(), gdel.found, _a(vals), _report(dst)
    twin(drill)


# slow in JAX: no phase on the card reshards an unpaged plane (ROADMAP
# Queue 1)
def test_unpaged_reshard_keeps_values_and_extents(tmp_path):
    def drill(p):
        cfg = _cfg(p, paged=False)
        src = p.shard.ShardedKV(cfg, mesh=p.mesh(4))
        keys = _keys(128, seed=47)
        vals = np.stack([keys[:, 0] ^ 7, keys[:, 1] + 1],
                        -1).astype(np.uint32)
        src.plane_insert(keys, vals).fetch()
        src.insert_extent(np.array([11, 0], np.uint32),
                          np.array([0, 4096], np.uint32), 16)
        path = _snap(p, tmp_path, src)
        dst = p.shard.ShardedKV(cfg, mesh=p.mesh(2))
        dst.restore(path)
        g = dst.plane_get(keys).fetch()
        assert g.found.all()
        np.testing.assert_array_equal(g.dense(), vals)
        evals, ef = dst.get_extent(np.array([[11, 9]], np.uint32))
        assert ef[0]
        return g.dense(), _a(evals), _report(dst)
    twin(drill)


# slow in JAX: phase 18 (b) restores a tiered KV's snapshot, but no phase
# reshards a tiered plane (ROADMAP Queue 1)
def test_tiered_reshard_drops_only_stale(tmp_path):
    def drill(p):
        cfg = _cfg(p, capacity=1 << 9, tier=dict(ghost_rows=32))
        src = p.shard.ShardedKV(cfg, mesh=p.mesh(2))
        keys = _keys(96, seed=43)
        pages = _pages(keys)
        src.plane_insert(keys, pages).fetch()
        path = _snap(p, tmp_path, src)
        dst = p.shard.ShardedKV(cfg, mesh=p.mesh(4))
        dst.restore(path)
        g = dst.plane_get(keys).fetch()
        assert g.found.all()
        np.testing.assert_array_equal(g.dense(), pages)
        return g.dense(), dst.tier_stats(), _report(dst)
    twin(drill)
