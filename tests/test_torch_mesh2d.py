"""PyTorch port: the 2-D serving plane (replica lanes) against the JAX one.

- Rules with their replicated markers, and the construction gates.
- Hedged reads around a corrupt lane: the first lane whose row passes its
  digest serves, per-lane attribution and `misses == Σ causes` exact;
  results, stats, per-shard stats rows and every lane's leaves equal the
  JAX plane's (the JAX lanes read from their device buffers).
- `replica_repair` attribution, read-only and counting GETs on 2-D.
- `MSG_RREPAIR` over the port's wire: the `TcpBackend` negotiates
  `replica_lanes == 2` with a port `NetServer` over a 2-D plane.
- A `ReplicaGroup` delegating to two port 2-D planes (`fused_delegated`
  counts every key, each key lands on one server); `fused_plane=False`
  keeps the host loops.
"""

from __future__ import annotations

import socket

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.client.replica import ReplicaGroup
from pmdfc_tpu_torch.config import NetConfig, ReplicaConfig
from pmdfc_tpu_torch.parallel import partitioning as tpt
from pmdfc_tpu_torch.parallel import plane as tplane
from pmdfc_tpu_torch.parallel import shard as tshard
from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

from test_torch_shard import (cfg_pair, check_stats, jax_lane_leaves,
                              keys_of, pages_of, pair, port_grid, same)
from pmdfc_tpu_torch import carry

pytestmark = pytest.mark.torch

W = 16


def _stop(srv):
    try:
        srv._lsock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.stop()


def _cause_sum(stats):
    return sum(int(stats[c]) for c in tkv.MISS_CAUSE_NAMES)


def _check_lanes(a, b, what):
    la = jax_lane_leaves(a.state, a.n_shards, a.n_replicas)
    lb = carry.sharded_to_numpy(b._st, lanes=True)
    assert sorted(la) == sorted(lb)
    for k in la:
        same(la[k], lb[k], f"{what} lane leaf {k}")


def test_mesh2d_rules_and_construction_gates():
    g1, g2 = port_grid(2), port_grid(2, lanes=2)
    tpt.validate_rules(tpt.MESH2D_AXIS_RULES, g2)
    with pytest.raises(ValueError, match="names a mesh axis"):
        tpt.validate_rules(tpt.MESH2D_AXIS_RULES, g1)
    _, tcfg = cfg_pair()
    for cfg in (tcfg, cfg_pair(bloom_bits=0)[1],
                cfg_pair(paged=False, page_words=1024)[1]):
        for row in tpt.describe(cfg, tpt.MESH2D_AXIS_RULES):
            assert tpt.REPLICA_MESH_AXIS in row["replicated_along"], row
    with pytest.raises(ValueError, match="devices"):
        tshard.make_mesh2d(2, 2, ["cpu"] * 3)
    _, tiered = cfg_pair(capacity=512, tier=dict(ghost_rows=32))
    with pytest.raises(ValueError, match="tiered"):
        tshard.ShardedKV(tiered, mesh=g2)
    skv = tshard.ShardedKV(tcfg, mesh=g2)
    assert skv.n_shards == 2 and skv.n_replicas == 2
    # every lane its own allocation
    ptrs = {st.pool.pages.data_ptr() for row in skv._st for st in row}
    assert len(ptrs) == 4
    assert skv.fast_view() is None and skv.directory_snapshot() is None


def test_mesh2d_hedged_read_routes_around_corrupt_lane_like_jax():
    jcfg, tcfg = cfg_pair()
    a, b = pair(jcfg, tcfg, 2, lanes=2)
    keys = keys_of(256, seed=17)
    pages = pages_of(keys)
    for skv in (a, b):
        skv.plane_insert(keys, pages).fetch()

    def get_both(what):
        ga, gb = a.plane_get(keys).fetch(), b.plane_get(keys).fetch()
        same(ga.found, gb.found, f"{what} found")
        same(ga.dense(), gb.dense(), f"{what} pages")
        same(ga.lane_served, gb.lane_served, f"{what} served")
        same(ga.lane_refused, gb.lane_refused, f"{what} refused")
        assert a.replica_report() == b.replica_report()
        check_stats(a, b, what)
        _check_lanes(a, b, what)
        return gb

    for skv in (a, b):
        skv.corrupt_replica_lane(1)
    g = get_both("lane 1 corrupt")
    assert g.found.all()
    same(g.dense(), pages, "lane 0 serves")
    rep = b.replica_report()
    assert rep["served"] == [256, 0] and rep["digest_refused"][1] == 256
    assert a.replica_repair() == b.replica_repair() >= 256
    for skv in (a, b):
        skv.corrupt_replica_lane(0)
    g = get_both("lane 0 corrupt")
    assert g.found.all()
    same(g.dense(), pages, "lane 1 rescues")
    s = b.stats()
    assert s["misses"] == _cause_sum(s) == 0
    for skv in (a, b):
        skv.corrupt_replica_lane(1)
    g = get_both("both corrupt")
    assert not g.found.any() and not g.dense().any()
    s = b.stats()
    assert s["misses"] == _cause_sum(s) == 256 == s["miss_digest"]
    assert sum(b.shard_report()["stats"]["misses"]) == s["misses"]


def test_mesh2d_verbs_and_repair_attribution_match_jax():
    jcfg, tcfg = cfg_pair(kind="hotring", capacity=512)
    a, b = pair(jcfg, tcfg, 2, lanes=2)
    keys = keys_of(128, seed=19)
    for skv in (a, b):
        skv.plane_insert(keys, pages_of(keys)).fetch()
        skv.corrupt_replica_lane(1)
    # hotring: every GET is the counting path (canonical delta on every
    # lane's stats leaf)
    ga, gb = a.plane_get(keys).fetch(), b.plane_get(keys).fetch()
    same(ga.found, gb.found, "counting found")
    assert gb.found.all()
    same(a.plane_delete(keys[:16]).fetch(), b.plane_delete(keys[:16]).fetch(),
         "delete on every lane")
    assert a.replica_repair() == b.replica_repair() >= 112
    rep = b.replica_report()
    assert rep == a.replica_report()
    assert rep["repaired"][1] >= 112 and rep["repaired"][0] == 0
    a.insert_extent([5, 0], [0, 8192], 16)
    b.insert_extent([5, 0], [0, 8192], 16)
    ep = np.array([[5, 3], [6, 0]], np.uint32)
    for x, y in zip(a.plane_get_extent(ep).fetch(),
                    b.plane_get_extent(ep).fetch()):
        same(x, y, "2-D get_extent")
    # the host verbs run on every lane and answer with lane 0's
    for x, y in zip(a.get(keys), b.get(keys)):
        same(x, y, "2-D host get")
    check_stats(a, b, "2-D")
    _check_lanes(a, b, "2-D")
    assert b.replica_report()["digest_refused"][1] == 128


def _plane_server(lanes=2):
    _, tcfg = cfg_pair()
    be = tplane.PlaneBackend(tshard.ShardedKV(tcfg, mesh=port_grid(
        2, lanes=lanes)))
    srv = NetServer(lambda: be, net=NetConfig(flush_timeout_us=2000,
                                              settle_us=200)).start()
    return be, srv


def test_mesh2d_msg_rrepair_over_the_wire():
    be, srv = _plane_server()
    keys = keys_of(256, seed=23)
    pages = pages_of(keys)
    try:
        with TcpBackend("127.0.0.1", srv.port, page_words=W,
                        keepalive_s=None, window=8) as tb:
            assert tb.replica_lanes == 2
            tb.put(keys, pages)
            be.skv.corrupt_replica_lane(0)
            out, found = tb.get(keys)
            assert found.all()
            same(out, pages, "wire pages around a corrupt lane")
            rep = be.skv.replica_report()
            assert rep["digest_refused"][0] == 256 and rep["served"][1] == 256
            wire = tb.server_stats()
            s = be.skv.stats()
            assert wire["misses"] == _cause_sum(wire) == s["misses"]
            assert wire["replica"]["digest_refused"] == rep["digest_refused"]
            assert tb.replica_repair() >= 256
            out, found = tb.get(keys)
            assert found.all()
            same(out, pages, "wire pages after repair")
            assert be.skv.replica_report()["served"][0] == 256
    finally:
        _stop(srv)
    # a 1-D plane advertises no lanes
    be1, srv1 = _plane_server(lanes=1)
    try:
        with TcpBackend("127.0.0.1", srv1.port, page_words=W,
                        keepalive_s=None) as tb:
            assert tb.replica_lanes == 1 and tb.replica_repair() == 0
    finally:
        _stop(srv1)


def _fleet(n):
    planes, servers = zip(*[_plane_server() for _ in range(n)])
    eps = [TcpBackend("127.0.0.1", s.port, page_words=W, keepalive_s=None)
           for s in servers]
    return planes, servers, eps


@pytest.mark.parametrize("fused", [True, False])
def test_replica_group_delegates_to_port_2d_planes(fused):
    planes, servers, eps = _fleet(2)
    g = ReplicaGroup(eps, page_words=W, cfg=ReplicaConfig(
        n_replicas=2, rf=2, repair_interval_s=0, fused_plane=fused))
    try:
        keys = keys_of(96, seed=31)
        pages = pages_of(keys)
        g.put(keys, pages)
        c = dict(g.counters)
        per = [int(p.skv.stats()["puts"]) for p in planes]
        if fused:
            assert c["fused_delegated"] >= 96
            # each key landed on exactly ONE server: the device lanes
            # carry the rf
            assert sum(per) == 96 and all(x > 0 for x in per), per
        else:
            assert c["fused_delegated"] == 0
            assert per == [96, 96], per
        out, found = g.get(keys)
        assert found.all()
        same(out, pages, "group pages")
        if fused:
            assert dict(g.counters)["hedges_fired"] == 0
    finally:
        g.close()
        for s in servers:
            _stop(s)
