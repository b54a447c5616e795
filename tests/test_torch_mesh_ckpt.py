"""PyTorch port: sharded snapshots, chains and reshard restores across the
two packages, and `carry`'s stacked states.

- A JAX `ShardedKV.save` (full, then a delta chain) restores in the port
  and the reverse, bit for bit: the two packages' files hold the same
  leaves and manifests, and the restored planes hold the same leaves.
- The reshard twins of `test_reshard_restore_loses_nothing` (4 -> 2,
  2 -> 3, 8 -> 4) and of its unpaged and tiered siblings: zero live
  pages lost, deleted keys stay deleted, extents replayed, counters
  carried; restored from the same file, the JAX and the port planes end
  with equal leaves.
- The config-mismatch refusal, with JAX's message, leaving the live
  plane's accounting alone.
- `carry` takes a stacked JAX state into a port grid and back, bit for
  bit, on a 1-D and a 2-D grid.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch.parallel import shard as tshard

from test_torch_shard import (cfg_pair, check_leaves, check_stats,
                              jax_grid, jax_lane_leaves, jax_leaves, keys_of,
                              pages_of, pair, port_grid, same)
from pmdfc_tpu.parallel import shard as jshard

pytestmark = pytest.mark.torch


def _file(path):
    """(meta without the random chain id, leaves, manifest) of one file."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("chain"):
            meta["chain"] = {k: v for k, v in meta["chain"].items()
                             if k not in ("id", "prev_crc")}
        names = [k for k in z.files if k.startswith("leaf_")
                 or k.startswith("__delta")]
        return meta, {k: z[k] for k in names}, z["__integrity__"]


def _same_files(pa, pb):
    ma, la, xa = _file(pa)
    mb, lb, xb = _file(pb)
    assert ma == mb
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        same(la[k], lb[k], f"file member {k}")
    same(xa, xb, "manifest")


def _drive(a, b, seed):
    keys = keys_of(200, seed=seed)
    for skv in (a, b):
        skv.plane_insert(keys, pages_of(keys)).fetch()
        skv.plane_get(keys[:150]).fetch()
        skv.plane_delete(keys[:20]).fetch()
    return keys


def test_sharded_snapshots_and_chains_cross_both_ways(tmp_path):
    jcfg, tcfg = cfg_pair()
    a, b = pair(jcfg, tcfg, 4)
    _drive(a, b, 1)
    a.insert_extent([5, 0], [0, 8192], 16)
    b.insert_extent([5, 0], [0, 8192], 16)
    paths = {}
    for tag in ("full", "d1", "d2"):
        pa, pb = str(tmp_path / f"j_{tag}.npz"), str(tmp_path / f"t_{tag}.npz")
        ra, rb = a.save(pa, delta=tag != "full"), b.save(pb,
                                                         delta=tag != "full")
        assert ra["kind"] == rb["kind"] == ("full" if tag == "full"
                                            else "delta")
        assert ra["dirty_rows"] == rb["dirty_rows"]
        _same_files(pa, pb)
        paths[tag] = (pa, pb)
        _drive(a, b, {"full": 2, "d1": 3, "d2": 4}[tag])
    # a full each way
    for src, into in ((0, "port"), (1, "jax")):
        path = paths["full"][src]
        ja, tb = pair(jcfg, tcfg, 4)
        ja.restore(path)
        tb.restore(path)
        check_leaves(ja, tb, f"full into {into}")
        check_stats(ja, tb, f"full into {into}")
    # the chains each way; the restored port plane resumes its chain
    for src in (0, 1):
        chain = [paths[t][src] for t in ("d2", "full", "d1")]
        ja, tb = pair(jcfg, tcfg, 4)
        ja.restore_chain(chain)
        tb.restore_chain(chain)
        check_leaves(ja, tb, "chain")
        check_stats(ja, tb, "chain")
        assert tb._chain is not None and tb._chain["seq"] == 2
        keys = keys_of(200, seed=4)
        ga, gb = ja.plane_get(keys).fetch(), tb.plane_get(keys).fetch()
        same(ga.found, gb.found, "chain found")
        same(ga.dense(), gb.dense(), "chain pages")
        assert tb.save(str(tmp_path / f"next{src}.npz"),
                       delta=True)["kind"] == "delta"


POOLS = {"flat": dict(), "unpaged": dict(paged=False, page_words=1024),
         "tiered": dict(capacity=512, tier=dict(ghost_rows=32))}


@pytest.mark.parametrize("n_from,n_to,pool", [
    (4, 2, "flat"), (2, 3, "flat"), (8, 4, "flat"), (4, 2, "unpaged"),
    (2, 4, "tiered")])
def test_reshard_restore_loses_nothing_like_jax(tmp_path, n_from, n_to,
                                                pool):
    """The twins of `test_reshard_restore_loses_nothing` (flat) and of
    `test_unpaged_reshard_keeps_values_and_extents` and
    `test_tiered_reshard_drops_only_stale` (unpaged values and extents
    replayed, tiered pages replayed)."""
    jcfg, tcfg = cfg_pair(**POOLS[pool])
    keys = keys_of(400, seed=31)
    pages = (pages_of(keys) if tcfg.paged else np.stack(
        [keys[:, 0] ^ 7, keys[:, 1] + 1], -1).astype(np.uint32))
    src = tshard.ShardedKV(tcfg, mesh=port_grid(n_from))
    src.plane_insert(keys, pages).fetch()
    assert src.plane_delete(keys[:50]).fetch().all()
    src.insert_extent(np.array([5, 0], np.uint32),
                      np.array([0, 8192], np.uint32), 16)
    stats_before = src.stats()
    path = str(tmp_path / "snap.npz")
    src.save(path)
    ja, tb = pair(jcfg, tcfg, n_to)
    ja.restore(path)
    tb.restore(path)
    check_leaves(ja, tb, "resharded")
    check_stats(ja, tb, "resharded")
    g = tb.plane_get(keys[50:]).fetch()
    assert g.found.all(), f"{int((~g.found).sum())} live pages lost"
    same(g.dense(), pages[50:], "resharded pages")
    assert not tb.plane_get(keys[:50]).fetch().found.any(), \
        "deleted keys resurrected"
    _, ef = tb.get_extent(np.array([[5, 7]], np.uint32))
    assert ef[0]
    after = tb.stats()
    for k in ("puts", "deletes", "extent_puts"):
        assert after[k] == stats_before[k], (k, after, stats_before)
    assert after["drops"] == 0
    assert tb._chain is None


def test_reshard_restore_rejects_mismatched_config(tmp_path):
    jsmall, tsmall = cfg_pair(capacity=1 << 10)
    jbig, tbig = cfg_pair(capacity=1 << 11)
    src = tshard.ShardedKV(tsmall, mesh=port_grid(2))
    keys = keys_of(32, seed=41)
    src.plane_insert(keys, pages_of(keys)).fetch()
    path = str(tmp_path / "snap.npz")
    src.save(path)
    ja, tb = pair(jbig, tbig, 4)
    for skv in (ja, tb):
        skv.plane_insert(keys, pages_of(keys)).fetch()
        assert skv.plane_get(keys).fetch().found.all()
    before = tb.stats()
    with pytest.raises(ValueError, match="per-shard KVConfig") as je:
        ja.restore(path)
    with pytest.raises(ValueError, match="per-shard KVConfig") as te:
        tb.restore(path)
    assert str(je.value) == str(te.value)
    assert tb.stats() == before


def test_carry_round_trips_a_stacked_jax_state():
    jcfg, tcfg = cfg_pair(capacity=512)
    keys = keys_of(200, seed=5)
    # 1-D: the JAX plane's stacked leaves into a port grid and back
    a = jshard.ShardedKV(jcfg, mesh=jax_grid(4))
    a.plane_insert(keys, pages_of(keys)).fetch()
    a.insert_extent([5, 0], [0, 8192], 16)
    leaves = jax_leaves(a.state)
    states = carry.sharded_from_numpy(leaves, tcfg, port_grid(4))
    back = carry.sharded_to_numpy(states)
    assert sorted(back) == sorted(leaves)
    for k in leaves:
        assert back[k].dtype == leaves[k].dtype
        same(back[k], leaves[k], f"1-D {k}")
    # the carried state serves as the JAX plane does
    b = tshard.ShardedKV(tcfg, mesh=port_grid(4), states=states)
    ga, gb = a.plane_get(keys).fetch(), b.plane_get(keys).fetch()
    same(ga.found, gb.found, "carried found")
    same(ga.dense(), gb.dense(), "carried pages")
    # 2-D: each replica lane its own copy, one lane damaged
    a2 = jshard.ShardedKV(jcfg, mesh=jshard.make_mesh2d(2, 2))
    a2.plane_insert(keys, pages_of(keys)).fetch()
    a2.corrupt_replica_lane(1)
    lanes = jax_lane_leaves(a2.state, 2, 2)
    assert not np.array_equal(lanes["pool.pages"][:, 0],
                              lanes["pool.pages"][:, 1])
    states2 = carry.sharded_from_numpy(lanes, tcfg, port_grid(2, lanes=2))
    back2 = carry.sharded_to_numpy(states2, lanes=True)
    for k in lanes:
        same(back2[k], lanes[k], f"2-D {k}")
    # lanes never share storage
    p = [[st.pool.pages for st in row] for row in states2]
    assert p[0][0].data_ptr() != p[0][1].data_ptr()
