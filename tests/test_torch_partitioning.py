"""PyTorch port: the partitioning tables, the routing hash and the host
router against the JAX package's.

Every leaf of every one of the nine index families, over the flat pool,
the tiered pool (with the admission gate) and unpaged, gets the same
logical axes, split and replicated-along markers from both packages'
`describe()`; the rules refuse what the JAX rules refuse; the owners of
`shard_of` (torch) and `shard_of_np` equal the JAX device hash's; and the
router bins, pads and scatters exactly as the JAX router does.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

from pmdfc_tpu.parallel import partitioning as jpt
from pmdfc_tpu.utils.hashing import shard_of as jshard_of
from pmdfc_tpu_torch.parallel import partitioning as tpt
from pmdfc_tpu_torch.parallel import shard as tshard
from pmdfc_tpu_torch.utils.hashing import shard_of as tshard_of

from test_torch_shard import cfg_pair, jax_grid, keys_of, port_grid, same

pytestmark = pytest.mark.torch

KINDS = ("linear", "cceh", "extendible", "cuckoo", "ccp", "level", "path",
         "static", "hotring")
POOLS = {
    "flat": dict(),
    "tiered": dict(tier=dict(ghost_rows=32, admit=dict())),
    "unpaged": dict(paged=False, page_words=1024),
}


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("kind", KINDS)
def test_describe_matches_jax_for_every_leaf(kind, pool):
    jcfg, tcfg = cfg_pair(kind=kind, capacity=1 << 10, **POOLS[pool])
    for jrules, trules in ((jpt.DEFAULT_AXIS_RULES, tpt.DEFAULT_AXIS_RULES),
                           (jpt.MESH2D_AXIS_RULES, tpt.MESH2D_AXIS_RULES)):
        ja, ta = jpt.describe(jcfg, jrules), tpt.describe(tcfg, trules)
        assert [r["leaf"] for r in ja] == [r["leaf"] for r in ta]
        for jr, tr in zip(ja, ta):
            assert tuple(jr["shape"]) == tr["shape"], jr["leaf"]
            assert jr["axes"] == tr["axes"], jr["leaf"]
            assert tuple(jpt.spec_for(jr["axes"], jrules)) == tr["spec"]
            assert jr["replicated_along"] == tr["replicated_along"]
            # every leaf splits over the shard axis and, on a 2-D grid,
            # is marked replicated along the lanes
            assert tr["spec"][0] == tpt.MESH_AXIS
            assert tpt.REPLICA_MESH_AXIS in tr["replicated_along"]
        place = tpt.placement(tcfg, trules)
        assert sorted(place) == sorted(r["leaf"] for r in ta)
        assert all(p["spec"] == (tpt.MESH_AXIS,) for p in place.values())


def test_rules_tables_equal_jax():
    assert tpt.DEFAULT_AXIS_RULES == jpt.DEFAULT_AXIS_RULES
    assert tpt.MESH2D_AXIS_RULES == jpt.MESH2D_AXIS_RULES
    assert tpt._PATH_AXES == jpt._PATH_AXES
    assert tpt._PATH_REPLICATED == jpt._PATH_REPLICATED
    assert tpt.resolve_rules((("x", None),)) == jpt.resolve_rules(
        (("x", None),))
    assert tuple(jpt.spec_for((jpt.SHARD, jpt.REPLICA_LANE),
                              jpt.MESH2D_AXIS_RULES)) == tpt.spec_for(
        (tpt.SHARD, tpt.REPLICA_LANE), tpt.MESH2D_AXIS_RULES) == (
        "kv", "replica")


def test_rules_refuse_what_jax_refuses():
    g1, g2 = port_grid(2), port_grid(2, lanes=2)
    j1, j2 = jax_grid(2), jax_grid(2, lanes=2)
    tpt.validate_rules(tpt.DEFAULT_AXIS_RULES, g1)
    tpt.validate_rules(tpt.MESH2D_AXIS_RULES, g2)
    assert tpt.rules_for_mesh(g2) == tpt.MESH2D_AXIS_RULES
    assert tpt.rules_for_mesh(g1) == tpt.DEFAULT_AXIS_RULES
    for jrules, trules, jg, tg in (
            ((("shard", "model"),), (("shard", "model"),), j1, g1),
            (jpt.MESH2D_AXIS_RULES, tpt.MESH2D_AXIS_RULES, j1, g1)):
        with pytest.raises(ValueError, match="names a mesh axis") as je:
            jpt.validate_rules(jrules, jg)
        with pytest.raises(ValueError, match="names a mesh axis") as te:
            tpt.validate_rules(trules, tg)
        assert str(je.value) == str(te.value)
    for fn in ("leaf_axes", "replicated_along"):
        args = (".nonsense.leaf", 1) if fn == "leaf_axes" else (
            ".nonsense.leaf",)
        with pytest.raises(ValueError) as je:
            getattr(jpt, fn)(*args)
        with pytest.raises(ValueError) as te:
            getattr(tpt, fn)(*args)
        assert str(je.value) == str(te.value)
    jcfg, tcfg = cfg_pair()
    with pytest.raises(ValueError, match="names a mesh axis"):
        tshard.ShardedKV(tcfg, mesh=g1, axis_rules=(("page_word", "nope"),))
    # the port keeps one whole leaf per shard: a rule splitting a
    # trailing axis over a grid axis is refused at construction
    with pytest.raises(ValueError, match="one whole leaf per shard"):
        tshard.ShardedKV(tcfg, mesh=g1, axis_rules=(("page_word", "kv"),))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_shard_owners_equal_the_jax_hash(n):
    keys = keys_of(4096, seed=n)
    keys[::7, 0] |= 0x80000000                          # hi >= 2^31
    keys[::97] = 0xFFFFFFFF                             # INVALID keys
    want = np.asarray(jshard_of(jnp.asarray(keys), n))
    same(tpt.shard_of_np(keys, n), want, "shard_of_np")
    got = tshard_of(torch.from_numpy(keys.view(np.int32)), n)
    same(got.numpy().astype(np.uint32), want, "shard_of")
    assert tpt.shard_of_np(keys, n).dtype == want.dtype


@pytest.mark.parametrize("n,floor", [(1, 8), (3, 8), (4, 16), (8, 8)])
def test_router_bins_and_scatters_like_jax(n, floor):
    keys = keys_of(500, seed=3)
    keys[::50] = keys[1::50]                            # duplicates
    vals = np.arange(500 * 4, dtype=np.uint32).reshape(500, 4)
    jr, tr = jpt.ShardRouter(n, pad_floor=floor), tpt.ShardRouter(
        n, pad_floor=floor)
    for v in (None, vals):
        ja, ta = jr.build(keys, v), tr.build(keys, v)
        for f in ("keys", "values", "pos", "counts"):
            x, y = getattr(ja, f), getattr(ta, f)
            assert (x is None) == (y is None)
            if x is not None:
                same(x, y, f"router {f}")
                assert x.dtype == y.dtype
        assert (ja.wl, ja.b) == (ta.wl, ta.b)
        # loss-free, stable within a shard, scatter round-trips
        assert len(np.unique(ta.pos)) == 500 and ta.counts.sum() == 500
        same(ta.scatter(ta.keys), keys, "scatter keys")
        own = tr.owners(keys)
        for s in range(n):
            assert (np.diff(ta.pos[own == s]) > 0).all()
    empty = tr.build(np.zeros((0, 2), np.uint32))
    assert empty.b == 0 and empty.wl == floor
    for bad in (0, 3):
        with pytest.raises(ValueError):
            tpt.ShardRouter(2, pad_floor=bad)
