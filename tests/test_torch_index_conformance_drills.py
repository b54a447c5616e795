"""PyTorch port: `tests/test_index_conformance.py`'s drills, one by one, on
both packages, over all nine index families.

`tests/test_torch_conformance.py` holds the IHash contract against the
port alone. Here each test carries the name of the JAX drill it twins and
runs the drill's batches through `pmdfc_tpu.models` (or `pmdfc_tpu.kv.KV`)
and the port's (`device="cpu"`) for every `IndexKind`: both are held to
the drill's own asserts, and what each returns must be equal (tolerance
0: integer arithmetic): every insert's slots, `fresh` flags, evicted keys
and their values and drops, every GET's values, found mask and slots
(last-wins resolution among them), every delete's hits and old values,
the scan, the final index leaves, and for the paged `KV` drill the pages,
stats and every state leaf, the pool's free rows among them. The last
four drills (the paged `KV`, HotRing's two, the lean GET) are in
`tests/test_torch_index_conformance_kv_drills.py`, which shares this
file's namespaces and helpers, so that no one worker carries all ten.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import bits, same, walk_in_reverse

from pmdfc_tpu import config as jconf
from pmdfc_tpu import kv as jkv
from pmdfc_tpu.models.base import get_index_ops as jops
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import config as tconf
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.models.base import get_index_ops as tops
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch
# the drills replay `test_index_conformance.py`'s own JAX programs: compiled
# as the suite compiles them, each file finds the other's in the persistent
# cache
KEEP_XLA_DEFAULTS = True

KINDS = [k.value for k in jconf.IndexKind]
INV = 0xFFFFFFFF


def _res(r) -> dict:
    return {f: bits(getattr(r, f)) for f in r._fields}


def _jax_leaves(st) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(st)
    return {".".join(getattr(k, "name", str(k)) for k in path): bits(v)
            for path, v in flat}


def _port_leaves(st) -> dict:
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = bits(v)
    return out


JAX = types.SimpleNamespace(
    conf=jconf, ops=lambda kind: jops(jconf.IndexKind(kind)),
    init=lambda ops, cfg: ops.init(cfg), arr=lambda a: np.asarray(a),
    index_leaves=_jax_leaves, KV=jkv.KV, utilization=jkv.utilization,
    kv_leaves=lambda kv: {".".join(k.name for k in p): np.asarray(v)
                          for p, v in jax.tree_util.tree_flatten_with_path(
                              kv.state)[0]})
PORT = types.SimpleNamespace(
    conf=tconf, ops=lambda kind: tops(tconf.IndexKind(kind)),
    init=lambda ops, cfg: ops.init(cfg, device="cpu"),
    arr=lambda a: u32.from_numpy(np.asarray(a, np.uint32), "cpu"),
    index_leaves=_port_leaves, KV=lambda cfg: tkv.KV(cfg, device="cpu"),
    utilization=tkv.utilization,
    kv_leaves=lambda kv: carry.state_to_numpy(kv.state))


def twin(drill, *args):
    a, b = drill(JAX, *args), drill(PORT, *args)
    same(a, b, drill.__name__)
    return b


def make_cfg(p, kind, capacity=1 << 12):
    kw = {}
    if kind in ("cceh", "extendible"):
        kw = dict(segment_slots=128, split_headroom=2)
    return p.conf.IndexConfig(kind=p.conf.IndexKind(kind), capacity=capacity,
                              **kw)


def keys_of(lo, hi=1):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.full_like(lo, hi), lo], axis=-1)


def vals_of(lo):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.zeros_like(lo), lo], axis=-1)


def _insert(p, ops, st, keys, vals):
    st, res = ops.insert_batch(st, p.arr(keys), p.arr(vals))
    return st, _res(res)


def _get(p, ops, st, keys):
    return _res(ops.get_batch(st, p.arr(keys)))


def _delete(p, ops, st, keys):
    st, hit, old = ops.delete_batch(st, p.arr(keys))
    return st, bits(hit), bits(old)


@pytest.fixture(params=KINDS)
def kind(request):
    return request.param


def test_roundtrip_and_update(kind):
    def drill(p, kind):
        ops = p.ops(kind)
        st = p.init(ops, make_cfg(p, kind))
        ks = keys_of(np.arange(100))
        st, res = _insert(p, ops, st, ks, vals_of(np.arange(100) * 2))
        assert not res["dropped"].any()
        got = _get(p, ops, st, ks)
        assert got["found"].all()
        np.testing.assert_array_equal(got["values"][:, 1],
                                      np.arange(100) * 2)
        st, res2 = _insert(p, ops, st, ks[:10], vals_of(np.arange(10) + 500))
        assert not res2["fresh"].any()
        got2 = _get(p, ops, st, ks[:10])
        np.testing.assert_array_equal(got2["values"][:, 1],
                                      np.arange(10) + 500)
        return res, got, res2, got2, p.index_leaves(st)
    twin(drill, kind)


def test_delete_returns_old_value(kind):
    def drill(p, kind):
        ops = p.ops(kind)
        st = p.init(ops, make_cfg(p, kind))
        ks = keys_of([11, 22, 33])
        st, res = _insert(p, ops, st, ks, vals_of([1, 2, 3]))
        st, hit, old = _delete(p, ops, st, ks[:2])
        np.testing.assert_array_equal(hit, [True, True])
        np.testing.assert_array_equal(old[:, 1], [1, 2])
        got = _get(p, ops, st, ks)
        np.testing.assert_array_equal(got["found"], [False, False, True])
        st, hit2, old2 = _delete(p, ops, st, keys_of([99]))
        assert not hit2.any()
        return res, hit, old, got, hit2, old2, p.index_leaves(st)
    twin(drill, kind)


def test_duplicates_last_wins(kind):
    def drill(p, kind):
        ops = p.ops(kind)
        st = p.init(ops, make_cfg(p, kind))
        ks = keys_of([5, 5, 5])
        st, res = _insert(p, ops, st, ks, vals_of([1, 2, 3]))
        got = _get(p, ops, st, ks[:1])
        assert int(got["values"][0, 1]) == 3
        assert int((res["slots"] != INV).sum()) == 1
        return res, got, p.index_leaves(st)
    twin(drill, kind)


def test_clean_cache_accounting_under_pressure(kind):
    def drill(p, kind):
        ops = p.ops(kind)
        cfg = make_cfg(p, kind, capacity=1 << 8)
        st = p.init(ops, cfg)
        n = ops.num_slots(cfg) * 3
        rng = np.random.default_rng(17)
        lo = rng.choice(1 << 24, size=n, replace=False)
        ks = keys_of(lo)
        ev = drop = 0
        results = []
        for i in range(0, n, 256):
            st, res = _insert(p, ops, st, ks[i:i + 256],
                              vals_of(lo[i:i + 256]))
            evm = (res["evicted"] != INV).all(-1)
            ev += int(evm.sum())
            drop += int(res["dropped"].sum())
            evv = res["evicted_vals"][evm]
            if len(evv):
                assert (evv != INV).all()
            results.append(res)
        got = _get(p, ops, st, ks)
        found = got["found"]
        assert int((~found).sum()) <= ev + drop
        np.testing.assert_array_equal(got["values"][found, 1], lo[found])
        return results, got, p.index_leaves(st)
    twin(drill, kind)


def test_padding_keys_are_noops(kind):
    def drill(p, kind):
        ops = p.ops(kind)
        st = p.init(ops, make_cfg(p, kind))
        before = p.index_leaves(st)
        pad = np.full((8, 2), INV, np.uint32)
        st, res = _insert(p, ops, st, pad, np.zeros((8, 2), np.uint32))
        assert (res["slots"] == INV).all()  # -1
        got = _get(p, ops, st, pad)
        assert not got["found"].any()
        st, hit, old = _delete(p, ops, st, pad)
        assert not hit.any()
        same(before, p.index_leaves(st), "padding changed the index")
        return res, got, hit, old
    twin(drill, kind)


def test_scan_powers_find_anyway(kind):
    def drill(p, kind):
        ops = p.ops(kind)
        st = p.init(ops, make_cfg(p, kind))
        ks = keys_of([7])
        st, res = _insert(p, ops, st, ks, vals_of([42]))
        fk, fv = (bits(a) for a in ops.scan(st))
        where = (fk[:, 0] == ks[0, 0]) & (fk[:, 1] == ks[0, 1])
        assert where.sum() == 1
        assert int(fv[where][0, 1]) == 42
        return res, fk, fv
    twin(drill, kind)


walk_in_reverse(globals())
