"""PyTorch port: snapshots and chains (`checkpoint.py`, `KV.snapshot`)
against the JAX package.

The same seeded verbs build a JAX `KV` and the port's `KV(device="cpu")`
(the port's state carried across with `carry.py`, so both hold the same
bytes). Then, for linear, CCEH, cuckoo, linear over the tiered pool with
the admission gate, and an unpaged config:

- a JAX snapshot restores in the port and a port snapshot in JAX, with
  equal leaves, equal integrity manifests and equal `prev_crc`;
- a JAX full + JAX delta chain and a port full + port delta chain of the
  same history are member for member equal (manifests, dirty rows) and
  each loads in the other package;
- a mixed chain (a JAX full, then a port delta written after
  `resume_chain`) loads in both.

The leaf-name list (the file's leaf order) is pinned against JAX's
`leaf_names` for all nine families over the flat pool, linear and CCEH
over the tiered pool with the gate, and an unpaged config. The refusals
(torn member, gap, lone delta, cross-chain mix, a named shape mismatch)
raise the same exception class with the same message in both packages.
Tolerance 0 throughout.
"""

from __future__ import annotations

import dataclasses
import json
import zipfile

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu import checkpoint as jck
from pmdfc_tpu import kv as jkv
from pmdfc_tpu.config import AdmitConfig as JAdmit
from pmdfc_tpu.config import BloomConfig as JBloomConfig
from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu.config import TierConfig as JTier
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import checkpoint as tck
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.config import AdmitConfig as TAdmit
from pmdfc_tpu_torch.config import BloomConfig as TBloomConfig
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.config import KVConfig as TKVConfig
from pmdfc_tpu_torch.config import TierConfig as TTier

pytestmark = pytest.mark.torch

W = 16
TIER = dict(hot_fraction=16, ghost_rows=32, balloon_step=32,
            max_promotes_per_batch=16, cold_init_rows=512, grow_free_rows=32)
CASES = {
    # name: (index kind, paged, tiered with the gate)
    "linear": ("linear", True, False),
    "cceh": ("cceh", True, False),
    "cuckoo": ("cuckoo", True, False),
    "linear-tiered": ("linear", True, True),
    "linear-unpaged": ("linear", False, False),
}


def _configs(kind, paged=True, tiered=False, capacity=1 << 10):
    def make(K, I, B, T, A, Kind):
        return K(index=I(kind=Kind(kind), capacity=capacity), page_words=W,
                 paged=paged, bloom=B(num_bits=1 << 12),
                 evicted_sketch_bits=1 << 10,
                 tier=T(**TIER, admit=A()) if tiered else None)
    return (make(JKVConfig, JIndexConfig, JBloomConfig, JTier, JAdmit, JKind),
            make(TKVConfig, TIndexConfig, TBloomConfig, TTier, TAdmit, TKind))


def _keys(lo, n):
    flat = np.arange(lo, lo + n, dtype=np.uint32)
    return np.stack([flat >> 11, flat & 0x7FF], -1).astype(np.uint32)


def _values(keys, paged):
    if not paged:
        return np.stack([keys[:, 1] * 7 + 1, keys[:, 0] ^ 0x5A5A], -1
                        ).astype(np.uint32)
    return (keys[:, 1:2].astype(np.uint32) * 3 + 1) * np.arange(
        1, W + 1, dtype=np.uint32)


def _jleaves(state) -> dict:
    """A JAX state's leaves by dotted name (admission included)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(getattr(p, "name", None) or str(p).strip(".[]")
                     for p in path): np.asarray(x) for path, x in flat}


def _same_state(jstate, tstate, what):
    a, b = _jleaves(jstate), carry.state_to_numpy(tstate)
    assert list(a) == list(b), f"{what}: leaf names differ"
    for n in a:
        assert a[n].dtype == b[n].dtype, f"{what}: {n} dtype"
        assert np.array_equal(a[n], b[n]), f"{what}: leaf {n} differs"


def _members(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _meta(members) -> dict:
    """The `__meta__` document without the chain linkage (random ids)."""
    doc = json.loads(bytes(members.pop("__meta__")).decode())
    doc.pop("chain")
    return doc


def _pair(name):
    """(JAX KV, port KV on the CPU) holding the same seeded history."""
    kind, paged, tiered = CASES[name]
    jc, tc = _configs(kind, paged, tiered)
    jk = jkv.KV(jc)
    ka = _keys(0, 96)
    jk.insert(ka, _values(ka, paged))
    jk.delete(ka[:8])
    jk.get(ka[8:40])  # a counting GET (tiered: promotions)
    tk = tkv.KV(tc, state=carry.state_from_numpy(_jleaves(jk.state), tc,
                                                 "cpu"), device="cpu")
    return jk, tk, jc, tc, paged


def _both_insert(jk, tk, keys, paged):
    jk.insert(keys, _values(keys, paged))
    tk.insert(keys, _values(keys, paged))


@pytest.mark.parametrize("kind", [k.value for k in JKind])
def test_leaf_names_match_jax_flat(kind):
    jc, tc = _configs(kind)
    names = tck.leaf_names(tkv.init(tc, "meta"))
    assert names == jck.leaf_names(jkv.init(jc))
    assert names[-1] == "evicted_filter" and "pool.pages" in names


@pytest.mark.parametrize("case", ["linear-tiered-admit", "cceh-tiered-admit",
                                  "linear-unpaged"])
def test_leaf_names_match_jax_tiered_and_unpaged(case):
    kind = case.split("-")[0]
    jc, tc = _configs(kind, paged=case != "linear-unpaged",
                      tiered="tiered" in case)
    names = tck.leaf_names(tkv.init(tc, "meta"))
    assert names == jck.leaf_names(jkv.init(jc))
    # the gate's leaves never reach the file
    assert not any(n.startswith("pool.admit_") for n in names)


@pytest.mark.parametrize("name", list(CASES))
def test_full_snapshot_crosses_both_ways(name, tmp_path):
    jk, tk, jc, tc, paged = _pair(name)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jr = jk.snapshot(jpath)
    tr = tk.snapshot(tpath)
    # same manifest, same prev_crc for the chain's next member
    assert jr["crc"] == tr["crc"] and jr["kind"] == tr["kind"] == "full"
    assert jr["total_rows"] == tr["total_rows"]
    ja, ta = _members(jpath), _members(tpath)
    assert np.array_equal(ja["__integrity__"], ta["__integrity__"])
    assert _meta(ja) == _meta(ta)  # names, dtypes, shapes, version
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert np.array_equal(ja[k], ta[k]), k
    # JAX -> port and port -> JAX restore the same state
    for path in (jpath, tpath):
        js = jck.load(path, jc, run_recovery=False)
        ts = tck.load(path, tc, run_recovery=False, device="cpu")
        _same_state(js, ts, f"{name} load {path}")
        # the live gate has counted; a restored one starts empty
        _same_state(jck.strip_admission(js), tck.strip_admission(tk.state),
                    f"{name} restored vs live")
    # and with the recovery repair
    _same_state(jck.load(tpath, jc), tck.load(jpath, tc, device="cpu"),
                f"{name} load with recovery")


@pytest.mark.parametrize("name", ["linear", "cceh", "cuckoo",
                                  "linear-tiered"])
def test_delta_chain_crosses_both_ways(name, tmp_path):
    jk, tk, jc, tc, paged = _pair(name)
    j = [str(tmp_path / f"j{i}.npz") for i in range(3)]
    t = [str(tmp_path / f"t{i}.npz") for i in range(3)]
    reps = []
    reps.append((jk.snapshot(j[0]), tk.snapshot(t[0])))
    _both_insert(jk, tk, _keys(96, 40), paged)
    reps.append((jk.snapshot(j[1], delta=True), tk.snapshot(t[1], delta=True)))
    jk.delete(_keys(20, 16)), tk.delete(_keys(20, 16))
    _both_insert(jk, tk, _keys(200, 8), paged)
    reps.append((jk.snapshot(j[2], delta=True), tk.snapshot(t[2], delta=True)))
    for i, (jr, tr) in enumerate(reps):
        for k in ("kind", "seq", "crc", "dirty_rows", "total_rows"):
            assert jr[k] == tr[k], (i, k, jr[k], tr[k])
        ja, ta = _members(j[i]), _members(t[i])
        assert _meta(ja) == _meta(ta)
        assert sorted(ja) == sorted(ta)
        for k in ja:
            assert np.array_equal(ja[k], ta[k]), (i, k)
    assert reps[1][0]["kind"] == "delta" and 0 < reps[1][0]["dirty_rows"]
    # each chain restores in both packages to the live state
    for chain in (j, t):
        order = [chain[2], chain[0], chain[1]]  # order-insensitive
        js = jck.load_chain(order, jc, run_recovery=False)
        ts = tck.load_chain(order, tc, run_recovery=False, device="cpu")
        _same_state(js, ts, f"{name} chain")
        _same_state(jck.strip_admission(js), tck.strip_admission(tk.state),
                    f"{name} chain vs live")
    folded = tck.materialize_chain(t)
    assert folded["chain"] == {
        k: v for k, v in jck.materialize_chain(t)["chain"].items()}
    assert folded["seq"] == 2 and set(folded["timings_s"]) == {"read", "fold"}


@pytest.mark.parametrize("name", ["linear", "linear-tiered"])
def test_mixed_chain_jax_full_then_port_delta(name, tmp_path):
    jk, _, jc, tc, paged = _pair(name)
    full, delta = str(tmp_path / "full.npz"), str(tmp_path / "d1.npz")
    jk.snapshot(full)
    # the port restores JAX's full, resumes its chain, and extends it
    folded = tck.materialize_chain([full])
    tk = tkv.KV(tc, state=tck.state_from_leaves(
        folded["leaves"], tc, run_recovery=False, device="cpu"),
        device="cpu")
    tk.resume_chain(folded["chain"])
    assert tk.recovery_info()["chain"] == {"id": folded["chain"]["id"],
                                           "seq": 0}
    more = _keys(300, 24)
    tk.insert(more, _values(more, paged))
    rep = tk.snapshot(delta, delta=True)
    assert rep["kind"] == "delta" and rep["seq"] == 1
    assert rep["chain_id"] == folded["chain"]["id"]
    jk.insert(more, _values(more, paged))
    js = jck.load_chain([full, delta], jc, run_recovery=False)
    ts = tck.load_chain([full, delta], tc, run_recovery=False, device="cpu")
    _same_state(js, ts, "mixed chain")
    _same_state(jck.strip_admission(jk.state), tck.strip_admission(ts),
                "mixed chain vs JAX live")


def test_admission_is_volatile_and_snapshot_bytes_ignore_the_gate(tmp_path):
    """A tiered snapshot with the gate and one without are the same bytes
    (as in JAX); a gated restore starts with a fresh gate."""
    jc, tc = _configs("linear", tiered=True)
    tc_bare = dataclasses.replace(
        tc, tier=dataclasses.replace(tc.tier, admit=None))
    ka = _keys(0, 64)
    gated = tkv.KV(tc, device="cpu")
    bare = tkv.KV(tc_bare, device="cpu")
    for kv in (gated, bare):
        kv.insert(ka, _values(ka, True))
    gated.get(ka)  # the sketch counts
    bare.get(ka)
    assert int(gated.state.pool.admit_ops) > 0
    pg, pb = str(tmp_path / "g.npz"), str(tmp_path / "b.npz")
    rg, rb = gated.snapshot(pg), bare.snapshot(pb)
    assert rg["crc"] == rb["crc"]
    a, b = _members(pg), _members(pb)
    a.pop("__meta__"), b.pop("__meta__")
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)
    # restore: the gate comes back empty, in both packages
    ts = tck.load(pg, tc, device="cpu")
    js = jck.load(pg, jc)
    fresh = tkv.init(tc, "cpu").pool
    for f in ("admit_cm", "admit_door", "admit_ops", "admit_thresh",
              "admit_stats"):
        assert np.array_equal(getattr(ts.pool, f).numpy(),
                              getattr(fresh, f).numpy()), f
    _same_state(js, ts, "gated restore")
    # a snapshot of the ungated store restores into the gated config
    _same_state(jck.load(pb, jc), tck.load(pb, tc, device="cpu"),
                "ungated file, gated config")


def _raises_same(fn_j, fn_t):
    with pytest.raises(Exception) as ej:
        fn_j()
    with pytest.raises(Exception) as et:
        fn_t()
    assert type(ej.value).__name__ == type(et.value).__name__
    assert str(ej.value) == str(et.value)
    return et.value


def test_delta_chain_roundtrip_and_refusals(tmp_path):
    """Twin of the JAX drill, on the port's files: the chain restores
    byte-exact, and each refusal is the JAX refusal (class and message)."""
    jc, tc = _configs("linear")
    kv = tkv.KV(tc, device="cpu")
    ka, kb = _keys(0, 48), _keys(48, 16)
    kv.insert(ka, _values(ka, True))
    full, d1, d2 = (str(tmp_path / f) for f in ("full.npz", "d1.npz",
                                                 "d2.npz"))
    r0 = kv.snapshot(full)
    assert r0["kind"] == "full" and r0["seq"] == 0
    kv.insert(kb, _values(kb, True))
    r1 = kv.snapshot(d1, delta=True)
    assert r1["kind"] == "delta" and r1["seq"] == 1
    assert 0 < r1["dirty_rows"] < r0["total_rows"]
    kv.delete(ka[:8])
    assert kv.snapshot(d2, delta=True)["seq"] == 2

    kv2 = tkv.KV(tc, state=tck.load_chain([d2, full, d1], tc,
                                          run_recovery=False, device="cpu"),
                 device="cpu")
    got, found = kv2.get(_keys(0, 64))
    assert not found[:8].any() and found[8:].all()
    np.testing.assert_array_equal(got[8:], _values(_keys(0, 64), True)[8:])

    e = _raises_same(lambda: jck.materialize_chain([full, d2]),
                     lambda: tck.materialize_chain([full, d2]))
    assert isinstance(e, tck.SnapshotChainError)
    e = _raises_same(lambda: jck.materialize_chain([d1]),
                     lambda: tck.materialize_chain([d1]))
    assert isinstance(e, tck.SnapshotChainError)
    e = _raises_same(lambda: jck.load_leaves(d1, None),
                     lambda: tck.load_leaves(d1, None))
    assert isinstance(e, ValueError)
    kvx = tkv.KV(tc, device="cpu")
    kvx.insert(ka, _values(ka, True))
    fullx, dx = str(tmp_path / "fullx.npz"), str(tmp_path / "dx.npz")
    kvx.snapshot(fullx)
    kvx.insert(kb, _values(kb, True))
    kvx.snapshot(dx, delta=True)
    with pytest.raises(tck.SnapshotChainError) as et:
        tck.materialize_chain([full, dx])
    with pytest.raises(jck.SnapshotChainError) as ej:
        jck.materialize_chain([full, dx])
    # the message lists the two random chain ids: the same set
    assert str(et.value) == str(ej.value)
    blob = bytearray(open(d1, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    torn = str(tmp_path / "torn.npz")
    open(torn, "wb").write(bytes(blob))
    e = _raises_same(lambda: jck.materialize_chain([full, torn]),
                     lambda: tck.materialize_chain([full, torn]))
    assert isinstance(e, (tck.CheckpointCorruptError, tck.SnapshotChainError,
                          ValueError))
    # a truncated full is corruption, in both
    cut = str(tmp_path / "cut.npz")
    open(cut, "wb").write(open(full, "rb").read()[:-100])
    e = _raises_same(lambda: jck.load(cut, jc), lambda: tck.load(
        cut, tc, device="cpu"))
    assert isinstance(e, tck.CheckpointCorruptError)


def test_restore_refusal_names_the_leaf(tmp_path):
    jc, tc = _configs("linear")
    kv = tkv.KV(tc, device="cpu")
    ka = _keys(0, 8)
    kv.insert(ka, _values(ka, True))
    path = str(tmp_path / "full.npz")
    kv.snapshot(path)
    jsmall, tsmall = _configs("linear", capacity=1 << 9)
    e = _raises_same(lambda: jck.load(path, jsmall),
                     lambda: tck.load(path, tsmall, device="cpu"))
    assert "mismatch" in str(e) and "'" in str(e) and "shape" in str(e)
    # a leaf-set change names the leaf gained or lost
    jun, tun = _configs("linear", paged=False)
    e = _raises_same(lambda: jck.load(path, jun),
                     lambda: tck.load(path, tun, device="cpu"))
    assert "pool.pages" in str(e)


def test_unpaged_delta_falls_back_to_full(tmp_path):
    jc, tc = _configs("linear", paged=False)
    kv = tkv.KV(tc, device="cpu")
    r0 = kv.snapshot(str(tmp_path / "a.npz"))
    r1 = kv.snapshot(str(tmp_path / "b.npz"), delta=True)
    assert r0["kind"] == r1["kind"] == "full"
    assert r0["chain_id"] != r1["chain_id"] and r1["total_rows"] is None
    with pytest.raises(ValueError, match="unpaged"):
        tck.save_delta(kv.state, str(tmp_path / "c.npz"),
                       {"id": "x", "seq": 1, "prev_crc": 0},
                       np.zeros(0, bool))


def test_snapshot_file_is_a_plain_npz_with_the_v2_members(tmp_path):
    _, tc = _configs("cceh")
    kv = tkv.KV(tc, device="cpu")
    path = str(tmp_path / "s.npz")
    kv.snapshot(path)
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
    n = len(tck.leaf_names(kv.state))
    assert names == {f"leaf_{i}.npy" for i in range(n)} | {
        "__integrity__.npy", "__meta__.npy"}


def test_delta_copies_only_the_dirty_rows_to_the_host(tmp_path,
                                                      monkeypatch):
    """A delta gathers its dirty rows on the device: the page leaf never
    crosses to the host whole (at the serving size it is 8 GiB), only a
    `[dirty rows, W]` tensor does."""
    _, tc = _configs("linear")
    kv = tkv.KV(tc, device="cpu")
    ka = _keys(0, 64)
    kv.insert(ka, _values(ka, True))
    kv.snapshot(str(tmp_path / "full.npz"))
    kb = _keys(64, 8)
    kv.insert(kb, _values(kb, True))
    crossed = []
    real_leaf, real_u32 = carry.leaf_to_numpy, tck.u32.to_numpy
    monkeypatch.setattr(carry, "leaf_to_numpy", lambda n, t: (
        crossed.append((n, tuple(t.shape))), real_leaf(n, t))[1])
    monkeypatch.setattr(tck.u32, "to_numpy", lambda t: (
        crossed.append(("u32", tuple(t.shape))), real_u32(t))[1])
    rep = kv.snapshot(str(tmp_path / "d1.npz"), delta=True)
    assert rep["kind"] == "delta" and rep["dirty_rows"] == 8
    pages = tuple(kv.state.pool.pages.shape)
    assert ("pool.pages", pages) not in crossed
    assert ("u32", (8, W)) in crossed
    assert all(shape != pages for _, shape in crossed)
