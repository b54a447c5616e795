"""PyTorch port: the `PMDFC_TIER` and `PMDFC_ADMIT` switches against the
JAX package's.

Both packages resolve the two switches when `kv.init` builds a state
(`kv._tier_cfg_at_init`, `kv._admit_cfg_at_init`): `PMDFC_TIER=off`
builds the flat pool whatever `KVConfig.tier` says, `on` builds the
tiered one with `TierConfig()` where the config carries none,
`PMDFC_ADMIT=off` strips the admission gate and `on` installs
`AdmitConfig()`; any other value raises the same `ValueError`. After
init every decision keys off the state's pool. JAX's five drills
(`tests/test_tier.py`, `tests/test_admit.py`) run here on both packages
with the same seeded inputs, bit for bit, plus the sharded plane's
refusal and pools, `checkpoint.transplant_admission`, and the fused
GET's instance on a state the switch flipped.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import timeless

from pmdfc_tpu import checkpoint as jckpt
from pmdfc_tpu import tier as jtier
from pmdfc_tpu.config import AdmitConfig as JAdmit
from pmdfc_tpu.config import IndexConfig as JIndex
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.config import KVConfig as JKVConfig
from pmdfc_tpu.config import TierConfig as JTier
from pmdfc_tpu.kv import KV as JKV
from pmdfc_tpu.ops.pagepool import PoolState as JPool
from pmdfc_tpu.parallel import shard as jshard
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import checkpoint as tckpt
from pmdfc_tpu_torch import tier as ttier
from pmdfc_tpu_torch.config import AdmitConfig as TAdmit
from pmdfc_tpu_torch.config import IndexConfig as TIndex
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.config import KVConfig as TKVConfig
from pmdfc_tpu_torch.config import TierConfig as TTier
from pmdfc_tpu_torch.kv import KV as TKV
from pmdfc_tpu_torch.ops import fused
from pmdfc_tpu_torch.ops.pagepool import PoolState as TPool
from pmdfc_tpu_torch.parallel import shard as tshard

pytestmark = pytest.mark.torch

W = 64
ADMIT = dict(sketch_width=1 << 10, door_bits=1 << 11, reset_ops=4096,
             threshold=2)


def _cfgs(capacity=1 << 10, kind="linear", tier=True, admit=False):
    """The same configuration in both packages."""
    out = []
    for KVC, IC, K, T, A in ((JKVConfig, JIndex, JKind, JTier, JAdmit),
                             (TKVConfig, TIndex, TKind, TTier, TAdmit)):
        t = T(admit=A(**ADMIT) if admit else None) if tier else None
        out.append(KVC(index=IC(kind=K(kind), capacity=capacity),
                       bloom=None, paged=True, page_words=W, tier=t))
    return out


def _keys(los):
    los = np.asarray(los, np.uint32)
    return np.stack([los >> 16, los], axis=-1).astype(np.uint32)


def _pages(keys):
    lo = np.asarray(keys, np.uint32)[:, 1]
    return (lo[:, None] * np.uint32(2654435761)
            + np.arange(W, dtype=np.uint32)[None, :])


def _jleaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(getattr(p, "name", None) or str(p).strip(".[]")
                     for p in path): np.asarray(x) for path, x in flat}


def _same_leaves(jstate, tstate):
    a, b = _jleaves(jstate), carry.state_to_numpy(tstate)
    assert list(a) == list(b)
    for n in a:
        assert a[n].dtype == b[n].dtype and np.array_equal(a[n], b[n]), n


def _stats(kv) -> dict:
    return timeless(kv.stats())


def test_tier_off_env_is_flat(monkeypatch):
    monkeypatch.setenv("PMDFC_TIER", "off")
    jc, tc = _cfgs()
    assert isinstance(JKV(jc).state.pool, JPool)
    assert isinstance(TKV(tc, device="cpu").state.pool, TPool)


def test_tier_on_env_default(monkeypatch):
    monkeypatch.setenv("PMDFC_TIER", "on")
    jc, tc = _cfgs(tier=False)
    a, b = JKV(jc), TKV(tc, device="cpu")
    assert isinstance(a.state.pool, jtier.TierState)
    assert isinstance(b.state.pool, ttier.TierState)
    assert b.state.pool.admit_cm is None
    _same_leaves(a.state, b.state)


@pytest.mark.parametrize("kind", ["linear", "cceh"])
def test_tier_off_bit_identical_conformance(monkeypatch, kind):
    """With PMDFC_TIER=off a tier-configured KV behaves exactly like the
    flat pool, in the port as in JAX: results, stats and leaves."""
    monkeypatch.setenv("PMDFC_TIER", "off")
    jc, tc = _cfgs(kind=kind)
    _, tflat = _cfgs(kind=kind, tier=False)
    j, a, b = JKV(jc), TKV(tc, device="cpu"), TKV(tflat, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(4):
        keys = _keys(rng.integers(0, 1 << 12, 48))
        pages = _pages(keys)
        for kv in (j, a, b):
            kv.insert(keys, pages)
        qj, fj = j.get(keys[:17])
        for kv in (a, b):
            q, f = kv.get(keys[:17])
            assert (f == fj).all() and (q == qj).all()
        dj = j.delete(keys[40:])
        assert (a.delete(keys[40:]) == dj).all()
        assert (b.delete(keys[40:]) == dj).all()
    assert _stats(a) == _stats(b) == _stats(j)
    _same_leaves(j.state, a.state)


def test_admit_env_resolution(monkeypatch):
    monkeypatch.setenv("PMDFC_ADMIT", "off")
    jc, tc = _cfgs(admit=True)
    for kv in (JKV(jc), TKV(tc, device="cpu")):
        assert kv.state.pool.admit_cm is None
        assert kv.admit_state() is None
        assert not kv.set_admit_threshold(3)
    monkeypatch.setenv("PMDFC_ADMIT", "on")
    jc, tc = _cfgs(admit=False)
    a, b = JKV(jc), TKV(tc, device="cpu")
    assert b.state.pool.admit_cm is not None  # defaults installed
    assert a.admit_state() == b.admit_state()
    _same_leaves(a.state, b.state)


def test_admit_off_bit_identical_conformance(monkeypatch):
    """PMDFC_ADMIT=off on a gate-configured KV is bit-identical to an
    admission-less config on a seeded mixed workload: results, stats and
    state leaves, in the port and against JAX."""
    monkeypatch.setenv("PMDFC_ADMIT", "off")
    jc, tc = _cfgs(admit=True)
    _, tnone = _cfgs(admit=False)
    j, a, b = JKV(jc), TKV(tc, device="cpu"), TKV(tnone, device="cpu")
    rng = np.random.default_rng(11)
    for _ in range(3):
        keys = _keys(rng.integers(0, 1 << 11, 48))
        pages = _pages(keys)
        for kv in (j, a, b):
            kv.insert(keys, pages)
        qj, fj = j.get(keys[:24])
        for kv in (a, b):
            q, f = kv.get(keys[:24])
            assert (f == fj).all() and (q == qj).all()
        dj = j.delete(keys[40:])
        assert (a.delete(keys[40:]) == dj).all()
        assert (b.delete(keys[40:]) == dj).all()
    assert _stats(a) == _stats(b) == _stats(j)
    assert "admit_denied" not in _stats(a)
    _same_leaves(j.state, a.state)
    _same_leaves(j.state, b.state)


@pytest.mark.parametrize("var", ["PMDFC_TIER", "PMDFC_ADMIT"])
def test_a_typo_raises_the_same_value_error(monkeypatch, var):
    monkeypatch.setenv(var, "banana")
    jc, tc = _cfgs(admit=True)
    with pytest.raises(ValueError) as je:
        JKV(jc)
    with pytest.raises(ValueError) as te:
        TKV(tc, device="cpu")
    assert str(te.value) == str(je.value)
    assert var in str(te.value)


@pytest.mark.parametrize("tier,admit,env", [
    (True, True, {"PMDFC_TIER": "off"}),
    (False, False, {"PMDFC_TIER": "on"}),
    (True, True, {"PMDFC_ADMIT": "off"}),
    (True, False, {"PMDFC_ADMIT": "on"}),
])
def test_sharded_kv_builds_the_pools_jax_builds(monkeypatch, tier, admit,
                                               env):
    """A 1-D plane of two shards builds, per shard, the pool type and
    admission leaves JAX's stacked state holds; a 2-D grid refuses a
    tiered pool the switch added, and accepts one the switch stripped."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jc, tc = _cfgs(capacity=1 << 10, tier=tier, admit=admit)
    j = jshard.ShardedKV(jc, mesh=jshard.make_mesh(jax.devices()[:2]))
    t = tshard.ShardedKV(tc, mesh=tshard.make_mesh(["cpu"] * 2))
    jtiered = isinstance(j.state.pool, jtier.TierState)
    for st in t.states:
        assert isinstance(st.pool, ttier.TierState) == jtiered
        if jtiered:
            assert (st.pool.admit_cm is None) == (j.state.pool.admit_cm
                                                  is None)
    jm2, tm2 = (jshard.make_mesh2d(2, 2, jax.devices()[:4]),
                tshard.make_mesh2d(2, 2, ["cpu"] * 4))
    if jtiered:
        with pytest.raises(ValueError) as je:
            jshard.ShardedKV(jc, mesh=jm2)
        with pytest.raises(ValueError) as te:
            tshard.ShardedKV(tc, mesh=tm2)
        assert str(te.value) == str(je.value)
    else:
        jshard.ShardedKV(jc, mesh=jm2)
        tshard.ShardedKV(tc, mesh=tm2)


@pytest.mark.parametrize("admit,env", [(False, "on"), (True, "off"),
                                       (True, "")])
def test_transplant_admission_follows_the_resolved_config(monkeypatch,
                                                          admit, env):
    """A stripped restored state gets the gate `kv.init` would build under
    the switch, as JAX's skeleton transplant gives it."""
    monkeypatch.setenv("PMDFC_ADMIT", env)
    jc, tc = _cfgs(admit=admit)
    monkeypatch.setenv("PMDFC_ADMIT", "on")
    a, b = JKV(jc), TKV(tc, device="cpu")  # both built with a gate
    monkeypatch.setenv("PMDFC_ADMIT", env)
    js = jckpt.transplant_admission(jckpt.strip_admission(a.state),
                                    JKV(jc).state)
    ts = tckpt.transplant_admission(tckpt.strip_admission(b.state), tc)
    want_gate = env == "on" or (env == "" and admit)
    assert (ts.pool.admit_cm is not None) == want_gate
    assert (js.pool.admit_cm is not None) == want_gate
    _same_leaves(js, ts)


@pytest.mark.parametrize("env,tier,variant", [
    ("off", True, "fused_get_linear_flat"),
    ("on", False, "fused_get_linear_tiered"),
    ("off", True, "fused_get_cceh_flat"),
    ("on", False, "fused_get_cceh_tiered"),
])
def test_fused_get_takes_the_instance_of_the_states_pool(monkeypatch, env,
                                                         tier, variant):
    """The fused GET picks its instance from the state's pool: a tier
    config built flat by PMDFC_TIER=off takes the flat instance, a flat
    config built tiered by PMDFC_TIER=on the tiered one (the wrapper's
    calls stand in for launches on the CPU)."""
    monkeypatch.setenv("PMDFC_TIER", env)
    kind = variant.split("_")[2]
    _, tc = _cfgs(kind=kind, tier=tier)
    calls = []
    plain = fused.fused_get

    def spy(keys, *args, **kw):
        pool = "tiered" if kw.get("cgen") is not None else "flat"
        fam = "cceh" if kw.get("dirr") is not None else "linear"
        calls.append(f"fused_get_{fam}_{pool}")
        return plain(keys, *args, **kw)

    monkeypatch.setattr(fused, "fused_get", spy)
    kv = TKV(tc, device="cpu")
    keys = _keys(np.arange(1, 65))
    kv.insert(keys, _pages(keys))
    out, found = kv.get(keys)
    assert found.all() and (out == _pages(keys)).all()
    assert calls == [variant]
