"""PyTorch port: `tests/test_fused.py`'s drills, one by one, on both packages.

Each test carries the name of the JAX drill it twins. The parity drills
build the drill's seeded `KV` (192 pages put, the last 10 deleted) in
each package, pad the same probe (present, deleted and absent keys) to
256 rows, and run it through each package's two GET programs: JAX's
composed `kv._get_core` and `fused.get_core` (the Pallas kernel in
interpret mode), the port's composed `kv._get_core` and `fused.get_core`
(on the CPU the CUDA kernel's plain version). All four must give the
same pages, found mask, int32[19] stats vector and state leaves
(tolerance 0: integer arithmetic), with `misses == Σ miss_*`. The JAX
states are shared across the parametrized cases; each port program runs
on its own copy of the port's state (the port's verbs work in place).

The port has no `PMDFC_FUSED`, no `KVConfig.fused_get` and no recompile
counters (ROADMAP, recorded differences): the four drills about them are
pinned on both packages, what JAX does beside what the port does, and
the serving results of the two compared exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import (counters, fresh_jax_registry,  # noqa: F401
                        registries, same)
from torch_twin import jax_jit_caches_left_cold  # noqa: F401 (fixture)
from torch_twin import jax_memo

from pmdfc_tpu import config as jconf
from pmdfc_tpu import kv as jkv
from pmdfc_tpu.ops import fused as jfused
from pmdfc_tpu.parallel import plane as jplane
from pmdfc_tpu.runtime import telemetry as jtele
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import config as tconf
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.ops import fused as tfused
from pmdfc_tpu_torch.parallel import plane as tplane
from pmdfc_tpu_torch.parallel import shard as tshard
from pmdfc_tpu_torch.runtime import telemetry as ttele
from pmdfc_tpu_torch.utils import u32

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures(
    "fresh_jax_registry", "jax_jit_caches_left_cold")]
# the drills replay `test_fused.py`'s own JAX programs: compiled as the suite
# compiles them, each file finds the other's in the persistent cache
KEEP_XLA_DEFAULTS = True

W = 64  # pow2 page words: inside both packages' fused support set
INV = 0xFFFFFFFF


def _cfg(c, kind="linear", tiered=False, capacity=2048, page_words=W,
         paged=True):
    return c.KVConfig(index=c.IndexConfig(kind=c.IndexKind(kind),
                                          capacity=capacity),
                      paged=paged, page_words=page_words,
                      tier=c.TierConfig() if tiered else None)


def _keys(n, rng):
    return np.stack([rng.integers(0, 1 << 30, n, dtype=np.uint32),
                     rng.integers(0, 1 << 30, n, dtype=np.uint32)], -1)


def _pages_of(keys, w=W):
    return ((keys[:, 0] * np.uint32(31) + keys[:, 1])[:, None]
            + np.arange(1, w + 1, dtype=np.uint32)[None, :])


def _seeded(kv, cfg, seed=7, n=192, deleted=10):
    """The drill's `_seeded_kv` on a `KV` of either package -> the probe
    (present, deleted and absent keys)."""
    rng = np.random.default_rng(seed)
    keys = _keys(n, rng)
    pages = rng.integers(0, 1 << 32, (n, cfg.page_words), dtype=np.uint32)
    kv.insert(keys, pages)
    kv.delete(keys[n - deleted:])
    return np.concatenate([keys[:n // 2], keys[n - deleted:],
                           _keys(48, rng)])


def _padded(probe, w=256):
    pk = np.full((w, 2), INV, np.uint32)
    pk[:len(probe)] = probe
    return pk


def _jax_leaves(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _stat(vec, name) -> int:
    return int(np.asarray(vec)[list(jkv.STAT_NAMES).index(name)])


@jax_memo
def _jax_seeded(kind, tiered):
    cfg = _cfg(jconf, kind, tiered)
    kv = jkv.KV(cfg)
    probe = _seeded(kv, cfg)
    return cfg, kv.state, probe


def _jax_side(kind, tiered, lean, recovering, damage) -> dict:
    """JAX's composed and fused GETs on the drill's state, held equal ->
    the fused side's observables."""
    cfg, state, probe = _jax_seeded(kind, tiered)
    assert jfused.supports(cfg)
    if damage:
        pool = state.pool
        state = dataclasses.replace(state, pool=dataclasses.replace(
            pool, pages=pool.pages ^ jnp.uint32(1 << 7)))
    pk = jnp.asarray(_padded(probe))
    s1, o1, f1 = jkv._get_core(state, cfg, pk, lean=lean,
                               recovering=recovering)
    s2, o2, f2 = jfused.get_core(state, cfg, pk, lean=lean,
                                 recovering=recovering)
    a = dict(out=np.asarray(o1), found=np.asarray(f1),
             stats=np.asarray(s1.stats), leaves=_jax_leaves(s1))
    b = dict(out=np.asarray(o2), found=np.asarray(f2),
             stats=np.asarray(s2.stats), leaves=_jax_leaves(s2))
    same(a, b, "JAX composed vs fused")
    return b


def _port_side(kind, tiered, lean, recovering, damage) -> dict:
    """The port's composed and fused GETs on the drill's state, each on
    its own copy, held equal -> the fused side's observables."""
    cfg = _cfg(tconf, kind, tiered)
    assert tfused.supports(cfg)
    kv = tkv.KV(cfg, device="cpu")
    probe = _seeded(kv, cfg)
    if damage:
        kv.state.pool.pages.bitwise_xor_(1 << 7)
    leaves = carry.state_to_numpy(kv.state)
    pk = u32.from_numpy(_padded(probe), "cpu")
    sides = []
    for core in (tkv._get_core, tfused.get_core):
        st = carry.state_from_numpy(leaves, cfg, device="cpu")
        st, out, found = core(st, cfg, pk, lean=lean, recovering=recovering)
        sides.append(dict(out=u32.to_numpy(out), found=found.numpy(),
                          stats=st.stats.numpy(),
                          leaves=carry.state_to_numpy(st)))
    same(sides[0], sides[1], "port composed vs fused")
    return sides[1]


def _parity(kind, tiered, lean, recovering=False, damage=False) -> dict:
    j = _jax_side(kind, tiered, lean, recovering, damage)
    p = _port_side(kind, tiered, lean, recovering, damage)
    same(j, p, f"{kind} tiered={tiered} lean={lean}")
    st = p["stats"]
    assert _stat(st, "misses") == sum(_stat(st, c)
                                      for c in jkv.MISS_CAUSE_NAMES)
    if not damage:  # the all-corrupt drill legitimately serves no hit
        assert _stat(st, "hits") > 0
    assert _stat(st, "misses") > 0
    return st


@pytest.mark.parametrize("kind,tiered,lean", [
    ("linear", False, True), ("linear", True, False), ("cceh", False, True),
], ids=["linear-flat-lean", "linear-tiered-counting", "cceh-flat-lean"])
def test_fused_core_parity_representative(kind, tiered, lean):
    _parity(kind, tiered, lean)


# slow in JAX: the card holds every variant against its plain version on
# every miss cause (phase 3) and on every path since (phases 4-18)
@pytest.mark.parametrize("lean", [False, True], ids=["counting", "lean"])
@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
@pytest.mark.parametrize("kind", ["linear", "cceh"])
def test_fused_core_parity_full_grid(kind, tiered, lean):
    _parity(kind, tiered, lean)


# slow in JAX: phase 8's recovering window and phase 9's restarted node
# (their cold misses counted as miss_recovering through the kernel)
@pytest.mark.parametrize("kind", ["linear", "cceh"])
def test_fused_core_parity_recovering(kind):
    st = _parity(kind, True, False, recovering=True)
    assert _stat(st, "miss_recovering") > 0 and _stat(st, "miss_cold") == 0


# slow in JAX: phase 3's digest cause and phase 14's pool poisoned in place
@pytest.mark.parametrize("kind", ["linear", "cceh"])
def test_fused_digest_cause_matches_composed(kind):
    st = _parity(kind, False, False, damage=True)
    assert _stat(st, "miss_digest") > 0
    assert _stat(st, "miss_digest") == _stat(st, "corrupt_pages")


def test_fused_kv_stats_parity_and_reconcile(monkeypatch):
    """JAX's `KV` with `PMDFC_FUSED=on` and `off`, and the port's `KV`
    (which always takes the fused route for this config: on the CPU the
    plain version, seen by a spy) serve the same mixed probe with the
    same pages, found mask and stats, `misses == Σ miss_*`."""
    outs = {}
    for mode in ("on", "off"):
        monkeypatch.setenv("PMDFC_FUSED", mode)
        cfg = _cfg(jconf)
        kv = jkv.KV(cfg)
        probe = _seeded(kv, cfg)
        assert kv._fused_on() is (mode == "on")
        pages, found = kv.get(probe)
        outs[mode] = (np.asarray(pages), np.asarray(found),
                      counters(kv.stats()))
    monkeypatch.delenv("PMDFC_FUSED")
    calls = []
    real = tfused.get_core_reference
    monkeypatch.setattr(tfused, "get_core_reference",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = _cfg(tconf)
    kv = tkv.KV(cfg, device="cpu")
    probe = _seeded(kv, cfg)
    assert kv._fused_on() is True
    pages, found = kv.get(probe)
    assert calls, "the port's GET did not take the fused route"
    port = (pages, found, counters(kv.stats()))
    same(outs["on"], outs["off"], "JAX on vs off")
    same(outs["on"], port, "JAX vs port")
    s = port[2]
    assert s["misses"] == sum(s[c] for c in jkv.MISS_CAUSE_NAMES)
    assert s["hits"] > 0 and s["misses"] > 0


def test_fused_mode_env_parsing_is_strict_in_jax_and_absent_in_port(
        monkeypatch):
    """JAX's `fused_mode` parses `PMDFC_FUSED` strictly and a typo
    raises; the port has no fused/composed switch: no `fused_mode`, and a
    `PMDFC_FUSED` of any value (the typo too) leaves its `KV` on the fused
    route, serving what JAX serves."""
    for v, want in (("off", "off"), ("0", "off"), ("false", "off"),
                    ("no", "off"), ("on", "on"), ("1", "on"),
                    ("true", "on"), ("yes", "on"), ("auto", "auto")):
        monkeypatch.setenv("PMDFC_FUSED", v)
        assert jconf.fused_mode() == want
    monkeypatch.delenv("PMDFC_FUSED")
    assert jconf.fused_mode() == "auto"
    assert jconf.fused_mode("off") == "off"
    monkeypatch.setenv("PMDFC_FUSED", "fused")
    with pytest.raises(ValueError, match="PMDFC_FUSED"):
        jconf.fused_mode()
    assert not hasattr(tconf, "fused_mode")
    cfg = _cfg(tconf)
    kv = tkv.KV(cfg, device="cpu")
    probe = _seeded(kv, cfg)
    assert kv._fused_on() is True
    got = kv.get(probe)
    monkeypatch.setenv("PMDFC_FUSED", "off")
    jcfg = _cfg(jconf)
    jk = jkv.KV(jcfg)
    same(tuple(np.asarray(a) for a in jk.get(_seeded(jk, jcfg))), got,
         "JAX composed vs the port under PMDFC_FUSED=fused")


def test_fused_config_field_validated_in_jax_and_absent_in_port():
    with pytest.raises(ValueError, match="fused_get"):
        jconf.KVConfig(fused_get="yes")
    assert "fused_get" not in {f.name for f in
                               dataclasses.fields(tconf.KVConfig)}
    with pytest.raises(TypeError, match="fused_get"):
        tconf.KVConfig(fused_get="on")


@pytest.mark.parametrize("case", ["unpaged", "page_words=48"])
def test_unsupported_configs_ride_composed(monkeypatch, case):
    """Outside `supports()` both packages serve through the composed GET,
    JAX even under a forced `PMDFC_FUSED=on`: the same seeded workload
    gives the same results and stats, and the port's fused route is never
    taken. Inside it, JAX forced fuses anywhere and off the TPU `auto`
    resolves composed; the port fuses on every device (on the CPU its
    plain version), having no switch."""
    kw = dict(paged=False) if case == "unpaged" else dict(page_words=48)
    monkeypatch.setenv("PMDFC_FUSED", "on")
    jcfg, tcfg = _cfg(jconf, **kw), _cfg(tconf, **kw)
    assert not jfused.supports(jcfg) and not tfused.supports(tcfg)
    assert not jfused.resolve(jcfg) and not tfused.resolve(tcfg)
    calls = []
    real = tfused.get_core
    monkeypatch.setattr(tfused, "get_core",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    obs = []
    for kv, cfg in ((jkv.KV(jcfg), jcfg), (tkv.KV(tcfg, device="cpu"),
                                            tcfg)):
        assert kv._fused_on() is False
        if cfg.paged:
            probe = _seeded(kv, cfg)
        else:
            rng = np.random.default_rng(7)
            keys = _keys(192, rng)
            kv.insert(keys, keys[:, ::-1].copy())
            kv.delete(keys[182:])
            probe = np.concatenate([keys[:96], keys[182:], _keys(48, rng)])
        out, found = kv.get(probe)
        obs.append((np.asarray(out), np.asarray(found),
                    counters(kv.stats())))
    same(obs[0], obs[1], case)
    assert not calls, "the port took the fused route outside supports()"
    assert jfused.resolve(_cfg(jconf)) and tfused.resolve(_cfg(tconf))
    monkeypatch.delenv("PMDFC_FUSED")
    if jax.default_backend() != "tpu":
        assert not jfused.resolve(_cfg(jconf))
    assert tfused.resolve(_cfg(tconf))


def _fused_recompiles(reg) -> dict:
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("recompile.kv.get_fused")}


def test_fused_cold_rung_counts_in_jax_and_not_in_port(monkeypatch,
                                                       tmp_path):
    """JAX counts a cold rung's jitted program and Pallas kernel once each
    (`recompile.kv.get_fused*`) and a known shape nothing; the port
    builds its kernel once with nvcc and tracks no program, so its
    registry holds no such counter. The three GETs serve the same in
    both."""
    monkeypatch.setenv("PMDFC_FUSED", "on")
    jreg = jtele.configure(jconf.TelemetryConfig(
        ring_capacity=1 << 15, dump_dir=str(tmp_path)))
    treg = ttele.configure(tconf.TelemetryConfig(
        ring_capacity=1 << 15, dump_dir=str(tmp_path)))
    obs = []
    for p, kv, cfg, reg in (
            ("jax", jkv.KV(_cfg(jconf)), _cfg(jconf), jreg),
            ("port", tkv.KV(_cfg(tconf), device="cpu"), _cfg(tconf), treg)):
        probe = _seeded(kv, cfg)
        got = [kv.get(probe[:16])]
        before = _fused_recompiles(reg)
        got.append(kv.get(probe[:33]))
        after = _fused_recompiles(reg)
        got.append(kv.get(probe[:40]))
        if p == "jax":
            bumped = {k: after[k] - before.get(k, 0) for k in after
                      if after[k] != before.get(k, 0)}
            assert sorted(bumped.values()) == [1, 1], bumped
            assert "recompile.kv.get_fused.kernel" in bumped
            prog = next(k for k in bumped
                        if k != "recompile.kv.get_fused.kernel")
            evs = [r for r in reg.ring if r.get("kind") == "recompile"
                   and r["program"] == prog[len("recompile."):]]
            assert any("family=linear" in r["sig"] and "tile=64" in r["sig"]
                       for r in evs), evs
            assert _fused_recompiles(reg) == after
        else:
            assert before == after == _fused_recompiles(reg) == {}
            assert not [r for r in reg.ring if r.get("kind") == "recompile"]
        obs.append([tuple(np.asarray(a) for a in g) for g in got])
    same(obs[0], obs[1], "the three GETs")


def _verb_transcript(be, seed=11, steps=20):
    """The drill's seeded mixed workload against the plane verbs, folded
    into a comparable transcript."""
    rng = np.random.default_rng(seed)
    universe = _keys(192, np.random.default_rng(3))
    out = []
    for _ in range(steps):
        op = int(rng.integers(4))
        lo = int(rng.integers(0, 176))
        n = int(rng.integers(1, 16))
        sel = universe[lo:lo + n]
        if op == 0:
            be.put(sel, _pages_of(sel))
            out.append(("put", n))
        elif op in (1, 2):
            pages, found = be.get(sel)
            out.append(("get", found.tolist(), pages[found].tolist()))
        else:
            out.append(("inval", be.invalidate(sel).tolist()))
    st = be.stats()
    out.append(("stats", {k: int(v) for k, v in st.items()
                          if isinstance(v, (int, np.integer))},
                st["shard_report"]["stats"]))
    return out


# slow in JAX: phase 13's `fused_get` harness holds the kernel side and the
# composed chain equal bit for bit on the card, and phase 10 serves the
# 4-shard plane through the kernel
def test_fused_off_kill_switch_plane_is_conformant(monkeypatch, tmp_path):
    """JAX's 4-shard serving plane under `PMDFC_FUSED=off` and forced
    `on`, and the port's 4-shard plane (`["cpu"] * 4`, no switch), give
    one verb transcript; JAX tracks no fused program under `off` and
    builds the kernel under `on`; the port tracks none."""
    jreg = jtele.configure(jconf.TelemetryConfig(
        ring_capacity=1 << 15, dump_dir=str(tmp_path)))
    treg = ttele.configure(tconf.TelemetryConfig(
        ring_capacity=1 << 15, dump_dir=str(tmp_path)))
    monkeypatch.setenv("PMDFC_FUSED", "off")
    off = jplane.make_serving_backend(_cfg(jconf, capacity=1 << 10),
                                      jconf.MeshConfig(n_shards=4))
    assert off.skv._fused_on() is False
    got_off = _verb_transcript(off)
    assert not any("get_fused" in k for k in jreg.snapshot()["counters"])
    monkeypatch.setenv("PMDFC_FUSED", "on")
    on = jplane.make_serving_backend(_cfg(jconf, capacity=1 << 10),
                                     jconf.MeshConfig(n_shards=4))
    assert on.skv._fused_on() is True
    got_on = _verb_transcript(on)
    assert "recompile.kv.get_fused.kernel" in jreg.snapshot()["counters"]
    port = tplane.make_serving_backend(_cfg(tconf, capacity=1 << 10),
                                       mesh=tshard.make_mesh(["cpu"] * 4))
    assert port.skv._fused_on() is True
    got_port = _verb_transcript(port)
    assert got_off == got_on == got_port
    assert not any("get_fused" in k for k in treg.snapshot()["counters"])
