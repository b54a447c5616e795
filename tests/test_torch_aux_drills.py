"""PyTorch port: `tests/test_aux.py`'s timer and checkpoint drills.

Each test carries its JAX drill's name and runs the drill's script on
both packages (the port's `KV` and `checkpoint.load` with
`device="cpu"`). The checkpoint drills are deterministic: the restored
pages, found masks, packed bloom words and the refusal's message must be
equal. The timers drill reads the host clock, so each package is held to
the JAX drill's own bounds and the printed indicator line's shape. The
policy-cache and logger drills are held in `test_torch_policy_cache.py`
and `test_torch_logger.py`.
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import JAX as _JAX
from torch_twin import PORT as _PORT
from torch_twin import registries, same  # noqa: F401
from torch_twin import twin as twin_of
from torch_twin import walk_in_reverse

import pmdfc_tpu.checkpoint as jckpt
import pmdfc_tpu.models.cceh as jcceh
import pmdfc_tpu.utils.timers as jtimers
import pmdfc_tpu_torch.checkpoint as tckpt
import pmdfc_tpu_torch.models.cceh as tcceh
import pmdfc_tpu_torch.utils.timers as ttimers

pytestmark = pytest.mark.torch


def _jax_dirr(state, dirr):
    import jax.numpy as jnp

    return dataclasses.replace(state, index=dataclasses.replace(
        state.index, dirr=jnp.asarray(dirr)))


def _port_dirr(state, dirr):
    return dataclasses.replace(state, index=dataclasses.replace(
        state.index, dirr=torch.from_numpy(dirr.astype(np.int32))))


JAX = types.SimpleNamespace(
    **vars(_JAX), name="jax", ckpt=jckpt, cceh=jcceh, timers=jtimers,
    load=lambda path, cfg: jckpt.load(path, cfg),
    kv_of=lambda cfg, state: _JAX.kv_mod.KV(cfg, state=state),
    with_dirr=_jax_dirr)
PORT = types.SimpleNamespace(
    **vars(_PORT), name="port", ckpt=tckpt, cceh=tcceh, timers=ttimers,
    load=lambda path, cfg: tckpt.load(path, cfg, device="cpu"),
    kv_of=lambda cfg, state: _PORT.kv_mod.KV(cfg, state=state, device="cpu"),
    with_dirr=_port_dirr)
PKGS = (JAX, PORT)


def twin(drill, *args):
    return twin_of(drill, *args, pkgs=PKGS)


def k2(lo):
    lo = np.asarray(lo, np.uint32)
    return np.stack([np.ones_like(lo), lo], axis=-1)


def test_timers_and_reporter(capsys):
    def drill(p):
        t = p.timers.Timers()
        with t.phase("insert"):
            time.sleep(0.01)
        t.add("poll", 0.002)
        avg = t.averages_us()
        assert avg["insert"] >= 10_000 and avg["poll"] == 2000
        assert "insert=" in t.report()
        r = p.timers.Reporter(interval_s=0.05, sinks=[t.report]).start()
        time.sleep(0.18)
        r.stop()
        out = capsys.readouterr().out
        assert "[indicator]" in out and "insert=" in out
        return sorted(avg), avg["poll"]

    twin(drill)


@pytest.mark.parametrize("kind", ["linear", "path"])
def test_checkpoint_roundtrip(tmp_path, kind):
    pages = np.random.default_rng(0).integers(0, 2**32, (200, 8),
                                              dtype=np.uint32)

    def drill(p):
        c = p.config
        cfg = c.KVConfig(index=c.IndexConfig(kind=c.IndexKind(kind),
                                             capacity=1 << 10),
                         bloom=c.BloomConfig(num_bits=1 << 12), paged=True,
                         page_words=8)
        kv = p.KV(cfg)
        ks = k2(np.arange(200))
        kv.insert(ks, pages)
        path = str(tmp_path / f"{p.name}.npz")
        p.ckpt.save(kv.state, path)
        kv2 = p.kv_of(cfg, p.load(path, cfg))
        out, found = kv2.get(ks)
        assert found.all()
        np.testing.assert_array_equal(out, pages)
        bloom = np.asarray(kv2.packed_bloom()).astype(np.uint32)
        np.testing.assert_array_equal(
            bloom, np.asarray(kv.packed_bloom()).astype(np.uint32))
        return np.asarray(out), found, bloom

    twin(drill)


def test_checkpoint_recovery_repairs_cceh(tmp_path):
    lo = np.random.default_rng(1).choice(1 << 20, 600, replace=False)

    def drill(p):
        c = p.config
        cfg = c.KVConfig(index=c.IndexConfig(kind=c.IndexKind.CCEH,
                                             capacity=1 << 9,
                                             segment_slots=128,
                                             split_headroom=2),
                         bloom=None, paged=False)
        kv = p.KV(cfg)
        kv.insert(k2(lo), k2(lo))
        st = kv.state.index
        g = p.cceh._geom(st)
        dirr = np.asarray(st.dirr).copy()
        ld = np.asarray(st.ld)
        for i in range(g.Smax):
            if i & ((1 << (g.Gmax - ld[dirr[i]])) - 1):
                dirr[i] = (dirr[i] + 1) % g.Smax
                bent = i
                break
        path = str(tmp_path / f"{p.name}.npz")
        p.ckpt.save(p.with_dirr(kv.state, dirr), path)
        kv2 = p.kv_of(cfg, p.load(path, cfg))
        out, found = kv2.get(k2(lo))
        assert found.all(), "recovery failed to repair the directory"
        return bent, np.asarray(out).astype(np.int64) & 0xFFFFFFFF, found

    twin(drill)


def test_checkpoint_rejects_wrong_config(tmp_path):
    def drill(p):
        c = p.config
        cfg = c.KVConfig(index=c.IndexConfig(capacity=1 << 10), bloom=None,
                         paged=False)
        path = str(tmp_path / f"{p.name}.npz")
        p.ckpt.save(p.KV(cfg).state, path)
        other = c.KVConfig(index=c.IndexConfig(capacity=1 << 12),
                           bloom=None, paged=False)
        with pytest.raises(ValueError, match="mismatch") as ex:
            p.load(path, other)
        return str(ex.value).replace(path, "<path>")

    twin(drill)


walk_in_reverse(globals())
