"""PyTorch port: the `KV` paths of the six families added last that no
other parity file drives, against the JAX `KV`.

Over the flat pool for cuckoo, cuckoo-probing, level, path, static and
HotRing, the tiered pool for cuckoo-probing, level, path and static, and
the unpaged `KV` for cuckoo, cuckoo-probing, level, path and static:
three rounds of 500 keys (updates, in-batch duplicates, padding) with 6
extents a round, each round followed by `get`, `get_compact_async`,
`get_extent`, `find_anyway`, `delete` (with duplicates) and `recovery`.
Every output, the stats vector and every state leaf must equal JAX's,
bit for bit.

The drill is `run_case`. Its cost is the JAX programs each configuration
compiles (5-18 s a case), so the cases are spread over this file and
`test_torch_kv_family_paths_{path,tiered,unpaged}.py`, which the
parallel runner schedules file by file.
"""

from __future__ import annotations

import zlib

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import kv_configs
import torch

from pmdfc_tpu import kv as jkv
from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert np.array_equal(a, b), f"{what} differs"


def _same_leaves(a, b, what):
    flat, _ = jax.tree_util.tree_flatten_with_path(a.state)
    la = {".".join(k.name for k in p): np.asarray(v) for p, v in flat}
    lb = carry.state_to_numpy(b.state)
    assert sorted(la) == sorted(lb), f"{what}: {set(la) ^ set(lb)}"
    for k in la:
        _same(la[k], lb[k], f"{what}: leaf {k}")


def _host(y, like):
    """A port output as numpy in the dtype of the JAX output `like`."""
    if isinstance(y, torch.Tensor):
        dt = np.asarray(like).dtype
        return u32.to_numpy(y) if dt == np.uint32 else y.numpy().astype(dt)
    return y


def run_case(kind, pool):
    """The drill for one family over one pool ("flat", "tiered" or
    "unpaged")."""
    jcfg, tcfg = kv_configs(kind, pool)
    a, b = jkv.KV(jcfg), tkv.KV(tcfg, device="cpu")
    rng = np.random.default_rng(zlib.crc32(f"{kind}-{pool}".encode()))
    vw = 2 if pool == "unpaged" else 64
    live = np.zeros((0, 2), np.uint32)
    for rnd in range(3):
        keys = rng.integers(0, 1 << 32, (500, 2), dtype=np.uint32)
        keys[:30] = keys[30:60]                             # duplicates
        if len(live):
            keys[100:140] = live[rng.integers(0, len(live), 40)]  # updates
        keys[rng.integers(0, 500, 4)] = 0xFFFFFFFF          # padding
        vals = rng.integers(0, 1 << 32, (500, vw), dtype=np.uint32)
        ra, rb = a.insert(keys, vals), b.insert(keys, vals)
        for f in ra._fields:
            _same(getattr(ra, f), getattr(rb, f), f"insert {rnd} {f}")
        live = np.concatenate([live, keys])
        bases = []
        for j in range(6):
            base = 8192 * (rnd * 6 + j + 1) + 64 * j
            key = np.array([0xE0000000 | rnd, base], np.uint32)
            val = np.array([j, (0xFFFFF000 - 4096 * 40 * j) % (1 << 32)],
                           np.uint32)
            ea = a.insert_extent(key, val, 3 + 11 * j)
            eb = b.insert_extent(key, val, 3 + 11 * j)
            assert ea[1] == eb[1]
            for f in ea[0]._fields:
                _same(getattr(ea[0], f), getattr(eb[0], f),
                      f"insert_extent {rnd}.{j} {f}")
            bases.append(key)
        probe = np.concatenate([
            live[rng.integers(0, len(live), 200)],
            rng.integers(0, 1 << 32, (40, 2), dtype=np.uint32),
            np.stack(bases)])                               # cover keys
        for i, (x, y) in enumerate(zip(a.get(probe), b.get(probe))):
            _same(x, y, f"get {rnd} output {i}")
        ra, rb = a.get_compact_async(probe), b.get_compact_async(probe)
        for i, (x, y) in enumerate(zip(ra[:-1], rb[:-1])):
            _same(np.asarray(x), _host(y, x), f"get_compact {rnd} {i}")
        assert ra[-1] == rb[-1]
        ext = np.concatenate([np.stack(bases) + np.array([0, o], np.uint32)
                              for o in (0, 1, 5, 40)])
        for i, (x, y) in enumerate(zip(a.get_extent(ext),
                                       b.get_extent(ext))):
            _same(x, y, f"get_extent {rnd} output {i}")
        lost = np.concatenate([live[:8], rng.integers(
            0, 1 << 32, (8, 2), dtype=np.uint32)])
        for i, (x, y) in enumerate(zip(a.find_anyway(lost),
                                       b.find_anyway(lost))):
            _same(x, y, f"find_anyway {rnd} output {i}")
        gone = np.concatenate([live[rng.integers(0, len(live), 120)],
                               live[:6], live[:6]])
        _same(a.delete(gone), b.delete(gone), f"delete {rnd}")
        assert a.recovery() and b.recovery()
        _same_leaves(a, b, f"round {rnd}")
    sa, sb = a.stats(), b.stats()
    for k in tkv.STAT_NAMES:
        assert sa[k] == sb[k], f"stat {k}: {sa[k]} vs {sb[k]}"
    assert sb["misses"] == sum(sb[c] for c in tkv.MISS_CAUSE_NAMES)
    assert sb["hits"] > 0 and sb["deletes"] > 0


@pytest.mark.parametrize("kind", ["cuckoo", "ccp", "level", "static"])
def test_family_kv_paths_over_the_flat_pool_match_jax(kind):
    run_case(kind, "flat")
