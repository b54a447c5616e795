"""PyTorch port: the row-rebuild insert (`models/linear.insert_batch_row`).

The row path is held bit for bit to the element path over 40 seeded
trials (tables, heads and every `InsertResult` field, as
`tests/test_linear.py` holds the JAX pair), and to the JAX package's own
`insert_batch_row` over a run of batches that update, evict, drop (a
batch overflowing one cluster) and collide an evicting insert with an
update of the same lane. A subprocess pins the import-time
`PMDFC_INSERT_PATH=row` switch: the registry, and so `KV`, then inserts
through the row path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)

from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.models import linear as jlin
from pmdfc_tpu.utils.hashing import hash_u64 as jhash_u64
from pmdfc_tpu_torch.bench.insert_rowscatter import check_equivalence
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.models import linear as tlin
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
INV = 0xFFFFFFFF


def test_row_path_equals_element_path_over_40_trials():
    assert check_equivalence(seed=7, trials=40, device="cpu") == 40


def test_check_equivalence_defaults_to_cuda(monkeypatch):
    """Without `device=` the drill asks for CUDA, which raises where there
    is no GPU (the port's entry points have no CPU fallback)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        check_equivalence(trials=1)


def _batches(rng, n_clusters):
    """Batches over a tiny keyspace (updates, evictions, duplicates,
    padding, hi words on both sides of 2^31), then one batch carrying
    more keys for a single cluster than it has lanes (drops)."""
    out = []
    for _ in range(12):
        n = int(rng.integers(16, 96))
        keys = rng.integers(0, 40, (n, 2), dtype=np.uint32)
        keys[: n // 3, 0] |= np.uint32(0x80000000)
        keys[rng.integers(0, n, 4)] = keys[rng.integers(0, n, 4)]
        keys[rng.integers(0, n, 3)] = INV
        out.append(keys)
    cand = rng.integers(0, 1 << 32, (1 << 14, 2), dtype=np.uint32)
    h = np.asarray(jhash_u64(jnp.asarray(cand[:, 0]), jnp.asarray(cand[:, 1])))
    out.append(cand[(h & (n_clusters - 1)) == 3][:40])
    # one padded width, so JAX compiles its program once
    return [np.concatenate([k, np.full((96 - len(k), 2), INV, np.uint32)])
            for k in out]


def test_row_path_matches_jax_row_path():
    rng = np.random.default_rng(11)
    jcfg = JIndexConfig(capacity=1 << 9, cluster_slots=16)
    tcfg = TIndexConfig(capacity=1 << 9, cluster_slots=16)
    js = jlin.init(jcfg)
    ts = tlin.init(tcfg, "cpu")
    seen = {"upd": 0, "evicted": 0, "dropped": 0}
    for i, keys in enumerate(_batches(rng, js.table.shape[0])):
        vals = rng.integers(0, 1 << 32, keys.shape, dtype=np.uint32)
        js, jr = jlin.insert_batch_row(js, jnp.asarray(keys),
                                       jnp.asarray(vals))
        ts, tr = tlin.insert_batch_row(ts, u32.from_numpy(keys, "cpu"),
                                       u32.from_numpy(vals, "cpu"))
        np.testing.assert_array_equal(u32.to_numpy(ts.table),
                                      np.asarray(js.table), f"table {i}")
        np.testing.assert_array_equal(u32.to_numpy(ts.head),
                                      np.asarray(js.head), f"head {i}")
        for f in jr._fields:
            a, b = getattr(tr, f), np.asarray(getattr(jr, f))
            a = (u32.to_numpy(a) if f.startswith("evicted")
                 else a.numpy())
            np.testing.assert_array_equal(a, b, f"{f} {i}")
        seen["upd"] += int(((tr.slots >= 0) & ~tr.fresh).sum())
        seen["evicted"] += int((u32.to_numpy(tr.evicted)[:, 0] != INV).sum())
        seen["dropped"] += int(tr.dropped.sum())
    assert all(seen.values()), seen


_SWITCH = """
import dataclasses, json
import numpy as np
from {pkg}.config import IndexConfig, IndexKind, KVConfig
from {pkg}.models import base, linear
want = linear.insert_batch_{path}
out = {{"registered": linear.insert_batch is want
        and base.get_index_ops(IndexKind.LINEAR).insert_batch is want}}
calls = []
def spy(*a):
    calls.append(1)
    return want(*a)
base._REGISTRY[IndexKind.LINEAR] = dataclasses.replace(
    base._REGISTRY[IndexKind.LINEAR], insert_batch=spy)
from {pkg}.kv import KV
kv = KV(KVConfig(index=IndexConfig(capacity=1 << 10), page_words=16){dev})
keys = np.stack([np.full(64, 5, np.uint32),
                 np.arange(64, dtype=np.uint32)], -1)
pages = np.arange(64 * 16, dtype=np.uint32).reshape(64, 16)
kv.insert(keys, pages)
got, found = kv.get(keys)
out.update(spied=bool(calls), found=int(np.asarray(found).sum()),
           exact=bool((np.asarray(got) == pages).all()))
print("SWITCH " + json.dumps(out))
"""


def test_insert_path_env_switch():
    """PMDFC_INSERT_PATH flips the linear index's registered `insert_batch`
    at import in both packages: `row` registers the row path, `element`
    (the default) the element path, and a `KV` then inserts through the
    one registered. Each package's child reports the same."""
    children = {}
    for path in ("row", "element"):
        for lin, dev in ((jlin, ""), (tlin, ", device='cpu'")):
            pkg = lin.__name__.split(".")[0]
            env = {**os.environ, "PMDFC_INSERT_PATH": path,
                   "JAX_PLATFORMS": "cpu"}
            children[path, pkg] = subprocess.Popen(
                [sys.executable, "-c",
                 _SWITCH.format(pkg=pkg, path=path, dev=dev)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)
    got = {}
    for key, child in children.items():
        out, err = child.communicate(timeout=120)
        line = [ln for ln in out.decode().splitlines()
                if ln.startswith("SWITCH ")]
        assert line, (key, err[-800:])
        got[key] = json.loads(line[0][len("SWITCH "):])
    want = {"registered": True, "spied": True, "found": 64, "exact": True}
    for path in ("row", "element"):
        assert got[path, "pmdfc_tpu"] == got[path, "pmdfc_tpu_torch"] \
            == want, path
