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

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

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
    assert check_equivalence(seed=7, trials=40) == 40


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


def test_insert_path_env_switch():
    """PMDFC_INSERT_PATH=row registers the row path as the linear index's
    `insert_batch` at import, and a `KV` then inserts through it."""
    code = (
        "import numpy as np\n"
        "from pmdfc_tpu_torch.models import linear\n"
        "from pmdfc_tpu_torch.models.base import get_index_ops\n"
        "from pmdfc_tpu_torch.config import IndexKind, KVConfig, IndexConfig\n"
        "assert linear.insert_batch is linear.insert_batch_row\n"
        "assert get_index_ops(IndexKind.LINEAR).insert_batch "
        "is linear.insert_batch_row\n"
        "calls = []\n"
        "real = linear.insert_batch_row\n"
        "def spy(*a):\n"
        "    calls.append(1)\n"
        "    return real(*a)\n"
        "import dataclasses\n"
        "from pmdfc_tpu_torch.models import base\n"
        "base._REGISTRY[IndexKind.LINEAR] = dataclasses.replace(\n"
        "    base._REGISTRY[IndexKind.LINEAR], insert_batch=spy)\n"
        "from pmdfc_tpu_torch.kv import KV\n"
        "kv = KV(KVConfig(index=IndexConfig(capacity=1 << 10), "
        "page_words=16), device='cpu')\n"
        "keys = np.stack([np.full(64, 5, np.uint32), "
        "np.arange(64, dtype=np.uint32)], -1)\n"
        "pages = np.arange(64 * 16, dtype=np.uint32).reshape(64, 16)\n"
        "kv.insert(keys, pages)\n"
        "out, found = kv.get(keys)\n"
        "assert calls and found.all() and (out == pages).all()\n"
        "print('switch-ok')\n")
    env = {**os.environ, "PMDFC_INSERT_PATH": "row"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, timeout=120)
    assert b"switch-ok" in out.stdout, out.stderr[-800:]
    env["PMDFC_INSERT_PATH"] = "element"
    out = subprocess.run(
        [sys.executable, "-c",
         "from pmdfc_tpu_torch.models import linear\n"
         "assert linear.insert_batch is linear.insert_batch_element\n"
         "print('default-ok')"], env=env, cwd=ROOT, capture_output=True,
        timeout=120)
    assert b"default-ok" in out.stdout, out.stderr[-800:]
