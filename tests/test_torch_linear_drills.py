"""PyTorch port: `tests/test_linear.py`'s larger drill on both packages.

`test_large_random_workload_no_false_hits` inserts 4096 distinct keys
into a 2^14-slot linear index in one batch, then probes them and 4096
keys that were never inserted. The same batch goes through
`pmdfc_tpu.models.linear` and `pmdfc_tpu_torch.models.linear` from equal
states: the insert's result, the state after it and both probes must be
identical, and each is held to the JAX drill's rule (every key found
unless evicted or dropped, no false hit). Tolerance 0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from test_torch_linear import _assert_result, _assert_state, _n, _t

from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.models import linear as jlin
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.models import linear as tlin

pytestmark = pytest.mark.torch

INV = 0xFFFFFFFF


def test_large_random_workload_no_false_hits_like_jax():
    rng = np.random.default_rng(0)
    js = jlin.init(JIndexConfig(capacity=1 << 14))
    ts = tlin.init(TIndexConfig(capacity=1 << 14), "cpu")
    n = 4096
    los = rng.choice(1 << 20, size=n, replace=False).astype(np.uint32)
    keys = np.stack([np.full(n, 3, np.uint32), los], -1)
    vals = np.stack([np.zeros(n, np.uint32), los], -1)
    js, jr = jlin.insert_batch_element(js, jnp.asarray(keys),
                                       jnp.asarray(vals))
    ts, tr = tlin.insert_batch_element(ts, _t(keys), _t(vals))
    _assert_result(jr, tr)
    _assert_state(js, ts)
    got = tlin.get_batch(ts, _t(keys))
    _assert_result(jlin.get_batch(js, jnp.asarray(keys)), got)
    lost = int((_n(tr.evicted) != INV).all(axis=1).sum()) \
        + int(tr.dropped.sum())
    found = got.found.numpy()
    assert int((~found).sum()) <= lost
    assert np.array_equal(_n(got.values)[found, 1], los[found])
    other = np.stack([np.full(n, 4, np.uint32), los], -1)
    got2 = tlin.get_batch(ts, _t(other))
    _assert_result(jlin.get_batch(js, jnp.asarray(other)), got2)
    assert not got2.found.any()
