"""PyTorch port: `chip_smoke.py`'s phase 16 (`ops`) rehearsed on the CPU.

The phase runs on the card: the operator pull (`teledump` and
`check_teledump` of `pmdfc_tpu_torch.tools`, each in a child interpreter
where importing JAX or the JAX package raises) against a live port
`NetServer`, and the fast lane's structural drills under serving traffic
through directory connections: a delete's epoch bump, a tier promotion
then a re-put, a balloon shrink mid-serve on a linear·tiered `KV`, and a
4 -> 2 reshard restore of a plane mid-serve. Here it runs at 2^12 slots
(2^11 a shard), 64-word pages and 128-key verbs, with the card-only calls
stood in for as `tests/test_torch_smoke.py` stands them in. The mutation
case shows the phase fails when a fast lane serves a stale page.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from test_torch_smoke import KEYS, smoke  # noqa: F401  (fixture)

import chip_smoke
from pmdfc_tpu_torch import kv as tkv

pytestmark = pytest.mark.torch

OPS_TINY = (
    ("OPS_INDEX", dict(capacity=1 << 12)),
    ("OPS_TIER", dict(hot_fraction=16, ghost_rows=32, balloon_step=64)),
    ("OPS_BLOOM_BITS", 1 << 15),
    ("OPS_PAGE_WORDS", 64),
    ("OPS_VERB", 128),
    ("OPS_SHRINK_EVICT", 64),
    ("OPS_PLANE_INDEX", dict(capacity=1 << 11)),
    ("OPS_PLANE_BLOOM_BITS", 1 << 14),
)


@pytest.fixture
def ops(smoke, monkeypatch):  # noqa: F811
    for name, value in OPS_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    return smoke


def test_ops_phase_and_its_kernels_lines(ops, capsys):
    entries = chip_smoke.run_ops(ops)
    assert [e["path"] for e in entries] == ["ops-tiered", "ops-plane"]
    assert [e["name"] for e in entries] == ["fused_get_linear_tiered",
                                            "fused_get_linear_flat"]
    for e in entries:
        assert set(e) == KEYS and e["launches"] > 0
        assert e["max_abs_err"] == 0 and e["bound_by"] == "bytes"
        assert e["library_ms"] is None
    out = capsys.readouterr().out
    for needle in ("(a) operator pull without JAX", "exit 0; the document "
                   "passes check and check_fastpath", "[check_teledump] OK",
                   "delete of 128 keys: epoch +1",
                   "stale lanes served the new bytes",
                   "balloon shrink mid-serve", "on both sides",
                   "4 -> 2 reshard mid-serve", "owners [0, 1]",
                   "one per fallback GET phase",
                   "one per shard per fallback GET phase",
                   "kernel == plain", "phase 16 took"):
        assert needle in out, needle
    json.dumps(entries)


def test_ops_fails_when_a_fast_lane_serves_a_stale_page(ops, monkeypatch):
    """The server's fast read stops checking the epoch, the row's liveness
    and its digest: it gathers whatever the directory's rows hold now, so
    after the delete a freed row's old page goes out as a fast hit."""
    real = tkv.FastView.read

    def unchecked(self, epoch, shards, rows, digs):
        _, _, cur = real(self, epoch, shards, rows, digs)
        return np.ones(len(rows), bool), self.gather(shards, rows), cur

    monkeypatch.setattr(tkv.FastView, "read", unchecked)
    with pytest.raises(AssertionError, match="fast hit"):
        chip_smoke.run_ops(ops)
