"""PyTorch port: `tests/test_insert_compaction.py`'s eviction-free drill on
both packages, one case per index family.

The `KV` facade skips its post-verify gather when an insert reports no
eviction, so an insert that reports no eviction and no drop must leave
every fresh slot's key gettable. Each family's index ops run in the JAX
package and in the port (`device="cpu"`) on the same 512 keys: the
insert result, the GET and every state leaf must be equal, and the
drill's invariant is held on the port's result. (The drill's three
siblings are in `tests/test_torch_insert_compaction.py`; this one sits
in its own file to keep each file's cold JAX compiles short.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from test_torch_insert_compaction import Twin, _live_evicted, keys_of, vals_of

from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu_torch.config import IndexKind as TKind

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("kind", [k.value for k in TKind])
def test_eviction_free_batches_keep_every_fresh_slot(kind):
    """An insert that reports no eviction and no drop leaves every fresh
    slot's key gettable (the facade skips its post-verify gather then),
    per family, in both packages."""
    assert {k.value for k in TKind} == {k.value for k in JKind}
    kw = {}
    if kind in ("cceh", "extendible"):
        kw = dict(segment_slots=128, split_headroom=2)
    tw = Twin(kind, 1 << 13, **kw)
    lo = np.arange(512, dtype=np.uint32)
    fresh, dropped, ev = tw.insert(keys_of(lo), vals_of(lo), "insert")
    if _live_evicted(ev).any():
        return  # the family reported displacement: the facade verifies
    found = np.asarray(tw.get_batch(keys_of(lo), "get").found)
    assert found[fresh & ~dropped].all(), (
        f"{kind}: eviction-free insert lost a fresh slot")
