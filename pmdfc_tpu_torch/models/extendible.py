"""Classic extendible hashing (twin of `pmdfc_tpu/models/extendible.py`):
the CCEH machinery of `models/cceh.py` with LSB directory arithmetic
(`msb=False`).

Reference: `server/src/extendible_hash.{h,cpp}`, an LSB-indexed directory
(`extendible_hash.h:27-33`) with block split and directory doubling. The
directory index is `h & (Smax - 1)`, a split redistributes by bit `ld`
counted from the bottom, and replication classes are strided.
"""

from __future__ import annotations

from pmdfc_tpu_torch.config import IndexConfig, IndexKind
from pmdfc_tpu_torch.models import cceh
from pmdfc_tpu_torch.models.base import IndexOps, register_index


def init(config: IndexConfig, device="cuda") -> cceh.CCEHState:
    return cceh.init(config, msb=False, device=device)


register_index(IndexKind.EXTENDIBLE, IndexOps(init=init, **cceh.OPS))
