"""Longkey packing and the INVALID sentinel (twin of `pmdfc_tpu/utils/keys.py`).

Keys travel as `[..., 2]` int32 tensors holding u32 bits, `[..., 0] = hi`,
`[..., 1] = lo` (the reference's `inode_oid << 32 | page_index`,
`client/julee.c:64-70`). INVALID (empty slot, padding) is all-ones in both
words: -1 as int32.
"""

from __future__ import annotations

import numpy as np
import torch

INVALID_WORD = 0xFFFFFFFF
INVALID_I32 = -1  # INVALID_WORD's bits as int32


def pack_key(hi, lo, device="cuda") -> torch.Tensor:
    """Stack hi/lo (python ints, numpy arrays or int tensors) into the
    canonical [..., 2] key layout. Ints >= 2^31 route through numpy
    uint64 so their bits survive."""
    def word(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.int32)
        a = np.asarray(x, np.uint64).astype(np.uint32).view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a))

    return torch.stack([word(hi), word(lo)], dim=-1).to(device)


def is_invalid(keys: torch.Tensor) -> torch.Tensor:
    """True where a [..., 2] key is the empty sentinel."""
    return (keys[..., 0] == INVALID_I32) & (keys[..., 1] == INVALID_I32)
