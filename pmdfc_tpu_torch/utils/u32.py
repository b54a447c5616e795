"""The port's one representation of unsigned 32-bit words.

torch has no usable uint32 arithmetic on every backend (on the CPU build
`+`, `>>` and `index_put_` raise for uint32), so:

- **stored** u32 words are `torch.int32` tensors holding the same bits
  (numpy `uint32` arrays cross over with `.view(np.int32)`);
- **computed** u32 values are `torch.int64` tensors in [0, 2^32): widen
  with `widen`, do the arithmetic, mask with `M32`, narrow with `narrow`.

Products of two full 32-bit words would overflow int64, so `mul` splits
the constant into 16-bit halves; every intermediate stays below 2^49.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 bits (or any integer tensor) -> int64 unsigned value."""
    return x.to(torch.int64) & M32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 value (any, taken mod 2^32) -> int32 tensor with those bits."""
    x = x & M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x an int64 tensor in [0, 2^32), c a u32 int."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def from_numpy(a, device) -> torch.Tensor:
    """numpy uint32 (or int32) array -> int32 tensor with the same bits."""
    a = np.array(a)  # a contiguous copy (0-d stays 0-d)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        a = a.astype(np.uint64).astype(np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of u32 bits -> numpy uint32 array."""
    return t.detach().cpu().numpy().astype(np.int32, copy=False).view(
        np.uint32)
