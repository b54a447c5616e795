"""pmdfc_tpu_torch — the page KV store of `pmdfc_tpu`, in PyTorch and CUDA.

A second package beside the JAX one, with the same module layout and
names, so each module here has its counterpart at the same path under
`pmdfc_tpu/`. The JAX package is the reference: on the same seeded
inputs both produce the same pages, found masks, slots, stats vector and
state leaves, bit for bit (`tests/test_torch_*.py`).

Layer map (the slices so far):

  L4     client/            — clean-cache / swap clients over backends:
                              local dict, direct `KV`, the engine, and
                              the directory mirror of the fast path
  L3     runtime/           — the native coalescing engine (`native/
                              runtime.cpp`, built by g++) and the
                              `KVServer` driver loop over the async verbs;
                              the wire (`net.py`: `NetServer`,
                              `TcpBackend`, `PoolServer`, `RemotePool`),
                              the failure layer, telemetry, QoS, SLOs
         onesided.py        — the passive page pool and its one-sided
                              client
  L2     kv.py, tier.py     — KV façade + the `KV` host class: insert / get /
                              get_compact / delete / extents / stats over
                              an index, counting bloom, evicted-key sketch
                              and the flat page pool or the tiered store;
                              the host stats overlay, the recovering
                              state and the fast path's `FastView`
  L1     models/            — linear-probing FIFO index (fused-row layout),
                              CCEH and extendible hashing
  L0     ops/               — bloom, page pool, and the fused GET: a CUDA
                              kernel for Hopper (`ops/csrc/fused_get.cu`)
                              beside its plain PyTorch version

u32 words. Every 32-bit unsigned word (keys, hashes, table lanes, page
words, digests) is stored as `torch.int32` with the same bits; plain code
widens to int64 and masks with 0xFFFFFFFF where it needs unsigned
arithmetic, the CUDA kernel reads the same memory as `uint32_t`. See
`utils/u32.py`.

Devices. Entry points run on `cuda` unless the caller passes
`device="cpu"`; asking for `cuda` on a machine without a GPU raises.
Importing the package builds and loads nothing: the kernel is compiled
with `nvcc` at its first launch (`ops/_build.py`).
"""

__version__ = "0.1.0"

from pmdfc_tpu_torch.config import (  # noqa: F401
    BloomConfig,
    IndexConfig,
    IndexKind,
    KVConfig,
)
