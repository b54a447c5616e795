"""Multi-device parallelism: the KV state sharded over a grid of devices
(twin of `pmdfc_tpu/parallel/`).

Reference analog: `server/NuMA_KV.{h,cpp}` — per-NUMA-node dispatch queues
with `GetNodeID(key)` routing (`server/NuMA_KV.cpp:136-151`). Here the
"nodes" are devices of a grid (one GPU may hold several shards), routing
is a hash of the key, and one controller process drives every shard.

`connect_multihost` (multi-process, on `torch.distributed`) is not ported
yet. The serving plane is imported from its module:
`from pmdfc_tpu_torch.parallel.plane import PlaneBackend,
make_serving_backend`.
"""

from pmdfc_tpu_torch.parallel.shard import (  # noqa: F401
    Mesh,
    ShardedKV,
    make_mesh,
    make_mesh2d,
)
