"""Cluster membership: consistent-hash placement ring + live migration
(twin of `pmdfc_tpu/cluster/`; numpy only, so the same code).

`ring.py` owns WHERE keys live (versioned consistent-hash ring with
virtual nodes, epoch per membership change); `migrate.py` owns HOW they
get there when membership changes (rate-bounded, digest-verified page
streaming with a dual-read window for in-flight keys). `ReplicaGroup`
(`client/replica.py`) adopts both behind the `PMDFC_RING` switch.
"""

from pmdfc_tpu_torch.cluster.ring import HashRing, key_pos  # noqa: F401
