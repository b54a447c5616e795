"""Clients of the KV (twin of `pmdfc_tpu/client/`: its backends, the
clean-cache client, the fast path's directory mirror and the replica
group)."""

from pmdfc_tpu_torch.client.backends import (  # noqa: F401
    DirectBackend,
    EngineBackend,
    IntegrityBackend,
    LocalBackend,
)
from pmdfc_tpu_torch.client.cleancache import (  # noqa: F401
    CleanCacheClient,
    SwapClient,
    get_longkey,
)
from pmdfc_tpu_torch.client.replica import ReplicaGroup  # noqa: F401
