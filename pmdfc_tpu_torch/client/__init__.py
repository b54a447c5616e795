"""Clients of the KV (twin of `pmdfc_tpu/client/`, its backends and the
clean-cache client)."""

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
