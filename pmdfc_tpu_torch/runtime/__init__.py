"""The serving runtime (twin of `pmdfc_tpu/runtime/`): the native
coalescing engine and the KVServer driver loop, the wire (`net`), the
failure layer (`failure`), telemetry, time series, workload sketches,
QoS, the SLO watchdog and the lock sanitizer."""

from pmdfc_tpu_torch.runtime.engine import (  # noqa: F401
    OP_DEL,
    OP_GET,
    OP_GET_EXT,
    OP_INS_EXT,
    OP_PUT,
    Engine,
)
from pmdfc_tpu_torch.runtime.server import KVServer  # noqa: F401
