"""PyTorch port: `pmdfc_tpu_torch/tools/teletop.py` against `tools/teletop.py`.

One wire document, pulled from a live port server over `MSG_STATS`, goes
through `summarize` and `render` of both tools: the rows and the
rendered text must be equal. The servers: a flat linear `KV` (its GETs
take the fused route, so it publishes `serving.fused_get` = 1), a cuckoo
`KV` (the composed GET, 0) and a two-shard tiered plane (shard rows, the
tier block). Each document also goes through both tools with the gauge
taken out, as a server that publishes none sends it.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import PORT, registries, stop  # noqa: F401

from pmdfc_tpu_torch.tools import teletop as tteletop
from tools import teletop as jteletop

pytestmark = pytest.mark.torch

W = 16
KIND = {"linear": "pallas_fused", "cuckoo": "xla_composed",
        "plane": "pallas_fused"}


def _cfg(kind: str, tier=None):
    c = PORT.config
    return c.KVConfig(index=c.IndexConfig(capacity=1 << 10,
                                          kind=c.IndexKind(kind)),
                      bloom=c.BloomConfig(num_bits=1 << 14), page_words=W,
                      tier=None if tier is None else c.TierConfig(**tier))


def _backend(name: str):
    """A port backend for the server named `name`, on the CPU."""
    if name != "plane":
        return PORT.backends.DirectBackend(PORT.KV(_cfg(name)))
    from pmdfc_tpu_torch.parallel.plane import PlaneBackend
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh

    cfg = _cfg("linear", dict(balloon_step=64, ghost_rows=32))
    return PlaneBackend(ShardedKV(cfg, mesh=make_mesh(["cpu"] * 2)))


def _document(name: str) -> dict:
    """The `MSG_STATS` document of a port server after some traffic: puts,
    GETs with cold misses, an invalidate, one closed series window."""
    col = PORT.ts.ensure_collector(interval_s=3600.0)
    col.tick()
    be = _backend(name)
    srv = PORT.net.NetServer(lambda: be, net=PORT.config.NetConfig(
        flush_timeout_us=0, settle_us=0)).start()
    try:
        with PORT.net.TcpBackend("127.0.0.1", srv.port, page_words=W,
                                 keepalive_s=None) as cli:
            rng = np.random.default_rng(5)
            flat = rng.choice(1 << 12, 256, replace=False)
            keys = np.stack([flat >> 6, flat & 0x3F], -1).astype(np.uint32)
            pages = (keys[:, 1:] * np.uint32(31)
                     + np.arange(W, dtype=np.uint32)[None, :])
            cli.put(keys[:192], pages[:192])
            for _ in range(4):
                cli.get(keys)
            cli.invalidate(keys[:8])
        col.tick()
        return tteletop.pull(f"127.0.0.1:{srv.port}", W, 10.0)
    finally:
        stop(srv)


@pytest.mark.parametrize("gauge", ["published", "absent"])
@pytest.mark.parametrize("name", sorted(KIND))
def test_rows_and_render_match_jax(name, gauge, monkeypatch):
    doc = _document(name)
    assert "error" not in doc, doc
    gauges = doc["telemetry"]["gauges"]
    # the port publishes its GET route, as the JAX package publishes its
    assert gauges["serving.fused_get"] == (KIND[name] == "pallas_fused")
    if gauge == "absent":
        del gauges["serving.fused_get"]
    ep = "127.0.0.1:7000"
    ja = jteletop.summarize(ep, copy.deepcopy(doc))
    tb = tteletop.summarize(ep, copy.deepcopy(doc))
    assert ja == tb
    assert tb["ok"] and tb["gets"] > 0
    assert tb["kernel"] == (KIND[name] if gauge == "published" else None)
    assert tb["misses"] == sum(tb["miss_causes"].values())
    assert len(tb.get("shards") or ()) == (2 if name == "plane" else 0)
    down = {"endpoint": "127.0.0.1:7001", "ok": False, "error": "refused"}
    # both renders stamp the wall clock: one frozen second for the two,
    # or a second boundary between them shows as a difference
    stamp = time.strftime("%H:%M:%S")
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: stamp)
    assert jteletop.render([ja, down]) == tteletop.render([tb, down])
