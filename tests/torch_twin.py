"""Shared pieces of the twin suites (`test_torch_qos.py`,
`test_torch_containment.py`, `test_torch_chaos.py`, `test_torch_xray.py`):
each package's modules under one name, the telemetry registries, and the
loopback server stop."""

from __future__ import annotations

import socket
import types

import pytest

import pmdfc_tpu.client.backends as jbackends
import pmdfc_tpu.client.cleancache as jcleancache
import pmdfc_tpu.config as jconfig
import pmdfc_tpu.kv as jkv
import pmdfc_tpu.runtime.failure as jfailure
import pmdfc_tpu.runtime.net as jnet
import pmdfc_tpu.runtime.qos as jqos
import pmdfc_tpu.runtime.telemetry as jtele
import pmdfc_tpu.runtime.timeseries as jts
import pmdfc_tpu.runtime.workload as jwl
import pmdfc_tpu_torch.client.backends as tbackends
import pmdfc_tpu_torch.client.cleancache as tcleancache
import pmdfc_tpu_torch.config as tconfig
import pmdfc_tpu_torch.kv as tkv
import pmdfc_tpu_torch.runtime.failure as tfailure
import pmdfc_tpu_torch.runtime.net as tnet
import pmdfc_tpu_torch.runtime.qos as tqos
import pmdfc_tpu_torch.runtime.telemetry as ttele
import pmdfc_tpu_torch.runtime.timeseries as tts
import pmdfc_tpu_torch.runtime.workload as twl

JAX = types.SimpleNamespace(
    config=jconfig, kv_mod=jkv, KV=lambda cfg: jkv.KV(cfg),
    backends=jbackends, cleancache=jcleancache, failure=jfailure, net=jnet,
    qos=jqos, tele=jtele, ts=jts, wl=jwl)
PORT = types.SimpleNamespace(
    config=tconfig, kv_mod=tkv, KV=lambda cfg: tkv.KV(cfg, device="cpu"),
    backends=tbackends, cleancache=tcleancache, failure=tfailure, net=tnet,
    qos=tqos, tele=ttele, ts=tts, wl=twl)
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def registries():
    """A fresh port registry for each test; JAX's registry left as it was
    found (a JAX side that configures its own or builds a server must not
    leave scopes behind for a later JAX test of the same worker)."""
    state = jtele._STATE
    found = (state.registry, state.tracing)
    reg = ttele.configure(tconfig.TelemetryConfig(enabled=True))
    yield reg
    state.registry, state.tracing = found
    ttele.configure()


def stop(srv) -> None:
    """Stop a server of either package without waiting out its accept
    loop's join timeout."""
    try:
        srv._lsock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.stop()


def cause_sum(pkg, st) -> int:
    return sum(int(st[k]) for k in pkg.kv_mod.MISS_CAUSE_NAMES)


def counters(st) -> dict:
    """A stats document's counters (every int field but the clock's
    `uptime_s`)."""
    return {k: int(v) for k, v in st.items() if k != "uptime_s"}
