"""PyTorch port: `chip_smoke.py`'s phase 15 (`trace`) rehearsed on the CPU.

The phase runs on the card: a 4-shard plane behind `NetServer` in the
smoke's process, a client child of `chip_smoke.py --trace-client` driving
it through `ReplicaGroup(rf 1) -> ReconnectingClient -> pipelined
TcpBackend`, both processes' flight dumps merged by
`tools/tracetool.py`, the shard spans held to the mesh counters, each
`flush:get` span to its device window, the SLO breach drill and healthy
control, and the two sweeps in the harness lanes. Here it runs at 4
connections (2 x 2) over 2^12 slots a shard, 64-word pages and 128-key
verbs, with the card-only calls stood in for as `tests/test_torch_smoke.py`
stands them in (the device window is the fetch's host time on the CPU).
The mutation cases show the phase fails when the flush span is dropped
from the server's ring (the chain is cut) and when one GET serves one
wrong page.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from test_torch_smoke import KEYS, smoke  # noqa: F401  (fixture)

import chip_smoke
from pmdfc_tpu_torch.ops import fused
from pmdfc_tpu_torch.runtime import telemetry as ttele

pytestmark = pytest.mark.torch

TRACE_TINY = (
    ("TRACE_INDEX", dict(capacity=1 << 12)),
    ("TRACE_BLOOM_BITS", 1 << 15),
    ("TRACE_PAGE_WORDS", 64),
    ("TRACE_CONNS", 4),
    ("TRACE_PUTS", 2),
    ("TRACE_GETS", 4),
    ("TRACE_VERB", 128),
    ("TRACE_WARMUP_GETS", 4),
    ("TRACE_HEALTHY_GETS", 4),
    ("DRILL_INDEX", dict(capacity=1 << 12)),
    ("TRACE_SWEEPS", (("net_sweep", ("--smoke",)),
                      ("autotune_sweep", ("--smoke", "--backend",
                                          "direct")))),
)


@pytest.fixture
def trace(smoke, monkeypatch):  # noqa: F811
    for name, value in TRACE_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    return smoke


@pytest.fixture
def trace_alone(trace, monkeypatch):
    """Phase 15 without the sweeps."""
    monkeypatch.setattr(chip_smoke, "TRACE_SWEEPS", ())
    return trace


def test_trace_phase_and_its_kernels_line(trace, capsys):
    entries = chip_smoke.run_trace(trace)
    (e,) = entries
    assert set(e) == KEYS and e["path"] == "trace-plane"
    assert e["name"] == "fused_get_linear_flat"
    assert e["launches"] > 0 and e["max_abs_err"] == 0
    assert e["bound_by"] == "bytes" and e["library_ms"] is None
    out = capsys.readouterr().out
    for needle in ("[trace] stage flush:get", "[trace] stage shard:get",
                   "[trace] stage server:queue_wait",
                   "16 GET traces joined", "check_flight clean",
                   "== mesh.shard{i}_ops", "device windows: every one",
                   "healthy control: warm-up", "breach drill: 20 ms lag",
                   "the dump names flush:get",
                   "[trace] sweep net_sweep", "[trace] sweep autotune_sweep",
                   "net_sweep row net_get_throughput",
                   "autotune_sweep row autotune_light_get_p99",
                   "phase 15 took", "kernel == plain"):
        assert needle in out, needle
    json.dumps(entries)


def test_trace_fails_when_the_flush_span_is_dropped(trace_alone,
                                                    monkeypatch):
    """The server's ring loses every `flush:get` span: the op's phase
    span no longer reaches the shard programs, and the joined trace is
    cut short of the chain."""
    real = ttele.Registry.record

    def record(self, rec):
        if rec.get("op") != "flush:get":
            real(self, rec)

    monkeypatch.setattr(ttele.Registry, "record", record)
    with pytest.raises(AssertionError, match="deep without the chain"):
        chip_smoke.run_trace(trace_alone)


def test_trace_fails_when_a_get_serves_a_wrong_page(trace_alone,
                                                    monkeypatch):
    """One word of one hit flipped in one plane GET: the client child
    sees it and the phase fails. The flipped hit is a pre-filled key's:
    a key the client's `ReplicaGroup` put itself is held to the digest
    the group recorded at the put, so a flipped page of one comes back as
    a legal miss, not as wrong bytes, and whether the first GET's first
    hit is such a key depends on the order the verbs coalesce in."""
    counted = fused.fused_get
    done = []
    pre = int(np.uint32(chip_smoke.TRACE_HI).view(np.int32))

    def wrong(keys, *args, **kw):
        out = counted(keys, *args, **kw)
        hits = ((out[1] == 0) & (keys[:, 0] == pre)).nonzero().flatten()
        if not done and len(hits):
            done.append(1)
            out[0][hits[0], 0] ^= 1
        return out

    monkeypatch.setattr(fused, "fused_get", wrong)
    with pytest.raises(AssertionError, match="1 hits with wrong bytes"):
        chip_smoke.run_trace(trace_alone)
