"""PyTorch port: `chip_smoke.py`'s phase 17 (`failure`) rehearsed on the CPU.

The phase runs on the card: the failure ladder on a `KVServer` behind the
engine, driven by eight `ReconnectingClient`s over `EngineBackend`
slices: (a) a kill and a restore from a durable checkpoint under eight
streaming client threads (an invalidation after the checkpoint, puts
after it, a torn newest checkpoint refused), (b) dropped completions,
(d) malformed frames through a `NetServer` of `EngineBackend`s and (c) a
stalled driver behind small queues. Here it runs at 2^12 slots, 64-word
pages and 128-key verbs, with the card-only calls stood in for as
`tests/test_torch_smoke.py` stands them in. Four planted faults show the
phase fails when a restored GET serves a wrong page, when an invalidated
key comes back after the restore, when a dropped batch's keys land (and
so hit) and when the torn snapshot is accepted.
"""

from __future__ import annotations

import json

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from test_torch_smoke import KEYS, smoke  # noqa: F401  (fixture)

import chip_smoke
from pmdfc_tpu_torch import checkpoint as tckpt
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.ops import fused
from pmdfc_tpu_torch.runtime import failure as tfailure
from pmdfc_tpu_torch.runtime import server as tserver

pytestmark = pytest.mark.torch

FAIL_TINY = (
    ("FAIL_INDEX", dict(capacity=1 << 12)),
    ("FAIL_BLOOM_BITS", 1 << 15),
    ("FAIL_PAGE_WORDS", 64),
    ("FAIL_VERB", 128),
    ("FAIL_STALL_QUEUE", 16),
    ("FAIL_DRILL_TIMEOUT_US", 2_000_000),  # margin for a loaded CPU
)


@pytest.fixture
def failure(smoke, monkeypatch, tmp_path):  # noqa: F811
    for name, value in FAIL_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "failure_dir",
                        lambda: tmp_path / "failure")
    return smoke


def test_failure_phase_and_its_kernels_line(failure, capsys):
    entries = chip_smoke.run_failure(failure)
    assert [e["path"] for e in entries] == ["failure"]
    e, = entries
    assert set(e) == KEYS and e["name"] == "fused_get_linear_flat"
    assert e["launches"] > 0 and e["max_abs_err"] == 0
    assert e["bound_by"] == "bytes" and e["library_ms"] is None
    out = capsys.readouterr().out
    for needle in ("(a) fill: 3072 pages through the engine",
                   "torn to half and refused", "replayed)",
                   "every invalidated and post-durable key a zeroed miss",
                   "(b) drop_next(3)", "no dropped put landed",
                   "GET flushes not dropped, one per flush",
                   "-> bad_frames 4", "refused (ProtocolError)",
                   "(c) stall_next(6, 0.25)", "full service after it",
                   "gates: no wrong byte", "kernel == plain",
                   "phase 17 took"):
        assert needle in out, needle
    json.dumps(entries)


def test_failure_fails_when_a_restored_get_serves_a_wrong_page(
        failure, monkeypatch):
    """After the durable checkpoint loads, one GET flush's kernel output
    has one word of one hit flipped: a restored GET serves a wrong page."""
    load, counted = tckpt.load, fused.fused_get
    armed = [False]

    def loaded(*args, **kw):
        state = load(*args, **kw)
        armed[0] = True
        return state

    def wrong(keys, *args, **kw):
        out = counted(keys, *args, **kw)
        hits = (out[1] == 0).nonzero().flatten()
        if armed[0] and len(hits):
            out[0][hits[0], 0] ^= 1
            armed[0] = False
        return out

    monkeypatch.setattr(tckpt, "load", loaded)
    monkeypatch.setattr(fused, "fused_get", wrong)
    with pytest.raises(AssertionError, match="wrong page"):
        chip_smoke.run_failure(failure)


def test_failure_fails_when_an_invalidated_key_comes_back(failure,
                                                          monkeypatch):
    """The client forgets its invalidation journal before it reattaches,
    so nothing replays into the restored server."""
    ensure = tfailure.ReconnectingClient._ensure

    def forgetful(self, force=False):
        with self._lock:
            self._inval_journal.clear()
        return ensure(self, force)

    monkeypatch.setattr(tfailure.ReconnectingClient, "_ensure", forgetful)
    with pytest.raises(AssertionError,
                       match="invalidated keys were served after"):
        chip_smoke.run_failure(failure)


def test_failure_fails_when_a_dropped_batch_lands(failure, monkeypatch):
    """The driver applies and launches a batch the fault injector drops,
    withholding only its completions: the dropped put's keys hit."""
    launch = tserver.KVServer._launch

    def leaky(self, reqs):
        fault, self.fault = self.fault, None
        try:
            handles = launch(self, reqs)
            if fault is not None and fault.on_batch(reqs) == "drop":
                return None
            return handles
        finally:
            self.fault = fault

    monkeypatch.setattr(tserver.KVServer, "_launch", leaky)
    with pytest.raises(AssertionError, match="a dropped batch's key hit"):
        chip_smoke.run_failure(failure)


def test_failure_fails_when_the_torn_snapshot_is_accepted(failure,
                                                          monkeypatch):
    """`checkpoint.load` swallows the corruption and hands back an empty
    state."""
    load = tckpt.load

    def lenient(path, config, *args, **kw):
        try:
            return load(path, config, *args, **kw)
        except tckpt.CheckpointCorruptError:
            return tkv.init(config, kw.get("device", "cpu"))

    monkeypatch.setattr(tckpt, "load", lenient)
    with pytest.raises(AssertionError, match="the torn snapshot loaded"):
        chip_smoke.run_failure(failure)
