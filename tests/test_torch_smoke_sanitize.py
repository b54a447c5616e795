"""PyTorch port: `chip_smoke.py`'s phase 19 (`sanitize`) rehearsed on the CPU.

The phase runs on the card under `PMDFC_SAN=on`: (a) JAX's acceptance
soak, a linear·tiered `KV` behind a coalescing `NetServer` and a seeded
`ChaosProxy`, four `ReconnectingClient` workers, the controller attached
and bound to the KV's balloon, a fifth connection whose window is set
live; (c) the traced chaos soak against the same server; (b) the
engine-backed `KVServer` with eight `ReconnectingClient`s over
`EngineBackend` slices and the bloom push on. Here it runs at 2^12 slots,
64-word pages and 128-key verbs for a second or two a part, with the
card-only calls stood in for as `tests/test_torch_smoke.py` stands them
in. Four planted faults show the phase fails when a GET serves one wrong
page, when the serving path takes `NetServer.op_lock` while holding
`KV._lock`, when a controller knob is pushed outside its envelope and
when a completed verb's server span is dropped.
"""

from __future__ import annotations

import json

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from test_torch_smoke import KEYS, smoke  # noqa: F401  (fixture)

import chip_smoke
from pmdfc_tpu_torch.client import backends as tbackends
from pmdfc_tpu_torch.ops import fused
from pmdfc_tpu_torch.runtime import autotune as tautotune
from pmdfc_tpu_torch.runtime import sanitizer as tsan
from pmdfc_tpu_torch.runtime import telemetry as ttele

pytestmark = pytest.mark.torch

SAN_TINY = (
    ("SAN_INDEX", dict(capacity=1 << 12)),
    ("SAN_BLOOM_BITS", 1 << 15),
    ("SAN_PAGE_WORDS", 64),
    ("SAN_VERB", 128),
    ("SAN_OWN", 1 << 10),
    ("SAN_SOAK_S", 2.0),
    ("SAN_ENGINE_S", 1.5),
    ("SAN_ENGINE_OWN", 1 << 9),
    ("SAN_TRACE_KEYS", 1 << 10),
    ("SAN_RING", 1 << 15),
)


@pytest.fixture
def sanitize(smoke, monkeypatch, tmp_path):  # noqa: F811
    for name, value in SAN_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "sanitize_dir",
                        lambda: tmp_path / "sanitize")
    yield smoke
    tsan.reset()
    tsan.configure(on=False)
    ttele.configure()


def test_sanitize_phase_and_its_kernels_line(sanitize, capsys):
    entries = chip_smoke.run_sanitize(sanitize)
    assert [e["path"] for e in entries] == ["sanitize-tiered", "sanitize"]
    assert [e["name"] for e in entries] == ["fused_get_linear_tiered",
                                            "fused_get_linear_flat"]
    for e in entries:
        assert set(e) == KEYS
        assert e["launches"] > 0 and e["max_abs_err"] == 0
        assert e["bound_by"] == "bytes" and e["library_ms"] is None
    assert not tsan.enabled()  # put back as found
    out = capsys.readouterr().out
    for needle in ("PMDFC_SAN=on, hold limit 200 ms",
                   "(a) soak", "hits byte-exact, every miss zeroed",
                   "window 32 -> 4 -> 64 live", "violations []",
                   "(a) controller:", "check_autotune over MSG_STATS []",
                   "(c) traced soak", "each joined to a server span",
                   "(b) engine-backed KVServer", "no -2 status",
                   "bloom push {", "GET flushes; PMDFC_SAN=on",
                   "GET phases", "kernel == plain", "phase 19 took"):
        assert needle in out, needle
    json.dumps(entries)


def test_sanitize_fails_when_a_get_serves_a_wrong_page(sanitize,
                                                       monkeypatch):
    """One GET's kernel output has one word of one hit flipped."""
    counted = fused.fused_get
    armed = [True]

    def flip(keys, *a, **kw):
        out, cause, rows, slots = counted(keys, *a, **kw)
        hit = (cause == 0).nonzero().flatten()
        if armed[0] and len(hit) and keys.shape[0] > 1:
            armed[0] = False
            out = out.clone()
            out[hit[0], 0] ^= 1
        return out, cause, rows, slots

    monkeypatch.setattr(fused, "fused_get", flip)
    with pytest.raises(AssertionError, match="wrong page"):
        chip_smoke.run_sanitize(sanitize)


def test_sanitize_fails_on_a_lock_inversion_on_the_serving_path(
        sanitize, monkeypatch):
    """The serving backend takes `NetServer.op_lock` (rank 30) while it
    holds `KV._lock` (rank 65): the sanitizer reports the inversion."""
    real = tbackends.DirectBackend.get
    planted = {}

    def get(self, keys):
        op = planted.setdefault("lock", tsan.lock("NetServer.op_lock"))
        with self.kv._lock:
            with op:
                pass
        return real(self, keys)

    monkeypatch.setattr(tbackends.DirectBackend, "get", get)
    with pytest.raises(AssertionError, match="sanitizer violations"):
        chip_smoke.run_sanitize(sanitize)
    assert any(v["kind"] == "inversion"
               and v["acquired"] == "NetServer.op_lock"
               and v["while_holding"] == "KV._lock"
               for v in tsan.violations())


def test_sanitize_fails_when_a_knob_leaves_its_envelope(sanitize,
                                                        monkeypatch):
    """After every controller round a knob (not the balloon's) lands past
    its envelope's top and is published there, whether or not the round
    stepped a knob (a loaded host can end the phase before one does):
    `check_autotune` over the server's MSG_STATS document refuses it."""
    real = tautotune.AutotuneController.tick

    def tick(self):
        out = real(self)
        with self._lock:
            k = self._knobs[min(n for n in self._knobs if n != "balloon_x")]
            top = k.hi * 2
            k.setter(int(top) if k.integer else top)
            self.stats.set(f"knob_{k.name}", top)
        return out

    monkeypatch.setattr(tautotune.AutotuneController, "tick", tick)
    with pytest.raises(AssertionError, match="check_autotune"):
        chip_smoke.run_sanitize(sanitize)


def test_sanitize_fails_when_a_server_span_is_dropped(sanitize,
                                                      monkeypatch):
    """The server's ring loses every record of the first five verbs the
    traced soak sends it (their op spans, queue waits and phases): those
    of them that complete join no server span."""
    armed = {"on": False}
    victims: set = set()
    real_soak = chip_smoke.san_traced

    def traced(*a, **kw):
        armed["on"] = True
        return real_soak(*a, **kw)

    def dropped(src, trace) -> bool:
        if not armed["on"] or src != "server" or not trace:
            return False
        if trace not in victims and len(victims) < 5:
            victims.add(trace)
        return trace in victims

    end, record, tree = (ttele.span_end, ttele.record_span,
                         ttele.record_tree_span)

    def span_end(span, *a, **kw):
        if span is not None and dropped(span.src, span.trace):
            return None
        return end(span, *a, **kw)

    def record_span(src, op, trace, *a, **kw):
        return None if dropped(src, trace) else record(src, op, trace, *a,
                                                       **kw)

    def record_tree_span(src, op, trace, *a, **kw):
        return None if dropped(src, trace) else tree(src, op, trace, *a,
                                                     **kw)

    monkeypatch.setattr(chip_smoke, "san_traced", traced)
    monkeypatch.setattr(ttele, "span_end", span_end)
    monkeypatch.setattr(ttele, "record_span", record_span)
    monkeypatch.setattr(ttele, "record_tree_span", record_tree_span)
    with pytest.raises(AssertionError, match="no server span"):
        chip_smoke.run_sanitize(sanitize)
    assert len(victims) == 5
