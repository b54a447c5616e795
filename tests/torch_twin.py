"""Shared pieces of the twin suites (`test_torch_qos.py`,
`test_torch_containment.py`, `test_torch_chaos.py`, `test_torch_xray.py`,
`test_torch_fastpath.py`, `test_torch_bf_push.py`,
`test_torch_onesided.py`): each package's modules under one name, the
telemetry registries, the loopback server stop and the deep comparison of
two packages' transcripts."""

from __future__ import annotations

import copy
import functools
import math
import socket
import types

import jax
import numpy as np
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


@pytest.fixture(scope="module")
def jax_jit_caches_left_cold():
    """For a twin of a JAX suite that counts its own compiles
    (`test_fused.py`, `test_tracing.py`: a batch outside the warmed pad
    ladder is traced, and counted, exactly once): JAX's in-process jit
    caches dropped once the twin's tests are done. A JAX program is traced
    once per process, so the suite, if it runs later in the same worker,
    would otherwise find the programs the twin's JAX side traced and
    count nothing."""
    yield
    jax.clear_caches()


@pytest.fixture
def fresh_jax_registry(registries):
    """JAX's side registers its servers' scopes in a fresh JAX registry;
    `registries` puts the one found back after the test (a later JAX test
    of the worker reads the registry's gauges)."""
    jtele.configure()


@pytest.fixture
def jax_registry():
    """For a file that keeps its port registry: JAX's side registers its
    servers' scopes in a fresh JAX registry, and the one found is put back
    after the test (a later JAX test of the worker reads its scopes)."""
    state = jtele._STATE
    found = (state.registry, state.tracing)
    jtele.configure()
    yield
    state.registry, state.tracing = found


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
    """A stats document's counters: every int field, once its clock
    `uptime_s` is checked to be there (`timeless`)."""
    return {k: int(v) for k, v in timeless(st).items() if k != "uptime_s"}


def bits(x) -> np.ndarray:
    """A result or leaf of either package (a tensor or an array) as int64
    of its 32-bit pattern: the port's int32 bits of u32 words, JAX's
    uint32 words and both packages' int32 slots compare alike. Bools stay
    bools."""
    if hasattr(x, "numpy") and not isinstance(x, np.ndarray):
        x = x.numpy()
    a = np.asarray(x)
    return a if a.dtype == bool else a.astype(np.int64) & 0xFFFFFFFF


# the wall-clock fields a transcript can carry: the recovering window's age
# (`KV.recovery_info`, the MSG_RECOVERY reply), the last window's length
# (the `recovery` scope's gauge) and a stats document's uptime
CLOCKS = frozenset({"recovering_s", "last_recovery_s", "uptime_s"})


class _Clock:
    """What `timeless` leaves in place of a clock's reading: equal to any
    other reading."""

    def __eq__(self, other) -> bool:
        return isinstance(other, _Clock)

    def __repr__(self) -> str:
        return "<clock>"


CLOCK = _Clock()


def timeless(x, keys=CLOCKS, where: str = ""):
    """`x` with the value of every wall-clock field (a dict key in `keys`,
    at any depth) replaced by `CLOCK`, once the value is checked to be a
    finite float >= 0. Two packages each read their own clock, so a twin
    compares such a field by its presence and type, never by its value."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in keys:
                assert isinstance(v, (float, np.floating)) and \
                    math.isfinite(v) and v >= 0, f"{where}.{k}: {v!r}"
                out[k] = CLOCK
            else:
                out[k] = timeless(v, keys, f"{where}.{k}")
        return out
    if isinstance(x, (tuple, list)):
        items = [timeless(v, keys, f"{where}[{i}]") for i, v in enumerate(x)]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def same(a, b, where: str = "") -> None:
    """Deep equality of two packages' transcripts (`timeless`: a clock
    field by its presence and type): arrays (and numpy scalars) by dtype,
    shape and value, sequences and dicts item by item, anything else by
    ==."""
    _same(timeless(a, where=where), timeless(b, where=where), where)


def _same(a, b, where: str) -> None:
    if isinstance(a, (np.ndarray, np.generic)) or isinstance(
            b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{where}: dtype {a.dtype} vs {b.dtype}"
        assert a.shape == b.shape and np.array_equal(a, b), f"{where} differs"
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), f"{where}: length {len(a)} vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), f"{where}: {set(a) ^ set(b)}"
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


def twin(drill, *args, pkgs=PKGS):
    """`drill(pkg, *args)` on JAX, then on the port; the transcripts must
    be equal -> the port's."""
    a, b = (drill(pkg, *args) for pkg in pkgs)
    same(a, b, drill.__name__)
    return b


# -- the catalogue of the twins' store configs -------------------------------

# the tiered pool of the family, path and KV-surface twins: a 16th of the
# slots as hot rows, 512 cold rows circulating at first, the balloon
# moving 32 rows a step and growing when fewer than 32 are free
TWIN_TIER = dict(hot_fraction=16, ghost_rows=32, balloon_step=32,
                 max_promotes_per_batch=16, cold_init_rows=512,
                 grow_free_rows=32)


def kv_configs(kind: str = "linear", pool: str = "flat", page_words: int = 64,
               **index):
    """The (JAX, port) `KVConfig` pair the family, path and KV-surface
    twins share, so that one worker's jit cache and the persistent cache
    serve them alike: an index of `kind` with 1024 slots (`index` adds or
    overrides its fields), 64-word pages, a 2^12-bit bloom, a 2^10-bit
    evicted-key sketch; `pool` is "flat", "unpaged" or "tiered" (with
    `TWIN_TIER`)."""
    assert pool in ("flat", "unpaged", "tiered"), pool

    def make(c):
        return c.KVConfig(
            index=c.IndexConfig(kind=c.IndexKind(kind),
                                **{"capacity": 1024, **index}),
            page_words=page_words, paged=pool != "unpaged",
            bloom=c.BloomConfig(num_bits=1 << 12),
            evicted_sketch_bits=1 << 10,
            tier=c.TierConfig(**TWIN_TIER) if pool == "tiered" else None)
    return make(jconfig), make(tconfig)


# -- JAX's answers, once per process -----------------------------------------

_ANSWERS: dict = {}


def jax_once(key, build):
    """JAX's answer to one twin question, asked once per process:
    `build()` runs live the first time `key` is asked in this worker, and
    every caller, the first included, gets its own deep copy of the
    answer, so a caller that changes its copy changes no other caller's.
    Nothing is written to disk: another worker asks JAX again. The key
    names the callable, the config and the seeded inputs in full."""
    if key not in _ANSWERS:
        _ANSWERS[key] = build()
    return copy.deepcopy(_ANSWERS[key])


def jax_memo(build):
    """`build(*args, **kw)` through `jax_once`, keyed by its module, its
    name and its arguments (all hashable)."""
    @functools.wraps(build)
    def call(*args, **kw):
        key = (build.__module__, build.__qualname__, args,
               tuple(sorted(kw.items())))
        return jax_once(key, lambda: build(*args, **kw))
    return call


def walk_in_reverse(namespace: dict) -> None:
    """Collect a module's tests in the reverse of their order in its file
    (call last, with the module's `globals()`). A twin file that keeps
    XLA's defaults (`KEEP_XLA_DEFAULTS`) replays its JAX suite's drills,
    so it compiles the same JAX programs, with the same cache keys, in
    the same order. Where `--dist loadfile` runs the two files at once in
    two workers, walking the opposite way, each finds about half of those
    programs already in the persistent compile cache, written by the
    other, instead of both compiling all of them at the same time
    (`torch_testtime.py overlap` says which pairs ran at once, `keys`
    what each handed the other). A twin compiled with other options
    shares no cache entry with its suite, and walking gains it nothing."""
    for name in [n for n in namespace if n.startswith("test_")][::-1]:
        namespace[name] = namespace.pop(name)
