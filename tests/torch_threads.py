"""One intra-op thread per test process for the port's CPU tests, and the
JAX compile settings of a port test.

The suite runs under pytest-xdist, several workers side by side on one
host. Left alone, every worker's torch starts one OpenMP thread per core
for each op on a large enough tensor, so the workers' threads outnumber
the cores many times over and spin against each other: a port test took
four times as long in the full suite as alone. The port's tests work on
small tensors, where one thread per process loses nothing. Every
`tests/test_torch_*.py` imports this module, so the cap holds in each
worker whatever file it collects first; nothing of what a test checks
depends on it.

Every `tests/test_torch_*.py` also imports `jax_compile_settings`, an
autouse fixture that changes these for the test's length and puts back
what it found afterwards:

- `OMP_NUM_THREADS` and `MKL_NUM_THREADS` 1 in the environment, so a
  child process the test starts (a spawned crashbox node, a harness or
  a `chip_smoke.py` lane child, a multi-process worker) caps its torch
  at one thread too, as the worker does, instead of one per core;
- `jax_disable_most_optimizations`: XLA compiles the test's programs
  without its expensive optimizations. The JAX side's programs run on
  the same small inputs as the port's, and JAX's compile was most of
  the port files' time; the programs compute the same results either
  way (integer arithmetic, compared exactly with the port's);
- `xla_cpu_use_fusion_emitters` off, passed to XLA with each program's
  compile options (`CPU_OPTIONS`): XLA:CPU emits each fusion through its
  older elemental emitter instead of compiling one kernel a fusion on
  a pool of threads as wide as the host. Beside five other workers,
  that pool was the largest load on the host; without it the port
  files' compiles took about 30% less time in the full suite, with the
  same results;
- `jax_persistent_cache_min_compile_time_secs` 0: every program the test
  compiles goes to the persistent compile cache, however short its
  compile (the suite's threshold is 0.5 s), so another port file that
  compiles it in another worker reads it from there. The compile options
  are part of a cache entry's key, so these entries are never the JAX
  suites' own: what a JAX test finds in the cache does not depend on them.

A file sets `KEEP_XLA_DEFAULTS = True` to change none of JAX's settings
(the environment still caps a child's threads): where its drills replay
a JAX suite's own programs (they then have the suite's cache keys, and
the suite, run before or beside it, hands it its compiles through the
cache), or where its harnesses run JAX programs for long enough that
XLA's optimized code pays for its compile.
"""

import pytest
import torch

torch.set_num_threads(1)

_THRESHOLD = "jax_persistent_cache_min_compile_time_secs"
_QUICK = "jax_disable_most_optimizations"
CHILD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
CPU_OPTIONS = {"xla_cpu_use_fusion_emitters": False}


def _with_cpu_options(get_compile_options):
    """JAX's `get_compile_options` with `CPU_OPTIONS` added to the options
    a program's compile passes on to XLA."""
    def call(*args, env_options_overrides=None, **kw):
        return get_compile_options(
            *args, env_options_overrides={**(env_options_overrides or {}),
                                          **CPU_OPTIONS}, **kw)
    return call


@pytest.fixture(autouse=True)
def jax_compile_settings(request):
    import jax
    from jax._src import compiler

    # its own patcher: a test's `monkeypatch.undo()` leaves these in place
    with pytest.MonkeyPatch.context() as mp:
        for k, v in CHILD_ENV.items():
            mp.setenv(k, v)
        if getattr(request.module, "KEEP_XLA_DEFAULTS", False):
            yield
            return
        mp.setattr(compiler, "get_compile_options",
                   _with_cpu_options(compiler.get_compile_options))
        want = {_QUICK: True, _THRESHOLD: 0.0}
        found = {k: jax.config.values[k] for k in want}
        for k, v in want.items():
            jax.config.update(k, v)
        try:
            yield
        finally:
            for k, v in found.items():
                jax.config.update(k, v)
