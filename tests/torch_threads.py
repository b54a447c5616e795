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
autouse fixture that sets two of JAX's compile options for the test's
length and puts back what it found afterwards:

- `jax_disable_most_optimizations`: XLA compiles the test's programs
  without its expensive optimizations. The JAX side's programs run on
  the same small inputs as the port's, and JAX's compile was most of
  the port files' time; the programs compute the same results either
  way (integer arithmetic, compared exactly with the port's);
- `jax_persistent_cache_min_compile_time_secs` 0: every program the test
  compiles goes to the persistent compile cache, however short its
  compile (the suite's threshold is 0.5 s), so another port file that
  compiles it in another worker reads it from there. The compile options
  are part of a cache entry's key, so these entries are never the JAX
  suites' own: what a JAX test finds in the cache does not depend on them.

A file sets `KEEP_XLA_DEFAULTS = True` to change neither: where its
drills replay a JAX suite's own programs (they then have the suite's
cache keys, and the two files, run side by side, read each other's
compiles from the cache), or where its harnesses run JAX programs for
long enough that XLA's optimized code pays for its compile.
"""

import pytest
import torch

torch.set_num_threads(1)

_THRESHOLD = "jax_persistent_cache_min_compile_time_secs"
_QUICK = "jax_disable_most_optimizations"


@pytest.fixture(autouse=True)
def jax_compile_settings(request):
    import jax

    if getattr(request.module, "KEEP_XLA_DEFAULTS", False):
        yield
        return
    want = {_QUICK: True, _THRESHOLD: 0.0}
    found = {k: jax.config.values[k] for k in want}
    for k, v in want.items():
        jax.config.update(k, v)
    try:
        yield
    finally:
        for k, v in found.items():
            jax.config.update(k, v)
