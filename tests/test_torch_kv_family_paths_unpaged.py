"""PyTorch port: the `KV` paths of the unpaged `KV` (u64 values, no pool)
for cuckoo, cuckoo-probing, level, path and static against the JAX `KV`
(`run_case` in `test_torch_kv_family_paths.py`)."""

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from test_torch_kv_family_paths import run_case

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("kind", ["cuckoo", "ccp", "level", "path",
                                  "static"])
def test_unpaged_family_kv_paths_match_jax(kind):
    run_case(kind, "unpaged")
