"""PyTorch port: the `KV` paths of path hashing over the flat and the
tiered pool against the JAX `KV` (`run_case` in
`test_torch_kv_family_paths.py`)."""

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from test_torch_kv_family_paths import run_case

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("pool", ["flat", "tiered"])
def test_path_kv_paths_match_jax(pool):
    run_case("path", pool)
