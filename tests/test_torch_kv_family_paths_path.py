"""PyTorch port: the `KV` paths of path hashing over the flat and the
tiered pool against the JAX `KV` (`run_case` in
`test_torch_kv_family_paths.py`)."""

import pytest

from test_torch_kv_family_paths import run_case

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("pool", ["flat", "tiered"])
def test_path_kv_paths_match_jax(pool):
    run_case("path", pool)
