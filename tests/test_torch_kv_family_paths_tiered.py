"""PyTorch port: the `KV` paths of cuckoo-probing, level and static over
the tiered pool, and of HotRing over the flat pool, against the JAX `KV`
(`run_case` in `test_torch_kv_family_paths.py`)."""

import pytest

from test_torch_kv_family_paths import run_case

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("kind", ["ccp", "level", "static"])
def test_family_kv_paths_over_the_tiered_pool_match_jax(kind):
    run_case(kind, "tiered")


def test_hotring_kv_paths_over_the_flat_pool_match_jax():
    run_case("hotring", "flat")
