"""PyTorch port: the concurrency gate the JAX package keeps.

`tools.analyze` holds `pmdfc_tpu/` to the guarded-by and lock-order rules
(`tests/test_analyze.py`). Here the same rule suite runs over
`pmdfc_tpu_torch/`:

- the tree is clean under an allowlist kept in this file, one justified
  line per entry, and the allowlist holds nothing but field-name
  collisions (a local or another class's `stats`/`state` that the
  analyzer takes for a guarded field);
- every lock declared in a serving-tier module (`lockorder.RANKED_MODULES`)
  has a rank in the port's own `sanitizer.HIERARCHY`. The tool's
  `unranked-lock` rule strips the prefix `pmdfc_tpu/`, so it never sees a
  `pmdfc_tpu_torch/` path: the rule is restated here, and a drill shows
  that a lock stripped of its rank is caught.
"""

from __future__ import annotations

from pathlib import Path

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)

from tools.analyze import build_model, run_analysis
from tools.analyze import lockorder
from tools.analyze.model import collect_files

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pmdfc_tpu_torch"

# finding id -> why it is not a race
ALLOW = {
    "guarded-write:pmdfc_tpu_torch/ops/fused.py:"
    "pmdfc_tpu_torch/ops/fused.py:get_core:stats":
        "get_core's local stats vector, not KV.stats",
    "guarded-write:pmdfc_tpu_torch/parallel/shard.py:"
    "ShardedKV._bump_lost:stats":
        "a shard state's stats tensor, written under ShardedKV._lock",
    "guarded-write:pmdfc_tpu_torch/parallel/shard.py:"
    "ShardedKV._get_extent_lane:stats":
        "a lane result's stats tensor, written under ShardedKV._lock",
    "guarded-write:pmdfc_tpu_torch/parallel/shard.py:"
    "ShardedKV._plane_get:stats":
        "a shard state's stats tensor, written under ShardedKV._lock",
    "guarded-write:pmdfc_tpu_torch/bench/swap_sim.py:"
    "pmdfc_tpu_torch/bench/swap_sim.py:run_jobs:stats":
        "bench Sim.stats name-coincidence; single-threaded reset phase",
    "guarded-write:pmdfc_tpu_torch/bench/fused_get.py:"
    "pmdfc_tpu_torch/bench/fused_get.py:composed_get_async:state":
        "a local state of the composed chain, not KV.state",
}


def _allowlist(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("analyze") / "allowlist.txt"
    path.write_text("".join(f"{k}  # {v}\n" for k, v in ALLOW.items()))
    return str(path)


def unranked(model, hierarchy) -> list[str]:
    """The `unranked-lock` rule for port paths: serving-tier locks with no
    rank in `hierarchy`."""
    missing = []
    for decl in model.all_locks():
        mod = decl.module.path.replace("\\", "/").split(
            "pmdfc_tpu_torch/", 1)[-1]
        if mod in lockorder.RANKED_MODULES and decl.lock_id not in hierarchy:
            missing.append(decl.lock_id)
    return missing


@pytest.fixture(scope="module")
def model():
    return build_model(collect_files([str(PORT)]))


def test_port_tree_is_clean_under_its_allowlist(tmp_path_factory):
    findings, stale = run_analysis(roots=[str(PORT)],
                                   allowlist_path=_allowlist(
                                       tmp_path_factory))
    assert not findings, "\n".join(str(f) for f in findings)
    assert not stale, f"stale allowlist entries: {stale}"


def test_allowlist_holds_only_field_name_collisions():
    for ident, why in ALLOW.items():
        assert ident.startswith("guarded-write:"), ident
        assert ident.rsplit(":", 1)[1] in ("stats", "state"), ident
        assert why


def test_port_lock_hierarchy_covers_every_ranked_module_lock(model):
    from pmdfc_tpu_torch.runtime.sanitizer import HIERARCHY

    assert {"runtime/server.py", "runtime/net.py",
            "parallel/shard.py"} <= lockorder.RANKED_MODULES
    assert not unranked(model, HIERARCHY)
    # the port's serving locks are really seen by the restated rule
    ids = {d.lock_id for d in model.all_locks()}
    assert {"KVServer._bf_push_lock", "KV._lock", "ShardedKV._lock",
            "NetServer._flush_cv"} <= ids


def test_unranked_port_serving_lock_is_a_finding(model):
    from pmdfc_tpu_torch.runtime.sanitizer import HIERARCHY

    stripped = {k: v for k, v in HIERARCHY.items()
                if k != "KVServer._bf_push_lock"}
    assert unranked(model, stripped) == ["KVServer._bf_push_lock"]
