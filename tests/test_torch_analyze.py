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

Four more of the tool's rules cannot see the port as it stands, so each
is restated here for port paths and held clean on the port tree, with a
planted port-path fixture that it must catch:

- **lock rank with the port's table.** `lockorder` ranks edges with
  JAX's `HIERARCHY` (`lockorder._hierarchy`), which lacks the port's
  `KVServer._bf_push_lock` (58) and `engine._lib_lock` (75), and skips an
  edge with an unranked endpoint. Here `_hierarchy` returns the port's
  table.
- **the profiler seam for torch.** JAX's rule looks for
  `block_until_ready` only. A `synchronize` call (`torch.cuda`, an event,
  a stream) in a port module outside `runtime/profiler.py` and `bench/`
  is a finding, keyed as JAX's rule keys its ids; the port's one sync is
  `profiler.block_ready`.
- **the kernel gate.** JAX requires each `pallas_call` to have a CPU
  path. The port's rule is stricter: in `pmdfc_tpu_torch/ops/`, a plain
  version (`*_reference`) is called only under a branch on
  `.type == "cpu"` and never from an `except` handler, and a built entry
  (`_entry(...)`) is reached only on the CUDA branch, so no failure of a
  kernel can fall back to its plain version.
- **one wire vocabulary.** `check_wire_drift` compares each module with
  the first `runtime/net.py` of its model; each tree was only analyzed
  alone. Here one model holds both trees.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)

import pmdfc_tpu.runtime.sanitizer as jsan
import pmdfc_tpu_torch.runtime.sanitizer as tsan
from tools.analyze import Allowlist, Finding, build_model, run_analysis
from tools.analyze import jaxrules, lockorder
from tools.analyze.model import collect_files
from tools.analyze.resolve import analyze_functions

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pmdfc_tpu_torch"
JAX_TREE = ROOT / "pmdfc_tpu"

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


def port_ranks(model, facts, allow=None, hierarchy=None) -> list:
    """`lockorder.run` with the port's `HIERARCHY` (or `hierarchy`) in
    place of JAX's -> its findings."""
    table = dict(tsan.HIERARCHY if hierarchy is None else hierarchy)
    real = lockorder._hierarchy
    lockorder._hierarchy = lambda: dict(table)
    try:
        return lockorder.run(model, facts, allow or Allowlist({}))
    finally:
        lockorder._hierarchy = real


def ranked_edges(facts, hierarchy) -> set:
    """The lock-order edges whose two endpoints `hierarchy` ranks: the
    edges the lock-rank rule checks with that table."""
    return {(e.src, e.dst) for e in lockorder.build_edges(facts)
            if e.src != e.dst and e.src in hierarchy and e.dst in hierarchy}


def _port_path(mi) -> str | None:
    """The part of a module path after `pmdfc_tpu_torch/`, or None for a
    module outside the port."""
    path = mi.path.replace("\\", "/")
    if not (path.startswith("pmdfc_tpu_torch/")
            or "/pmdfc_tpu_torch/" in path):
        return None
    return path.split("pmdfc_tpu_torch/", 1)[1]


def _callee(call: ast.Call) -> str | None:
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else None


def torch_seam(model, allow=None) -> list:
    """The profiler-seam rule for port paths: a `synchronize` call (the
    function `torch.cuda.synchronize`, or an event's or a stream's method)
    outside `runtime/profiler.py` and `bench/` is a finding, with JAX's
    id `profiler-seam:<path>:<enclosing def>`."""
    allow = allow or Allowlist({})
    out = []
    for mi in model.modules.values():
        rel = _port_path(mi)
        if rel is None or rel.startswith("bench/") or "/bench/" in rel \
                or rel == "runtime/profiler.py":
            continue
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call) or \
                    _callee(node) != "synchronize":
                continue
            ident = (f"profiler-seam:{mi.path}:"
                     f"{jaxrules._enclosing_name(mi.tree, node)}")
            if allow.allows(ident):
                continue
            out.append(Finding(
                "profiler-seam", mi.path, node.lineno, ident,
                "a device sync outside the profiler's seam: route it "
                "through `profiler.block_ready` (runtime/profiler.py)"))
    return out


def _type_test(test, op, value: str) -> bool:
    """`<expr>.type <op> "<value>"`."""
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], op)
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == value)


def _parents(tree) -> dict:
    return {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}


def _chain(node, parents):
    """(child, ancestor) pairs from `node` up to its enclosing def."""
    while node in parents:
        up = parents[node]
        yield node, up
        if isinstance(up, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        node = up


def _under(chain, op, value: str) -> bool:
    """Whether the call sits in the body of an `if <x>.type <op> value`."""
    return any(isinstance(up, ast.If) and _type_test(up.test, op, value)
               and child in up.body for child, up in chain)


def _after_cuda_guard(chain) -> bool:
    """Whether, in the enclosing def, an earlier statement is
    `if <x>.type != "cuda": raise ...`: the rest is the CUDA branch."""
    if not chain or not isinstance(chain[-1][1], (ast.FunctionDef,
                                                  ast.AsyncFunctionDef)):
        return False
    top, fn = chain[-1]
    for stmt in fn.body[:fn.body.index(top)]:
        if isinstance(stmt, ast.If) and _type_test(stmt.test, ast.NotEq,
                                                   "cuda") \
                and isinstance(stmt.body[-1], ast.Raise):
            return True
    return False


def kernel_gate(model, allow=None) -> list:
    """The port's kernel gate over `pmdfc_tpu_torch/ops/`: a plain version
    (`*_reference`) is called only under `if <x>.type == "cpu"` and never
    from an `except` handler; a built entry (`_entry(...)`) only on the
    CUDA branch (under `if <x>.type == "cuda"`, or after an
    `if <x>.type != "cuda": raise`) and never from a handler. Id:
    `kernel-gate:<path>:<enclosing def>:<callee>`."""
    allow = allow or Allowlist({})
    out = []
    for mi in model.modules.values():
        rel = _port_path(mi)
        if rel is None or not rel.startswith("ops/"):
            continue
        parents = _parents(mi.tree)
        for node in ast.walk(mi.tree):
            name = _callee(node) if isinstance(node, ast.Call) else None
            if name is None or not (name.endswith("_reference")
                                    or name == "_entry"):
                continue
            chain = list(_chain(node, parents))
            if any(isinstance(up, ast.ExceptHandler) for _, up in chain):
                why = "called from an `except` handler"
            elif name == "_entry":
                why = None if (_under(chain, ast.Eq, "cuda")
                               or _after_cuda_guard(chain)) \
                    else "reached off the CUDA branch"
            else:
                why = None if _under(chain, ast.Eq, "cpu") \
                    else 'not under a `.type == "cpu"` branch'
            if why is None:
                continue
            ident = (f"kernel-gate:{mi.path}:"
                     f"{jaxrules._enclosing_name(mi.tree, node)}:{name}")
            if allow.allows(ident):
                continue
            out.append(Finding(
                "kernel-gate", mi.path, node.lineno, ident,
                f"`{name}` {why}: a CPU tensor runs the plain version, a "
                "CUDA tensor launches the kernel or raises"))
    return out


def kernel_sites(model) -> list[tuple[str, str]]:
    """(path, callee) of every `*_reference` and `_entry` call the gate
    looks at: the rule is not vacuous."""
    return sorted((mi.path, _callee(n)) for mi in model.modules.values()
                  if (_port_path(mi) or "").startswith("ops/")
                  for n in ast.walk(mi.tree) if isinstance(n, ast.Call)
                  and (_callee(n) or "").endswith(("_reference", "_entry")))


def wire_constants(model, suffix: str) -> dict:
    """NAME -> value of the wire constants of the model's module whose
    path ends with `suffix`."""
    mi, = [m for m in model.modules.values()
           if m.path.replace("\\", "/").endswith(suffix)]
    return {k: v for k, (v, _) in jaxrules._wire_constants(mi).items()}


def write_tree(root: Path, files: dict) -> list[tuple[str, str]]:
    """Write `{relative path: source}` under `root` -> build_model's
    `(absolute, relative)` pairs."""
    out = []
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
        out.append((str(p), rel))
    return out


@pytest.fixture(scope="module")
def model():
    return build_model(collect_files([str(PORT)]))


@pytest.fixture(scope="module")
def facts(model):
    return analyze_functions(model)


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


# -- the restated rules ------------------------------------------------------

_KV_SERVER = '''
import threading


class KV:
    def __init__(self):
        # guarded-by: <none>  (fixture)
        self._lock = threading.RLock()


class KVServer:
    def __init__(self):
        self.kv = KV()
        # guarded-by: <none>  (fixture)
        self._bf_push_lock = threading.Lock()

    def push_cycle(self):
        with self._bf_push_lock:
            pass

    def flush(self):
        with self.kv._lock:
            self.push_cycle()
'''

_ENGINE = '''
import threading

# guarded-by: <none>  (fixture)
_lib_lock = threading.Lock()


class KV:
    def __init__(self):
        # guarded-by: <none>  (fixture)
        self._lock = threading.RLock()

    def load(self):
        with _lib_lock:
            with self._lock:
                pass
'''


def test_port_lock_ranks_hold_with_the_port_table(model, facts):
    """The port tree is clean under the lock-rank rule with its own table,
    and that table checks edges JAX's cannot: those through
    `KVServer._bf_push_lock` and `engine._lib_lock`'s callees."""
    found = port_ranks(model, facts, Allowlist(dict(ALLOW)))
    assert found == [], "\n".join(str(f) for f in found)
    mine = ranked_edges(facts, tsan.HIERARCHY)
    theirs = ranked_edges(facts, jsan.HIERARCHY)
    extra = mine - theirs
    assert {("KVServer._bf_push_lock", "KVServer._bf_lock")} <= extra
    assert all("KVServer._bf_push_lock" in e or "engine._lib_lock" in e
               for e in extra), extra


@pytest.mark.parametrize("name,files,ident", [
    ("bf-push", {"pmdfc_tpu_torch/runtime/server.py": _KV_SERVER},
     "lock-rank:KV._lock->KVServer._bf_push_lock"),
    ("lib-lock", {"pmdfc_tpu_torch/runtime/engine.py": _ENGINE},
     "lock-rank:engine._lib_lock->KV._lock"),
])
def test_planted_port_rank_inversion_is_a_finding(tmp_path, name, files,
                                                  ident):
    m = build_model(write_tree(tmp_path, files))
    f = analyze_functions(m)
    assert [x.ident for x in port_ranks(m, f)] == [ident]
    # JAX's table ranks neither port lock: its rule passes the inversion
    real = port_ranks(m, f, hierarchy=jsan.HIERARCHY)
    assert [x.rule for x in real] == []


def test_port_sync_calls_stay_inside_the_profiler_seam(model):
    assert torch_seam(model) == []
    prof = [mi for mi in model.modules.values()
            if mi.path.endswith("runtime/profiler.py")][0]
    # the seam itself holds the port's one sync
    assert any(isinstance(n, ast.Call) and _callee(n) == "synchronize"
               for n in ast.walk(prof.tree))


_SYNCS = '''
import torch


def drain(kv):
    torch.cuda.synchronize(kv.device)


def wait_event(ev):
    ev.synchronize()


def wait_stream(dev):
    torch.cuda.current_stream(dev).synchronize()
'''


def test_planted_sync_outside_the_seam_is_a_finding(tmp_path):
    files = write_tree(tmp_path, {
        "pmdfc_tpu_torch/runtime/leak.py": _SYNCS,
        "pmdfc_tpu_torch/bench/lat.py": _SYNCS,
        "pmdfc_tpu_torch/runtime/profiler.py": _SYNCS})
    found = torch_seam(build_model(files))
    assert {f.ident for f in found} == {
        f"profiler-seam:pmdfc_tpu_torch/runtime/leak.py:{q}"
        for q in ("drain", "wait_event", "wait_stream")}
    allow = Allowlist({
        "profiler-seam:pmdfc_tpu_torch/runtime/leak.py:drain": "drill"})
    assert len(torch_seam(build_model(files), allow)) == 2
    assert allow.unused() == []


def test_port_kernel_wrappers_pass_the_gate(model):
    assert kernel_gate(model) == []
    assert ("pmdfc_tpu_torch/ops/fused.py", "_entry") in kernel_sites(model)
    assert ("pmdfc_tpu_torch/ops/fused.py",
            "get_core_reference") in kernel_sites(model)


_GATES = {
    "fallback": '''
from pmdfc_tpu_torch.ops.fused import _entry, get_core_reference


def fused_get(keys, table):
    try:
        return _entry("fused_get_linear_flat")(keys, table)
    except Exception:
        return get_core_reference(keys, table)
''',
    "ungated": '''
from pmdfc_tpu_torch.ops.fused import _entry, get_core_reference


def fused_get(keys, table):
    if keys.device.type != "cpu":
        return _entry("fused_get_linear_flat")(keys, table)
    return get_core_reference(keys, table)
''',
    "clean": '''
from pmdfc_tpu_torch.ops.fused import _entry, get_core_reference


def fused_get(keys, table):
    if keys.device.type == "cpu":
        return get_core_reference(keys, table)
    if keys.device.type != "cuda":
        raise ValueError(keys.device)
    return _entry("fused_get_linear_flat")(keys, table)


def fused_get_branch(keys, table):
    if keys.device.type == "cuda":
        return _entry("fused_get_linear_flat")(keys, table)
    elif keys.device.type == "cpu":
        return get_core_reference(keys, table)
    raise ValueError(keys.device)
''',
}


@pytest.mark.parametrize("shape,idents", [
    ("fallback", {"kernel-gate:pmdfc_tpu_torch/ops/gate.py:fused_get:"
                  "get_core_reference",
                  "kernel-gate:pmdfc_tpu_torch/ops/gate.py:fused_get:"
                  "_entry"}),
    ("ungated", {"kernel-gate:pmdfc_tpu_torch/ops/gate.py:fused_get:"
                 "get_core_reference",
                 "kernel-gate:pmdfc_tpu_torch/ops/gate.py:fused_get:"
                 "_entry"}),
    ("clean", set()),
])
def test_planted_kernel_gate_shapes(tmp_path, shape, idents):
    m = build_model(write_tree(
        tmp_path, {"pmdfc_tpu_torch/ops/gate.py": _GATES[shape]}))
    assert {f.ident for f in kernel_gate(m)} == idents
    # outside ops/ the gate does not apply
    m = build_model(write_tree(
        tmp_path / "x", {"pmdfc_tpu_torch/bench/gate.py": _GATES[shape]}))
    assert kernel_gate(m) == []


@pytest.fixture(scope="module")
def both_trees():
    return build_model(collect_files([str(JAX_TREE), str(PORT)]))


def test_one_wire_vocabulary_across_both_trees(both_trees):
    assert jaxrules.check_wire_drift(both_trees, Allowlist({})) == []
    want = wire_constants(both_trees, "pmdfc_tpu/runtime/net.py")
    got = wire_constants(both_trees, "pmdfc_tpu_torch/runtime/net.py")
    assert got == want
    assert {"PIPE_FLAG", "TRACE_FLAG"} <= set(got)
    assert sum(k.startswith("MSG_") for k in got) >= 20


def test_planted_port_wire_drift_is_caught(tmp_path):
    src = (PORT / "runtime" / "net.py").read_text()
    assert "\nMSG_PUTPAGE = 3\n" in src
    drifted = src.replace("\nMSG_PUTPAGE = 3\n", "\nMSG_PUTPAGE = 250\n")
    files = (collect_files([str(JAX_TREE / "runtime" / "net.py")])
             + write_tree(tmp_path,
                          {"pmdfc_tpu_torch/runtime/net.py": drifted}))
    files[0] = (files[0][0], "pmdfc_tpu/runtime/net.py")
    found = jaxrules.check_wire_drift(build_model(files), Allowlist({}))
    assert [f.ident for f in found] == [
        "wire-drift:pmdfc_tpu_torch/runtime/net.py:MSG_PUTPAGE"]
