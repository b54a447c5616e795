"""PyTorch port: `tests/test_analyze.py`'s rule drills, each held on a port
path.

`tools.analyze` keys two of its rules on JAX's side: `unranked-lock`
strips the prefix `pmdfc_tpu/`, and the lock-rank rule ranks edges with
JAX's `HIERARCHY`. The other rules read the shape of a module wherever it
lies. Each drill here runs JAX's fixture where JAX's drill runs it, then
writes the same shape under `tmp_path/pmdfc_tpu_torch/...` and runs the
same rule family there, with the port's table in the rank rule and the
port's restated rules (`test_torch_analyze.py`) beside the tool's: the
findings must be the same, their paths aside. The JAX-only constructs
(`donate_argnums`, `shard_map`, `pallas_call`, `jax` itself) are held by
JAX's rule on JAX's tree and by an AST census of the port tree, which
holds none of them: the rule's silence on the port is by construction.
The sanitizer's drills are in `test_torch_sanitizer_drills.py`.
"""

from __future__ import annotations

import ast
import os
from collections import Counter
from pathlib import Path
from unittest import mock

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from test_torch_analyze import (ALLOW, JAX_TREE, PORT, kernel_gate,
                                port_ranks, torch_seam, unranked,
                                write_tree)

import pmdfc_tpu.runtime.sanitizer as jsan
import pmdfc_tpu_torch.runtime.sanitizer as tsan
import test_analyze as jdrill
from tools.analyze import DEFAULT_ALLOWLIST, Allowlist, build_model
from tools.analyze import guarded, jaxrules, lockorder
from tools.analyze.model import collect_files
from tools.analyze.resolve import analyze_functions

pytestmark = pytest.mark.torch

FIXTURES = Path(__file__).resolve().parent / "data" / "analyze_fixtures"
SEAT = "pmdfc_tpu_torch/runtime/"   # where a port-path fixture is written


def rules(files, port: bool, allow=None) -> list:
    """JAX's `_run_all` over `files`: guarded-by, lock order and the JAX
    rules; on the port side the rank rule takes the port's table and the
    restated seam and gate rules run beside the tool's."""
    model = build_model(files)
    facts = analyze_functions(model)
    allow = allow or Allowlist({})
    found = guarded.run(model, facts, allow)
    if port:
        found += port_ranks(model, facts, allow)
        found += jaxrules.run(model, allow)
        found += torch_seam(model, allow) + kernel_gate(model, allow)
    else:
        found += lockorder.run(model, facts, allow) + jaxrules.run(model,
                                                                  allow)
    return found


def seated(findings, rel: str) -> list:
    """(rule, id, message) with the fixture's path taken out."""
    return sorted((f.rule, f.ident.replace(rel, "<f>"),
                   f.message.replace(rel, "<f>")) for f in findings)


def jax_side(root: Path, files: dict) -> list:
    """JAX's side of a drill: `files` ({relative path: source}) written
    under `root` and run through JAX's own drill helper,
    `test_analyze._run_all` (guarded-by, lock order and the JAX rules),
    with its fixture directory pointed at `root`."""
    write_tree(root, files)
    with mock.patch.object(jdrill, "_FIXTURES", str(root)):
        return jdrill._run_all(*files)


def kinds(findings) -> Counter:
    """How many findings of each rule."""
    return Counter(f.rule for f in findings)


def twin_fixture(tmp_path, name: str, src: str | None = None) -> tuple:
    """The fixture `name` (or `src`) through JAX's drill helper at its
    bare name, and at a port path through the port's rules -> the port's
    seated findings. The two must hold the same rule ids, the same count
    of each kind, and the same findings their paths aside."""
    src = (FIXTURES / name).read_text() if src is None else src
    found_j = jax_side(tmp_path / "j", {name: src})
    found_p = rules(write_tree(tmp_path / "p", {SEAT + name: src}),
                    port=True)
    assert kinds(found_j) == kinds(found_p)
    a, b = seated(found_j, name), seated(found_p, SEAT + name)
    assert a == b
    return b


@pytest.fixture(scope="module")
def port_tree():
    model = build_model(collect_files([str(PORT)]))
    return model, analyze_functions(model)


@pytest.fixture(scope="module")
def jax_tree():
    model = build_model(collect_files([str(JAX_TREE)]))
    return model, analyze_functions(model)


def constructs(model) -> dict:
    """Each JAX-only construct the rules key on -> the port modules that
    hold it."""
    out: dict[str, list] = {}
    for mi in model.modules.values():
        for n in ast.walk(mi.tree):
            hits = []
            if isinstance(n, ast.keyword) and n.arg in ("donate_argnums",
                                                        "donate_argnames"):
                hits.append(n.arg)
            if isinstance(n, ast.Name) and n.id in ("shard_map",
                                                    "pallas_call"):
                hits.append(n.id)
            if isinstance(n, ast.Attribute) and n.attr in ("shard_map",
                                                           "pallas_call"):
                hits.append(n.attr)
            if isinstance(n, ast.Import):
                hits += ["jax" for a in n.names
                         if a.name.split(".")[0] == "jax"]
            if isinstance(n, ast.ImportFrom) and n.module and \
                    n.module.split(".")[0] == "jax":
                hits.append("jax")
            for h in hits:
                out.setdefault(h, []).append(mi.path)
    return out


def test_port_tree_holds_no_jax_construct(port_tree, jax_tree):
    assert constructs(port_tree[0]) == {}
    # the census sees them where they are
    assert {"donate_argnums", "shard_map", "pallas_call",
            "jax"} <= set(constructs(jax_tree[0]))


# --- 1. the tree gate --------------------------------------------------------


def test_tree_is_clean_under_checked_in_allowlist(port_tree):
    # JAX's side: its tree gate as JAX's drill runs it
    findings, stale = jdrill.run_analysis()
    model, facts = port_tree
    allow = Allowlist(dict(ALLOW))
    found = guarded.run(model, facts, allow) \
        + port_ranks(model, facts, allow) + jaxrules.run(model, allow) \
        + torch_seam(model, allow) + kernel_gate(model, allow)
    assert kinds(found) == kinds(findings) == Counter()
    assert found == [], "\n".join(str(f) for f in found)
    assert allow.unused() == stale == []


def test_lock_hierarchy_covers_every_ranked_module_lock(port_tree, jax_tree):
    for model, table, prefix in (
            (jax_tree[0], jsan.HIERARCHY, "pmdfc_tpu/"),
            (port_tree[0], tsan.HIERARCHY, "pmdfc_tpu_torch/")):
        missing = [d.lock_id for d in model.all_locks()
                   if d.module.path.split(prefix, 1)[-1]
                   in lockorder.RANKED_MODULES and d.lock_id not in table]
        assert missing == [], (prefix, missing)
    assert unranked(port_tree[0], tsan.HIERARCHY) == []
    assert {"parallel/shard.py", "parallel/partitioning.py",
            "parallel/plane.py", "runtime/slo.py"} <= lockorder.RANKED_MODULES
    # the port ranks every JAX lock as JAX does, and two of its own
    assert {k: tsan.HIERARCHY[k] for k in jsan.HIERARCHY} == jsan.HIERARCHY


def _unranked(port_tree, jax_tree, monkeypatch, lock):
    """JAX's tool finds `lock` unranked once its rank is stripped from
    JAX's table; the restated rule finds the port's `lock` once stripped
    from the port's."""
    model, facts = jax_tree
    monkeypatch.setattr(jsan, "HIERARCHY", {
        k: v for k, v in jsan.HIERARCHY.items() if k != lock})
    found = lockorder.run(model, facts, Allowlist({}))
    assert [f.ident for f in found if f.rule == "unranked-lock"] == [
        f"unranked-lock:{lock}"]
    stripped = {k: v for k, v in tsan.HIERARCHY.items() if k != lock}
    assert unranked(port_tree[0], stripped) == [lock]


def test_unranked_serving_lock_is_a_finding(port_tree, jax_tree,
                                            monkeypatch):
    _unranked(port_tree, jax_tree, monkeypatch, "ShardedKV._lock")


def test_unranked_slo_lock_is_a_finding(port_tree, jax_tree, monkeypatch):
    _unranked(port_tree, jax_tree, monkeypatch, "SloWatchdog._lock")


# --- 2. seeded fixtures, on a port path --------------------------------------


def test_bad_inversion_fixture_yields_lock_order_cycle(tmp_path):
    found = twin_fixture(tmp_path, "bad_inversion.py")
    cycles = [f for f in found if f[0] == "lock-order"]
    assert cycles and all("Pair.lock_a" in m and "Pair.lock_b" in m
                          for _, _, m in cycles)


def test_bad_unguarded_fixture_yields_guarded_write(tmp_path):
    found = twin_fixture(tmp_path, "bad_unguarded.py")
    assert [i for _, i, _ in found] == \
        ["guarded-write:<f>:Box.drop:closed"]


def _jax_only(tmp_path, name: str, rule: str, ident: str):
    """A JAX-only construct's rule: it bites on JAX's fixture, on JAX's
    fixture written at a port path too (the rule reads shapes, not
    prefixes), and JAX's tree is clean under its allowlist."""
    found = twin_fixture(tmp_path, name)
    assert [i for r, i, _ in found if r == rule] == [ident]


def test_bad_donation_fixture_yields_jax_donation(tmp_path, port_tree):
    _jax_only(tmp_path, "bad_donation.py", "jax-donation",
              "jax-donation:<f>:scatter")
    assert "donate_argnums" not in constructs(port_tree[0])


def test_bad_shardmap_donation_fixture_yields_jax_donation(tmp_path,
                                                            port_tree):
    _jax_only(tmp_path, "bad_donation_shardmap.py", "jax-donation",
              "jax-donation:<f>:build")
    assert "shard_map" not in constructs(port_tree[0])


def test_local_donate_spoof_does_not_count_as_guard(tmp_path, port_tree):
    found = twin_fixture(tmp_path, "bad_donation_spoof.py")
    assert [r for r, _, _ in found] == ["jax-donation"]
    assert "donate_argnames" not in constructs(port_tree[0])


_FALLBACK = '''
from pmdfc_tpu_torch.ops.fused import _entry, get_core_reference


def launch(keys):
    try:
        return _entry("fused_get_linear_flat")(keys)
    except RuntimeError:
        return get_core_reference(keys)
'''


def test_bad_pallas_gate_fixture_yields_finding(tmp_path, port_tree):
    _jax_only(tmp_path, "bad_pallas_gate.py", "pallas-platform-gate",
              "pallas-platform-gate:<f>:launch")
    model, _ = port_tree
    assert "pallas_call" not in constructs(model)
    assert kernel_gate(model) == []
    # the port's counterpart: a kernel whose failure falls back to its
    # plain version
    m = build_model(write_tree(tmp_path / "g",
                               {"pmdfc_tpu_torch/ops/gate.py": _FALLBACK}))
    assert sorted(f.ident for f in kernel_gate(m)) == [
        "kernel-gate:pmdfc_tpu_torch/ops/gate.py:launch:_entry",
        "kernel-gate:pmdfc_tpu_torch/ops/gate.py:launch:get_core_reference"]


_UNGATED = '''
from pmdfc_tpu_torch.ops.fused import _entry


def go(keys):
    return _entry("fused_get_linear_flat")(keys)
'''


def test_interpret_false_literal_is_still_unconditional(tmp_path):
    src = ("from jax.experimental import pallas as pl\n"
           "def go(x, k, s):\n"
           "    return pl.pallas_call(k, out_shape=s, interpret=False)(x)\n")
    found = twin_fixture(tmp_path, "lit.py", src)
    assert [r for r, _, _ in found] == ["pallas-platform-gate"]
    # the port's counterpart: a built entry reached with no device test
    m = build_model(write_tree(tmp_path / "g",
                               {"pmdfc_tpu_torch/ops/go.py": _UNGATED}))
    assert [f.ident for f in kernel_gate(m)] == [
        "kernel-gate:pmdfc_tpu_torch/ops/go.py:go:_entry"]


_TORCH_SEAM_BAD = '''
import torch


def fetch_result(out):
    torch.cuda.synchronize(out.device)
    return out


def drain(handle):
    return handle.synchronize()
'''

_TORCH_SEAM_CLEAN = '''
from pmdfc_tpu_torch.runtime import profiler


def fetch_result(out, b):
    return profiler.fetch("kv.get", "get", lambda: out[:b], n_ops=b)


def warm(x):
    return profiler.block_ready(x)
'''


def test_bad_profiler_seam_fixture_yields_findings(tmp_path):
    found = twin_fixture(tmp_path, "bad_profiler_seam.py")
    assert {i for r, i, _ in found if r == "profiler-seam"} == {
        "profiler-seam:<f>:fetch_result", "profiler-seam:<f>:drain"}
    # the same two shapes in torch, caught by the restated rule
    files = write_tree(tmp_path / "t", {SEAT + "seam.py": _TORCH_SEAM_BAD})
    assert {f.ident for f in rules(files, port=True)} == {
        f"profiler-seam:{SEAT}seam.py:fetch_result",
        f"profiler-seam:{SEAT}seam.py:drain"}


def test_profiler_seam_exempts_bench_and_the_seam_itself(tmp_path):
    src = ("import jax\n"
           "def measure(x):\n"
           "    return jax.block_until_ready(x)\n")
    tsrc = ("import torch\n"
            "def measure(x):\n"
            "    torch.cuda.synchronize(x.device)\n"
            "    return x\n")
    def tree(pkg, body):
        return {f"{pkg}/bench/lat.py": body,
                f"{pkg}/runtime/profiler.py": body}

    # JAX's side through JAX's drill helper, the port's through its rules
    found_j = jax_side(tmp_path / "j", tree("pmdfc_tpu", src))
    for i, body in enumerate((src, tsrc)):
        found = rules(write_tree(tmp_path / f"p{i}",
                                 tree("pmdfc_tpu_torch", body)), port=True)
        assert kinds(found) == kinds(found_j), (found, found_j)
        assert [f for f in found if f.rule == "profiler-seam"] == [], found
    assert found_j == []


def test_clean_fixtures_pass(tmp_path):
    for name in ("clean_locks.py", "clean_donation.py",
                 "clean_donation_shared.py", "clean_donation_shardmap.py",
                 "clean_pallas_gate.py", "clean_profiler_seam.py"):
        assert twin_fixture(tmp_path / name[:-3], name) == []
    files = write_tree(tmp_path / "t", {
        SEAT + "seam.py": _TORCH_SEAM_CLEAN,
        "pmdfc_tpu_torch/ops/gate.py":
            (PORT / "ops" / "fused.py").read_text()})
    assert rules(files, port=True) == []


def test_allowlist_suppresses_and_reports_stale(tmp_path):
    # JAX's side: JAX's drill itself, then what its fixture yields under
    # no allowlist through JAX's helper
    jdrill.test_allowlist_suppresses_and_reports_stale()
    bare = kinds(jdrill._run_all("bad_unguarded.py"))
    for rel in ("bad_unguarded.py", SEAT + "bad_unguarded.py"):
        files = write_tree(tmp_path, {
            rel: (FIXTURES / "bad_unguarded.py").read_text()})
        model = build_model(files)
        facts = analyze_functions(model)
        assert kinds(guarded.run(model, facts, Allowlist({}))) == bare
        allow = Allowlist({
            f"guarded-write:{rel}:Box.drop:closed": "drill",
            f"guarded-write:{rel}:Box.gone:items": "stale entry"})
        assert guarded.run(model, facts, allow) == []
        assert allow.unused() == [f"guarded-write:{rel}:Box.gone:items"]


_LAMBDA = '''
import threading

class A:
    def __init__(self):
        # guarded-by: <none>  (fixture)
        self.lock_a = threading.Lock()
        # guarded-by: <none>  (fixture)
        self.lock_b = threading.Lock()

    def inner(self):
        with self.lock_a:
            pass

    def defer(self):
        with self.lock_b:
            cb = lambda: self.inner()   # noqa: E731
        return cb

    def order(self):
        with self.lock_a:
            with self.lock_b:
                pass
'''

_SELF = '''
import threading

class B:
    def __init__(self):
        # guarded-by: <none>  (fixture)
        self._lock = threading.Lock()
        # guarded-by: <none>  (fixture)
        self._rlock = threading.RLock()

    def bad(self):
        with self._lock:
            with self._lock:
                pass

    def fine(self):
        with self._rlock:
            with self._rlock:
                pass
'''


def test_lambda_body_does_not_fabricate_lock_order_edges(tmp_path):
    assert twin_fixture(tmp_path, "lam.py", _LAMBDA) == []


def test_lexical_self_reacquire_is_flagged(tmp_path):
    assert [i for _, i, _ in twin_fixture(tmp_path, "self.py", _SELF)] == \
        ["lock-order:B._lock->B._lock"]


def test_none_guard_with_justification_declares_no_fields(tmp_path,
                                                          port_tree,
                                                          jax_tree):
    src = ("import threading\n\n\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        # guarded-by: <none>  (pure section, alive, stats)\n"
           "        self._lock = threading.Lock()\n")
    # JAX's side: JAX's drill itself, and JAX's helper over the same
    # source finds nothing
    (tmp_path / "jax").mkdir()
    jdrill.test_none_guard_with_justification_declares_no_fields(
        tmp_path / "jax")
    assert jax_side(tmp_path / "j", {"none_guard.py": src}) == []
    for rel in ("none_guard.py", SEAT + "none_guard.py"):
        model = build_model(write_tree(tmp_path, {rel: src}))
        c = model.modules[rel].classes["C"]
        assert model.find_lock(c, "_lock").guards == []
        assert dict(c.guarded) == {}
    # the prose the trees carry in a field list (not a `<none>` line)
    # reads as the same non-field names in both: the port adds none
    def prose(model, prefix):
        return sorted((mi.path.split(prefix, 1)[1], c.name, f)
                      for mi in model.modules.values()
                      for c in mi.classes.values() for f in c.guarded
                      if not f.isidentifier())

    assert prose(port_tree[0], "pmdfc_tpu_torch/") == \
        prose(jax_tree[0], "pmdfc_tpu/")


def test_wire_drift_rule_catches_constant_divergence(tmp_path):
    def tree(pkg):
        return {pkg + "runtime/net.py": "MSG_PUTPAGE = 3\nPIPE_FLAG = 0x100\n",
                pkg + "runtime/peer.py": "MSG_PUTPAGE = 4\nTRACE_FLAG = 0x10\n"}

    # JAX's side through JAX's drill helper, the port's through the rule
    found_j = jax_side(tmp_path / "j", tree(""))
    files = write_tree(tmp_path / "p", tree("pmdfc_tpu_torch/"))
    found = jaxrules.run(build_model(files), Allowlist({}))
    assert kinds(found) == kinds(found_j) == Counter({"wire-drift": 2})
    for pkg, got in (("", found_j), ("pmdfc_tpu_torch/", found)):
        assert {f.ident for f in got} == {
            f"wire-drift:{pkg}runtime/peer.py:MSG_PUTPAGE",
            f"wire-drift:{pkg}runtime/peer.py:TRACE_FLAG"}


def test_checked_in_allowlist_names_no_port_path():
    """JAX's checked-in allowlist stays JAX's: the port's exceptions live
    in `test_torch_analyze.ALLOW`."""
    with open(DEFAULT_ALLOWLIST) as f:
        body = [ln for ln in f if ln.strip() and not ln.startswith("#")]
    assert body and not any("pmdfc_tpu_torch" in ln for ln in body)
    assert all(os.path.basename(k.split(":")[1]) for k in ALLOW)
