"""The suite-time reports of `tests/torch_testtime.py` on made-up junit
files: `schedule` replays per-test seconds through pytest-xdist's loadfile
queue, which hands files out by test count, so few-test files start last
whatever their seconds; `compare` sets two runs side by side, `overlap`
says whether a twin ran beside its JAX suite, `keys` counts the programs
two port files ask for. Also `torch_twin.jax_once`, the per-process memo
of a JAX answer, which hands each caller its own copy."""

from __future__ import annotations

from pathlib import Path

import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch_testtime as tt


def _junit(tmp_path, files: dict) -> str:
    cases = "".join(
        f'<testcase classname="tests.{f[:-3]}" name="t{i}" time="{s}" />'
        for f, secs in files.items() for i, s in enumerate(secs))
    n = sum(len(v) for v in files.values())
    path = tmp_path / "run.xml"
    path.write_text(
        '<?xml version="1.0" encoding="utf-8"?><testsuites name="pytest '
        f'tests"><testsuite name="pytest" errors="0" failures="0" '
        f'skipped="0" tests="{n}" time="1.0">{cases}</testsuite>'
        '</testsuites>')
    return str(path)


FILES = {
    # one heavy file of one test, queued last however long it runs
    "test_heavy.py": [90.0],
    "test_many.py": [1.0] * 10,
    "test_some.py": [2.0] * 5,
    "test_few.py": [3.0, 3.0, 3.0],
}


def test_files_are_queued_by_test_count_and_heavy_few_test_files_go_last(
        tmp_path):
    files = tt._junit_files(_junit(tmp_path, FILES))
    assert files == dict(sorted(FILES.items()))
    rows = tt.replay(files, workers=2)
    assert [r[0] for r in rows] == ["test_many.py", "test_some.py",
                                    "test_few.py", "test_heavy.py"]
    start = {f: t0 for f, _, t0, _ in rows}
    end = {f: t1 for f, _, _, t1 in rows}
    # test_some (5 tests) has 2 left at t = 6: the worker takes test_few;
    # test_many (10 tests) has 2 left at t = 8: that worker takes heavy
    assert start["test_many.py"] == start["test_some.py"] == 0.0
    assert start["test_few.py"] == 10.0 and start["test_heavy.py"] == 10.0
    assert end["test_heavy.py"] == 100.0 and end["test_few.py"] == 19.0


def test_a_worker_takes_the_next_file_only_when_two_tests_are_left(tmp_path):
    files = tt._junit_files(_junit(tmp_path, {
        "test_a.py": [1.0] * 4, "test_b.py": [5.0], "test_c.py": [7.0]}))
    rows = tt.replay(files, workers=1)
    # a, then b after a's second test (two left), then c once b is handed
    # and one test of a is done (a's last plus b: two left)
    assert [(f, t0, t1) for f, _, t0, t1 in rows] == [
        ("test_a.py", 0.0, 4.0), ("test_b.py", 4.0, 9.0),
        ("test_c.py", 9.0, 16.0)]


def test_schedule_prints_the_projected_wall_and_the_last_starts(
        tmp_path, capsys):
    tt.schedule(_junit(tmp_path, FILES), "2", "2")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("4 files on 2 workers: projected wall 100.0 s, mean "
                      "per worker 59.5 s")
    assert out[1].endswith("test_few.py") and out[2].endswith("test_heavy.py")


def test_compare_prints_each_group_with_its_ratio_and_the_host_factor(
        tmp_path, capsys):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    parent = _junit(tmp_path / "a", {
        "test_kv.py": [10.0, 10.0], "test_torch_kv.py": [30.0, 10.0],
        "test_torch_smoke.py": [20.0]})
    change = _junit(tmp_path / "b", {
        "test_kv.py": [11.0, 11.0], "test_torch_kv.py": [15.0, 5.0],
        "test_torch_kv_more.py": [10.0], "test_torch_smoke.py": [10.0]})
    tt.compare(parent, change)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "wall 1.0 -> 1.0 s (1.000); tests 5 -> 6"
    rows = {line.split(maxsplit=3)[3]: line.split()[:3]
            for line in out[2:] if not line.startswith("host")}
    assert rows["all files"] == ["80.0", "62.0", "0.775"]
    assert rows["jax suites (1 -> 1 files)"] == ["20.0", "22.0", "1.100"]
    assert rows["port: other (1 -> 2 files)"] == ["40.0", "30.0", "0.750"]
    assert rows["port: smoke rehearsals (1 -> 1 files)"] == [
        "20.0", "10.0", "0.500"]
    assert rows["port files"] == ["60.0", "40.0", "0.667"]
    assert rows["test_torch_kv_more.py"] == ["0.0", "10.0", "-"]
    # the same JAX suite cost 1.1x: the second host ran slower
    assert "host factor (JAX suites, change / parent): 1.100" in out


def _ordered_junit(tmp_path, order: list) -> str:
    """A junit whose test cases stand in the order they finished."""
    cases = "".join(f'<testcase classname="tests.{f[:-3]}" name="t{i}" '
                    f'time="1.0" />' for i, f in enumerate(order))
    path = tmp_path / "run.xml"
    path.write_text(
        '<?xml version="1.0" encoding="utf-8"?><testsuites><testsuite '
        f'name="pytest" errors="0" failures="0" skipped="0" '
        f'tests="{len(order)}" time="1.0">{cases}</testsuite></testsuites>')
    return str(path)


def test_overlap_says_which_twin_ran_beside_its_suite(tmp_path, capsys):
    twins = tmp_path / "twins.py"
    twins.write_text(
        '_A = "test_torch_a_drills.py::"\n'
        '_B = ("test_torch_b.py::test_one",)\n'
        'DRILLS = {"test_a.py": {"test_x": (_A + "test_x",)},\n'
        '          "test_b.py": {"test_y": _B, "test_z": (_A + "t",)}}\n')
    run = _ordered_junit(tmp_path, [
        "test_a.py", "test_torch_a_drills.py", "test_a.py",
        "test_torch_b.py", "test_torch_b.py", "test_b.py"])
    assert tt._drill_pairs(str(twins)) == {
        "test_a.py": ["test_torch_a_drills.py"],
        "test_b.py": ["test_torch_a_drills.py", "test_torch_b.py"]}
    tt.overlap(run, str(twins))
    assert capsys.readouterr().out.splitlines() == [
        "overlap test_a.py 0-2  test_torch_a_drills.py 1-1",
        "apart   test_b.py 5-5  test_torch_a_drills.py 1-1",
        "apart   test_b.py 5-5  test_torch_b.py 3-4"]


def test_overlap_reads_the_drill_map_of_the_twins_file():
    pairs = tt._drill_pairs(str(Path(tt.__file__).with_name(
        "test_torch_twins.py")))
    assert "test_torch_mesh_drills.py" in pairs["test_mesh.py"]
    assert "test_torch_fused_drills.py" in pairs["test_fused.py"]


def test_keys_counts_the_programs_two_port_files_ask_for(tmp_path, capsys):
    out = tmp_path / "out"
    out.mkdir()
    recs = [
        {"id": "tests/test_torch_a.py::t", "keys": [
            {"m": "jit_get", "k": "K1", "hit": False, "s": 2.0, "tl": 1.0,
             "t": 1.0},
            {"m": "jit_put", "k": "K2", "hit": False, "s": 1.0, "tl": 0.5,
             "t": 2.0}]},
        # b read K1 from the cache after a compiled it: a handed it 2.0 s
        {"id": "tests/test_torch_b.py::t", "keys": [
            {"m": "jit_get", "k": "K1", "hit": True, "s": 0.1, "tl": 0.9,
             "t": 5.0}]},
        # a record of the older plugin: (module, key, compile s) of misses
        {"id": "tests/test_torch_c.py::t", "keys": [["jit_put", "K2", 1.5]]}]
    (out / "gw0-1.jsonl").write_text(
        "".join(tt.json.dumps(r) + "\n" for r in recs))
    tt.keys(str(out))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "3 compiles, 2 programs, 4.5 s; recompiles 1.5 s"
    assert lines[1] == ("2 programs asked for (hit or miss), 2 of them by "
                        "two or more port files: 7.0 s of trace, lowering "
                        "and compile or read in all their files")
    assert sorted(lines[2:4]) == [
        "      3.0 test_torch_a.py + test_torch_c.py",
        "      4.0 test_torch_a.py + test_torch_b.py"]
    assert lines[4:] == [
        "compiles handed between files through the cache: 2.0 s saved",
        "      2.0 test_torch_a.py -> test_torch_b.py"]


def test_jax_once_hands_each_caller_its_own_copy():
    import numpy as np
    import jax.numpy as jnp
    import torch_twin

    calls = []

    def build():
        calls.append(1)
        found = jnp.arange(4, dtype=jnp.uint32) * 3   # JAX, run live
        return {"found": np.asarray(found), "stats": [1, 2]}

    key = ("test_torch_testtime", "jax_once", 4)
    first = torch_twin.jax_once(key, build)
    first["found"][0] = 99
    first["stats"].append(3)
    second = torch_twin.jax_once(key, build)
    assert calls == [1]
    assert second["found"].tolist() == [0, 3, 6, 9]
    assert second["stats"] == [1, 2]
    second["stats"].clear()
    assert torch_twin.jax_once(key, build)["stats"] == [1, 2]


def test_jax_memo_keys_by_arguments():
    import torch_twin

    calls = []

    @torch_twin.jax_memo
    def answer(n, scale=1):
        calls.append((n, scale))
        return [n * scale]

    assert answer(2) == [2] and answer(2) == [2]
    assert answer(2, scale=3) == [6] and answer(3) == [3]
    assert calls == [(2, 1), (2, 3), (3, 1)]


def test_contention_sets_alone_group_and_full_side_by_side(tmp_path, capsys):
    for d in ("full", "alone", "g"):
        (tmp_path / d).mkdir()
    full = _junit(tmp_path / "full", {
        "test_torch_a.py": [30.0, 30.0], "test_torch_b.py": [10.0],
        "test_a.py": [99.0]})
    alone = tmp_path / "alone"
    (alone / "test_torch_a.py.xml").write_text(Path(_junit(
        tmp_path / "g", {"test_torch_a.py": [20.0, 10.0]})).read_text())
    group = tmp_path / "store.xml"
    group.write_text(Path(_junit(tmp_path / "g", {
        "test_torch_a.py": [20.0, 20.0], "test_torch_b.py": [8.0]}))
        .read_text())
    tt.contention(full, str(alone), str(group), top=2)
    out = capsys.readouterr().out.splitlines()
    assert out[1].split() == ["30.0", "40.0", "60.0", "2.00", "1.33",
                              "test_torch_a.py", "(store)"]
    # no alone run of b: its factors are not given
    assert out[2].split() == ["0.0", "8.0", "10.0", "-", "-",
                              "test_torch_b.py", "(store)"]
    assert out[3].split()[:5] == ["30.0", "48.0", "70.0", "2.33", "1.60"]


def test_load_splits_the_host_by_thread_kind_and_by_compiles(
        tmp_path, capsys):
    rows = [
        {"t": 100.0, "load1": 8.0, "runnable": 10,
         "cpu": {"w7/worker/main": 1.0, "w7/worker/native-early": 2.0,
                 "w7/spawn/main": 0.5, "w7/spawn/native-early": 1.5},
         "wait": {"w7/worker/native-early": 1.0}, "running": {}},
        {"t": 200.0, "load1": 4.0, "runnable": 4,
         "cpu": {"w7/worker/main": 1.0, "run/pytest/main": 0.2},
         "wait": {}, "running": {}}]
    samples = tmp_path / "samples.jsonl"
    samples.write_text("".join(tt.json.dumps(r) + "\n" for r in rows))
    out = tmp_path / "out"
    out.mkdir()
    # one JAX compile, 99.5 s to 100.5 s: the first sample's second
    (out / "gw0-7.jsonl").write_text(tt.json.dumps(
        {"id": "tests/test_torch_a.py::t", "keys": [
            {"m": "jit_f", "k": "K", "hit": False, "s": 1.0, "tl": 0.0,
             "t": 99.5}]}) + "\n")
    tt.load(str(samples), str(out))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("all samples: 2 s, load1 6.00, runnable 7.00, cores "
                        "used 3.10, demand 3.60")
    at = lines.index("a worker compiling: 1 s, load1 8.00, runnable 10.00, "
                     "cores used 5.00, demand 6.00")
    # demand: cores used plus threads waiting for a core, 6.0 in all
    assert [ln.split() for ln in lines[at + 2:at + 6]] == [
        ["2.000", "1.000", "50.0%", "worker", "native-early"],
        ["1.500", "0.000", "25.0%", "child", "spawn", "threads"],
        ["1.000", "0.000", "16.7%", "worker", "main"],
        ["0.500", "0.000", "8.3%", "child", "spawn", "main"]]
    # the second second: no compile, 1.2 of demand
    assert lines[-1].split() == ["0.200", "0.000", "16.7%", "pytest",
                                 "pytest"]
