"""The suite-time reports of `tests/torch_testtime.py` on made-up junit
files: `schedule` replays per-test seconds through pytest-xdist's loadfile
queue, which hands files out by test count, so few-test files start last
whatever their seconds."""

from __future__ import annotations

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
