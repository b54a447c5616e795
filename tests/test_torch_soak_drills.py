"""PyTorch port: `tests/test_soak.py`'s `--history` drill, a recorded
difference pinned on both packages.

JAX's `bench/soak.py --history` off a TPU exits 3 and appends nothing:
the exit code is the TPU agenda's done-marker, telling a resumable step
that no on-chip evidence was written. The port has no TPU agenda; its
`bench/soak.py` keeps `--history` as an evidence log that only a card
run appends to (`bench.common.append_history` skips a record stamped
with another device), and off the card it exits 0 after a clean soak.
Both append nothing off their chip. The soak's smoke and the insert
profile's drills run both packages in `test_torch_bench_soaks.py` and
`test_torch_bench_sweeps.py`.
"""

from __future__ import annotations

import sys

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_twin import fresh_jax_registry, registries  # noqa: F401

from pmdfc_tpu.bench import soak as jsoak
from pmdfc_tpu_torch.bench import soak as tsoak

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("fresh_jax_registry")]

ARGS = ["--minutes", "0.03", "--threads", "1", "--verb", "32",
        "--capacity", "8192", "--keyspace", "256", "--page-words", "16",
        "--engine-batch", "256"]


def test_soak_history_offchip_exits_3_in_jax_and_0_in_port(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PMDFC_COMPILE_CACHE", "0")
    jhist, thist = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    monkeypatch.setattr(sys, "argv", ["soak", *ARGS, "--history",
                                      str(jhist)])
    with pytest.raises(SystemExit) as ex:
        jsoak.main()
    assert ex.value.code == 3
    assert tsoak.main(["--device", "cpu", *ARGS, "--history",
                       str(thist)]) == 0
    for hist in (jhist, thist):
        assert not hist.exists() or not hist.read_text().strip()
    capsys.readouterr()
