"""PyTorch port: `tests/test_aux.py::test_logger_levels`'s twin.

The port keeps its own copy of the leveled logger
(`pmdfc_tpu_torch/utils/logger.py`). The same calls through each
package's `make_logger` must write the same file lines, timestamps
aside: the level names (the reference's `TRACE` among them), the
logger's name and the messages.
"""

from __future__ import annotations

import logging

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

from pmdfc_tpu.utils import logger as jlogger
from pmdfc_tpu_torch.utils import logger as tlogger

pytestmark = pytest.mark.torch


# stdlib loggers are process-wide and `make_logger` installs its sinks
# only on a logger without handlers: a name no other test uses
NAME = "pmdfc_logger_twin"


def _lines(mod, path) -> list[str]:
    log = mod.make_logger(NAME, "trace", logfile=str(path))
    try:
        log.info("hello %d", 42)
        log.trace("fine detail")
        log.debug("debug %s", "line")
        log.warning("careful")
        quiet = mod.make_logger(NAME + "_quiet", "warn", logfile=None)
        quiet.info("not shown")
    finally:
        # both packages name the same stdlib logger: drop its handlers so
        # the next `make_logger` installs its own file sink
        for h in list(log.handlers):
            log.removeHandler(h)
            h.close()
    # "<date> <time> [LEVEL] name: message" -> "[LEVEL] name: message"
    return [ln.split(" ", 2)[2] for ln in path.read_text().splitlines()]


def test_logger_levels(tmp_path):
    a = _lines(jlogger, tmp_path / "jax.txt")
    b = _lines(tlogger, tmp_path / "port.txt")
    assert a == b
    assert b == [f"[{lvl}] {NAME}: {msg}" for lvl, msg in (
        ("INFO", "hello 42"), ("TRACE", "fine detail"),
        ("DEBUG", "debug line"), ("WARNING", "careful"))]
    assert tlogger.TRACE == jlogger.TRACE == 5
    assert logging.getLevelName(tlogger.TRACE) == "TRACE"
    assert tlogger._LEVELS == jlogger._LEVELS
