"""Leveled file+console logger (ref `server/Logger.{h,cpp}`; twin of
`pmdfc_tpu/utils/logger.py`).

The reference writes level-tagged printf lines to `log.txt` and stderr with
macros `fatal…trace` (`Logger.h:20-26`). This is the same surface on top of
the stdlib: one logger, optional file sink, the reference's level names.
"""

from __future__ import annotations

import logging
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "fatal": logging.CRITICAL,
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": TRACE,
}


def make_logger(name: str = "pmdfc", level: str = "info",
                logfile: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(_LEVELS.get(level, logging.INFO))
    if not logger.handlers:
        fmt = logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
        )
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if logfile:
            fh = logging.FileHandler(logfile)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    logger.trace = lambda msg, *a: logger.log(TRACE, msg, *a)  # type: ignore
    return logger
