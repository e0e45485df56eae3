"""Structured logging (a copy of ``poccala_tpu/utils/logging.py``, whose
package imports jax; ``tests/test_torch_train.py`` pins the copy).

Python's stdlib logging plus an optional CSV file sink in the row format
of the reference's per-job log files (``LogPrint.py:21-130``:
``log_<job>.csv`` with ``[INFO]/[WARN]/[ERROR]`` rows, timestamps, ANSI
stripping, console mirroring).
"""

from __future__ import annotations

import logging
import os
import re
import time

_ANSI_RE = re.compile(r"\x1b\[[0-9;]*m")

_LEVELS = {"i": logging.INFO, "w": logging.WARNING, "e": logging.ERROR}
_TAGS = {logging.INFO: "[INFO]", logging.WARNING: "[WARN]", logging.ERROR: "[ERROR]"}


class CsvFormatter(logging.Formatter):
    """Rows shaped like the reference's ``Log.note`` output
    (``LogPrint.py:64-102``): ``<tag>,<timestamp>,<message>``."""

    def format(self, record: logging.LogRecord) -> str:
        tag = _TAGS.get(record.levelno, "[INFO]")
        ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(record.created))
        msg = _ANSI_RE.sub("", record.getMessage())
        return f"{tag},{ts},{msg}"


def get_logger(
    name: str = "poccala",
    job_id: int | str = 0,
    log_dir: str | None = None,
    console: bool = True,
) -> logging.Logger:
    """Build a logger; with ``log_dir`` set, also writes
    ``log_<job_id>.csv`` there (reference naming, ``LogPrint.py:38-44``)."""
    logger = logging.getLogger(f"{name}.{job_id}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
        return logger
    if console:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(sh)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"log_{job_id}.csv"))
        fh.setFormatter(CsvFormatter())
        logger.addHandler(fh)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


def note(logger: logging.Logger, content: str, cls: str = "i") -> None:
    """Severity-class shim matching the reference API
    (``Log.note(content, cls)``, ``LogPrint.py:64``)."""
    logger.log(_LEVELS.get(cls, logging.INFO), content)
