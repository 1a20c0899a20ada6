"""Structured console logging setup (loguru-style, stdlib-backed).

The port of the JAX package's `utils/logging.py`: a leveled, colorized,
rank-aware configuration of the 'xmmsr' logger on the stdlib. In a
multi-process run only process 0 logs at INFO by default; the process
index is the rank of the default torch.distributed group when one is
initialized, else 0.
"""

from __future__ import annotations

import logging
import sys

_FMT = "%(asctime)s | %(levelname)-8s | %(name)s:%(funcName)s - %(message)s"

_LEVEL_COLORS = {
    "DEBUG": "\x1b[36m",
    "INFO": "\x1b[32m",
    "WARNING": "\x1b[33m",
    "ERROR": "\x1b[31m",
    "CRITICAL": "\x1b[41m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _LEVEL_COLORS.get(record.levelname)
        if color and sys.stderr.isatty():
            return f"{color}{msg}{_RESET}"
        return msg


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def setup_logging(level: int = logging.INFO, process_index: int | None = None) -> logging.Logger:
    """Configure the 'xmmsr' logger; non-zero processes drop to WARNING."""
    if process_index is None:
        process_index = _process_index()
    if process_index != 0:
        level = max(level, logging.WARNING)

    logger = logging.getLogger("xmmsr")
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_ColorFormatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
    return logger
