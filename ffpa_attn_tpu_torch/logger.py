"""Logging for the PyTorch/CUDA port.

Package-root "FFPA_TORCH" logger with an env-controlled level
(``FFPA_TORCH_LOGGER_LEVEL``), a multi-line prefix formatter and ``*_once``
dedup helpers.
"""

from __future__ import annotations

import logging
import os
import sys
from functools import lru_cache
from typing import Any

_FORMAT = "%(levelname)s %(asctime)s [%(name)s] %(message)s"
_DATEFMT = "%m-%d %H:%M:%S"

_ROOT_NAME = "FFPA_TORCH"


class _MultilineFormatter(logging.Formatter):
    """Prefix every line of a multi-line message."""

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if "\n" not in msg:
            return msg
        head, *rest = msg.split("\n")
        prefix = head[: len(head) - len(record.getMessage().split("\n")[0])]
        return "\n".join([head] + [prefix + line for line in rest])


def _level_from_env() -> int:
    name = os.environ.get("FFPA_TORCH_LOGGER_LEVEL", "INFO").upper()
    return getattr(logging, name, logging.INFO)


@lru_cache(maxsize=None)
def _root_logger() -> logging.Logger:
    logger = logging.getLogger(_ROOT_NAME)
    logger.setLevel(_level_from_env())
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_MultilineFormatter(_FORMAT, datefmt=_DATEFMT))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


_ONCE_SEEN: set[tuple[str, str]] = set()


def _log_once(logger: logging.Logger, level: int, msg: str, *args: Any) -> None:
    key = (logger.name, msg % args if args else msg)
    if key in _ONCE_SEEN:
        return
    _ONCE_SEEN.add(key)
    logger.log(level, msg, *args)


def init_logger(name: str) -> logging.Logger:
    """Return a child logger with ``debug_once``/``info_once``/``warning_once``."""
    _root_logger()
    logger = logging.getLogger(f"{_ROOT_NAME}.{name}")
    logger.setLevel(_level_from_env())
    logger.debug_once = lambda msg, *a, _l=logger: _log_once(_l, logging.DEBUG, msg, *a)  # type: ignore[attr-defined]
    logger.info_once = lambda msg, *a, _l=logger: _log_once(_l, logging.INFO, msg, *a)  # type: ignore[attr-defined]
    logger.warning_once = lambda msg, *a, _l=logger: _log_once(_l, logging.WARNING, msg, *a)  # type: ignore[attr-defined]
    return logger
