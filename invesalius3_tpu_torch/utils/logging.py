"""Logging setup (the part of invesalius3_tpu/utils/logging.py the app
calls: ``ensure_logging`` and ``get_logger``; reference
invesalius/enhanced_logging.py).  Records go to an in-memory ring, and to
the console when asked."""

from __future__ import annotations

import logging
from collections import deque
from typing import Deque, Optional

LOGGER_NAME = "invesalius3_tpu_torch"


class InMemoryHandler(logging.Handler):
    """Ring buffer of the last ``capacity`` formatted records."""

    def __init__(self, capacity: int = 2000):
        super().__init__()
        self.records: Deque[str] = deque(maxlen=capacity)

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(self.format(record))


_memory_handler: Optional[InMemoryHandler] = None


def setup_logging(level: int = logging.INFO, console: bool = True) -> logging.Logger:
    global _memory_handler
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    if console:
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        logger.addHandler(h)
    _memory_handler = InMemoryHandler()
    _memory_handler.setFormatter(fmt)
    logger.addHandler(_memory_handler)
    return logger


def ensure_logging(**kw) -> None:
    """Idempotent setup: install the ring if absent, without clobbering an
    explicit setup."""
    if _memory_handler is None:
        setup_logging(**kw)


def get_logger(component: str = "") -> logging.Logger:
    return logging.getLogger(f"{LOGGER_NAME}.{component}" if component else LOGGER_NAME)
