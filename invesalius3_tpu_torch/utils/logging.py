"""Structured logging and performance spans (port of
invesalius3_tpu/utils/logging.py; reference invesalius/enhanced_logging.py:
console / rotating-file / in-memory ring handlers, per-component filtering,
export; and the ``[PERF]`` stage timers of surface_process.py:186-408).

``span`` waits for the card when handed the tensors a stage produced, so it
times the work and not its launch; ``trace`` wraps ``torch.profiler`` and
writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import logging.handlers
import time
from collections import deque
from pathlib import Path
from typing import Deque, Optional

LOGGER_NAME = "invesalius3_tpu_torch"


class InMemoryHandler(logging.Handler):
    """Ring buffer of the last ``capacity`` records (reference
    enhanced_logging.py:177), as formatted lines and as structured entries
    for the log API (level filter and search, :212)."""

    def __init__(self, capacity: int = 2000):
        super().__init__()
        self.records: Deque[str] = deque(maxlen=capacity)
        self.entries: Deque[dict] = deque(maxlen=capacity)

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(self.format(record))
        comp = record.name
        if comp.startswith(LOGGER_NAME):
            comp = comp[len(LOGGER_NAME):].lstrip(".") or "app"
        self.entries.append({
            "ts": record.created,
            "level": record.levelname,
            "levelno": record.levelno,
            "component": comp,
            "message": record.getMessage(),
        })

    def dump(self) -> list:
        return list(self.records)


_memory_handler: Optional[InMemoryHandler] = None


def setup_logging(level: int = logging.INFO, log_dir: Optional[Path] = None,
                  console: bool = True) -> logging.Logger:
    """Console, a rotating file under ``log_dir`` when given, and the
    in-memory ring."""
    global _memory_handler
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    if console:
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        logger.addHandler(h)
    if log_dir is not None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            log_dir / "invesalius3_tpu_torch.log", maxBytes=2_000_000, backupCount=3)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
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


def recent_log_lines() -> list:
    return _memory_handler.dump() if _memory_handler else []


def query_log(level: Optional[str] = None, component: Optional[str] = None,
              search: Optional[str] = None, limit: int = 500) -> list:
    """Filtered view of the ring: records at or above ``level``, whose
    component contains ``component``, whose message contains ``search``
    (case-blind); the last ``limit``."""
    if _memory_handler is None:
        return []
    entries = list(_memory_handler.entries)
    if level:
        min_no = logging.getLevelName(level.upper())
        if isinstance(min_no, int):
            entries = [e for e in entries if e["levelno"] >= min_no]
    if component:
        entries = [e for e in entries if component in e["component"]]
    if search:
        s = search.lower()
        entries = [e for e in entries if s in e["message"].lower()]
    return entries[-int(limit):]


# ---------------------------------------------------------------------------
# perf spans
# ---------------------------------------------------------------------------

_spans: list = []


def _synchronize(result) -> None:
    """Wait for the card on every CUDA device holding a tensor in
    ``result`` (a tensor, or a list, tuple or dict of them); CPU tensors
    and other values need nothing."""
    import torch

    stack, devices = [result], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def span(name: str, sync_result=None):
    """``[PERF]`` stage timer.  Pass the stage's tensors as ``sync_result``
    to wait for the card before the clock stops (else it times the launch
    only)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync_result is not None:
            _synchronize(sync_result)
        dt = time.perf_counter() - t0
        _spans.append({"name": name, "seconds": dt, "ts": time.time()})
        get_logger("perf").info("[PERF] %s: %.4fs", name, dt)


def timing(fn):
    """Decorator timing a function as a span (reference utils.py:392)."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with span(fn.__qualname__):
            return fn(*a, **kw)

    return wrapper


def perf_report() -> list:
    return list(_spans)


def export_perf_report(path) -> None:
    Path(path).write_text(json.dumps(_spans, indent=2))


@contextlib.contextmanager
def trace(log_dir=None):
    """``torch.profiler`` around a region (the CPU, and the card when there
    is one); its Chrome trace is written into ``log_dir`` (the user log
    directory's ``trace/`` by default)."""
    import torch

    from invesalius3_tpu_torch.utils.paths import user_log_dir

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir) if log_dir is not None else user_log_dir() / "trace"
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.strftime('%Y%m%d_%H%M%S')}"
                                      f"_{time.time_ns() % 10**9}.json"))
