"""Structured logging and performance spans (port of
invesalius3_tpu/utils/logging.py; reference invesalius/enhanced_logging.py:
console / rotating-file / in-memory ring handlers, per-component filtering,
export; and the ``[PERF]`` stage timers of surface_process.py:186-408).

``span`` and ``count`` trace the program's stages while a ``torch.profiler``
records (``trace`` wraps one and writes its Chrome trace): each span is a
``record_function`` in that trace, on the kernels' clock, and an entry in a
bounded ring that ``perf_report`` reads.  With no profiler recording they
do nothing.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import logging.handlers
import threading
import time
from collections import deque
from pathlib import Path
from typing import Deque, Dict, Optional

import torch

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

RING_SPANS = 8192  # the ring keeps the last spans closed; a 256^3 segmentation closes 502
_ring: Deque[dict] = deque(maxlen=RING_SPANS)
_ids = itertools.count(1)
_open = threading.local()  # this thread's stack of open spans, outermost first


class _Untraced:
    """What ``span`` returns while no profiler records: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_UNTRACED = _Untraced()


class Span:
    """One traced span: a ``record_function("invesalius." + name)`` in the
    profiler's trace, and an entry in the ring when it closes."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "counts", "start_ns", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.counts: Dict[str, int] = {}

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self._rf = torch.profiler.record_function("invesalius." + self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.time_ns()
        self._rf.__exit__(*exc)
        _open.stack.pop()
        entry = {"name": self.name, "start_ns": self.start_ns, "end_ns": end_ns,
                 "id": self.id, "parent": self.parent, "root": self.root,
                 "attrs": self.attrs}
        if self.parent is None:
            entry["counts"] = self.counts
            get_logger("perf").info("[PERF] %s: %.4fs", self.name,
                                    (end_ns - self.start_ns) / 1e9)
        _ring.append(entry)
        return False


def span(name: str, **attrs):
    """A stage of the program, traced while a profiler records (``trace``,
    or the benchmark's traced run).  The outermost open span is a root: one
    user action, whose id its spans share and whose ``[PERF]`` line is
    logged.  Untraced it checks that flag and does nothing: no clock, no
    ``record_function``, no entry.  A span reads nothing from the card and
    waits for nothing, so it times the host's part of a stage."""
    if not torch.autograd._profiler_enabled():
        return _UNTRACED
    return Span(name, attrs)


def root_span() -> Optional[Span]:
    """The outermost span open on this thread while a profiler records, or
    None: a ``count`` made on another thread for it (autograd runs a CUDA
    backward on a thread of its own) names it as ``root``."""
    if not torch.autograd._profiler_enabled():
        return None
    stack = getattr(_open, "stack", None)
    return stack[0] if stack else None


def count(name: str, n: int = 1, root: Optional[Span] = None) -> None:
    """Add ``n`` to ``counts[name]`` of ``root`` (kept in the root's ring
    entry), by default the open root span of this thread while a profiler
    records."""
    if root is None:
        root = root_span()
    if root is not None:
        root.counts[name] = root.counts.get(name, 0) + n


def timing(fn):
    """Decorator tracing a function as a span (reference utils.py:392)."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with span(fn.__qualname__):
            return fn(*a, **kw)

    return wrapper


def perf_report() -> list:
    """The ring's entries, oldest first: ``name``, ``start_ns`` and
    ``end_ns`` (``time.time_ns()``, the clock the profiler's Chrome trace
    is offset from), ``id``, ``parent`` (None for a root), ``root``,
    ``attrs``, and a root's ``counts``."""
    return list(_ring)


def export_perf_report(path) -> None:
    Path(path).write_text(json.dumps(perf_report(), indent=2, default=str))


@contextlib.contextmanager
def trace(log_dir=None):
    """``torch.profiler`` around a region (the CPU, and the card when there
    is one); its Chrome trace is written into ``log_dir`` (the user log
    directory's ``trace/`` by default).  Spans and counts are traced inside
    it."""
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
