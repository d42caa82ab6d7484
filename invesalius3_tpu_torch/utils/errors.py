"""Error taxonomy, the ``handle_errors`` decorator, the global exception
hook and crash reports (port of invesalius3_tpu/utils/errors.py; reference
invesalius/error_handling.py: ``ErrorCategory``/``ErrorSeverity`` :57/:78,
``InVesaliusException`` and its domain subclasses :89-259,
``handle_errors`` :263, ``global_exception_handler`` :657, the crash report
with system info :391-495).

The crash report names torch, its CUDA version and the CUDA devices; on a
machine without a card it names none.
"""

from __future__ import annotations

import datetime
import functools
import json
import platform
import sys
import traceback
from enum import Enum
from pathlib import Path
from typing import Callable, Optional

from invesalius3_tpu_torch.utils.logging import get_logger


class ErrorCategory(Enum):
    FILE_IO = "file_io"
    DICOM = "dicom"
    SEGMENTATION = "segmentation"
    SURFACE = "surface"
    NAVIGATION = "navigation"
    NETWORK = "network"
    DEVICE = "device"  # GPU/accelerator errors
    PROJECT = "project"
    UNKNOWN = "unknown"


class ErrorSeverity(Enum):
    INFO = "info"
    WARNING = "warning"
    ERROR = "error"
    CRITICAL = "critical"


class InVesaliusError(Exception):
    category = ErrorCategory.UNKNOWN
    severity = ErrorSeverity.ERROR

    def __init__(self, message: str, details: Optional[dict] = None):
        super().__init__(message)
        self.details = details or {}


class FileIOError(InVesaliusError):
    category = ErrorCategory.FILE_IO


class DicomReadError(InVesaliusError):
    category = ErrorCategory.DICOM


class SegmentationError(InVesaliusError):
    category = ErrorCategory.SEGMENTATION


class SurfaceError(InVesaliusError):
    category = ErrorCategory.SURFACE


class NavigationError(InVesaliusError):
    category = ErrorCategory.NAVIGATION


class NetworkError(InVesaliusError):
    category = ErrorCategory.NETWORK


class DeviceError(InVesaliusError):
    category = ErrorCategory.DEVICE
    severity = ErrorSeverity.CRITICAL


class ProjectError(InVesaliusError):
    category = ErrorCategory.PROJECT


def handle_errors(category: ErrorCategory = ErrorCategory.UNKNOWN,
                  reraise: bool = True, default=None):
    """Decorator: log an exception with its category and traceback, then
    re-raise it (or return ``default`` with ``reraise=False``)."""

    def deco(fn: Callable):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            try:
                return fn(*a, **kw)
            except Exception as e:
                get_logger("errors").exception(
                    "[%s] %s failed: %s", category.value, fn.__qualname__, e)
                if reraise:
                    raise
                return default

        return wrapper

    return deco


def system_info() -> dict:
    """Platform, Python, torch, its CUDA version and the CUDA devices' names
    (an empty list without a card)."""
    import torch

    info = {"platform": platform.platform(), "python": sys.version,
            "torch": torch.__version__, "cuda": torch.version.cuda, "devices": []}
    if torch.cuda.is_available():
        info["devices"] = [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())]
    return info


def generate_crash_report(exc_type, exc_value, exc_tb,
                          out_dir: Optional[Path] = None) -> Path:
    """A categorised crash-report file with system info (reference
    error_handling.py:391-495), under the user directory's ``crash/`` by
    default."""
    import invesalius3_tpu_torch
    from invesalius3_tpu_torch.utils.paths import user_dir

    out_dir = Path(out_dir) if out_dir else user_dir() / "crash"
    out_dir.mkdir(parents=True, exist_ok=True)
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    report = {
        "timestamp": ts,
        "version": invesalius3_tpu_torch.__version__,
        "exception": repr(exc_value),
        "category": getattr(exc_value, "category", ErrorCategory.UNKNOWN).value
        if isinstance(exc_value, InVesaliusError) else ErrorCategory.UNKNOWN.value,
        "traceback": "".join(traceback.format_exception(exc_type, exc_value, exc_tb)),
        "system": system_info(),
    }
    path = out_dir / f"crash_{ts}.json"
    path.write_text(json.dumps(report, indent=2))
    return path


def install_global_exception_handler(out_dir: Optional[Path] = None) -> None:
    """``sys.excepthook`` writing crash reports (reference
    error_handling.py:657)."""

    def hook(exc_type, exc_value, exc_tb):
        try:
            path = generate_crash_report(exc_type, exc_value, exc_tb, out_dir)
            get_logger("errors").critical("crash report written to %s", path)
        finally:
            sys.__excepthook__(exc_type, exc_value, exc_tb)

    sys.excepthook = hook
