"""Filesystem locations (the part of invesalius3_tpu/utils/paths.py the
port's session and translations use; reference invesalius/inv_paths.py).
The port keeps its own user directory, apart from the JAX package's."""

from __future__ import annotations

import os
from pathlib import Path


def user_dir() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME", str(Path.home() / ".config"))
    return Path(base) / "invesalius3_tpu_torch"
