"""Filesystem locations (the part of invesalius3_tpu/utils/paths.py the
port's session, translations, raycasting presets and model weights use;
reference invesalius/inv_paths.py).  The port keeps its own user directory, apart
from the JAX package's."""

from __future__ import annotations

import os
from pathlib import Path


def user_dir() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME", str(Path.home() / ".config"))
    return Path(base) / "invesalius3_tpu_torch"


def user_presets_dir() -> Path:
    return user_dir() / "presets"


def models_dir() -> Path:
    """DL weight storage (reference inv_paths.MODELS_DIR 'ai/')."""
    return user_dir() / "ai"
