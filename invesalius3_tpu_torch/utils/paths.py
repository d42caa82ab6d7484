"""Filesystem locations (port of invesalius3_tpu/utils/paths.py; reference
invesalius/inv_paths.py).  The port keeps its own user directory, apart
from the JAX package's."""

from __future__ import annotations

import os
from pathlib import Path


def user_dir() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME", str(Path.home() / ".config"))
    return Path(base) / "invesalius3_tpu_torch"


def user_log_dir() -> Path:
    return user_dir() / "logs"


def user_presets_dir() -> Path:
    return user_dir() / "presets"


def user_plugins_dir() -> Path:
    return user_dir() / "plugins"


def models_dir() -> Path:
    """DL weight storage (reference inv_paths.MODELS_DIR 'ai/')."""
    return user_dir() / "ai"


def create_conf_folders() -> None:
    """Reference inv_paths.create_conf_folders :95."""
    for p in (user_dir(), user_log_dir(), user_presets_dir(),
              user_plugins_dir(), models_dir()):
        p.mkdir(parents=True, exist_ok=True)


RELEASES_URL = "https://api.github.com/repos/invesalius/invesalius3/releases/latest"


def check_for_updates(current_version: str, timeout: float = 3.0):
    """Release update check (reference utils.py:311 UpdateCheck): the latest
    release's tag, or None when the site cannot be reached."""
    import json
    import urllib.request

    try:
        with urllib.request.urlopen(RELEASES_URL, timeout=timeout) as r:
            return json.load(r).get("tag_name")
    except Exception:
        return None
