"""Plugin discovery and loading (port of invesalius3_tpu/utils/plugins.py;
reference invesalius/plugins.py ``PluginManager`` :47).

Scans the user plugin directory and any extra directories for folders
holding a ``plugin.json`` ({"name", "description", "enable"}), imports each
plugin's ``__init__.py`` (import_source :36) and calls its ``load()``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.utils.logging import get_logger
from invesalius3_tpu_torch.utils.paths import user_plugins_dir


def import_source(module_name: str, module_path) -> object:
    """Import a file as a module (reference plugins.py:36)."""
    spec = importlib.util.spec_from_file_location(module_name, module_path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


class PluginManager:
    def __init__(self, extra_dirs: List = None, bus=None):
        self.bus = bus or events.bus
        self.dirs = [user_plugins_dir()] + [Path(d) for d in (extra_dirs or [])]
        self.plugins: Dict[str, dict] = {}

    def find_plugins(self) -> Dict[str, dict]:
        for root in self.dirs:
            if not root.is_dir():
                continue
            for child in sorted(root.iterdir()):
                manifest = child / "plugin.json"
                if not manifest.is_file():
                    continue
                try:
                    info = json.loads(manifest.read_text())
                    self.plugins[info["name"]] = {
                        "folder": child,
                        "description": info.get("description", ""),
                        "enable": info.get("enable", True),
                    }
                except (ValueError, KeyError) as e:
                    get_logger("plugins").warning("bad plugin at %s: %s", child, e)
        self.bus.send_message("plugins.found", names=list(self.plugins))
        return self.plugins

    def load_plugin(self, name: str) -> object:
        """Import the plugin package and call its load() (reference
        plugins.py:82)."""
        info = self.plugins[name]
        init = Path(info["folder"]) / "__init__.py"
        module = import_source(f"invesalius3_tpu_torch_plugin_{name}", init)
        if hasattr(module, "load"):
            module.load()
        self.bus.send_message("plugins.loaded", name=name)
        return module

    def load_all_enabled(self) -> None:
        for name, info in self.plugins.items():
            if info["enable"]:
                self.load_plugin(name)
