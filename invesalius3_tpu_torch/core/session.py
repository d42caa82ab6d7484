"""Session: persistent configuration + state, recent projects, crash
detection, and timed auto-backup (a copy of invesalius3_tpu/core/session.py;
its user directory is the port's own, ``utils.paths.user_dir``).

Reference: invesalius/session.py ``Session`` singleton :70 — JSON
config.json + state.json under the user config dir (_write_to_json :252,
ReadConfig :334), recent projects :258, auto-backup + crash detection
(CreateAutoBackup :386, ExitedSuccessfullyLastTime :135,
GetAutoBackupPath :447).
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from invesalius3_tpu_torch.utils.paths import user_dir as default_user_dir

DEFAULT_CONFIG = {
    "language": "en",
    "mode": "default",
    "project_folder": "",
    "recent_projects": [],
    "auto_reload_preview": False,
    "auto_backup_interval_min": 5,
    "surface_quality": "Optimal *",
    "slice_interpolation": 1,
}


class Session:
    def __init__(self, user_dir: Optional[Path] = None):
        self.user_dir = Path(user_dir) if user_dir else default_user_dir()
        self.user_dir.mkdir(parents=True, exist_ok=True)
        self._config_path = self.user_dir / "config.json"
        self._state_path = self.user_dir / "state.json"
        self.config: Dict[str, Any] = dict(DEFAULT_CONFIG)
        self.state: Dict[str, Any] = {}
        self.temp_item = False
        self.project_status: int = 3  # 0 open+saved, 1 changed, 3 closed
        self._backup_thread: Optional[threading.Thread] = None
        self._backup_stop = threading.Event()
        self.read_config()
        self.read_state()

    # -- config ------------------------------------------------------------------
    def read_config(self) -> bool:
        try:
            with open(self._config_path) as f:
                self.config.update(json.load(f))
            return True
        except (OSError, json.JSONDecodeError):
            return False

    def write_config(self) -> None:
        tmp = str(self._config_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.config, f, indent=2, sort_keys=True)
        os.replace(tmp, self._config_path)

    def get_config(self, key: str, default=None):
        return self.config.get(key, default)

    def set_config(self, key: str, value) -> None:
        self.config[key] = value
        self.write_config()

    # -- state (crash detection) ----------------------------------------------------
    def read_state(self) -> bool:
        try:
            with open(self._state_path) as f:
                self.state = json.load(f)
            return True
        except (OSError, json.JSONDecodeError):
            self.state = {}
            return False

    def write_state(self) -> None:
        tmp = str(self._state_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f, indent=2)
        os.replace(tmp, self._state_path)

    def get_state(self, key: str, default=None):
        return self.state.get(key, default)

    def set_state(self, key: str, value) -> None:
        self.state[key] = value
        self.write_state()

    def exited_successfully_last_time(self) -> bool:
        """Reference session.py:135: a leftover state.json with an open
        project means the last run crashed."""
        return self.get_state("exited_successfully", True)

    def mark_running(self) -> None:
        self.set_state("exited_successfully", False)

    def exit(self) -> None:
        self.stop_auto_backup()
        self.set_state("exited_successfully", True)

    # -- recent projects -------------------------------------------------------------
    def add_recent_project(self, path: str, name: str = "") -> None:
        recents: List = [p for p in self.config.get("recent_projects", []) if p[0] != path]
        recents.insert(0, [path, name or Path(path).stem])
        self.config["recent_projects"] = recents[:10]
        self.write_config()

    @property
    def recent_projects(self) -> List:
        return self.config.get("recent_projects", [])

    # -- auto-backup (reference session.py:386-453) ------------------------------------
    def get_auto_backup_path(self, project_name: str = "project") -> Path:
        return self.user_dir / f"autobackup_{project_name}.inv3"

    def create_auto_backup(self, project, interval_s: Optional[float] = None) -> None:
        """Start (or restart) the timed backup thread saving the project to
        the auto-backup path."""
        self.stop_auto_backup()
        if interval_s is None:
            interval_s = self.get_config("auto_backup_interval_min", 5) * 60.0
        self._backup_stop.clear()

        def loop():
            while not self._backup_stop.wait(interval_s):
                try:
                    project.save(self.get_auto_backup_path(project.name or "project"))
                    self.set_state("last_backup_time", time.time())
                except Exception:
                    pass

        self._backup_thread = threading.Thread(target=loop, daemon=True)
        self._backup_thread.start()
        self.set_state("backup_project_name", project.name or "project")

    def stop_auto_backup(self) -> None:
        if self._backup_thread is not None:
            self._backup_stop.set()
            self._backup_thread = None

    def remove_auto_backup(self) -> None:
        name = self.get_state("backup_project_name")
        if name:
            p = self.get_auto_backup_path(name)
            if p.exists():
                p.unlink()

    def recover_auto_backup(self) -> Optional[Path]:
        """If the last run crashed and a backup exists, return its path."""
        if self.exited_successfully_last_time():
            return None
        name = self.get_state("backup_project_name")
        if not name:
            return None
        p = self.get_auto_backup_path(name)
        return p if p.exists() else None
