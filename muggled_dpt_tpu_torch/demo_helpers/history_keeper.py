"""JSON persistence of last-used paths/settings (reference
demo_helpers/history_keeper.py): lets the demo apps re-offer the previously
used model/image/crop on relaunch.

The port's copy of the JAX package's ``demo_helpers/history_keeper.py`` (that package
imports jax), unchanged but for this note."""

from __future__ import annotations

import json
import os
import os.path as osp


class HistoryKeeper:
    def __init__(self, parent_folder: str | None = None, file_name: str = ".history"):
        folder = parent_folder or os.getcwd()
        self._path = osp.join(folder, file_name)
        self._data = self._load()

    def _load(self) -> dict:
        try:
            with open(self._path, "r") as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return {}

    def read(self, key: str):
        """Returns (has_entry, value)."""
        value = self._data.get(key)
        if isinstance(value, str) and key.endswith("_path") and not osp.exists(value):
            return False, None
        return (value is not None), value

    def store(self, **key_values) -> None:
        self._data.update({k: v for k, v in key_values.items() if v is not None})
        try:
            with open(self._path, "w") as f:
                json.dump(self._data, f, indent=2)
        except OSError:
            pass
