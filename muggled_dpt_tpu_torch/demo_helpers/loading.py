"""Interactive model/image selection (reference demo_helpers/loading.py):
weights discovery in a model_weights folder, a numbered menu with substring
matching, and path prompting with history defaults.

The port's copy of the JAX package's ``demo_helpers/loading.py`` (that package
imports jax), unchanged but for this note."""

from __future__ import annotations

import os
import os.path as osp

VALID_WEIGHT_EXTS = (".pt", ".pth", ".safetensors")
VALID_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def find_model_weights(folder: str | None = None) -> list[str]:
    """List checkpoint files in ./model_weights (or a given folder)."""
    folder = folder or osp.join(os.getcwd(), "model_weights")
    if not osp.isdir(folder):
        return []
    files = [osp.join(folder, f) for f in sorted(os.listdir(folder)) if f.lower().endswith(VALID_WEIGHT_EXTS)]
    return files


def ask_for_path(prompt: str, default: str | None = None, must_exist: bool = True) -> str:
    """Prompt for a file path, offering a default (from history)."""
    while True:
        suffix = f" [{default}]" if default else ""
        raw = input(f"{prompt}{suffix}: ").strip().strip("'\"")
        path = raw or (default or "")
        path = osp.expanduser(path)
        if path and (not must_exist or osp.exists(path)):
            return path
        print(f"  Invalid path: {path!r}")


def ask_for_model_path(root_folder: str | None = None, default_path: str | None = None) -> str:
    """Menu-select a model checkpoint from model_weights/, with substring
    matching of typed input; falls back to path prompting when none found."""
    candidates = find_model_weights(root_folder)
    if not candidates:
        return ask_for_path("Enter path to model weights", default_path)

    default_idx = 0
    if default_path in candidates:
        default_idx = candidates.index(default_path)

    print("\nSelect model file:")
    for i, path in enumerate(candidates):
        marker = "(default)" if i == default_idx else ""
        print(f"  {i + 1}: {osp.basename(path)} {marker}")
    raw = input("Selection: ").strip()

    if not raw:
        return candidates[default_idx]
    if raw.isdigit() and 1 <= int(raw) <= len(candidates):
        return candidates[int(raw) - 1]
    # substring match
    matches = [p for p in candidates if raw.lower() in osp.basename(p).lower()]
    if len(matches) == 1:
        return matches[0]
    if osp.exists(osp.expanduser(raw)):
        return osp.expanduser(raw)
    print(f"  No unique match for {raw!r}, using default")
    return candidates[default_idx]


def ask_for_image_path(default_path: str | None = None) -> str:
    return ask_for_path("Enter path to image", default_path)


class PathCarousel:
    """Cycle through image files in a folder (reference toadui PathCarousel /
    run_image.py's file selector): built from a file path (siblings included)
    or a folder path."""

    def __init__(self, image_or_folder_path: str):
        path = osp.expanduser(str(image_or_folder_path))
        folder = path if osp.isdir(path) else osp.dirname(path) or "."
        self.paths = [
            osp.join(folder, f) for f in sorted(os.listdir(folder)) if f.lower().endswith(VALID_IMAGE_EXTS)
        ] if osp.isdir(folder) else []
        if not self.paths and osp.isfile(path):
            self.paths = [path]
        self._idx = self.paths.index(path) if path in self.paths else 0

    def __len__(self):
        return len(self.paths)

    @property
    def current(self) -> str:
        return self.paths[self._idx]

    def next(self) -> str:
        self._idx = (self._idx + 1) % len(self.paths)
        return self.current

    def prev(self) -> str:
        self._idx = (self._idx - 1) % len(self.paths)
        return self.current


def ask_for_video_path(default_path: str | None = None) -> str:
    """Video path or webcam index (digits select a camera)."""
    suffix = f" [{default_path}]" if default_path else ""
    raw = input(f"Enter path to video (or webcam number){suffix}: ").strip().strip("'\"")
    path = raw or (default_path or "0")
    if path.isdigit():
        return path
    path = osp.expanduser(path)
    if osp.exists(path):
        return path
    print(f"  Invalid path: {path!r}, defaulting to webcam 0")
    return "0"
