"""Video input helpers (reference demo_helpers/video.py): a looping frame
iterator with pause/seek for the interactive demos, and robust capture setup
for files and webcams.

The port's copy of the JAX package's ``demo_helpers/video.py`` (that package
imports jax), the same code."""

from __future__ import annotations

import os.path as osp

import cv2
import numpy as np


def create_video_capture(video_source: str | int) -> cv2.VideoCapture:
    """Open a video file or webcam. Webcams are selected by integer/digit
    strings; raises on failure (reference video.py:220-225)."""
    if isinstance(video_source, str) and video_source.isdigit():
        video_source = int(video_source)
    if isinstance(video_source, str) and not osp.exists(video_source):
        raise FileNotFoundError(f"Video not found: {video_source}")
    cap = cv2.VideoCapture(video_source)
    if not cap.isOpened():
        raise IOError(f"Could not open video source: {video_source}")
    # Opt in to rotation metadata so phone-shot portrait videos decode upright
    # (OpenCV ignores the orientation tag unless asked; reference
    # video.py:220-225 / opencv/opencv#26795). Not supported by every
    # capture backend (some webcams), hence the guard.
    try:
        cap.set(cv2.CAP_PROP_ORIENTATION_AUTO, 1)
    except cv2.error:
        pass
    return cap


class LoopingVideoReader:
    """Iterator yielding (is_paused, frame_index, frame_bgr), looping at the
    end of file, with pause/seek controls (reference video.py:19-112)."""

    def __init__(self, video_source: str | int, display_size_px: int | None = None):
        self._cap = create_video_capture(video_source)
        self._is_webcam = isinstance(video_source, int) or (isinstance(video_source, str) and video_source.isdigit())
        self.total_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)) if not self._is_webcam else -1
        self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0
        self._display_size = display_size_px
        self._paused = False
        self._frame_idx = -1
        self._last_frame = None

    @property
    def is_webcam(self) -> bool:
        return self._is_webcam

    def toggle_pause(self) -> bool:
        self._paused = not self._paused
        return self._paused

    def pause(self, set_paused: bool = True):
        self._paused = set_paused

    def seek(self, frame_index: int):
        if not self._is_webcam and self.total_frames > 0:
            frame_index = int(np.clip(frame_index, 0, self.total_frames - 1))
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, frame_index)
            self._frame_idx = frame_index - 1

    def peek_frame(self):
        """Read one frame without advancing playback (non-webcam sources are
        rewound). Used to grab a frame for the --crop UI before the loop."""
        ok, frame = self._cap.read()
        if not ok:
            return False, None
        if not self._is_webcam:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        return True, self._scale(frame)

    def get_frame_wh(self) -> tuple[int, int]:
        w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        return (w, h)

    def _scale(self, frame):
        if self._display_size is None:
            return frame
        h, w = frame.shape[:2]
        scale = self._display_size / max(h, w)
        if abs(scale - 1.0) < 1e-3:
            return frame
        return cv2.resize(frame, None, fx=scale, fy=scale)

    def __iter__(self):
        return self

    def __next__(self):
        if self._paused and self._last_frame is not None:
            return True, self._frame_idx, self._last_frame
        ok, frame = self._cap.read()
        if not ok:
            if self._is_webcam:
                raise StopIteration
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, 0)  # loop
            self._frame_idx = -1
            ok, frame = self._cap.read()
            if not ok:
                raise StopIteration
        self._frame_idx += 1
        self._last_frame = self._scale(frame)
        return False, self._frame_idx, self._last_frame

    def release(self):
        self._cap.release()
