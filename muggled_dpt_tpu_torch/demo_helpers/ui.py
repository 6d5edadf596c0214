"""Compact OpenCV UI toolkit for the interactive demos.

Plays the role of the reference's vendored ~12k-LoC 'toadui' package
(demo_helpers/toadui/): window + keypress registry, layout family
(H/V stacks with optional width weights, grid stack, swapper, overlay
stack, separators, padding — toadui/layout.py), sliders incl. multi-handle
(toadui/sliders.py), toggle/immediate/radio buttons + a button carousel
(toadui/buttons.py, carousels.py), a colormap selector bar (including a
custom spectral map), text blocks and a message bar (toadui/text.py),
hover readouts + draggable markers, a composable overlay family —
text/rectangle/polygon/mask/crosshair/hover-label overlays plus
point-click, box-select, editable crop-box, grid-select and mouse-paint
interactions (toadui/overlays.py) — line and histogram plots
(toadui/plots.py) and a video playback bar (toadui/video.py) — implemented
from scratch and sized to what the demo apps actually use. Model-agnostic:
numpy/cv2 only.

The port's copy of the JAX package's ``demo_helpers/ui.py`` (that package
imports jax), unchanged but for this note."""

from __future__ import annotations

import cv2
import numpy as np

_BG = (35, 35, 35)
_FG = (210, 210, 210)
_ACCENT = (90, 160, 255)
_FONT = cv2.FONT_HERSHEY_SIMPLEX


class TextDrawer:
    """Simple text rendering helper (reference demo_helpers/text.py)."""

    def __init__(self, scale: float = 0.5, thickness: int = 1, color=_FG, font=_FONT):
        self.scale, self.thickness, self.color, self.font = scale, thickness, color, font

    def draw(self, image, text: str, xy: tuple[int, int], color=None, anchor: str = "topleft"):
        (tw, th), baseline = cv2.getTextSize(text, self.font, self.scale, self.thickness)
        x, y = xy
        if anchor == "center":
            x, y = x - tw // 2, y + th // 2
        elif anchor == "topleft":
            y = y + th
        cv2.putText(image, text, (int(x), int(y)), self.font, self.scale, color or self.color, self.thickness, cv2.LINE_AA)
        return image

    def size(self, text: str):
        (tw, th), _ = cv2.getTextSize(text, self.font, self.scale, self.thickness)
        return tw, th


class UIElement:
    """Base: fixed-height horizontal bar rendered at a given width."""

    height = 40

    def render(self, width: int) -> np.ndarray:
        raise NotImplementedError

    def on_mouse(self, x: int, y: int, event: int, flags: int = 0):
        pass

    def on_mouse_elsewhere(self):
        """Called when the cursor is over a *different* element, so hover
        state can be cleared."""
        pass

    def wants_mouse(self) -> bool:
        """True while a drag owned by this element is in progress; stacks keep
        routing events to it even when the cursor leaves its row/column (the
        scrub/drag shouldn't cancel on a few pixels of overshoot)."""
        return False


class Slider(UIElement):
    """Draggable horizontal slider (reference toadui/sliders.py)."""

    def __init__(self, label, value, min_value, max_value, step=1, marker_step=None, height=36):
        self.label = label
        self.min, self.max, self.step = min_value, max_value, step
        self._value = value
        self.height = height
        self._changed = False
        self._dragging = False
        self._marker_step = marker_step

    @property
    def value(self):
        return self._value

    def set(self, value, flag_change: bool = False):
        value = np.clip(value, self.min, self.max)
        value = self.min + round((value - self.min) / self.step) * self.step
        value = type(self.step)(value)
        if value != self._value:
            self._value = value
            self._changed = self._changed or flag_change
        return self

    def read(self):
        changed, self._changed = self._changed, False
        return changed, self._value

    def render(self, width):
        img = np.full((self.height, width, 3), _BG, np.uint8)
        pad = 10
        t = (self._value - self.min) / max(self.max - self.min, 1e-9)
        x = int(pad + t * (width - 2 * pad))
        cv2.line(img, (pad, self.height // 2), (width - pad, self.height // 2), (90, 90, 90), 2)
        cv2.circle(img, (x, self.height // 2), 7, _ACCENT, -1)
        txt = f"{self.label}: {self._value:g}" if isinstance(self._value, float) else f"{self.label}: {self._value}"
        TextDrawer(0.45).draw(img, txt, (pad, 2))
        self._width = width
        return img

    def on_mouse(self, x, y, event, flags=0):
        if event == cv2.EVENT_LBUTTONDOWN:
            self._dragging = True
        if event == cv2.EVENT_LBUTTONUP:
            self._dragging = False
        if self._dragging and event in (cv2.EVENT_LBUTTONDOWN, cv2.EVENT_MOUSEMOVE):
            pad = 10
            t = np.clip((x - pad) / max(getattr(self, "_width", 300) - 2 * pad, 1), 0, 1)
            self.set(self.min + t * (self.max - self.min), flag_change=True)

    def wants_mouse(self):
        return self._dragging


class ToggleButton(UIElement):
    def __init__(self, label, default=False, height=34):
        self.label = label
        self._on = bool(default)
        self.height = height
        self._changed = False

    def toggle(self, set_on=None):
        self._on = (not self._on) if set_on is None else bool(set_on)
        self._changed = True
        return self._on

    def read(self):
        changed, self._changed = self._changed, False
        return changed, self._on

    @property
    def is_on(self):
        return self._on

    def render(self, width):
        img = np.full((self.height, width, 3), _BG, np.uint8)
        color = _ACCENT if self._on else (80, 80, 80)
        cv2.rectangle(img, (4, 4), (width - 4, self.height - 4), color, 2)
        TextDrawer(0.45).draw(img, f"{self.label}: {'ON' if self._on else 'off'}", (12, 7))
        return img

    def on_mouse(self, x, y, event, flags=0):
        if event == cv2.EVENT_LBUTTONDOWN:
            self.toggle()


class ButtonBar(UIElement):
    """Row of momentary buttons; .read() pops the most recent click label."""

    def __init__(self, labels, height=34):
        self.labels = list(labels)
        self.height = height
        self._clicked = None
        self._width = 300

    def read(self):
        clicked, self._clicked = self._clicked, None
        return clicked

    def render(self, width):
        self._width = width
        img = np.full((self.height, width, 3), _BG, np.uint8)
        n = max(len(self.labels), 1)
        for i, lab in enumerate(self.labels):
            x0, x1 = int(i * width / n), int((i + 1) * width / n)
            cv2.rectangle(img, (x0 + 3, 4), (x1 - 3, self.height - 4), (80, 80, 80), 1)
            TextDrawer(0.42).draw(img, lab, ((x0 + x1) // 2, self.height // 2 - 6), anchor="center")
        return img

    def on_mouse(self, x, y, event, flags=0):
        if event == cv2.EVENT_LBUTTONDOWN and self.labels:
            idx = int(np.clip(x * len(self.labels) // max(self._width, 1), 0, len(self.labels) - 1))
            self._clicked = self.labels[idx]


def make_spectral_colormap() -> np.ndarray:
    """Custom spectral colormap LUT (256,1,3) BGR — the reference ships its
    own spectral map beside the cv2 builtins (toadui/colormaps.py)."""
    anchors = np.array(
        [  # RGB anchor points, dark blue -> cyan -> green -> yellow -> red
            (94, 79, 162), (50, 136, 189), (102, 194, 165), (171, 221, 164),
            (230, 245, 152), (255, 255, 191), (254, 224, 139), (253, 174, 97),
            (244, 109, 67), (213, 62, 79), (158, 1, 66),
        ],
        dtype=np.float32,
    )
    xs = np.linspace(0, 1, len(anchors))
    grid = np.linspace(0, 1, 256)
    rgb = np.stack([np.interp(grid, xs, anchors[:, c]) for c in range(3)], axis=-1)
    bgr = rgb[:, ::-1].astype(np.uint8)
    return bgr.reshape(256, 1, 3)


class ColormapsBar(UIElement):
    """Colormap selector: cv2 builtins + custom spectral + grayscale
    (reference toadui/colormaps.py). Click or .next() to cycle; .apply()
    maps a uint8 image to BGR."""

    def __init__(self, height=30):
        self.height = height
        self._maps = [
            ("spectral", make_spectral_colormap()),
            ("magma", cv2.COLORMAP_MAGMA),
            ("viridis", cv2.COLORMAP_VIRIDIS),
            ("inferno", cv2.COLORMAP_INFERNO),
            ("turbo", cv2.COLORMAP_TURBO),
            ("gray", None),
        ]
        self._idx = 0
        self._changed = False
        self._width = 300

    @property
    def name(self):
        return self._maps[self._idx][0]

    def next(self):
        self._idx = (self._idx + 1) % len(self._maps)
        self._changed = True

    def read(self):
        changed, self._changed = self._changed, False
        return changed, self._idx

    def apply(self, image_uint8: np.ndarray) -> np.ndarray:
        _, cmap = self._maps[self._idx]
        if cmap is None:
            return cv2.cvtColor(image_uint8, cv2.COLOR_GRAY2BGR)
        if isinstance(cmap, np.ndarray):
            return cv2.applyColorMap(image_uint8, cmap)
        return cv2.applyColorMap(image_uint8, cmap)

    def render(self, width):
        self._width = width
        img = np.full((self.height, width, 3), _BG, np.uint8)
        n = len(self._maps)
        ramp = np.tile(np.linspace(0, 255, width // n, dtype=np.uint8), (self.height - 8, 1))
        for i, (name, cmap) in enumerate(self._maps):
            x0 = int(i * width / n)
            seg = ramp[:, : int(width / n) - 6]
            if cmap is None:
                colored = cv2.cvtColor(seg, cv2.COLOR_GRAY2BGR)
            else:
                colored = cv2.applyColorMap(seg, cmap)
            img[4 : 4 + colored.shape[0], x0 + 3 : x0 + 3 + colored.shape[1]] = colored
            if i == self._idx:
                cv2.rectangle(img, (x0 + 1, 1), (x0 + int(width / n) - 2, self.height - 2), (255, 255, 255), 1)
        return img

    def on_mouse(self, x, y, event, flags=0):
        if event == cv2.EVENT_LBUTTONDOWN:
            self._idx = int(np.clip(x * len(self._maps) // max(self._width, 1), 0, len(self._maps) - 1))
            self._changed = True


class DraggableMarker:
    """A point overlay on an ImageDisplay the user can drag (reference
    toadui/overlays.py draggable points). Position is normalized (x, y) in
    [0, 1]; .read() pops a changed flag the way Slider.read() does."""

    GRAB_RADIUS_PX = 18

    def __init__(self, xy_norm=(0.5, 0.5), color=(80, 255, 255)):
        self.xy_norm = (float(xy_norm[0]), float(xy_norm[1]))
        self.color = color
        self._changed = False
        self._dragging = False

    def set(self, xy_norm, flag_change: bool = False):
        self.xy_norm = (float(np.clip(xy_norm[0], 0, 1)), float(np.clip(xy_norm[1], 0, 1)))
        self._changed = self._changed or flag_change
        return self

    def read(self):
        changed, self._changed = self._changed, False
        return changed, self.xy_norm


class Overlay:
    """Composable drawing/interaction layer for ImageDisplay (the reference's
    toadui/overlays.py BaseOverlay family). Attach with
    ImageDisplay.add_overlay(); draw() receives the render-size BGR frame
    (already a private copy) and mouse hooks receive normalized coordinates."""

    enabled = True

    def draw(self, frame: np.ndarray, wh: tuple[int, int]) -> None:
        pass

    def on_mouse(self, xy_norm, event: int, flags: int = 0):
        pass

    def on_mouse_elsewhere(self):
        pass

    def wants_mouse(self) -> bool:
        return False


class TextOverlay(Overlay):
    """Anchored text on the image panel (reference toadui TextOverlay):
    static labels, scale readouts, etc. set() accepts a string or a list of
    lines; anchor is one of topleft/topright/bottomleft/bottomright/center."""

    def __init__(self, text="", anchor="topleft", scale=0.45, color=_FG, bg_color=(25, 25, 25), margin=8):
        self._lines = []
        self.anchor, self.scale, self.color, self.bg_color, self.margin = anchor, scale, color, bg_color, margin
        self.set(text)

    def set(self, text):
        if text is None:
            text = ""
        self._lines = list(text) if isinstance(text, (list, tuple)) else str(text).split("\n")
        self._lines = [ln for ln in self._lines if ln != ""]
        return self

    def draw(self, frame, wh):
        if not self._lines:
            return
        w, h = wh
        td = TextDrawer(self.scale, color=self.color)
        sizes = [td.size(ln) for ln in self._lines]
        bw = max(s[0] for s in sizes)
        line_h = max(s[1] for s in sizes) + 6
        bh = line_h * len(self._lines)
        m = self.margin
        x0 = {"topleft": m, "bottomleft": m, "topright": w - bw - m, "bottomright": w - bw - m}.get(
            self.anchor, (w - bw) // 2
        )
        y0 = {"topleft": m, "topright": m, "bottomleft": h - bh - m, "bottomright": h - bh - m}.get(
            self.anchor, (h - bh) // 2
        )
        if self.bg_color is not None:
            cv2.rectangle(frame, (x0 - 4, y0 - 3), (x0 + bw + 4, y0 + bh + 3), self.bg_color, -1)
        for i, ln in enumerate(self._lines):
            td.draw(frame, ln, (x0, y0 + i * line_h))


class RectangleOverlay(Overlay):
    """Draws normalized ((x1,y1),(x2,y2)) boxes with a contrast outline
    (reference toadui DrawRectangleOverlay)."""

    def __init__(self, color=(0, 255, 255), thickness=1, bg_color=(0, 0, 0)):
        self.color, self.thickness, self.bg_color = color, thickness, bg_color
        self._boxes = []

    def set_boxes(self, xy1xy2_norm_list):
        self._boxes = [((float(x1), float(y1)), (float(x2), float(y2))) for (x1, y1), (x2, y2) in xy1xy2_norm_list]
        return self

    def draw(self, frame, wh):
        w, h = wh
        for (x1, y1), (x2, y2) in self._boxes:
            p1, p2 = (int(x1 * w), int(y1 * h)), (int(x2 * w), int(y2 * h))
            if self.bg_color is not None:
                cv2.rectangle(frame, p1, p2, self.bg_color, self.thickness + 1)
            cv2.rectangle(frame, p1, p2, self.color, self.thickness)


class PolygonsOverlay(Overlay):
    """Draws normalized polygons, optionally alpha-filled (reference toadui
    DrawPolygonsOverlay / DrawOutlineOverlay)."""

    def __init__(self, color=(80, 255, 80), thickness=1, closed=True, fill_alpha=0.0):
        self.color, self.thickness, self.closed, self.fill_alpha = color, thickness, closed, fill_alpha
        self._polys = []

    def set_polygons(self, polygons_norm):
        self._polys = [np.asarray(p, np.float32).reshape(-1, 2) for p in polygons_norm]
        return self

    def draw(self, frame, wh):
        if not self._polys:
            return
        w, h = wh
        pts = [np.round(p * (w, h)).astype(np.int32) for p in self._polys]
        if self.fill_alpha > 0:
            filled = frame.copy()
            cv2.fillPoly(filled, pts, self.color)
            cv2.addWeighted(filled, self.fill_alpha, frame, 1 - self.fill_alpha, 0, dst=frame)
        cv2.polylines(frame, pts, self.closed, self.color, self.thickness, cv2.LINE_AA)


class MaskOverlay(Overlay):
    """Tints the panel where a binary/uint8 mask is set (reference toadui
    DrawMaskOverlay); the mask is resized (nearest) to the render size."""

    def __init__(self, color=(0, 0, 255), alpha=0.4):
        self.color, self.alpha = color, alpha
        self._mask = None

    def set_mask(self, mask_hw):
        self._mask = None if mask_hw is None else (np.asarray(mask_hw) > 0).astype(np.uint8)
        return self

    def draw(self, frame, wh):
        if self._mask is None or not self._mask.any():
            return
        w, h = wh
        m = cv2.resize(self._mask, (w, h), interpolation=cv2.INTER_NEAREST).astype(bool)
        tint = frame[m].astype(np.float32) * (1 - self.alpha) + np.float32(self.color) * self.alpha
        frame[m] = tint.astype(np.uint8)


class OutlineOverlay(Overlay):
    """Border outline around the panel with separate hover styling (reference
    toadui DrawOutlineOverlay, overlays.py:261-318) — e.g. highlighting the
    hovered display in a multi-panel layout."""

    def __init__(self, color=(0, 0, 0), thickness=1, hover_color=None, hover_thickness=None):
        self.color, self.thickness = color, thickness
        self.hover_color = color if hover_color is None else hover_color
        self.hover_thickness = thickness if hover_thickness is None else hover_thickness
        self._hovered = False

    def on_mouse(self, xy_norm, event, flags=0):
        self._hovered = True

    def on_mouse_elsewhere(self):
        self._hovered = False

    def draw(self, frame, wh):
        color = self.hover_color if self._hovered else self.color
        t = self.hover_thickness if self._hovered else self.thickness
        w, h = wh
        cv2.rectangle(frame, (0, 0), (w - 1, h - 1), color, t)


class CustomOverlay(Overlay):
    """User-defined draw callback (reference toadui DrawCustomOverlay,
    overlays.py:321-383): fn(frame_bgr, xy_norm_or_None) may draw on the
    frame in place or return a same-shape replacement; a None fn disables
    the overlay. xy_norm is the latest hover position (None off-panel)."""

    def __init__(self, draw_fn=None):
        self.draw_fn = draw_fn
        self._xy_norm = None

    def set_render(self, draw_fn):
        self.draw_fn = draw_fn
        return self

    def on_mouse(self, xy_norm, event, flags=0):
        self._xy_norm = xy_norm

    def on_mouse_elsewhere(self):
        self._xy_norm = None

    def draw(self, frame, wh):
        if self.draw_fn is None:
            return
        out = self.draw_fn(frame, self._xy_norm)
        if out is not None and out is not frame:
            np.copyto(frame, np.asarray(out, frame.dtype))


class CrosshairOverlay(Overlay):
    """Full-span crosshair lines following the hover position (or pinned via
    set()), with an optional coordinate readout (reference toadui crosshair
    overlays)."""

    def __init__(self, color=(200, 200, 200), show_label=True):
        self.color, self.show_label = color, show_label
        self._xy = None
        self._pinned = False

    def set(self, xy_norm):
        self._xy = None if xy_norm is None else (float(xy_norm[0]), float(xy_norm[1]))
        self._pinned = xy_norm is not None
        return self

    def on_mouse(self, xy_norm, event, flags=0):
        if not self._pinned:
            self._xy = xy_norm

    def on_mouse_elsewhere(self):
        if not self._pinned:
            self._xy = None

    def draw(self, frame, wh):
        if self._xy is None:
            return
        w, h = wh
        x, y = int(self._xy[0] * w), int(self._xy[1] * h)
        cv2.line(frame, (0, y), (w, y), self.color, 1, cv2.LINE_AA)
        cv2.line(frame, (x, 0), (x, h), self.color, 1, cv2.LINE_AA)
        if self.show_label:
            TextDrawer(0.38, color=self.color).draw(frame, f"({self._xy[0]:.3f}, {self._xy[1]:.3f})", (min(x + 6, w - 90), min(y + 4, h - 16)))


class PointClickOverlay(Overlay):
    """Collects clicked points: click replaces the newest point, shift-click
    appends, right-click clears (reference toadui PointClickOverlay).
    read() -> (changed, tuple of normalized points)."""

    def __init__(self, color=(80, 255, 255), max_points=None):
        self.color = color
        self.max_points = max_points
        self._points: list[tuple[float, float]] = []
        self._changed = False

    def clear(self):
        self._changed = self._changed or bool(self._points)
        self._points = []
        return self

    def read(self):
        changed, self._changed = self._changed, False
        return changed, tuple(self._points)

    def on_mouse(self, xy_norm, event, flags=0):
        if event == cv2.EVENT_LBUTTONDOWN:
            if not (flags & cv2.EVENT_FLAG_SHIFTKEY) and self._points:
                self._points.pop()
            self._points.append((float(np.clip(xy_norm[0], 0, 1)), float(np.clip(xy_norm[1], 0, 1))))
            if self.max_points is not None and len(self._points) > self.max_points:
                self._points.pop(0)
            self._changed = True
        elif event == cv2.EVENT_RBUTTONDOWN:
            self.clear()

    def draw(self, frame, wh):
        w, h = wh
        for px, py in self._points:
            cv2.drawMarker(frame, (int(px * w), int(py * h)), self.color, cv2.MARKER_TILTED_CROSS, 12, 2)


class BoxSelectOverlay(Overlay):
    """Drag-to-select boxes — the crop-box widget family's interaction core
    (reference toadui BoxSelectOverlay / EditBoxOverlay): drag draws an
    in-progress box; release commits it; a plain new drag replaces the newest
    box while shift-drag adds another; right-click clears. read() ->
    (changed, tuple of ((x1,y1),(x2,y2)) normalized, top-left/bottom-right
    ordered)."""

    MIN_SIZE_NORM = 0.005

    def __init__(self, color=(0, 255, 255), thickness=1, bg_color=(0, 0, 0)):
        self._painter = RectangleOverlay(color, thickness, bg_color)
        self._boxes: list[tuple[tuple[float, float], tuple[float, float]]] = []
        self._inprog = None
        self._changed = False

    def clear(self, flag_change: bool = True):
        self._changed = self._changed or (flag_change and (bool(self._boxes) or self._inprog is not None))
        self._boxes = []
        self._inprog = None
        return self

    @staticmethod
    def _tlbr(p1, p2):
        (x1, y1), (x2, y2) = p1, p2
        return ((min(x1, x2), min(y1, y2)), (max(x1, x2), max(y1, y2)))

    def _all_boxes(self):
        boxes = list(self._boxes)
        if self._inprog is not None:
            tl, br = self._tlbr(*self._inprog)
            if br[0] - tl[0] > self.MIN_SIZE_NORM and br[1] - tl[1] > self.MIN_SIZE_NORM:
                boxes.append((tl, br))
        return boxes

    def read(self):
        changed, self._changed = self._changed, False
        return changed, tuple(self._all_boxes())

    def on_mouse(self, xy_norm, event, flags=0):
        xy = (float(np.clip(xy_norm[0], 0, 1)), float(np.clip(xy_norm[1], 0, 1)))
        if event == cv2.EVENT_LBUTTONDOWN:
            if not (flags & cv2.EVENT_FLAG_SHIFTKEY) and self._boxes:
                self._boxes.pop()
            self._inprog = [xy, xy]
            self._changed = True
        elif event == cv2.EVENT_MOUSEMOVE and self._inprog is not None:
            self._inprog[1] = xy
            self._changed = True
        elif event == cv2.EVENT_LBUTTONUP and self._inprog is not None:
            self._inprog[1] = xy  # the release position finishes the box
            tl, br = self._tlbr(*self._inprog)
            if br[0] - tl[0] > self.MIN_SIZE_NORM and br[1] - tl[1] > self.MIN_SIZE_NORM:
                self._boxes.append((tl, br))
            self._inprog = None
            self._changed = True
        elif event == cv2.EVENT_RBUTTONDOWN:
            self.clear()

    def wants_mouse(self):
        return self._inprog is not None

    def draw(self, frame, wh):
        self._painter.set_boxes(self._all_boxes())
        self._painter.draw(frame, wh)


class GridSelectOverlay(Overlay):
    """Cell picker over a (rows, cols) grid — hover highlight + click select
    (reference toadui GridSelectOverlay; the patch-grid analog of the token
    pickers the experiments use). read() -> (changed, (row, col) | None)."""

    def __init__(self, grid_hw: tuple[int, int], color=(0, 255, 255)):
        self.grid_hw = (int(grid_hw[0]), int(grid_hw[1]))
        self.color = color
        self._selected = None
        self._hover = None
        self._changed = False

    def _cell(self, xy_norm):
        gh, gw = self.grid_hw
        return (
            int(np.clip(xy_norm[1] * gh, 0, gh - 1)),
            int(np.clip(xy_norm[0] * gw, 0, gw - 1)),
        )

    def read(self):
        changed, self._changed = self._changed, False
        return changed, self._selected

    def on_mouse(self, xy_norm, event, flags=0):
        self._hover = self._cell(xy_norm)
        if event == cv2.EVENT_LBUTTONDOWN:
            sel = self._cell(xy_norm)
            if sel != self._selected:
                self._selected = sel
                self._changed = True

    def on_mouse_elsewhere(self):
        self._hover = None

    def draw(self, frame, wh):
        w, h = wh
        gh, gw = self.grid_hw
        for cell, thickness in ((self._hover, 1), (self._selected, 2)):
            if cell is None:
                continue
            r, c = cell
            p1 = (int(c * w / gw), int(r * h / gh))
            p2 = (int((c + 1) * w / gw), int((r + 1) * h / gh))
            cv2.rectangle(frame, p1, p2, self.color, thickness)


class HoverLabelOverlay(Overlay):
    """Tooltip following the cursor, text supplied by a callback
    (reference toadui/overlays.py:685 HoverLabelOverlay). The composable
    form of ImageDisplay.set_hover_text — usable on any OverlayStack base."""

    def __init__(self, label_fn, scale=0.45, color=_FG, bg_color=(25, 25, 25)):
        self.label_fn = label_fn
        self.scale, self.color, self.bg_color = scale, color, bg_color
        self._xy = None

    def on_mouse(self, xy_norm, event, flags=0):
        self._xy = xy_norm

    def on_mouse_elsewhere(self):
        self._xy = None

    def draw(self, frame, wh):
        if self._xy is None or self.label_fn is None:
            return
        text = self.label_fn(self._xy)
        if not text:
            return
        w, h = wh
        td = TextDrawer(self.scale, color=self.color)
        tw, th = td.size(text)
        x0 = int(min(self._xy[0] * w + 12, w - tw - 10))
        y0 = int(max(self._xy[1] * h - th - 14, 2))
        if self.bg_color is not None:
            cv2.rectangle(frame, (x0 - 4, y0 - 3), (x0 + tw + 4, y0 + th + 6), self.bg_color, -1)
        td.draw(frame, text, (x0, y0))


class MousePaintOverlay(Overlay):
    """Paint a mask over the panel with the mouse (reference
    toadui/overlays.py:455 MousePaintOverlay): left-drag paints, ctrl- or
    right-drag erases, a brush-radius circle tracks the hover position.
    The painted mask accumulates at a fixed internal resolution;
    read_mask() -> (changed, uint8 HxW mask) and read_trail() pops the
    most recently finished stroke as normalized points (the reference's
    trail-reading contract)."""

    def __init__(self, mask_hw=(256, 256), brush_radius_norm=0.05, color=(0, 255, 255), alpha=0.35):
        self.mask = np.zeros((int(mask_hw[0]), int(mask_hw[1])), np.uint8)
        self.brush_radius_norm = float(brush_radius_norm)
        self.color, self.alpha = color, alpha
        self._hover = None
        self._prev_xy = None
        self._painting = 0  # 0 idle, +1 paint, -1 erase
        self._changed = False
        self._trail: list[tuple[float, float]] = []
        self._finished_trail = None

    def clear(self):
        self._changed = self._changed or bool(self.mask.any())
        self.mask[:] = 0
        return self

    def read_mask(self):
        changed, self._changed = self._changed, False
        return changed, self.mask.copy()

    def read_trail(self):
        """Pops (finished, points): the last completed stroke, once."""
        trail, self._finished_trail = self._finished_trail, None
        return trail is not None, tuple(trail or ())

    def _stamp(self, xy_norm, value):
        mh, mw = self.mask.shape
        p = (int(np.clip(xy_norm[0], 0, 1) * (mw - 1)), int(np.clip(xy_norm[1], 0, 1) * (mh - 1)))
        r = max(1, int(round(self.brush_radius_norm * mw)))
        if self._prev_xy is not None:
            q = (int(np.clip(self._prev_xy[0], 0, 1) * (mw - 1)), int(np.clip(self._prev_xy[1], 0, 1) * (mh - 1)))
            cv2.line(self.mask, q, p, value, thickness=2 * r)
        cv2.circle(self.mask, p, r, value, -1)
        self._prev_xy = xy_norm
        self._changed = True

    def on_mouse(self, xy_norm, event, flags=0):
        self._hover = xy_norm
        erase = bool(flags & cv2.EVENT_FLAG_CTRLKEY)
        if event == cv2.EVENT_LBUTTONDOWN:
            self._painting = -1 if erase else 1
            self._prev_xy = None
            self._trail = [xy_norm]
            self._stamp(xy_norm, 0 if erase else 255)
        elif event == cv2.EVENT_RBUTTONDOWN:
            self._painting = -1
            self._prev_xy = None
            self._stamp(xy_norm, 0)
        elif event == cv2.EVENT_MOUSEMOVE and self._painting:
            if self._painting > 0:
                self._trail.append(xy_norm)
            self._stamp(xy_norm, 255 if self._painting > 0 else 0)
        elif event in (cv2.EVENT_LBUTTONUP, cv2.EVENT_RBUTTONUP) and self._painting:
            if self._painting > 0 and self._trail:
                self._finished_trail = list(self._trail)
            self._painting = 0
            self._prev_xy = None
            self._trail = []

    def on_mouse_elsewhere(self):
        self._hover = None

    def wants_mouse(self):
        return bool(self._painting)

    def draw(self, frame, wh):
        w, h = wh
        if self.mask.any():
            m = cv2.resize(self.mask, (w, h), interpolation=cv2.INTER_NEAREST).astype(bool)
            tint = frame[m].astype(np.float32) * (1 - self.alpha) + np.float32(self.color) * self.alpha
            frame[m] = tint.astype(np.uint8)
        if self._hover is not None:
            p = (int(self._hover[0] * w), int(self._hover[1] * h))
            cv2.circle(frame, p, max(2, int(self.brush_radius_norm * w)), self.color, 1, cv2.LINE_AA)


class EditBoxOverlay(Overlay):
    """Single editable box — the crop-box widget (reference
    toadui/overlays.py:1109 EditBoxOverlay): drag a corner or mid-edge
    handle to resize, drag the interior to move, drag far outside to redraw
    the box from scratch; right-click resets to the full frame. Exactly one
    box always exists (it starts as the full frame, like the reference's
    clear()). read() -> (changed, ((x1,y1),(x2,y2)) normalized)."""

    HANDLE_DIST_NORM = 0.03
    MIN_SIZE_NORM = 0.01

    def __init__(self, box=((0.0, 0.0), (1.0, 1.0)), color=(0, 255, 255), thickness=2, bg_color=(0, 0, 0)):
        (x1, y1), (x2, y2) = box
        self._box = [min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)]
        self.color, self.thickness, self.bg_color = color, thickness, bg_color
        self._mode = None  # ("resize", ix, iy) | ("move", dx, dy) | ("new",)
        self._changed = True

    def clear(self):
        self._box = [0.0, 0.0, 1.0, 1.0]
        self._mode = None
        self._changed = True
        return self

    def set(self, box, flag_change: bool = False):
        (x1, y1), (x2, y2) = box
        self._box = [min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)]
        self._changed = self._changed or flag_change
        return self

    def read(self):
        changed, self._changed = self._changed, False
        x1, y1, x2, y2 = self._box
        return changed, ((x1, y1), (x2, y2))

    # -- interaction ------------------------------------------------------
    def _handles(self):
        """9-point handle lattice: corners, mid-edges and center (xs x ys)."""
        x1, y1, x2, y2 = self._box
        return (x1, (x1 + x2) / 2, x2), (y1, (y1 + y2) / 2, y2)

    def on_mouse(self, xy_norm, event, flags=0):
        x = float(np.clip(xy_norm[0], 0, 1))
        y = float(np.clip(xy_norm[1], 0, 1))
        if event == cv2.EVENT_RBUTTONDOWN:
            self.clear()
            return
        if event == cv2.EVENT_LBUTTONDOWN:
            xs, ys = self._handles()
            ix = int(np.argmin([abs(x - v) for v in xs]))
            iy = int(np.argmin([abs(y - v) for v in ys]))
            near_x, near_y = abs(x - xs[ix]), abs(y - ys[iy])
            t = self.HANDLE_DIST_NORM
            x1, y1, x2, y2 = self._box
            if near_x < t and near_y < t and not (ix == 1 and iy == 1):
                self._mode = ("resize", ix, iy)  # corner or mid-edge handle
            elif near_x < t and ix != 1 and y1 - t <= y <= y2 + t:
                self._mode = ("resize", ix, 1)  # vertical edge anywhere along it
            elif near_y < t and iy != 1 and x1 - t <= x <= x2 + t:
                self._mode = ("resize", 1, iy)  # horizontal edge
            elif x1 - t <= x <= x2 + t and y1 - t <= y <= y2 + t:
                self._mode = ("move", x - x1, y - y1)
            else:
                self._box = [x, y, x, y]
                self._mode = ("resize", 2, 2)  # drawing fresh: drag the far corner
                self._changed = True
            return
        if self._mode is None:
            return
        if event == cv2.EVENT_MOUSEMOVE or event == cv2.EVENT_LBUTTONUP:
            kind = self._mode[0]
            x1, y1, x2, y2 = self._box
            if kind == "move":
                dx, dy = self._mode[1], self._mode[2]
                w, h = x2 - x1, y2 - y1
                nx1 = float(np.clip(x - dx, 0, 1 - w))
                ny1 = float(np.clip(y - dy, 0, 1 - h))
                self._box = [nx1, ny1, nx1 + w, ny1 + h]
            else:
                _, ix, iy = self._mode
                if ix == 0:
                    x1 = x
                elif ix == 2:
                    x2 = x
                if iy == 0:
                    y1 = y
                elif iy == 2:
                    y2 = y
                # dragging a corner past its opposite swaps the handle's role
                if x1 > x2:
                    x1, x2 = x2, x1
                    ix = 2 - ix
                if y1 > y2:
                    y1, y2 = y2, y1
                    iy = 2 - iy
                self._mode = ("resize", ix, iy)
                # enforce a minimum size by pushing the dragged side back
                if ix != 1 and x2 - x1 < self.MIN_SIZE_NORM:
                    if ix == 0:
                        x1 = max(x2 - self.MIN_SIZE_NORM, 0.0)
                    else:
                        x2 = min(x1 + self.MIN_SIZE_NORM, 1.0)
                if iy != 1 and y2 - y1 < self.MIN_SIZE_NORM:
                    if iy == 0:
                        y1 = max(y2 - self.MIN_SIZE_NORM, 0.0)
                    else:
                        y2 = min(y1 + self.MIN_SIZE_NORM, 1.0)
                self._box = [x1, y1, x2, y2]
            self._changed = True
            if event == cv2.EVENT_LBUTTONUP:
                self._mode = None

    def wants_mouse(self):
        return self._mode is not None

    def draw(self, frame, wh):
        w, h = wh
        x1, y1, x2, y2 = self._box
        p1, p2 = (int(x1 * w), int(y1 * h)), (int(x2 * w), int(y2 * h))
        if self.bg_color is not None:
            cv2.rectangle(frame, p1, p2, self.bg_color, self.thickness + 1)
        cv2.rectangle(frame, p1, p2, self.color, self.thickness)
        xs, ys = self._handles()
        for iy, yv in enumerate(ys):
            for ix, xv in enumerate(xs):
                if ix == 1 and iy == 1:
                    continue
                c = (int(xv * w), int(yv * h))
                cv2.circle(frame, c, 4, self.bg_color or (0, 0, 0), -1)
                cv2.circle(frame, c, 3, self.color, -1)


class Carousel(UIElement):
    """Button carousel: < label > cycling through options (reference toadui
    button carousels, buttons.py). Click the arrow thirds to cycle, the
    middle to advance. read() -> (changed, index, label)."""

    ARROW_W = 36

    def __init__(self, label: str, options, default_index: int = 0, height=34):
        self.label = label
        self.options = list(options)
        self._idx = int(np.clip(default_index, 0, max(len(self.options) - 1, 0)))
        self.height = height
        self._changed = False
        self._width = 300

    @property
    def value(self):
        return self.options[self._idx] if self.options else None

    @property
    def index(self):
        return self._idx

    def cycle(self, step: int = 1):
        if self.options:
            self._idx = (self._idx + step) % len(self.options)
            self._changed = True
        return self

    def read(self):
        changed, self._changed = self._changed, False
        return changed, self._idx, self.value

    def render(self, width):
        self._width = width
        img = np.full((self.height, width, 3), _BG, np.uint8)
        aw, hh = self.ARROW_W, self.height // 2
        cv2.rectangle(img, (3, 3), (aw - 3, self.height - 3), (80, 80, 80), 1)
        cv2.rectangle(img, (width - aw + 3, 3), (width - 3, self.height - 3), (80, 80, 80), 1)
        cv2.fillPoly(img, [np.array([(aw // 2 + 4, hh - 6), (aw // 2 + 4, hh + 6), (aw // 2 - 6, hh)])], _FG)
        cv2.fillPoly(img, [np.array([(width - aw // 2 - 4, hh - 6), (width - aw // 2 - 4, hh + 6), (width - aw // 2 + 6, hh)])], _FG)
        shown = self._display_text()
        text = f"{self.label}: {shown}" if self.label else shown
        TextDrawer(0.45).draw(img, text, (width // 2, hh - 7), anchor="center")
        return img

    def _display_text(self) -> str:
        return str(self.value)

    def on_mouse(self, x, y, event, flags=0):
        if event == cv2.EVENT_LBUTTONDOWN:
            self.cycle(-1 if x < self.ARROW_W else 1)


class PathCarousel(Carousel):
    """Carousel over filesystem paths: cycles full paths as values but shows
    only the basename (reference toadui PathCarousel, carousels.py) — the
    model/file pickers in the reference demos use this form."""

    def _display_text(self) -> str:
        import os.path as osp

        # ASCII placeholder: TextDrawer renders via cv2 Hershey fonts, which
        # draw non-ASCII glyphs (an em dash) as "??" garbage
        return osp.basename(str(self.value)) if self.value is not None else "(none)"


class ImageDisplay(UIElement):
    """Main image panel; height tracks the image aspect at render width.
    Supports hover readouts (set_hover_text), draggable point markers
    (add_marker) and composable overlays (add_overlay: text, rectangles,
    polygons, masks, crosshairs, point/box/grid selection) — the
    toadui/overlays.py feature family the experiments build on."""

    def __init__(self, image_bgr=None):
        self._img = image_bgr if image_bgr is not None else np.zeros((64, 64, 3), np.uint8)
        self.height = self._img.shape[0]
        self.last_click_xy_norm = None
        self.hover_xy_norm = None
        self._hover_text_fn = None
        self._markers: list[DraggableMarker] = []
        self._overlays: list[Overlay] = []

    def set_image(self, image_bgr):
        self._img = image_bgr
        return self

    @property
    def image(self):
        """The current full-resolution BGR image (read-only view for savers)."""
        return self._img

    def set_hover_text(self, text_fn):
        """Attach a hover readout: text_fn((x_norm, y_norm)) -> str is drawn
        in a tooltip beside the cursor while it is over the panel."""
        self._hover_text_fn = text_fn
        return self

    def add_marker(self, xy_norm=(0.5, 0.5), color=(80, 255, 255)) -> DraggableMarker:
        marker = DraggableMarker(xy_norm, color)
        self._markers.append(marker)
        return marker

    def add_overlay(self, overlay: Overlay) -> Overlay:
        self._overlays.append(overlay)
        return overlay

    def remove_overlay(self, overlay: Overlay):
        if overlay in self._overlays:
            self._overlays.remove(overlay)
        return self

    def render(self, width):
        h, w = self._img.shape[:2]
        self.height = max(1, int(round(h * width / w)))
        self._render_wh = (width, self.height)
        if (w, h) == (width, self.height):
            img = self._img
        else:
            img = cv2.resize(self._img, (width, self.height))
        active_overlays = [ov for ov in self._overlays if ov.enabled]
        if self._markers or active_overlays or (self._hover_text_fn and self.hover_xy_norm):
            img = img.copy()
        for m in self._markers:
            mx, my = int(m.xy_norm[0] * width), int(m.xy_norm[1] * self.height)
            cv2.drawMarker(img, (mx, my), m.color, cv2.MARKER_CROSS, 16, 2)
            cv2.circle(img, (mx, my), 6, m.color, 1, cv2.LINE_AA)
        for ov in active_overlays:
            ov.draw(img, (width, self.height))
        if self._hover_text_fn and self.hover_xy_norm is not None:
            self._draw_tooltip(img, width)
        return img

    def _draw_tooltip(self, img, width):
        text = self._hover_text_fn(self.hover_xy_norm)
        if not text:
            return
        td = TextDrawer(0.45)
        tw, th = td.size(text)
        hx, hy = int(self.hover_xy_norm[0] * width), int(self.hover_xy_norm[1] * self.height)
        x0 = min(hx + 12, width - tw - 10)
        y0 = max(hy - th - 14, 2)
        cv2.rectangle(img, (x0 - 4, y0 - 3), (x0 + tw + 4, y0 + th + 6), (25, 25, 25), -1)
        td.draw(img, text, (x0, y0))

    def on_mouse(self, x, y, event, flags=0):
        w, h = getattr(self, "_render_wh", (1, 1))
        xy_norm = (x / max(w, 1), y / max(h, 1))
        self.hover_xy_norm = xy_norm
        for ov in self._overlays:
            if ov.enabled:
                ov.on_mouse(xy_norm, event, flags)
        # interactive overlays (box select etc.) claim the click: don't also
        # grab/place markers under an overlay-owned drag
        overlay_owns_drag = any(ov.wants_mouse() for ov in self._overlays if ov.enabled)
        if event == cv2.EVENT_LBUTTONDOWN and not overlay_owns_drag:
            self.last_click_xy_norm = xy_norm
            for m in self._markers:  # grab the nearest marker within reach
                dx, dy = (m.xy_norm[0] - xy_norm[0]) * w, (m.xy_norm[1] - xy_norm[1]) * h
                if dx * dx + dy * dy <= DraggableMarker.GRAB_RADIUS_PX**2:
                    m._dragging = True
                    break
            else:
                # click-to-place when a single marker exists (token picking)
                if len(self._markers) == 1:
                    self._markers[0].set(xy_norm, flag_change=True)
        if event == cv2.EVENT_LBUTTONUP:
            for m in self._markers:
                m._dragging = False
        if event == cv2.EVENT_MOUSEMOVE:
            for m in self._markers:
                if m._dragging:
                    m.set(xy_norm, flag_change=True)

    def on_mouse_elsewhere(self):
        self.hover_xy_norm = None
        for ov in self._overlays:
            ov.on_mouse_elsewhere()

    def wants_mouse(self):
        return any(m._dragging for m in self._markers) or any(
            ov.wants_mouse() for ov in self._overlays if ov.enabled
        )


class LinePlot(UIElement):
    """Minimal line plot bar (reference toadui/plots.py): one 1-D series
    with min/max axis labels and an optional highlighted x index, used by the
    experiments to show per-layer statistics."""

    def __init__(self, title: str = "", height: int = 110, color=_ACCENT):
        self.title = title
        self.height = height
        self.color = color
        self._ys = None
        self._highlight = None
        self._hover_idx = None

    def set_series(self, ys, highlight_idx=None):
        self._ys = None if ys is None else np.asarray(ys, np.float32).reshape(-1)
        self._highlight = highlight_idx
        return self

    def render(self, width):
        self._width = width
        img = np.full((self.height, width, 3), _BG, np.uint8)
        ys = self._ys
        if ys is None or len(ys) == 0:
            return img
        pad_l, pad_r, pad_t, pad_b = 12, 12, 18, 10
        pw, ph = width - pad_l - pad_r, self.height - pad_t - pad_b
        lo, hi = float(ys.min()), float(ys.max())
        span = max(hi - lo, 1e-9)
        xs = pad_l + np.linspace(0, pw, len(ys))
        pys = pad_t + ph - (ys - lo) / span * ph
        pts = np.stack([xs, pys], axis=-1).astype(np.int32)
        if self._highlight is not None and 0 <= self._highlight < len(ys):
            hx = int(xs[self._highlight])
            cv2.line(img, (hx, pad_t - 4), (hx, self.height - pad_b + 4), (90, 90, 90), 1)
        cv2.polylines(img, [pts], False, self.color, 1, cv2.LINE_AA)
        for p in pts:
            cv2.circle(img, tuple(p), 2, self.color, -1, cv2.LINE_AA)
        td = TextDrawer(0.38, color=(150, 150, 150))
        label = self.title
        if self._hover_idx is not None and 0 <= self._hover_idx < len(ys):
            label = f"{self.title}  [{self._hover_idx}] = {ys[self._hover_idx]:.2f}"
        TextDrawer(0.42).draw(img, label, (pad_l, 2))
        td.draw(img, f"{hi:.2f}", (width - pad_r - td.size(f'{hi:.2f}')[0], pad_t - 6))
        td.draw(img, f"{lo:.2f}", (width - pad_r - td.size(f'{lo:.2f}')[0], self.height - pad_b - 8))
        return img

    def on_mouse(self, x, y, event, flags=0):
        if self._ys is None or len(self._ys) == 0:
            return
        pad_l, pad_r = 12, 12
        pw = max(getattr(self, "_width", 300) - pad_l - pad_r, 1)
        self._hover_idx = int(np.clip(round((x - pad_l) / pw * (len(self._ys) - 1)), 0, len(self._ys) - 1))

    def on_mouse_elsewhere(self):
        self._hover_idx = None


class PlaybackBar(UIElement):
    """Video playback control bar (reference toadui/video.py): a play/pause
    button, a draggable frame-position slider and a frame counter in one
    row. The app polls read_seek()/read_pause() each frame."""

    BTN_W = 44

    def __init__(self, total_frames: int, height: int = 36):
        self.total = max(int(total_frames), 1)
        self.height = height
        self._frame = 0
        self._paused = False
        self._seek = None
        self._pause_changed = False
        self._dragging = False
        self._width = 300

    @property
    def is_paused(self):
        return self._paused

    def set_frame(self, idx: int):
        if not self._dragging:
            self._frame = int(np.clip(idx, 0, self.total - 1))
        return self

    def toggle_pause(self, set_paused=None):
        self._paused = (not self._paused) if set_paused is None else bool(set_paused)
        self._pause_changed = True
        return self._paused

    def read_pause(self):
        changed, self._pause_changed = self._pause_changed, False
        return changed, self._paused

    def read_seek(self):
        """Pops the pending seek target (None when the user hasn't scrubbed)."""
        seek, self._seek = self._seek, None
        return seek is not None, seek

    def render(self, width):
        self._width = width
        img = np.full((self.height, width, 3), _BG, np.uint8)
        bw, hh = self.BTN_W, self.height // 2
        cv2.rectangle(img, (3, 3), (bw - 3, self.height - 3), (80, 80, 80), 1)
        if self._paused:  # show the action the button will take: play triangle
            cv2.fillPoly(img, [np.array([(bw // 2 - 5, hh - 7), (bw // 2 - 5, hh + 7), (bw // 2 + 7, hh)])], _FG)
        else:  # pause bars
            cv2.rectangle(img, (bw // 2 - 7, hh - 7), (bw // 2 - 3, hh + 7), _FG, -1)
            cv2.rectangle(img, (bw // 2 + 3, hh - 7), (bw // 2 + 7, hh + 7), _FG, -1)
        counter = f"{self._frame + 1}/{self.total}"
        td = TextDrawer(0.42)
        cw = td.size(counter)[0] + 14
        td.draw(img, counter, (width - cw + 4, hh - 7))
        pad = 10
        x0, x1 = bw + pad, width - cw - pad
        t = self._frame / max(self.total - 1, 1)
        x = int(x0 + t * max(x1 - x0, 1))
        cv2.line(img, (x0, hh), (x1, hh), (90, 90, 90), 2)
        cv2.line(img, (x0, hh), (x, hh), _ACCENT, 2)
        cv2.circle(img, (x, hh), 7, _ACCENT, -1)
        self._track = (x0, x1)
        return img

    def _scrub_to(self, x):
        x0, x1 = getattr(self, "_track", (self.BTN_W + 10, self._width - 60))
        t = np.clip((x - x0) / max(x1 - x0, 1), 0, 1)
        self._frame = int(round(t * (self.total - 1)))
        self._seek = self._frame

    def on_mouse(self, x, y, event, flags=0):
        if event == cv2.EVENT_LBUTTONDOWN:
            if x < self.BTN_W:
                self.toggle_pause()
            else:
                self._dragging = True
                self._scrub_to(x)
        if event == cv2.EVENT_LBUTTONUP:
            self._dragging = False
        if self._dragging and event == cv2.EVENT_MOUSEMOVE:
            self._scrub_to(x)

    def wants_mouse(self):
        return self._dragging


class HStack(UIElement):
    """Horizontal row of elements sharing one bar height (reference
    toadui/layout.py). Children split the width equally; the row height
    tracks the tallest child's natural height each render (image panels
    change aspect when their content changes), and any child stretched to
    the row height gets its mouse-normalization size fixed up to match."""

    def __init__(self, *elements, height=None, weights=None):
        self.elements = [e for e in elements if e is not None]
        self._fixed_height = height
        self.height = height or max((e.height for e in self.elements), default=34)
        if weights is not None:
            assert len(weights) == len(self.elements), "one weight per element"
        self._weights = weights

    def render(self, width):
        n = max(len(self.elements), 1)
        if self._weights:
            total = sum(self._weights)
            widths = [max(1, int(width * wt / total)) for wt in self._weights]
        else:
            widths = [width // n] * n
        widths[-1] += width - sum(widths)
        parts = [e.render(w) for e, w in zip(self.elements, widths)]
        self.height = self._fixed_height or max(p.shape[0] for p in parts)
        for i, (e, w) in enumerate(zip(self.elements, widths)):
            if parts[i].shape[0] != self.height:
                parts[i] = cv2.resize(parts[i], (w, self.height))
                if isinstance(e, ImageDisplay):
                    # hover/marker math must use the displayed size
                    e._render_wh = (w, self.height)
        self._widths = widths
        return np.hstack(parts)

    def on_mouse(self, x, y, event, flags=0):
        offs = np.cumsum([0] + getattr(self, "_widths", []))
        # exclusive drag routing: while one child owns a drag, only it gets
        # live events (clipped into its band so the drag survives overshoot);
        # everything else sees on_mouse_elsewhere — otherwise releasing a drag
        # over a neighbor would spuriously trigger its LBUTTONUP handling
        drag_owner = next((e for e in self.elements if e.wants_mouse()), None)
        for i, e in enumerate(self.elements):
            if e is drag_owner:
                e.on_mouse(int(np.clip(x - offs[i], 0, offs[i + 1] - offs[i] - 1)), y, event, flags)
            elif drag_owner is None and offs[i] <= x < offs[i + 1]:
                e.on_mouse(x - offs[i], y, event, flags)
            else:
                e.on_mouse_elsewhere()

    def wants_mouse(self):
        return any(e.wants_mouse() for e in self.elements)

    def on_mouse_elsewhere(self):
        for e in self.elements:
            e.on_mouse_elsewhere()


class VStack:
    """Vertical layout + mouse routing (reference toadui/layout.py)."""

    def __init__(self, *elements):
        self.elements = [e for e in elements if e is not None]

    def render(self, width: int) -> np.ndarray:
        parts = [e.render(width) for e in self.elements]
        self._offsets = np.cumsum([0] + [p.shape[0] for p in parts])
        return np.vstack(parts)

    def on_mouse(self, x, y, event, flags=0):
        offs = getattr(self, "_offsets", None)
        if offs is None:
            return
        # exclusive drag routing (see HStack.on_mouse): the drag owner gets
        # events clipped into its row; everyone else gets on_mouse_elsewhere
        drag_owner = next((e for e in self.elements if e.wants_mouse()), None)
        for i, e in enumerate(self.elements):
            if e is drag_owner:
                e.on_mouse(x, int(np.clip(y - offs[i], 0, offs[i + 1] - offs[i] - 1)), event, flags)
            elif drag_owner is None and offs[i] <= y < offs[i + 1]:
                e.on_mouse(x, y - offs[i], event, flags)
            else:
                e.on_mouse_elsewhere()

    def wants_mouse(self):
        return any(e.wants_mouse() for e in self.elements)

    def on_mouse_elsewhere(self):
        for e in self.elements:
            e.on_mouse_elsewhere()


class TextBlock(UIElement):
    """Static multi-line text bar (reference toadui/text.py:24 TextBlock /
    :158 TwoLineTextBlock — pass a list of lines for the multi-line forms).
    set() replaces the text; prefix= gives the PrefixedTextBlock behavior
    (set() only replaces the suffix)."""

    def __init__(self, text="", prefix: str = "", scale=0.45, align="left", color=_FG):
        self.prefix, self.scale, self.align, self.color = prefix, scale, align, color
        self._lines: list[str] = []
        self.set(text)

    def set(self, text):
        lines = list(text) if isinstance(text, (list, tuple)) else str(text or "").split("\n")
        self._lines = [self.prefix + ln for ln in lines] or [self.prefix]
        self.height = 14 + 18 * max(len(self._lines), 1)
        return self

    def render(self, width):
        img = np.full((self.height, width, 3), _BG, np.uint8)
        td = TextDrawer(self.scale, color=self.color)
        for i, ln in enumerate(self._lines):
            tw = td.size(ln)[0]
            x = {"left": 10, "right": width - tw - 10}.get(self.align, (width - tw) // 2)
            td.draw(img, ln, (x, 7 + 18 * i))
        return img


class MessageBar(UIElement):
    """One-line status bar; messages expire after show_for renders
    (reference toadui/text.py:260 MessageBar)."""

    def __init__(self, text="", height=28, show_for: int | None = None, color=_ACCENT):
        self.height, self.color = height, color
        self._text = str(text)
        self._show_for = show_for
        self._remaining = show_for

    def set(self, text):
        self._text = str(text or "")
        self._remaining = self._show_for
        return self

    def render(self, width):
        img = np.full((self.height, width, 3), _BG, np.uint8)
        if self._remaining is not None:
            if self._remaining <= 0:
                self._text = ""
            self._remaining -= 1
        if self._text:
            td = TextDrawer(0.45, color=self.color)
            td.draw(img, self._text, ((width - td.size(self._text)[0]) // 2, self.height // 2 - 8))
        return img


class ImmediateButton(UIElement):
    """Momentary button — fires on click, read() pops the click flag
    (reference toadui/buttons.py:339 ImmediateButton)."""

    def __init__(self, label, height=34, color=(80, 80, 80)):
        self.label, self.height, self.color = label, height, color
        self._clicked = False
        self._flash = 0

    def click(self):
        self._clicked = True
        self._flash = 2
        return self

    def read(self) -> bool:
        clicked, self._clicked = self._clicked, False
        return clicked

    def render(self, width):
        img = np.full((self.height, width, 3), _BG, np.uint8)
        color = _ACCENT if self._flash > 0 else self.color
        self._flash = max(self._flash - 1, 0)
        cv2.rectangle(img, (4, 4), (width - 4, self.height - 4), color, 2)
        td = TextDrawer(0.45)
        td.draw(img, self.label, ((width - td.size(self.label)[0]) // 2, self.height // 2 - 8))
        return img

    def on_mouse(self, x, y, event, flags=0):
        if event == cv2.EVENT_LBUTTONDOWN:
            self.click()


class ImmediateImageButton(UIElement):
    """Momentary button that renders a user-supplied image instead of a text
    label (reference toadui/buttons.py:429 ImmediateImageButton). The image
    is aspect-fit into the bar (INTER_AREA, letterboxed on the background);
    grayscale inputs are promoted to BGR. Click pops True from read() like
    ImmediateButton; hovering draws the outline in the accent color."""

    def __init__(self, image, height=None, outline=True):
        img = np.asarray(image)
        if img.ndim == 2:
            img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        self._img = img
        self.height = int(height) if height is not None else int(img.shape[0]) + 8
        self._outline = bool(outline)
        self._clicked = False
        self._hover = False
        self._cache_w = -1
        self._cache_thumb = None

    def click(self):
        self._clicked = True
        return self

    def read(self) -> bool:
        clicked, self._clicked = self._clicked, False
        return clicked

    def _fit(self, width):
        ih, iw = self._img.shape[:2]
        scale = min(max(width - 8, 1) / iw, max(self.height - 8, 1) / ih)
        tw, th = max(int(iw * scale), 1), max(int(ih * scale), 1)
        return cv2.resize(self._img, (tw, th), interpolation=cv2.INTER_AREA)

    def render(self, width):
        if self._cache_w != width:
            self._cache_w, self._cache_thumb = width, self._fit(width)
        thumb = self._cache_thumb
        img = np.full((self.height, width, 3), _BG, np.uint8)
        th, tw = thumb.shape[:2]
        y0, x0 = (self.height - th) // 2, (width - tw) // 2
        img[y0 : y0 + th, x0 : x0 + tw] = thumb
        if self._outline:
            color = _ACCENT if self._hover else (80, 80, 80)
            cv2.rectangle(img, (x0 - 2, y0 - 2), (x0 + tw + 1, y0 + th + 1), color, 1)
        return img

    def on_mouse(self, x, y, event, flags=0):
        self._hover = True
        if event == cv2.EVENT_LBUTTONDOWN:
            self.click()

    def on_mouse_elsewhere(self):
        self._hover = False


class ToggleImageButton(ImmediateImageButton):
    """Image button with a persistent on/off state (reference
    toadui/buttons.py:159 ToggleImageButton). A distinct `toggle_image` is
    shown while ON; without one the ON state is signalled by the accent
    outline instead (the reference's show_outline_on_toggle default).
    read() -> (changed, is_on), ToggleButton-compatible — usable inside a
    RadioConstraint."""

    def __init__(self, image, toggle_image=None, default=False, height=None):
        super().__init__(image, height=height, outline=True)
        self._imgs = {False: self._img, True: self._img}
        self._has_toggle_img = toggle_image is not None
        if self._has_toggle_img:
            on_img = np.asarray(toggle_image)
            if on_img.ndim == 2:
                on_img = cv2.cvtColor(on_img, cv2.COLOR_GRAY2BGR)
            self._imgs[True] = on_img
        self._on = bool(default)
        self._changed = False

    def toggle(self, set_on=None):
        self._on = (not self._on) if set_on is None else bool(set_on)
        self._changed = True
        return self._on

    def read(self):
        changed, self._changed = self._changed, False
        return changed, self._on

    @property
    def is_on(self):
        return self._on

    def render(self, width):
        img = self._imgs[self._on]
        if img is not self._img or self._cache_w != width:
            self._img, self._cache_w, self._cache_thumb = img, width, None
            self._cache_thumb = self._fit(width)
        out = np.full((self.height, width, 3), _BG, np.uint8)
        thumb = self._cache_thumb
        th, tw = thumb.shape[:2]
        y0, x0 = (self.height - th) // 2, (width - tw) // 2
        out[y0 : y0 + th, x0 : x0 + tw] = thumb
        on_accent = self._on and not self._has_toggle_img
        color = _ACCENT if (on_accent or self._hover) else (80, 80, 80)
        cv2.rectangle(out, (x0 - 2, y0 - 2), (x0 + tw + 1, y0 + th + 1), color, 2 if on_accent else 1)
        return out

    def on_mouse(self, x, y, event, flags=0):
        self._hover = True
        if event == cv2.EVENT_LBUTTONDOWN:
            self.toggle()


class RadioConstraint:
    """Non-layout wrapper that enforces exactly-one-active across toggle
    elements placed anywhere in a UI (reference toadui/buttons.py:547
    RadioConstraint — unlike RadioBar the items need not share a row).
    Works on anything ToggleButton-shaped: read() -> (changed, is_on),
    toggle(set_on=...), .is_on. read() -> (changed, active_index,
    active_item); the first read reports changed=True (forced initial
    state), and toggling the active item off re-forces it on."""

    def __init__(self, *items, initial_active_index: int = 0):
        assert items, "RadioConstraint needs at least one item"
        self._items = tuple(items)
        self._idx = int(np.clip(initial_active_index, 0, len(items) - 1))
        self._changed = True
        self._enforce()

    def __iter__(self):
        return iter(self._items)

    @property
    def active_index(self):
        return self._idx

    def _enforce(self):
        for i, item in enumerate(self._items):
            if item.is_on != (i == self._idx):
                item.toggle(set_on=(i == self._idx))
                item.read()  # swallow the forced-change flag

    def change_to(self, idx_or_item):
        idx = (
            self._items.index(idx_or_item)
            if idx_or_item in self._items
            else int(idx_or_item)
        )
        idx = int(np.clip(idx, 0, len(self._items) - 1))
        if idx != self._idx:
            self._idx, self._changed = idx, True
            self._enforce()
        return self

    def read(self):
        # the newest item toggled ON (other than the current) wins
        new_idx = None
        for i, item in enumerate(self._items):
            changed, is_on = item.read()
            if changed and is_on and i != self._idx:
                new_idx = i
        if new_idx is not None:
            self._idx, self._changed = new_idx, True
        self._enforce()
        changed, self._changed = self._changed, False
        return changed, self._idx, self._items[self._idx]


class RadioBar(UIElement):
    """Row of mutually-exclusive options — exactly one active (reference
    toadui/buttons.py:678 RadioBar / :547 RadioConstraint).
    read() -> (changed, index, label)."""

    def __init__(self, labels, default_index: int = 0, height=34):
        self.labels = list(labels)
        self._idx = int(np.clip(default_index, 0, max(len(self.labels) - 1, 0)))
        self.height = height
        self._changed = False
        self._width = 300

    @property
    def value(self):
        return self.labels[self._idx] if self.labels else None

    @property
    def index(self):
        return self._idx

    def select(self, idx_or_label, flag_change: bool = True):
        idx = self.labels.index(idx_or_label) if isinstance(idx_or_label, str) else int(idx_or_label)
        idx = int(np.clip(idx, 0, len(self.labels) - 1))
        if idx != self._idx:
            self._idx = idx
            self._changed = self._changed or flag_change
        return self

    def read(self):
        changed, self._changed = self._changed, False
        return changed, self._idx, self.value

    def render(self, width):
        self._width = width
        img = np.full((self.height, width, 3), _BG, np.uint8)
        n = max(len(self.labels), 1)
        for i, lab in enumerate(self.labels):
            x0, x1 = int(i * width / n), int((i + 1) * width / n)
            on = i == self._idx
            if on:
                cv2.rectangle(img, (x0 + 3, 4), (x1 - 3, self.height - 4), (60, 90, 130), -1)
            cv2.rectangle(img, (x0 + 3, 4), (x1 - 3, self.height - 4), _ACCENT if on else (80, 80, 80), 1)
            TextDrawer(0.42).draw(img, lab, ((x0 + x1) // 2, self.height // 2 - 6), anchor="center")
        return img

    def on_mouse(self, x, y, event, flags=0):
        if event == cv2.EVENT_LBUTTONDOWN and self.labels:
            self.select(x * len(self.labels) // max(self._width, 1))


class MultiSlider(UIElement):
    """Several handles on one track — e.g. a min/max threshold pair
    (reference toadui/sliders.py:236 MultiSlider). Handles cannot cross;
    read() -> (changed, tuple of values, ordered)."""

    PAD = 10

    def __init__(self, label, values, min_value, max_value, step=1, height=36):
        self.label = label
        self.min, self.max, self.step = min_value, max_value, step
        self._values = sorted(type(step)(v) for v in values)
        self.height = height
        self._changed = False
        self._drag_idx = None
        self._width = 300

    @property
    def values(self):
        return tuple(self._values)

    def set(self, idx, value, flag_change: bool = False):
        value = np.clip(value, self.min, self.max)
        value = self.min + round((value - self.min) / self.step) * self.step
        lo = self._values[idx - 1] if idx > 0 else self.min
        hi = self._values[idx + 1] if idx + 1 < len(self._values) else self.max
        value = type(self.step)(np.clip(value, lo, hi))
        if value != self._values[idx]:
            self._values[idx] = value
            self._changed = self._changed or flag_change
        return self

    def read(self):
        changed, self._changed = self._changed, False
        return changed, tuple(self._values)

    def _to_x(self, v, width):
        t = (v - self.min) / max(self.max - self.min, 1e-9)
        return int(self.PAD + t * (width - 2 * self.PAD))

    def render(self, width):
        self._width = width
        img = np.full((self.height, width, 3), _BG, np.uint8)
        cy = self.height // 2
        cv2.line(img, (self.PAD, cy), (width - self.PAD, cy), (90, 90, 90), 2)
        if len(self._values) >= 2:  # highlight the spanned range
            cv2.line(img, (self._to_x(self._values[0], width), cy), (self._to_x(self._values[-1], width), cy), (60, 90, 130), 2)
        for v in self._values:
            cv2.circle(img, (self._to_x(v, width), cy), 7, _ACCENT, -1)
        vals = ", ".join(f"{v:g}" for v in self._values)
        TextDrawer(0.45).draw(img, f"{self.label}: {vals}", (self.PAD, 2))
        return img

    def on_mouse(self, x, y, event, flags=0):
        if event == cv2.EVENT_LBUTTONDOWN and self._values:
            xs = [self._to_x(v, self._width) for v in self._values]
            self._drag_idx = int(np.argmin([abs(x - xv) for xv in xs]))
        if event == cv2.EVENT_LBUTTONUP:
            self._drag_idx = None
        if self._drag_idx is not None and event in (cv2.EVENT_LBUTTONDOWN, cv2.EVENT_MOUSEMOVE):
            t = np.clip((x - self.PAD) / max(self._width - 2 * self.PAD, 1), 0, 1)
            self.set(self._drag_idx, self.min + t * (self.max - self.min), flag_change=True)

    def wants_mouse(self):
        return self._drag_idx is not None


class HistogramPlot(UIElement):
    """Bar-histogram panel (reference toadui/plots.py:29 SimpleHistogramPlot).
    Feed bin counts directly (set_counts) or raw values (set_data); hovering
    reads out the bin index and count."""

    def __init__(self, title: str = "", height: int = 110, color=_ACCENT):
        self.title, self.height, self.color = title, height, color
        self._counts = None
        self._hover_idx = None

    def set_counts(self, counts):
        self._counts = None if counts is None else np.asarray(counts, np.float64).reshape(-1)
        return self

    def set_data(self, values, bins=64, value_range=None):
        counts, _ = np.histogram(np.asarray(values).reshape(-1), bins=bins, range=value_range)
        return self.set_counts(counts)

    def render(self, width):
        self._width = width
        img = np.full((self.height, width, 3), _BG, np.uint8)
        cs = self._counts
        if cs is None or len(cs) == 0:
            return img
        pad_l, pad_r, pad_t, pad_b = 12, 12, 18, 8
        pw, ph = width - pad_l - pad_r, self.height - pad_t - pad_b
        peak = max(float(cs.max()), 1e-9)
        n = len(cs)
        for i, c in enumerate(cs):
            x0 = pad_l + int(i * pw / n)
            x1 = pad_l + max(int((i + 1) * pw / n) - 1, x0 + 1)
            bh = int(round(c / peak * ph))
            color = (130, 190, 255) if i == self._hover_idx else self.color
            if bh > 0:
                cv2.rectangle(img, (x0, pad_t + ph - bh), (x1, pad_t + ph), color, -1)
        label = self.title
        if self._hover_idx is not None and 0 <= self._hover_idx < n:
            label = f"{self.title}  bin {self._hover_idx}: {cs[self._hover_idx]:g}"
        TextDrawer(0.42).draw(img, label, (pad_l, 2))
        return img

    def on_mouse(self, x, y, event, flags=0):
        if self._counts is None or len(self._counts) == 0:
            return
        pad_l, pad_r = 12, 12
        pw = max(getattr(self, "_width", 300) - pad_l - pad_r, 1)
        self._hover_idx = int(np.clip((x - pad_l) * len(self._counts) // pw, 0, len(self._counts) - 1))

    def on_mouse_elsewhere(self):
        self._hover_idx = None


class HSeparator(UIElement):
    """Thin horizontal rule between VStack rows (reference
    toadui/layout.py:942 HSeparator)."""

    def __init__(self, height=7, color=(70, 70, 70)):
        self.height, self.color = height, color

    def render(self, width):
        img = np.full((self.height, width, 3), _BG, np.uint8)
        cv2.line(img, (6, self.height // 2), (width - 6, self.height // 2), self.color, 1)
        return img


class VSeparator(UIElement):
    """Thin vertical rule for HStack rows — give it a small weight, e.g.
    HStack(a, sep, b, weights=(1, 0.04, 1)) (reference toadui/layout.py:982
    VSeparator)."""

    def __init__(self, height=34, color=(70, 70, 70)):
        self.height, self.color = height, color

    def render(self, width):
        img = np.full((self.height, width, 3), _BG, np.uint8)
        cv2.line(img, (width // 2, 3), (width // 2, self.height - 3), self.color, 1)
        return img


class Padded(UIElement):
    """Margin wrapper around a child element (reference toadui/layout.py:1022
    Padded); mouse coordinates shift into the child's frame."""

    def __init__(self, element, pad: int = 8, color=_BG):
        self.element, self.pad, self.color = element, int(pad), color
        self.height = element.height + 2 * self.pad

    def render(self, width):
        inner = self.element.render(max(width - 2 * self.pad, 1))
        img = cv2.copyMakeBorder(
            inner, self.pad, self.pad, self.pad, width - inner.shape[1] - self.pad,
            cv2.BORDER_CONSTANT, value=self.color,
        )
        self.height = img.shape[0]
        return img

    def on_mouse(self, x, y, event, flags=0):
        self.element.on_mouse(x - self.pad, y - self.pad, event, flags)

    def on_mouse_elsewhere(self):
        self.element.on_mouse_elsewhere()

    def wants_mouse(self):
        return self.element.wants_mouse()


class GridStack(UIElement):
    """Elements arranged on a fixed column grid (reference
    toadui/layout.py:401 GridStack): rows of HStacks sharing the drag-routing
    semantics of VStack."""

    def __init__(self, *elements, num_cols: int = 2):
        elements = [e for e in elements if e is not None]
        rows = [HStack(*elements[i : i + num_cols]) for i in range(0, len(elements), num_cols)]
        self._v = VStack(*rows)
        self.elements = elements
        self.height = sum(r.height for r in rows)

    def render(self, width):
        img = self._v.render(width)
        self.height = img.shape[0]
        return img

    def on_mouse(self, x, y, event, flags=0):
        self._v.on_mouse(x, y, event, flags)

    def on_mouse_elsewhere(self):
        self._v.on_mouse_elsewhere()

    def wants_mouse(self):
        return self._v.wants_mouse()


class Swapper(UIElement):
    """Holds several elements, renders/routes only the active one (reference
    toadui/layout.py:802 Swapper) — page switching for tools that share one
    panel region."""

    def __init__(self, *elements, active: int = 0):
        self.elements = [e for e in elements if e is not None]
        self._idx = int(np.clip(active, 0, max(len(self.elements) - 1, 0)))
        self._changed = False

    @property
    def active(self):
        return self.elements[self._idx] if self.elements else None

    @property
    def index(self):
        return self._idx

    def set_active(self, idx: int, flag_change: bool = True):
        idx = int(idx) % max(len(self.elements), 1)
        if idx != self._idx:
            for e in self.elements:
                e.on_mouse_elsewhere()
            self._idx = idx
            self._changed = self._changed or flag_change
        return self

    def cycle(self, step: int = 1):
        return self.set_active(self._idx + step)

    def read(self):
        changed, self._changed = self._changed, False
        return changed, self._idx

    @property
    def height(self):
        return self.active.height if self.active else 34

    @height.setter
    def height(self, _v):  # UIElement compatibility; height follows the active child
        pass

    def render(self, width):
        return self.active.render(width) if self.active else np.full((34, width, 3), _BG, np.uint8)

    def on_mouse(self, x, y, event, flags=0):
        if self.active:
            self.active.on_mouse(x, y, event, flags)

    def on_mouse_elsewhere(self):
        if self.active:
            self.active.on_mouse_elsewhere()

    def wants_mouse(self):
        return bool(self.active) and self.active.wants_mouse()


class OverlayStack(UIElement):
    """Lifts the composable Overlay family onto ANY element (reference
    toadui/layout.py:703 OverlayStack): the base element renders normally,
    then each attached Overlay draws over the full rendered frame and
    receives normalized mouse coordinates — the same protocol ImageDisplay
    uses internally, now available for stacks, plots, etc."""

    def __init__(self, base, *overlays):
        self.base = base
        self.overlays = list(overlays)

    def add_overlay(self, overlay: Overlay) -> Overlay:
        self.overlays.append(overlay)
        return overlay

    @property
    def height(self):
        return self.base.height

    @height.setter
    def height(self, _v):
        pass

    def render(self, width):
        img = self.base.render(width)
        active = [ov for ov in self.overlays if ov.enabled]
        self._wh = (img.shape[1], img.shape[0])
        if active:
            img = img.copy()
            for ov in active:
                ov.draw(img, self._wh)
        return img

    def on_mouse(self, x, y, event, flags=0):
        w, h = getattr(self, "_wh", (1, 1))
        xy_norm = (x / max(w, 1), y / max(h, 1))
        # ownership must be checked AFTER dispatching to the overlays (like
        # ImageDisplay.on_mouse): an overlay claiming this LBUTTONDOWN has to
        # keep the base from also starting a drag it would never see end
        base_owned = self.base.wants_mouse()
        for ov in self.overlays:
            if ov.enabled:
                ov.on_mouse(xy_norm, event, flags)
        overlay_owns = any(ov.wants_mouse() for ov in self.overlays if ov.enabled)
        if base_owned or not overlay_owns:
            self.base.on_mouse(x, y, event, flags)
        else:
            self.base.on_mouse_elsewhere()

    def on_mouse_elsewhere(self):
        self.base.on_mouse_elsewhere()
        for ov in self.overlays:
            ov.on_mouse_elsewhere()

    def wants_mouse(self):
        return self.base.wants_mouse() or any(ov.wants_mouse() for ov in self.overlays if ov.enabled)


class DisplayWindow:
    """cv2 window with a keypress-callback registry and mouse routing to a
    layout (reference toadui/window.py)."""

    WINDOW_CLOSE_KEYS = (27, ord("q"))  # esc / q

    def __init__(self, title: str = "Display"):
        self.title = title
        self._key_callbacks = {}
        self._layout = None
        self._created = False

    def attach(self, layout: VStack):
        self._layout = layout
        return self

    def attach_keypress_callback(self, key, callback):
        self._key_callbacks[key if isinstance(key, int) else ord(key)] = callback
        return self

    def _ensure_window(self):
        if not self._created:
            cv2.namedWindow(self.title, cv2.WINDOW_AUTOSIZE)
            if self._layout is not None:
                cv2.setMouseCallback(self.title, self._on_mouse)
            self._created = True

    def _on_mouse(self, event, x, y, flags, _param):
        if self._layout is not None:
            self._layout.on_mouse(x, y, event, flags)

    def show(self, image_or_width=800, frame_delay_ms: int = 1):
        """Render the attached layout (or show a raw image) and pump events.
        Returns (request_close, keypress)."""
        self._ensure_window()
        if isinstance(image_or_width, np.ndarray):
            frame = image_or_width
        else:
            frame = self._layout.render(int(image_or_width))
        cv2.imshow(self.title, frame)
        key = cv2.waitKey(frame_delay_ms) & 0xFF
        if key in self._key_callbacks:
            self._key_callbacks[key]()
        request_close = key in self.WINDOW_CLOSE_KEYS
        try:
            if cv2.getWindowProperty(self.title, cv2.WND_PROP_VISIBLE) < 1:
                request_close = True
        except cv2.error:
            request_close = True
        return request_close, key

    def close(self):
        if self._created:
            cv2.destroyWindow(self.title)
            self._created = False
