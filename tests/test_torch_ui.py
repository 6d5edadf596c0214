"""The port's ``demo_helpers/ui.py`` against the JAX package's: every widget
that tests/test_ui_toolkit.py, test_ui_widgets2.py and test_ui_overlays.py
drive, driven here through both modules with the same scripted cv2 events.
Each scenario records what the widgets render (numpy frames) and what their
``read`` calls return; the two modules must give equal frames
(``np.array_equal``) and equal values."""

import cv2
import numpy as np
import pytest

from muggled_dpt_tpu.demo_helpers import ui as jax_ui
from muggled_dpt_tpu_torch.demo_helpers import ui as torch_ui

DOWN, UP, MOVE = cv2.EVENT_LBUTTONDOWN, cv2.EVENT_LBUTTONUP, cv2.EVENT_MOUSEMOVE
RDOWN, SHIFT, CTRL = cv2.EVENT_RBUTTONDOWN, cv2.EVENT_FLAG_SHIFTKEY, cv2.EVENT_FLAG_CTRLKEY
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _display(ui, w=200, h=100):
    d = ui.ImageDisplay(np.zeros((h, w, 3), np.uint8))
    d.render(w)
    return d


# ---------------------------------------------------------------------------
# tests/test_ui_toolkit.py


@scenario
def slider_set_read_and_drag(ui):
    s = ui.Slider("x", 5, 0, 10, step=1)
    out = [s.read()]
    s.set(7, flag_change=True)
    out += [s.read(), s.render(300)]
    s.on_mouse(295, 10, DOWN)
    return out + [s.read(), s.render(300)]


@scenario
def toggle_and_buttonbar(ui):
    t = ui.ToggleButton("t", False)
    t.on_mouse(5, 5, DOWN)
    bar = ui.ButtonBar(["a", "b", "c"])
    out = [t.is_on, t.render(120), bar.render(300)]
    bar.on_mouse(250, 5, DOWN)
    return out + [bar.read(), bar.read(), bar.render(300)]


@scenario
def colormaps_apply_all(ui):
    c = ui.ColormapsBar()
    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    out = []
    for _ in range(6):
        out += [c.apply(img), c.read(), c.render(300)]
        c.next()
    return out


@scenario
def spectral_colormap(ui):
    return [ui.make_spectral_colormap()]


@scenario
def stacks_render_and_route(ui):
    s = ui.Slider("x", 0, 0, 10)
    t = ui.ToggleButton("t")
    img_panel = ui.ImageDisplay(np.zeros((40, 80, 3), np.uint8))
    v = ui.VStack(img_panel, ui.HStack(s, t), None)
    out = [v.render(200)]
    v.on_mouse(150, img_panel.height + 5, DOWN)
    return out + [t.is_on, s.read(), v.render(200)]


@scenario
def image_display_hover_and_marker(ui):
    d = ui.ImageDisplay(np.zeros((100, 200, 3), np.uint8))
    marker = d.add_marker((0.5, 0.5))
    d.set_hover_text(lambda xy: f"{xy[0]:.2f}")
    out = [d.render(400)]
    d.on_mouse(200, 100, DOWN)
    d.on_mouse(300, 50, MOVE)
    d.on_mouse(300, 50, UP)
    out += [marker.read(), d.render(400)]
    d.on_mouse(40, 20, DOWN)
    out += [marker.read(), d.render(400)]
    d.on_mouse_elsewhere()
    return out + [d.hover_xy_norm, d.render(400)]


@scenario
def line_plot_render_and_hover(ui):
    p = ui.LinePlot("stat").set_series([1.0, 5.0, 3.0, 8.0, 2.0], highlight_idx=3)
    out = [p.render(400)]
    p.on_mouse(200, 50, MOVE)
    out += [p._hover_idx, p.render(400)]
    p.on_mouse_elsewhere()
    return out + [p._hover_idx, p.render(400), ui.LinePlot().render(300)]


@scenario
def playback_bar_controls(ui):
    pb = ui.PlaybackBar(100)
    out = [pb.render(500)]
    pb.on_mouse(10, 10, DOWN)
    out += [pb.read_pause(), pb.is_paused]
    pb.on_mouse(300, 10, DOWN)
    pb.on_mouse(350, 10, MOVE)
    pb.on_mouse(350, 10, UP)
    out += [pb.read_seek(), pb.render(500)]
    pb.set_frame(500)
    return out + [pb._frame, pb.render(500)]


# ---------------------------------------------------------------------------
# tests/test_ui_widgets2.py


@scenario
def immediate_button(ui):
    b = ui.ImmediateButton("save")
    out = [b.render(120), b.read()]
    b.on_mouse(60, 17, DOWN)
    return out + [b.read(), b.read(), b.render(120)]


@scenario
def radio_bar(ui):
    r = ui.RadioBar(["a", "b", "c"], default_index=1)
    out = [r.render(300), r.index, r.value]
    r.on_mouse(250, 17, DOWN)
    out += [r.read(), r.render(300)]
    r.on_mouse(250, 17, DOWN)
    out.append(r.read())
    r.select("a")
    return out + [r.read(), r.render(300)]


@scenario
def multislider_drag(ui):
    ms = ui.MultiSlider("range", (20, 80), 0, 100, step=1)
    out = [ms.render(320), ms.values]
    ms.on_mouse(ms._to_x(20, 320), 18, DOWN)
    out.append(ms.wants_mouse())
    ms.on_mouse(310, 18, MOVE)
    ms.on_mouse(310, 18, UP)
    return out + [ms.read(), ms.render(320)]


@scenario
def textblock_and_messagebar(ui):
    tb = ui.TextBlock(["line one", "line two"], prefix="* ")
    out = [tb.render(260), tb.height]
    tb.set("single")
    out += [tb.render(260), tb.height]
    mb = ui.MessageBar(show_for=2)
    out.append(mb.render(200))
    mb.set("saved!")
    return out + [mb.render(200) for _ in range(4)]


@scenario
def histogram_plot(ui):
    hp = ui.HistogramPlot("hist")
    out = [hp.render(300)]
    hp.set_data(np.concatenate([np.zeros(50), np.ones(10)]), bins=4, value_range=(0, 1))
    out.append(hp.render(300))
    hp.on_mouse(20, 50, MOVE)
    out += [hp._hover_idx, hp.render(300)]
    hp.on_mouse_elsewhere()
    return out + [hp._hover_idx]


@scenario
def weighted_hstack_and_separators(ui):
    s1, s2 = ui.Slider("a", 5, 0, 10), ui.Slider("b", 5, 0, 10)
    row = ui.HStack(s1, ui.VSeparator(), s2, weights=(1, 0.05, 1))
    out = [row.render(410)]
    row.on_mouse(380, 18, DOWN)
    row.on_mouse(380, 18, UP)
    return out + [s1.read(), s2.read(), row.render(410), ui.HSeparator().render(200)]


@scenario
def padded_offsets_mouse(ui):
    s = ui.Slider("a", 0, 0, 10)
    p = ui.Padded(s, pad=10)
    out = [p.render(320)]
    p.on_mouse(310, 25, DOWN)
    p.on_mouse(310, 25, UP)
    return out + [s.read(), p.wants_mouse(), p.render(320)]


@scenario
def gridstack_routes(ui):
    buttons = [ui.ToggleButton(f"b{i}") for i in range(4)]
    grid = ui.GridStack(*buttons, num_cols=2)
    out = [grid.render(200), grid.height]
    grid.on_mouse(150, grid.height - 10, DOWN)
    return out + [b.read() for b in buttons] + [grid.render(200)]


@scenario
def swapper_routes_active(ui):
    a, b = ui.ToggleButton("a"), ui.ToggleButton("b")
    sw = ui.Swapper(a, b)
    out = [sw.render(150)]
    sw.on_mouse(75, 17, DOWN)
    out += [a.read(), b.read()]
    sw.cycle()
    out += [sw.read(), sw.render(150)]
    sw.on_mouse(75, 17, DOWN)
    return out + [a.read(), b.read(), sw.render(150)]


@scenario
def overlay_stack_hover_label(ui):
    tb = ui.TextBlock("")
    seen = []
    stack = ui.OverlayStack(tb, ui.HoverLabelOverlay(lambda xy: seen.append(xy) or f"{xy[0]:.1f}"))
    out = [tb.render(200), stack.render(200)]
    stack.on_mouse(100, tb.height // 2, MOVE)
    out.append(stack.render(200))
    stack.on_mouse_elsewhere()
    return out + [stack.render(200), seen]


@scenario
def editbox_corner_resize(ui):
    d = _display(ui)
    box = d.add_overlay(ui.EditBoxOverlay())
    out = [box.read()]
    d.on_mouse(0, 0, DOWN)
    out.append(box.wants_mouse())
    d.on_mouse(50, 25, MOVE)
    d.on_mouse(50, 25, UP)
    return out + [box.read(), d.render(200)]


@scenario
def editbox_move_redraw_reset(ui):
    box = ui.EditBoxOverlay(box=((0.2, 0.2), (0.4, 0.4)))
    out = [box.read()]
    for events in (((0.3, 0.3), (0.5, 0.5)), ((0.8, 0.1), (0.9, 0.3)), ((0.9, 0.3), (0.7, 0.05))):
        box.on_mouse(events[0], DOWN)
        box.on_mouse(events[1], MOVE)
        box.on_mouse(events[1], UP)
        out.append(box.read())
    box.on_mouse((0.5, 0.5), RDOWN)
    out.append(box.read())
    frame = np.zeros((100, 200, 3), np.uint8)
    box.draw(frame, (200, 100))
    return out + [frame]


@scenario
def mousepaint(ui):
    paint = ui.MousePaintOverlay(mask_hw=(64, 64), brush_radius_norm=0.1)
    out = [paint.read_mask()]
    paint.on_mouse((0.3, 0.5), DOWN)
    paint.on_mouse((0.7, 0.5), MOVE)
    paint.on_mouse((0.7, 0.5), UP)
    out += [paint.read_mask(), paint.read_trail(), paint.read_trail()]
    paint.on_mouse((0.5, 0.5), DOWN, CTRL)
    paint.on_mouse((0.5, 0.5), UP, CTRL)
    out.append(paint.read_mask())
    frame = np.zeros((100, 100, 3), np.uint8)
    paint.on_mouse((0.2, 0.2), MOVE)
    paint.draw(frame, (100, 100))
    paint.clear()
    return out + [frame, paint.read_mask()]


@scenario
def overlaystack_overlay_owned_drag(ui):
    ms = ui.MultiSlider("range", [20, 97], 0, 100)
    stack = ui.OverlayStack(ms)
    box = stack.add_overlay(ui.EditBoxOverlay(box=((0.2, 0.2), (0.6, 0.6))))
    out = [stack.render(300)]
    stack.on_mouse(120, 20, DOWN)
    out.append(box.wants_mouse())
    stack.on_mouse(200, 30, MOVE)
    stack.on_mouse(200, 30, UP)
    return out + [list(ms.values), stack.wants_mouse(), box.read(), stack.render(300)]


@scenario
def immediate_image_button(ui):
    b = ui.ImmediateImageButton(np.full((20, 40, 3), 200, np.uint8), height=40)
    out = [b.render(200), b.read()]
    b.on_mouse(100, 20, DOWN)
    g = ui.ImmediateImageButton(np.full((10, 10), 99, np.uint8))
    return out + [b.read(), b.read(), g.render(60)]


@scenario
def toggle_image_button(ui):
    off, on = np.full((16, 16, 3), 50, np.uint8), np.full((16, 16, 3), 250, np.uint8)
    b = ui.ToggleImageButton(off, toggle_image=on, height=32)
    out = [b.read(), b.render(100)]
    b.on_mouse(50, 16, DOWN)
    out += [b.read(), b.render(100)]
    b2 = ui.ToggleImageButton(off, height=32, default=True)
    out += [b2.is_on, b2.render(100)]
    b2.toggle(set_on=False)
    return out + [b2.read(), b2.render(100)]


@scenario
def radio_constraint(ui):
    items = a, b, c = ui.ToggleButton("a"), ui.ToggleButton("b", default=True), ui.ToggleButton("c")
    radio = ui.RadioConstraint(a, b, c, initial_active_index=0)

    def read():
        changed, idx, item = radio.read()
        return changed, idx, items.index(item), [x.is_on for x in items]

    out = [read()]
    c.toggle()
    out.append(read())
    c.toggle()
    out.append(read())
    radio.change_to(b)
    return out + [read(), [x.is_on for x in radio]]


# ---------------------------------------------------------------------------
# tests/test_ui_overlays.py


@scenario
def draw_overlays_and_enabled(ui):
    d = _display(ui)
    text = d.add_overlay(ui.TextOverlay("hello", anchor="topleft"))
    rect = d.add_overlay(ui.RectangleOverlay())
    rect.set_boxes([((0.25, 0.25), (0.75, 0.75))])
    poly = d.add_overlay(ui.PolygonsOverlay(fill_alpha=0.5))
    poly.set_polygons([[(0.1, 0.8), (0.2, 0.9), (0.05, 0.95)]])
    mask = d.add_overlay(ui.MaskOverlay())
    m = np.zeros((10, 20), np.uint8)
    m[2:5, 3:9] = 1
    mask.set_mask(m)
    out = [d.render(200)]
    for ov in (text, rect, poly, mask):
        ov.enabled = False
    out.append(d.render(200))
    text.enabled = True
    text.set("")
    return out + [d.render(200)]


@scenario
def crosshair_hover_and_pin(ui):
    d = _display(ui)
    ch = d.add_overlay(ui.CrosshairOverlay(show_label=False))
    out = [d.render(200)]
    d.on_mouse(100, 50, MOVE)
    out.append(d.render(200))
    d.on_mouse_elsewhere()
    out.append(d.render(200))
    ch.set((0.25, 0.5))
    d.on_mouse(190, 90, MOVE)
    return out + [d.render(200)]


@scenario
def point_click(ui):
    d = _display(ui)
    pts = d.add_overlay(ui.PointClickOverlay())
    d.on_mouse(50, 50, DOWN)
    d.on_mouse(100, 20, DOWN)
    out = [pts.read(), d.render(200)]
    d.on_mouse(150, 80, DOWN, SHIFT)
    out += [pts.read(), d.render(200)]
    d.on_mouse(0, 0, RDOWN)
    return out + [pts.read()]


@scenario
def box_select(ui):
    d = _display(ui)
    box = d.add_overlay(ui.BoxSelectOverlay())
    d.on_mouse(20, 10, DOWN)
    out = [d.wants_mouse()]
    d.on_mouse(120, 60, MOVE)
    out += [box.read(), d.render(200)]
    d.on_mouse(120, 60, UP)
    out += [box.read(), d.wants_mouse()]
    d.on_mouse(10, 70, DOWN)
    d.on_mouse(60, 95, UP)
    out.append(box.read())
    d.on_mouse(150, 10, DOWN, SHIFT)
    d.on_mouse(190, 40, UP)
    out += [box.read(), d.render(200)]
    box.clear()
    return out + [box.read()]


@scenario
def box_select_degenerate_and_marker(ui):
    d = _display(ui)
    box = d.add_overlay(ui.BoxSelectOverlay())
    d.on_mouse(20, 10, DOWN)
    d.on_mouse(20, 10, UP)
    out = [box.read()]
    d2 = _display(ui)
    marker = d2.add_marker((0.5, 0.5))
    d2.add_overlay(ui.BoxSelectOverlay())
    d2.on_mouse(100, 50, DOWN)
    d2.on_mouse(150, 80, MOVE)
    d2.on_mouse(150, 80, UP)
    return out + [marker.read(), d2.render(200)]


@scenario
def grid_select(ui):
    d = _display(ui, w=160, h=80)
    grid = d.add_overlay(ui.GridSelectOverlay((4, 8)))
    d.on_mouse(100, 30, MOVE)
    out = [d.render(160)]
    d.on_mouse(100, 30, DOWN)
    out.append(grid.read())
    d.on_mouse(100, 30, DOWN)
    return out + [grid.read(), d.render(160)]


@scenario
def text_overlay_anchors(ui):
    d = _display(ui, w=200, h=120)
    ov = d.add_overlay(ui.TextOverlay("X", anchor="bottomright", bg_color=None, color=(255, 255, 255)))
    out = [d.render(200)]
    ov.anchor = "topleft"
    return out + [d.render(200)]


@scenario
def carousel_cycles(ui):
    c = ui.Carousel("mode", ["a", "b", "c"])
    out = [c.render(300)]
    c.on_mouse(290, 10, DOWN)
    out.append(c.read())
    for _ in range(2):
        c.on_mouse(5, 10, DOWN)
        out.append(c.read())
    return out + [c.render(300)]


@scenario
def outline_overlay_hover(ui):
    d = _display(ui)
    d.add_overlay(ui.OutlineOverlay(color=(40, 40, 40), hover_color=(0, 255, 0), thickness=1, hover_thickness=2))
    out = [d.render(200)]
    d.on_mouse(100, 50, MOVE)
    out.append(d.render(200))
    d.on_mouse_elsewhere()
    return out + [d.render(200)]


@scenario
def custom_overlay(ui):
    d = _display(ui)
    seen = []

    def draw(frame, xy_norm):
        seen.append(xy_norm)
        frame[:, :, 2] = 200

    ov = d.add_overlay(ui.CustomOverlay(draw))
    out = [d.render(200)]
    d.on_mouse(150, 50, MOVE)
    out.append(d.render(200))
    ov.set_render(lambda frame, xy: np.full_like(frame, 7))
    out.append(d.render(200))
    ov.set_render(None)
    return out + [d.render(200), seen]


@scenario
def path_carousel(ui):
    car = ui.PathCarousel("model", ["/a/b/first.pt", "/a/b/second.pt"])
    out = [car.render(300), car.height, car.value, car._display_text()]
    car.on_mouse(290, 10, DOWN)
    return out + [car.read(), car.render(300)]


@scenario
def text_drawer(ui):
    frame = np.zeros((60, 200, 3), np.uint8)
    ui.TextDrawer(0.6, 2, (255, 255, 255)).draw(frame, "12.5 ms (dispatch)", (10, 8))
    return [frame]


def scripted_window(ui):
    """A ``DisplayWindow`` class of ``ui`` (either package's) that opens no
    window: each ``show`` renders the layout into ``frames`` and plays the
    next step of the class's ``script``: a key, None for no key, or a
    function of the window that may send mouse events through the window's
    own routing (``_on_mouse``) and returns one of those. An exhausted script
    presses q. The last window made is the class's ``last``."""

    class ScriptedWindow(ui.DisplayWindow):
        script = ()
        last = None

        def __init__(self, title="Display"):
            super().__init__(title)
            self.frames, self._steps = [], iter(self.script)
            type(self).last = self

        def _ensure_window(self):
            pass

        def show(self, image_or_width=800, frame_delay_ms=1):
            self.frames.append(self._layout.render(int(image_or_width)))
            step = next(self._steps, "q")
            key = step(self) if callable(step) else step
            key = ord(key) if key else 255
            if key in self._key_callbacks:
                self._key_callbacks[key]()
            return key in self.WINDOW_CLOSE_KEYS, key

        def close(self):
            pass

        def click(self, x, y):
            self._on_mouse(cv2.EVENT_LBUTTONDOWN, int(x), int(y), 0, None)
            self._on_mouse(cv2.EVENT_LBUTTONUP, int(x), int(y), 0, None)

        def row(self, i) -> tuple[int, int]:
            """(top, height) of the layout's row i, as last rendered."""
            offsets = self._layout._offsets
            return int(offsets[i]), int(offsets[i + 1] - offsets[i])

    return ScriptedWindow


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_ui_matches_jax(name):
    ours, theirs = SCENARIOS[name](torch_ui), SCENARIOS[name](jax_ui)
    assert len(ours) == len(theirs) and len(ours) >= 1
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert _equal(a, b), f"{name}: observation {i} differs: {a!r} vs {b!r}"
    frames = [o for o in ours if isinstance(o, np.ndarray) and o.ndim == 3]
    assert all(f.dtype == np.uint8 for f in frames)


def test_every_widget_class_is_driven():
    """Every public widget, overlay and layout class of the JAX ui is in a scenario."""
    import inspect

    names = {n for n, obj in vars(jax_ui).items() if inspect.isclass(obj) and obj.__module__ == jax_ui.__name__}
    source = inspect.getsource(inspect.getmodule(test_every_widget_class_is_driven))
    base = {"UIElement", "Overlay", "DraggableMarker", "DisplayWindow"}  # driven through their subclasses or the apps
    assert {n for n in names - base if f"ui.{n}(" not in source} == set()
