"""Interactive single-image depth demo, the counterpart of the JAX
package's ``run_image.py``: load any supported checkpoint, re-run inference
at slider-driven sizes/aspect modes, plane ('floor') removal, min/max
thresholding + histogram equalization, colormaps, and PNG / .npy /
uint16-PNG export.

    python -m muggled_dpt_tpu_torch.run_image -m CKPT -i IMAGE [--headless] [-d cpu]

Runs on the CUDA card in bfloat16 (float16 with ``-u``) unless ``-d cpu``
(float32) is given, and exits with an error where there is no card.

Keys: s = save, c = cycle colormap, r = reverse colors, p = plane removal,
      e = histogram equalization, q/esc = quit."""

import argparse
import os.path as osp

import cv2
import numpy as np

from .demo_helpers import ui
from .demo_helpers.crop_ui import run_crop_ui
from .demo_helpers.history_keeper import HistoryKeeper
from .demo_helpers.loading import PathCarousel, ask_for_model_path, ask_for_path
from .demo_helpers.misc import (
    DEVICE_HELP,
    depth_to_numpy,
    make_device_config,
    maybe_quantize_int8,
    print_config_feedback,
    reduce_overthreading,
)
from .demo_helpers.plane_fit import estimate_plane_of_best_fit
from .demo_helpers.postprocess import (
    convert_to_uint8,
    histogram_equalization,
    normalize_01,
    remove_infinities,
    scale_prediction,
)
from .demo_helpers.saving import make_save_name, save_image, save_numpy_array, save_uint16_png
from .make_dpt import make_dpt_from_state_dict


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run depth estimation on a single image")
    parser.add_argument("-i", "--image_path", default=None, help="Path to input image or folder of images")
    parser.add_argument("-m", "--model_path", default=None, help="Path to DPT model weights (.pt/.pth)")
    parser.add_argument("-s", "--display_size", default=800, type=int, help="Display size in pixels")
    parser.add_argument("-d", "--device", default=None, help=DEVICE_HELP)
    parser.add_argument("-f32", "--use_float32", action="store_true", help="Use float32 (default bfloat16)")
    parser.add_argument("-u", "--prefer_unstable_f16", action="store_true", help="Prefer float16 over bfloat16")
    parser.add_argument("-z", "--no_optimization", action="store_true", help="Disable attention optimizations")
    parser.add_argument("--int8", action="store_true", help="int8 encoder serving tier (DA/BEiT; see docs/performance.md)")
    parser.add_argument("--int8-full", dest="int8_full", action="store_true",
                        help="int8 tier incl. the full neck: reassembly GEMMs + fusion/head convs (implies --int8; docs/performance.md)")
    parser.add_argument("-ar", "--use_aspect_ratio", action="store_true", help="Keep original aspect ratio")
    parser.add_argument("-b", "--base_size_px", default=None, type=int, help="Override base model size")
    parser.add_argument("--crop", action="store_true", help="Interactively crop before inference")
    parser.add_argument(
        "--noselect", action="store_true",
        help="Disable the file selector (n/b image cycling) even for folder inputs (reference run_image.py:102-106)",
    )
    parser.add_argument("--headless", action="store_true", help="No UI: run once, save outputs, quit")
    return parser.parse_args(argv)


def compute_depth_display(dpt_model, image_bgr, max_side, use_square):
    """Run inference + postprocessing; returns (depth_norm float01 HW, plane)."""
    prediction = dpt_model.inference(image_bgr, max_side, use_square)
    h, w = image_bgr.shape[:2]
    scaled = scale_prediction(depth_to_numpy(prediction), (w, h))
    depth_norm = normalize_01(remove_infinities(scaled.squeeze()))
    plane = estimate_plane_of_best_fit(depth_norm, rng=np.random.default_rng(0))
    return depth_norm, plane


def render_depth_image(depth_norm, plane, *, remove_plane, reverse_colors, thresholds, use_histeq, cmap_bar):
    depth = depth_norm - plane if remove_plane else depth_norm
    depth = normalize_01(depth)
    tmin, tmax = thresholds
    if tmax < tmin:
        tmin, tmax = tmax, tmin
    depth = np.clip((depth - tmin) / max(tmax - tmin, 1e-6), 0.0, 1.0)
    if reverse_colors:
        depth = 1.0 - depth
    depth_u8 = convert_to_uint8(depth)
    if use_histeq:
        depth_u8 = histogram_equalization(depth_u8)
    return cmap_bar.apply(depth_u8)


def main(argv=None):
    """Returns the saved paths in --headless mode, else None."""
    args = parse_args(argv)
    reduce_overthreading()
    device_config = make_device_config(args.device, args.use_float32, prefer_bfloat16=not args.prefer_unstable_f16)

    history = HistoryKeeper()
    _, hist_img = history.read("image_path")
    _, hist_model = history.read("model_path")
    image_path = args.image_path or ask_for_path("Enter path to image", hist_img)
    model_path = args.model_path or ask_for_model_path(default_path=hist_model)
    history.store(image_path=image_path, model_path=model_path)

    print("", "Loading model weights...", f"  @ {model_path}", sep="\n", flush=True)
    # The per-grid aux cache stays on (the JAX app turns it off): the port's cache is bounded by the card's free
    # memory and evicts the least recently used size, and SwinV2's inline CPB bias is float32, which would send
    # every bfloat16 or float16 window attention to the slower kernel of csrc/window_attention.cu.
    model_config, dpt_model = make_dpt_from_state_dict(
        model_path, enable_optimizations=not args.no_optimization, dtype=device_config["dtype"],
        device=device_config["device"],
    )
    dpt_model = maybe_quantize_int8(dpt_model, args.int8, args.int8_full)
    print_config_feedback(model_path, device_config, use_cache=True)

    carousel = PathCarousel(image_path)
    if len(carousel) == 0:
        raise FileNotFoundError(f"No image files at: {image_path}")
    image_path = carousel.current
    image_bgr = cv2.imread(image_path)
    if image_bgr is None:
        raise FileNotFoundError(f"Could not load image: {image_path}")
    if args.crop:
        _, prev_crop = history.read("crop_xy1xy2_norm")
        (ys, xs), crop_norm = run_crop_ui(image_bgr, prev_crop)
        image_bgr = image_bgr[ys, xs]
        history.store(crop_xy1xy2_norm=crop_norm)

    base_size = args.base_size_px or dpt_model.default_size_px
    use_square = not args.use_aspect_ratio

    depth_norm, plane = compute_depth_display(dpt_model, image_bgr, base_size, use_square)

    if args.headless:
        cmap = ui.ColormapsBar()
        colored = render_depth_image(
            depth_norm, plane, remove_plane=False, reverse_colors=False,
            thresholds=(0.0, 1.0), use_histeq=False, cmap_bar=cmap,
        )
        name = make_save_name(image_path)
        p1 = save_image(colored, name)
        p2 = save_numpy_array(depth_norm, name + "_raw")
        p3 = save_uint16_png(depth_norm, name + "_u16")
        print("Saved:", p1, p2, p3, sep="\n  ")
        return p1, p2, p3

    # ---- interactive UI ----
    tile = dpt_model.tiling_size
    display = ui.ImageDisplay()

    def _hover_depth(xy_norm):
        # live depth readout under the cursor (normalized inverse depth)
        h, w = depth_norm.shape[:2]
        xi, yi = min(int(xy_norm[0] * w), w - 1), min(int(xy_norm[1] * h), h - 1)
        return f"d={depth_norm[yi, xi]:.3f}"

    display.set_hover_text(_hover_depth)
    size_slider = ui.Slider("Image size", base_size, tile * 4, max(base_size * 2, 1024), step=tile)
    min_slider = ui.Slider("Min threshold", 0.0, 0.0, 1.0, step=0.01)
    max_slider = ui.Slider("Max threshold", 1.0, 0.0, 1.0, step=0.01)
    plane_toggle = ui.ToggleButton("Plane removal", False)
    reverse_toggle = ui.ToggleButton("Reverse colors", False)
    histeq_toggle = ui.ToggleButton("Equalize", False)
    ar_toggle = ui.ToggleButton("Aspect ratio", not use_square)
    cmap_bar = ui.ColormapsBar()
    layout = ui.VStack(display, cmap_bar, size_slider, min_slider, max_slider, plane_toggle, reverse_toggle, histeq_toggle, ar_toggle)

    window = ui.DisplayWindow(f"Depth - {osp.basename(image_path)}")
    window.attach(layout)
    window.attach_keypress_callback("c", cmap_bar.next)
    window.attach_keypress_callback("r", reverse_toggle.toggle)
    window.attach_keypress_callback("p", plane_toggle.toggle)
    window.attach_keypress_callback("e", histeq_toggle.toggle)

    print("\nKeys: s=save  c=colormap  r=reverse  p=plane removal  e=equalize  n/b=next/prev image  q=quit")
    needs_render = True
    file_changed = False

    def _cycle(direction):
        nonlocal file_changed
        carousel.next() if direction > 0 else carousel.prev()
        file_changed = True

    if len(carousel) > 1 and not args.noselect:
        window.attach_keypress_callback("n", lambda: _cycle(+1))
        window.attach_keypress_callback("b", lambda: _cycle(-1))

    while True:
        size_changed, size_val = size_slider.read()
        ar_changed, use_ar = ar_toggle.read()
        if file_changed:
            image_path = carousel.current
            new_img = cv2.imread(image_path)
            if new_img is not None:
                image_bgr = new_img
                print(f"Loaded {osp.basename(image_path)}")
            file_changed = False
            size_changed = True
        if size_changed or ar_changed:
            depth_norm, plane = compute_depth_display(dpt_model, image_bgr, size_val, not use_ar)
            needs_render = True

        for element in (min_slider, max_slider, plane_toggle, reverse_toggle, histeq_toggle, cmap_bar):
            changed = element.read()[0]
            needs_render = needs_render or changed

        if needs_render:
            colored = render_depth_image(
                depth_norm, plane,
                remove_plane=plane_toggle.is_on,
                reverse_colors=reverse_toggle.is_on,
                thresholds=(min_slider.value, max_slider.value),
                use_histeq=histeq_toggle.is_on,
                cmap_bar=cmap_bar,
            )
            display.set_image(colored)
            needs_render = False

        request_close, key = window.show(args.display_size, 16)
        if key == ord("s"):
            name = make_save_name(image_path)
            save_image(display.image, name)
            save_numpy_array(depth_norm, name + "_raw")
            save_uint16_png(depth_norm, name + "_u16")
            print(f"Saved results as {name}*")
        if request_close:
            break
    window.close()


if __name__ == "__main__":
    main()
