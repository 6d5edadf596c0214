"""Per-block token-norm visualization, the counterpart of JAX
``experiments/block_norm_visualization.py``: the L2 norm of every patch
token after each block, which shows the high-norm outlier tokens of large
ViTs ("Vision Transformers Need Registers").

    python -m muggled_dpt_tpu_torch.experiments.block_norm_visualization -m CKPT [--headless] [-d cpu]

The block outputs come from one introspection forward
(``DPTModel.forward_with_internals``), captured once before the explorer
starts: the explorer's events (a block slider, a line plot of each block's
max token norm, the norm under the cursor, "c" colormap, "s" save the view,
"a" save every block) only redraw from those norms. ``--headless`` saves
every block's map and quits."""

from __future__ import annotations

import argparse
import os.path as osp

import cv2
import numpy as np

from ..demo_helpers import ui
from ..demo_helpers.saving import get_save_folder
from .common import add_model_args, load_image, load_model


def capture_block_norms(model, image_bgr, base_size_px):
    """One introspection forward -> ((L, gh, gw) float32 norms of each
    block's patch tokens, the BGR image at the model input's size for
    display)."""
    image_bchw = model.prepare_image_bgr(image_bgr, base_size_px)
    h, w = image_bchw.shape[2:]
    p = model.patch_size_px
    gh, gw = h // p, w // p
    _, internals = model.forward_with_internals(image_bchw)
    if internals["block_tokens"][-1].shape[1] < gh * gw:
        raise SystemExit("block_norm_visualization: a hierarchical encoder (SwinV2) has no per-block map on one grid")
    norms = []
    for tokens in internals["block_tokens"]:
        patch = tokens[0, -gh * gw :].float()  # strip any cls/readout token
        norms.append(patch.norm(dim=-1).reshape(gh, gw).cpu().numpy())
    return np.stack(norms), cv2.resize(image_bgr, (w, h))


def colorize_norms(norms_hw, cmap_bar=None, upscale=8):
    lo, hi = float(norms_hw.min()), float(norms_hw.max())
    img = ((norms_hw - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    img = cv2.resize(img, (norms_hw.shape[1] * upscale, norms_hw.shape[0] * upscale), interpolation=cv2.INTER_NEAREST)
    if cmap_bar is not None:
        return cmap_bar.apply(img), (lo, hi)
    return cv2.applyColorMap(img, cv2.COLORMAP_VIRIDIS), (lo, hi)


def save_all_blocks(norms, out_dir):
    """Batch dump: per-block norm maps and a contact sheet of them."""
    tiles = []
    for i in range(norms.shape[0]):
        img, (lo, hi) = colorize_norms(norms[i])
        cv2.putText(img, f"blk {i} [{lo:.1f},{hi:.1f}]", (4, 16), cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1)
        tiles.append(img)
        cv2.imwrite(osp.join(out_dir, f"block_{i:02d}.png"), img)
    cols = int(np.ceil(np.sqrt(len(tiles))))
    rows = int(np.ceil(len(tiles) / cols))
    blank = np.zeros_like(tiles[0])
    grid = [tiles[r * cols : (r + 1) * cols] for r in range(rows)]
    grid = [row + [blank] * (cols - len(row)) for row in grid]
    cv2.imwrite(osp.join(out_dir, "all_blocks.png"), np.vstack([np.hstack(row) for row in grid]))
    return len(tiles)


def render_view(norms, layer, cmap_bar):
    """The explorer's norm panel for one block, labelled with its range."""
    img, (lo, hi) = colorize_norms(norms[layer], cmap_bar)
    ui.TextDrawer(0.5, 1, (255, 255, 255)).draw(img, f"block {layer}  [{lo:.1f}, {hi:.1f}]", (6, 4))
    return img


def explore(norms, disp_img, out_dir_arg, display_size) -> dict:
    """The interactive explorer over captured norms; runs no model. Returns
    the last view: {"panel", "layer"}."""
    num_layers, gh, gw = norms.shape
    image_panel = ui.ImageDisplay(disp_img)
    norm_panel = ui.ImageDisplay()
    layer_slider = ui.Slider("Block", num_layers - 1, 0, num_layers - 1, step=1)
    plot = ui.LinePlot("max token norm per block").set_series(norms.max(axis=(1, 2)))
    cmap_bar = ui.ColormapsBar()
    layout = ui.VStack(ui.HStack(image_panel, norm_panel), layer_slider, plot, cmap_bar)
    window = ui.DisplayWindow("Block norm visualization").attach(layout)
    window.attach_keypress_callback("c", cmap_bar.next)

    def _hover_norm(xy_norm):
        layer = layer_slider.value
        x = min(int(xy_norm[0] * gw), gw - 1)
        y = min(int(xy_norm[1] * gh), gh - 1)
        return f"({x},{y}) |t| = {norms[layer, y, x]:.2f}"

    norm_panel.set_hover_text(_hover_norm)

    print("\nKeys: s=save view  a=save all blocks  c=colormap  q=quit")
    needs_render = True
    while True:
        l_changed, layer = layer_slider.read()
        c_changed, _ = cmap_bar.read()
        if needs_render or l_changed or c_changed:
            norm_panel.set_image(render_view(norms, layer, cmap_bar))
            plot.set_series(norms.max(axis=(1, 2)), highlight_idx=layer)
            needs_render = False

        request_close, key = window.show(display_size, 16)
        if key == ord("s"):
            out_dir = get_save_folder(out_dir_arg)
            path = osp.join(out_dir, f"block_{layer:02d}.png")
            cv2.imwrite(path, norm_panel.image)
            print(f"Saved {path}")
        if key == ord("a"):
            out_dir = get_save_folder(out_dir_arg)
            n = save_all_blocks(norms, out_dir)
            print(f"Saved {n} per-block maps to {out_dir}")
        if request_close:
            break
    window.close()
    return {"panel": norm_panel.image, "layer": layer}


def main(argv=None):
    """Returns the output folder in --headless mode, else the explorer's last view."""
    parser = add_model_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("-o", "--output_folder", default=None)
    parser.add_argument("--headless", action="store_true", help="No UI: save all block maps and quit")
    parser.add_argument("--display_size", default=1000, type=int, help="Window size of the interactive explorer")
    args = parser.parse_args(argv)

    model = load_model(args)
    image_bgr = load_image(args)
    norms, disp_img = capture_block_norms(model, image_bgr, args.base_size_px)
    del model  # the explorer runs on the captured norms only
    print(f"Captured {norms.shape[0]} block outputs; grid {norms.shape[1]}x{norms.shape[2]}")

    out_dir_arg = args.output_folder or osp.join("saved_results", "block_norms")
    if not args.headless:
        return explore(norms, disp_img, out_dir_arg, args.display_size)
    out_dir = get_save_folder(out_dir_arg)
    n = save_all_blocks(norms, out_dir)
    print(f"Saved {n} per-block norm maps to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
