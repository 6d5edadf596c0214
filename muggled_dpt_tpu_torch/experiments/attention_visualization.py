"""Attention visualization, the counterpart of JAX
``experiments/attention_visualization.py``: capture every block's softmax
attention and save, for one patch token, how every layer and head attends
from it (row attention) and to it (column attention).

    python -m muggled_dpt_tpu_torch.experiments.attention_visualization -m CKPT [--headless] [-t x,y] [-d cpu]

The weights come from one introspection forward
(``DPTModel.forward_with_internals``), captured once before the explorer
starts: the explorer's events (drag or click the marker on the input image
to pick the token, slide layer and head, head -1 = the mean over heads, "c"
colormap, "s" save the view, "a" save every layer) only redraw from those
maps. ``--headless`` saves every layer for one token and quits."""

from __future__ import annotations

import argparse
import os.path as osp

import cv2
import numpy as np

from ..demo_helpers import ui
from ..demo_helpers.saving import get_save_folder
from .common import add_model_args, load_image, load_model


def capture_attention(model, image_bgr, base_size_px):
    """One introspection forward -> (attention list of (H, N, N) float16
    arrays, gh, gw, cls_offset, the BGR image at the model input's size for
    display)."""
    image_bchw = model.prepare_image_bgr(image_bgr, base_size_px)
    h, w = image_bchw.shape[2:]
    p = model.patch_size_px
    gh, gw = h // p, w // p
    _, internals = model.forward_with_internals(image_bchw)
    if internals["attention"][0].dim() != 4:
        raise SystemExit("attention_visualization: windowed attention (SwinV2) has no per-token map over the grid")
    # float16 halves host memory: ViT-L at 518 captures 24 x (16, 1370, 1370) maps
    attn = [a[0].half().cpu().numpy() for a in internals["attention"]]
    cls_offset = 1 if attn[0].shape[-1] == gh * gw + 1 else 0
    return attn, gh, gw, cls_offset, cv2.resize(image_bgr, (w, h))


def token_attention_maps(attn_layer, token_xy, gh, gw, cls_offset, head=-1):
    """(row, col) attention over the patch grid for one token; head=-1 means
    the mean over heads. Row = where the token looks, col = who looks at it."""
    tx, ty = token_xy
    idx = cls_offset + ty * gw + tx
    a = attn_layer if head < 0 else attn_layer[head : head + 1]
    row = a[:, idx, cls_offset:].astype(np.float32).mean(0).reshape(gh, gw)
    col = a[:, cls_offset:, idx].astype(np.float32).mean(0).reshape(gh, gw)
    return row, col


def colorize_map(m, cmap_bar=None, upscale=8):
    img = (m / max(float(m.max()), 1e-9) * 255).astype(np.uint8)
    img = cv2.resize(img, (m.shape[1] * upscale, m.shape[0] * upscale), interpolation=cv2.INTER_NEAREST)
    if cmap_bar is not None:
        return cmap_bar.apply(img)
    return cv2.applyColorMap(img, cv2.COLORMAP_INFERNO)


def save_all_layers(attn, token_xy, gh, gw, cls_offset, out_dir):
    """Batch dump: per layer, a sheet of every head's row maps over its column maps."""
    for layer_idx, a in enumerate(attn):
        rows, cols = [], []
        for head in range(a.shape[0]):
            r, c = token_attention_maps(a, token_xy, gh, gw, cls_offset, head)
            rows.append(colorize_map(r))
            cols.append(colorize_map(c))
        cv2.imwrite(osp.join(out_dir, f"layer_{layer_idx:02d}.png"), np.vstack([np.hstack(rows), np.hstack(cols)]))
    return len(attn)


def render_view(attn, token_xy, gh, gw, cls_offset, layer, head, cmap_bar):
    """The explorer's attention panel: one layer's row map beside its column
    map for the token, labelled. Returns (panel, row, col)."""
    row, col = token_attention_maps(attn[layer], token_xy, gh, gw, cls_offset, head)
    row_img, col_img = colorize_map(row, cmap_bar), colorize_map(col, cmap_bar)
    td = ui.TextDrawer(0.5, 1, (255, 255, 255))
    td.draw(row_img, f"row attn L{layer}" + (f" H{head}" if head >= 0 else " mean"), (6, 4))
    td.draw(col_img, "col attn", (6, 4))
    return np.hstack([row_img, col_img]), row, col


def explore(attn, gh, gw, cls_offset, disp_img, token_xy, out_dir_arg, display_size) -> dict:
    """The interactive explorer over captured maps; runs no model. Returns
    the last view: {"panel", "token", "layer", "head"}."""
    num_layers, num_heads = len(attn), attn[0].shape[0]
    tx, ty = token_xy
    image_panel = ui.ImageDisplay(disp_img)
    marker = image_panel.add_marker(((tx + 0.5) / gw, (ty + 0.5) / gh))
    attn_panel = ui.ImageDisplay()
    layer_slider = ui.Slider("Layer", num_layers - 1, 0, num_layers - 1, step=1)
    head_slider = ui.Slider("Head (-1 = mean)", -1, -1, num_heads - 1, step=1)
    cmap_bar = ui.ColormapsBar()
    layout = ui.VStack(ui.HStack(image_panel, attn_panel), layer_slider, head_slider, cmap_bar)
    window = ui.DisplayWindow("Attention visualization").attach(layout)
    window.attach_keypress_callback("c", cmap_bar.next)

    state = {"row": None, "col": None}

    def _hover_value(xy_norm):
        if state["row"] is None:
            return ""
        # left half shows the row map, right half the column map
        half = 0 if xy_norm[0] < 0.5 else 1
        m = state["row"] if half == 0 else state["col"]
        x = min(int((xy_norm[0] * 2 - half) * gw), gw - 1)
        y = min(int(xy_norm[1] * gh), gh - 1)
        kind = "row" if half == 0 else "col"
        return f"{kind} ({x},{y}) = {m[y, x]:.4f}"

    attn_panel.set_hover_text(_hover_value)

    print("\nKeys: s=save view  a=save all layers  c=colormap  q=quit")
    print("Click/drag the marker on the input image to pick the target token")
    needs_render = True
    while True:
        m_changed, m_xy = marker.read()
        l_changed, layer = layer_slider.read()
        h_changed, head = head_slider.read()
        c_changed, _ = cmap_bar.read()
        needs_render = needs_render or m_changed or l_changed or h_changed or c_changed
        if needs_render:
            tx, ty = min(int(m_xy[0] * gw), gw - 1), min(int(m_xy[1] * gh), gh - 1)
            panel, state["row"], state["col"] = render_view(attn, (tx, ty), gh, gw, cls_offset, layer, head, cmap_bar)
            attn_panel.set_image(panel)
            needs_render = False

        request_close, key = window.show(display_size, 16)
        if key == ord("s"):
            out_dir = get_save_folder(out_dir_arg)
            path = osp.join(out_dir, f"token_{tx}_{ty}_layer_{layer:02d}_head_{head}.png")
            cv2.imwrite(path, attn_panel.image)
            print(f"Saved {path}")
        if key == ord("a"):
            out_dir = get_save_folder(out_dir_arg)
            n = save_all_layers(attn, (tx, ty), gh, gw, cls_offset, out_dir)
            print(f"Saved {n} layer sheets for token ({tx},{ty}) to {out_dir}")
        if request_close:
            break
    window.close()
    return {"panel": attn_panel.image, "token": (tx, ty), "layer": layer, "head": head}


def main(argv=None):
    """Returns the output folder in --headless mode, else the explorer's last view."""
    parser = add_model_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("-t", "--token_xy", default=None, help="Patch coordinate 'x,y' to visualize (default: center)")
    parser.add_argument("-o", "--output_folder", default=None)
    parser.add_argument("--headless", action="store_true", help="No UI: save all layers for the chosen token and quit")
    parser.add_argument("--display_size", default=1000, type=int, help="Window size of the interactive explorer")
    args = parser.parse_args(argv)

    model = load_model(args)
    image_bgr = load_image(args)
    attn, gh, gw, cls_offset, disp_img = capture_attention(model, image_bgr, args.base_size_px)
    del model  # the explorer runs on the captured maps only
    print(f"Captured attention for {len(attn)} blocks x {attn[0].shape[0]} heads; grid {gh}x{gw}")

    tx, ty = (int(v) for v in args.token_xy.split(",")) if args.token_xy else (gw // 2, gh // 2)
    out_dir_arg = args.output_folder or osp.join("saved_results", "attention_viz")
    if not args.headless:
        return explore(attn, gh, gw, cls_offset, disp_img, (tx, ty), out_dir_arg, args.display_size)
    out_dir = get_save_folder(out_dir_arg)
    n = save_all_layers(attn, (tx, ty), gh, gw, cls_offset, out_dir)
    print(f"Saved {n} row/column attention images for token ({tx},{ty}) to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
