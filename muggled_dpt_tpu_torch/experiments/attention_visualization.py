"""Attention visualization, the counterpart of JAX
``experiments/attention_visualization.py``: capture every block's softmax
attention and save, for one patch token, how every layer and head attends
from it (row attention) and to it (column attention).

    python -m muggled_dpt_tpu_torch.experiments.attention_visualization -m CKPT --headless [-t x,y] [-d cpu]

The weights come from one introspection forward
(``DPTModel.forward_with_internals``). Only the --headless batch mode is
ported; the interactive explorer waits on ``demo_helpers/ui.py`` (ROADMAP A12)."""

from __future__ import annotations

import argparse
import os.path as osp

import cv2
import numpy as np

from ..demo_helpers.saving import get_save_folder
from .common import add_model_args, load_image, load_model, need_headless


def capture_attention(model, image_bgr, base_size_px):
    """One introspection forward -> (attention list of (H, N, N) float16
    arrays, gh, gw, cls_offset)."""
    image_bchw = model.prepare_image_bgr(image_bgr, base_size_px)
    p = model.patch_size_px
    gh, gw = image_bchw.shape[2] // p, image_bchw.shape[3] // p
    _, internals = model.forward_with_internals(image_bchw)
    if internals["attention"][0].dim() != 4:
        raise SystemExit("attention_visualization: windowed attention (SwinV2) has no per-token map over the grid")
    # float16 halves host memory: ViT-L at 518 captures 24 x (16, 1370, 1370) maps
    attn = [a[0].half().cpu().numpy() for a in internals["attention"]]
    cls_offset = 1 if attn[0].shape[-1] == gh * gw + 1 else 0
    return attn, gh, gw, cls_offset


def token_attention_maps(attn_layer, token_xy, gh, gw, cls_offset, head=-1):
    """(row, col) attention over the patch grid for one token; head=-1 means
    the mean over heads. Row = where the token looks, col = who looks at it."""
    tx, ty = token_xy
    idx = cls_offset + ty * gw + tx
    a = attn_layer if head < 0 else attn_layer[head : head + 1]
    row = a[:, idx, cls_offset:].astype(np.float32).mean(0).reshape(gh, gw)
    col = a[:, cls_offset:, idx].astype(np.float32).mean(0).reshape(gh, gw)
    return row, col


def colorize_map(m, upscale=8):
    img = (m / max(float(m.max()), 1e-9) * 255).astype(np.uint8)
    img = cv2.resize(img, (m.shape[1] * upscale, m.shape[0] * upscale), interpolation=cv2.INTER_NEAREST)
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


def main(argv=None) -> str:
    parser = add_model_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("-t", "--token_xy", default=None, help="Patch coordinate 'x,y' to visualize (default: center)")
    parser.add_argument("-o", "--output_folder", default=None)
    parser.add_argument("--headless", action="store_true", help="No UI: save all layers for the chosen token and quit")
    parser.add_argument("--display_size", default=1000, type=int, help="Window size of the interactive explorer")
    args = parser.parse_args(argv)
    need_headless(args, "attention_visualization")

    model = load_model(args)
    image_bgr = load_image(args)
    attn, gh, gw, cls_offset = capture_attention(model, image_bgr, args.base_size_px)
    print(f"Captured attention for {len(attn)} blocks x {attn[0].shape[0]} heads; grid {gh}x{gw}")

    tx, ty = (int(v) for v in args.token_xy.split(",")) if args.token_xy else (gw // 2, gh // 2)
    out_dir = get_save_folder(args.output_folder or osp.join("saved_results", "attention_viz"))
    n = save_all_layers(attn, (tx, ty), gh, gw, cls_offset, out_dir)
    print(f"Saved {n} row/column attention images for token ({tx},{ty}) to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
