"""Per-block token-norm visualization, the counterpart of JAX
``experiments/block_norm_visualization.py``: the L2 norm of every patch
token after each block, which shows the high-norm outlier tokens of large
ViTs ("Vision Transformers Need Registers").

    python -m muggled_dpt_tpu_torch.experiments.block_norm_visualization -m CKPT --headless [-d cpu]

The block outputs come from one introspection forward
(``DPTModel.forward_with_internals``). Only the --headless batch mode is
ported; the interactive explorer waits on ``demo_helpers/ui.py`` (ROADMAP A12)."""

from __future__ import annotations

import argparse
import os.path as osp

import cv2
import numpy as np

from ..demo_helpers.saving import get_save_folder
from .common import add_model_args, load_image, load_model, need_headless


def capture_block_norms(model, image_bgr, base_size_px):
    """One introspection forward -> (L, gh, gw) float32 norms of each
    block's patch tokens."""
    image_bchw = model.prepare_image_bgr(image_bgr, base_size_px)
    p = model.patch_size_px
    gh, gw = image_bchw.shape[2] // p, image_bchw.shape[3] // p
    _, internals = model.forward_with_internals(image_bchw)
    if internals["block_tokens"][-1].shape[1] < gh * gw:
        raise SystemExit("block_norm_visualization: a hierarchical encoder (SwinV2) has no per-block map on one grid")
    norms = []
    for tokens in internals["block_tokens"]:
        patch = tokens[0, -gh * gw :].float()  # strip any cls/readout token
        norms.append(patch.norm(dim=-1).reshape(gh, gw).cpu().numpy())
    return np.stack(norms)


def colorize_norms(norms_hw, upscale=8):
    lo, hi = float(norms_hw.min()), float(norms_hw.max())
    img = ((norms_hw - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    img = cv2.resize(img, (norms_hw.shape[1] * upscale, norms_hw.shape[0] * upscale), interpolation=cv2.INTER_NEAREST)
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


def main(argv=None) -> str:
    parser = add_model_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("-o", "--output_folder", default=None)
    parser.add_argument("--headless", action="store_true", help="No UI: save all block maps and quit")
    parser.add_argument("--display_size", default=1000, type=int, help="Window size of the interactive explorer")
    args = parser.parse_args(argv)
    need_headless(args, "block_norm_visualization")

    model = load_model(args)
    image_bgr = load_image(args)
    norms = capture_block_norms(model, image_bgr, args.base_size_px)
    print(f"Captured {norms.shape[0]} block outputs; grid {norms.shape[1]}x{norms.shape[2]}")

    out_dir = get_save_folder(args.output_folder or osp.join("saved_results", "block_norms"))
    n = save_all_blocks(norms, out_dir)
    print(f"Saved {n} per-block norm maps to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
