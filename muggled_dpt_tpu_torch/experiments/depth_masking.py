"""Depth-based image masking, the counterpart of JAX
``experiments/depth_masking.py``: threshold the (optionally plane-flattened)
depth prediction to build a foreground mask and apply it to the image.

    python -m muggled_dpt_tpu_torch.experiments.depth_masking -m CKPT [--remove_plane] [-d cpu]"""

from __future__ import annotations

import argparse
import os.path as osp

import cv2
import numpy as np

from ..demo_helpers.plane_fit import estimate_plane_of_best_fit
from ..demo_helpers.postprocess import normalize_01, remove_infinities, scale_prediction
from ..demo_helpers.saving import get_save_folder
from .common import add_model_args, load_image, load_model


def main(argv=None) -> str:
    parser = add_model_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("--threshold", default=0.5, type=float, help="Depth threshold in [0,1]")
    parser.add_argument("--invert", action="store_true", help="Keep far instead of near")
    parser.add_argument("--remove_plane", action="store_true", help="Subtract plane of best fit first")
    parser.add_argument("-o", "--output_folder", default=None)
    args = parser.parse_args(argv)

    model = load_model(args)
    image_bgr = load_image(args)

    h, w = image_bgr.shape[:2]
    prediction = model.inference(image_bgr, args.base_size_px)
    depth = normalize_01(remove_infinities(scale_prediction(prediction, (w, h)).squeeze()))

    if args.remove_plane:
        depth = normalize_01(depth - estimate_plane_of_best_fit(depth, rng=np.random.default_rng(0)))

    mask = depth >= args.threshold
    if args.invert:
        mask = ~mask
    mask_u8 = (mask * 255).astype(np.uint8)
    masked = cv2.bitwise_and(image_bgr, image_bgr, mask=mask_u8)
    rgba = np.dstack([image_bgr, mask_u8])

    out_dir = get_save_folder(args.output_folder or osp.join("saved_results", "depth_masking"))
    cv2.imwrite(osp.join(out_dir, "mask.png"), mask_u8)
    cv2.imwrite(osp.join(out_dir, "masked.png"), masked)
    cv2.imwrite(osp.join(out_dir, "masked_rgba.png"), rgba)
    print(f"Mask keeps {mask.mean() * 100:.1f}% of pixels; saved to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
