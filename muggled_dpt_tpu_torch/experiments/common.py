"""What the experiments share: the model and image flags, the model (a
checkpoint, or a tiny random DA-V2 when none is given) and the input image
(a file, or a random 480x640 frame)."""

from __future__ import annotations

import argparse

import cv2
import numpy as np

from ..make_depthanythingv2_dpt import make_depthanythingv2_dpt
from ..make_dpt import make_dpt_from_state_dict


def add_model_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("-m", "--model_path", default=None, help="Original checkpoint (default: a tiny random DA-V2)")
    parser.add_argument("-i", "--image_path", default=None, help="Input image (default: a random 480x640 frame)")
    parser.add_argument("-b", "--base_size_px", default=None, type=int, help="Max side the image is scaled to")
    parser.add_argument("-d", "--device", default=None,
                        help="Device to run on (default: the CUDA card, which must exist; 'cpu' for the CPU)")
    return parser


def load_model(args):
    """The DPTModel of ``args.model_path`` in float32 on ``args.device``, or a
    tiny random DA-V2 when no path is given."""
    if args.model_path:
        return make_dpt_from_state_dict(args.model_path, device=args.device)[1]
    print("No model path - using tiny random DA-V2")
    return make_depthanythingv2_dpt(64, 1, 8, (8, 16, 32, 64), (16, 16), 16, device=args.device)


def load_image(args) -> np.ndarray:
    """The BGR uint8 image of ``args.image_path``, or a random 480x640 frame."""
    if args.image_path:
        image_bgr = cv2.imread(args.image_path)
        if image_bgr is None:
            raise FileNotFoundError(f"Could not read: {args.image_path}")
        return image_bgr
    return np.random.default_rng(0).integers(0, 256, (480, 640, 3), dtype=np.uint8)

