"""Minimal API example, the counterpart of JAX
``simple_examples/depth_prediction.py``: load a checkpoint, run inference on
one image, display the normalized result.

    python -m muggled_dpt_tpu_torch.simple_examples.depth_prediction [-m CKPT] [-i IMAGE] [--no_display] [-d cpu]

Without a model path a tiny randomly-initialized DA-V2 runs, so the example
needs no download; without an image path a random 480x640 frame. Runs on the
CUDA card (float32, as the JAX example) unless ``-d cpu`` is given, and
raises where there is no card."""

from __future__ import annotations

import argparse

import cv2
import numpy as np

from ..demo_helpers.misc import DEVICE_HELP, depth_to_numpy
from ..demo_helpers.postprocess import normalize_01, remove_infinities
from ..make_depthanythingv2_dpt import make_depthanythingv2_dpt
from ..make_dpt import make_dpt_from_state_dict


def main(argv=None) -> np.ndarray:
    """Returns the normalized (H, W) depth."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-m", "--model_path", default=None)
    parser.add_argument("-i", "--image_path", default=None)
    parser.add_argument("--no_display", action="store_true")
    parser.add_argument("-d", "--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)

    # Load model (or build a tiny random one so the example runs standalone)
    if args.model_path:
        config_dict, dpt_model = make_dpt_from_state_dict(args.model_path, device=args.device)
    else:
        print("No model path given - using a tiny randomly-initialized DA-V2 model")
        dpt_model = make_depthanythingv2_dpt(384, 6, 12, (48, 96, 192, 384), (37, 37), 64, device=args.device)
        config_dict = dpt_model.config

    # Load image
    if args.image_path:
        image_bgr = cv2.imread(args.image_path)
        if image_bgr is None:
            raise FileNotFoundError(f"Could not read image: {args.image_path}")
    else:
        image_bgr = np.random.default_rng(0).integers(0, 256, (480, 640, 3), dtype=np.uint8)

    # Inference: BGR uint8 in -> (1, H, W) inverse-depth out, a tensor on the model's device
    inverse_depth = depth_to_numpy(dpt_model.inference(image_bgr))
    depth_norm = normalize_01(remove_infinities(inverse_depth.squeeze()))
    print("Inverse depth shape:", inverse_depth.shape)
    print("Depth range (normalized): 0..1, mean", float(depth_norm.mean()))

    if not args.no_display:
        depth_u8 = (depth_norm * 255).astype(np.uint8)
        cv2.imshow("Depth", cv2.applyColorMap(depth_u8, cv2.COLORMAP_MAGMA))
        cv2.waitKey(0)
        cv2.destroyAllWindows()
    return depth_norm


if __name__ == "__main__":
    main()
