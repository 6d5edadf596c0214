"""Fusion-scaling experiment, the counterpart of JAX
``experiments/fusion_scaling.py``: drive the 4 fusion blocks by hand with
per-block scaling factors to see how much each reassembly stage contributes
to the final depth map.

    python -m muggled_dpt_tpu_torch.experiments.fusion_scaling -m CKPT [-f 1,1,0.5,0.25] [-d cpu]

The reassembly maps come from one introspection forward
(``DPTModel.forward_with_internals``); each sweep entry runs
``fusion_forward(..., input_scales=...)`` and the model's head (which
upsamples by the family's ``head_upsample``: P/8 for Depth-Anything, 2 for
BEiT and SwinV2)."""

from __future__ import annotations

import argparse
import os.path as osp

import cv2
import numpy as np
import torch

from ..demo_helpers.model_capture import to_numpy
from ..demo_helpers.postprocess import normalize_01, remove_infinities
from ..demo_helpers.saving import get_save_folder
from ..models.dpt_neck import fusion_forward
from .common import add_model_args, load_image, load_model


def default_sweep():
    """Unit scales, then each block knocked out in turn."""
    sweep = [(1.0, 1.0, 1.0, 1.0)]
    for i in range(4):
        s = [1.0, 1.0, 1.0, 1.0]
        s[i] = 0.0
        sweep.append(tuple(s))
    return sweep


def main(argv=None) -> str:
    parser = add_model_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    parser.add_argument("-f", "--scales", default=None, help="Comma-separated f1,f2,f3,f4 (default sweep)")
    parser.add_argument("-o", "--output_folder", default=None)
    args = parser.parse_args(argv)

    model = load_model(args)
    image_bgr = load_image(args)

    # Run the pipeline up to reassembly once, then fuse repeatedly with scales
    image_bchw = model.prepare_image_bgr(image_bgr, args.base_size_px)
    _, internals = model.forward_with_internals(image_bchw)
    maps, net = internals["reassembly_maps"], model.net

    def fused_depth(scales):
        with torch.inference_mode(), model._precision():
            d = net.head(fusion_forward(maps, net.fusion, input_scales=scales))
        return normalize_01(remove_infinities(to_numpy(d).squeeze()))

    sweep = [tuple(float(v) for v in args.scales.split(","))] if args.scales else default_sweep()
    out_dir = get_save_folder(args.output_folder or osp.join("saved_results", "fusion_scaling"))
    for scales in sweep:
        d = fused_depth(scales)
        img = cv2.applyColorMap((d * 255).astype(np.uint8), cv2.COLORMAP_MAGMA)
        name = "f" + "_".join(f"{s:g}" for s in scales)
        cv2.imwrite(osp.join(out_dir, f"{name}.png"), img)
        print(f"scales={scales}: depth mean {d.mean():.4f} -> {name}.png")
    print(f"Saved to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
