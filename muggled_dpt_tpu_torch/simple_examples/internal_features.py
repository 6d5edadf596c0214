"""Run the five DPT components one by one and print every intermediate
shape, the counterpart of JAX ``simple_examples/internal_features.py``.

    python -m muggled_dpt_tpu_torch.simple_examples.internal_features [-m CKPT] [-d cpu]

Depth-Anything drives patch embed, encoder, reassembly, fusion and head by
hand; BEiT and SwinV2 show the same intermediates through
``forward_with_internals``. The port's layouts: tokens (B, N, F), maps NCHW
(the JAX package's maps are NHWC)."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..experiments.common import load_model
from ..models.depth_anything import DepthAnything
from ..models.dpt_neck import fusion_forward
from ..ops.nn import patchify_embed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-m", "--model_path", default=None, help="Original checkpoint (default: a tiny random DA-V2)")
    parser.add_argument("-d", "--device", default=None,
                        help="Device to run on (default: the CUDA card, which must exist; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    model = load_model(args)

    image_bgr = np.random.default_rng(0).integers(0, 256, (300, 400, 3), dtype=np.uint8)
    image_bchw = model.prepare_image_bgr(image_bgr)
    print(f"\nPre-processed image shape: {tuple(image_bchw.shape)}  (BCHW)")

    net = model.net
    if isinstance(net, DepthAnything):
        with torch.inference_mode(), model._precision():
            # 1) patch embedding
            tokens, grid_hw = patchify_embed(image_bchw, net.patch_embed.weight, net.patch_embed.bias)
            print(f"Patch tokens: {tuple(tokens.shape)}  (BxNxF), patch grid: {grid_hw}")
            # 2) image encoder (4 stage outputs)
            stages = net.encoder(tokens, grid_hw)
            for i, s in enumerate(stages, 1):
                print(f"Encoder stage {i} tokens: {tuple(s.shape)}  (Bx(1+N)xF)")
            # 3) reassembly (4 image-like maps at x4 / x2 / x1 / x0.5 of the patch grid)
            maps = [stage(t, grid_hw) for stage, t in zip(net.reassemble, stages)]
            for i, m in enumerate(maps, 1):
                print(f"Reassembly stage {i} map: {tuple(m.shape)}  (NCHW)")
            # 4) fusion (one map at 8x the patch grid)
            fused = fusion_forward(maps, net.fusion)
            print(f"Fused feature map: {tuple(fused.shape)}  (NCHW)")
            # 5) head (inverse depth at about the input resolution)
            depth = net.head(fused)
    else:
        depth, internals = model.forward_with_internals(image_bchw)
        for i, t in enumerate(internals["block_tokens"], 1):
            print(f"Block {i} tokens: {tuple(t.shape)}")
        for i, m in enumerate(internals["reassembly_maps"], 1):
            print(f"Reassembly stage {i} map: {tuple(m.shape)}  (NCHW)")
        print(f"Fused feature map: {tuple(internals['fused_map'].shape)}  (NCHW)")
    print(f"Inverse depth: {tuple(depth.shape)}  (BxHxW)")


if __name__ == "__main__":
    main()
