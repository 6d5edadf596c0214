"""Depth-Anything V2 ViT-Giant in the original checkpoint's layout: the keys
and shapes of ``weights/depth_anything_v2.py``, but each block's MLP is
DINOv2's ``SwiGLUFFNFused`` (``depth_anything_v2/dinov2_layers/swiglu_ffn.py``
of github.com/DepthAnything/Depth-Anything-V2): ``mlp.w12`` (2 * hidden, F)
holds both gate halves and ``mlp.w3`` (F, hidden) projects back, where the
GELU blocks hold ``mlp.fc1`` and ``mlp.fc2``. ``mlp_hidden`` is the SwiGLU
hidden width."""

from __future__ import annotations

from . import depth_anything_v2, draw


def layout(config: dict) -> list:
    """(key, shape, scale, shift) of every tensor the model reads."""
    hidden = config["mlp_hidden"]
    out = []
    for key, shape, scale, shift in depth_anything_v2.layout(config):
        if ".mlp.fc1." in key:
            key, shape = key.replace(".mlp.fc1.", ".mlp.w12."), (2 * hidden, *shape[1:])
        elif ".mlp.fc2." in key:
            key = key.replace(".mlp.fc2.", ".mlp.w3.")
        out.append((key, shape, scale, shift))
    return out


def generate(config: dict, seed: int, device, dtype) -> dict:
    """The original-layout state dict of ``config``, made on ``device`` in ``dtype``."""
    return draw(layout(config), seed, device, dtype)
