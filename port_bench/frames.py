"""The traffic: a pool of distinct RGB frames made from the seed, the size
each frame is scaled to, and which frames each step sends.

One general generator reads every traffic file (``traffic/<mix>.json``):
``batch`` frames per step from a pool of ``pool_frames`` frames of
``frame_hw``, taken in order and around again, scaled so the longer side is
``max_side`` rounded to the configuration's ``tiling_px`` (``square``: both sides), with
one client in a closed loop (``loop``). ``warmup_steps`` steps run in set-up,
``trace_steps`` under the profiler, and ``check_steps`` steps of the window,
drawn from the seed, are held against the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .weights import sub_seed

FRAMES_SALT = 0xF2A3_0002
OCTAVES = ((9, 16, 0.55), (36, 64, 0.3), (144, 256, 0.15))  # (rows, cols, weight) of the random fields summed


def check_traffic(traffic: dict) -> None:
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError(f"this generator drives one client in a closed loop, got {traffic['loop']!r} x {traffic['clients']}")
    if traffic["pool_frames"] % traffic["batch"]:
        raise ValueError("pool_frames must be a multiple of batch")


def scaled_hw(config: dict, traffic: dict) -> tuple[int, int]:
    """The model's input size for a frame: the longer side scaled to
    ``max_side`` and rounded to the configuration's ``tiling_px`` (the side
    every input size is a multiple of: twice the patch for a ViT, eight
    times for SwinV2's three merges), as the apps size a frame."""
    tile = config["tiling_px"]
    h, w = traffic["frame_hw"]
    largest = max(h, w)
    target = (largest, largest) if traffic["square"] else (h, w)
    return tuple(max(1, round(s * traffic["max_side"] / largest / tile)) * tile for s in target)


def make_pool(traffic: dict, seed: int, device) -> torch.Tensor:
    """(P, H, W, 3) uint8 RGB frames, distinct, made on ``device`` from the
    seed: random fields at three scales, bilinearly enlarged and summed, with
    fine noise, so each frame has structure at every size the model sees.
    On a CUDA device the pool is returned in pinned host memory."""
    h, w = traffic["frame_hw"]
    count = traffic["pool_frames"]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, FRAMES_SALT))
    pool = torch.empty((count, h, w, 3), dtype=torch.uint8, device=device)
    chunk = 16
    for i in range(0, count, chunk):
        n = min(chunk, count - i)
        x = torch.zeros((n, 3, h, w), device=device)
        for rows, cols, weight in OCTAVES:
            field = torch.rand((n, 3, rows, cols), generator=gen, device=device)
            x += weight * F.interpolate(field, size=(h, w), mode="bilinear", align_corners=False)
        x += 0.08 * (torch.rand((n, 3, h, w), generator=gen, device=device) - 0.5)
        pool[i:i + n] = (x.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1)
    if pool.device.type == "cuda":
        host = torch.empty(pool.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(pool)
        return host
    return pool


def step_frames(traffic: dict, step: int) -> slice:
    """The pool rows step ``step`` sends."""
    b = traffic["batch"]
    start = (step * b) % traffic["pool_frames"]
    return slice(start, start + b)
