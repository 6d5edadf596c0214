"""Original-layout weights made on the device from the seed, one file per
family (``<family>.py``: ``layout(config)`` lists every tensor).

``draw`` makes them all from one ``torch.Generator`` on the device in one
normal draw over a flat buffer, scaled and shifted per tensor, then cast in
one call to the type the cell serves. The scales are the repo's own synthetic
checkpoints' (``muggled_dpt_tpu_torch/checkpoints/random_init.py`` and
``checkpoints/beit.py:random_original_state_dict``); the draws are not theirs,
since those come from numpy on the host."""

from __future__ import annotations

import math

import torch

GENERATOR_SALT = 0x5EED_0001  # the weights' stream; frames use another


def sub_seed(seed: int, salt: int) -> int:
    """A 63-bit seed for one stream of a run, from the run's ``--seed``."""
    return (int(seed) * 0x9E3779B97F4A7C15 + salt) % (1 << 63)


def draw(layout: list, seed: int, device, dtype) -> dict:
    """{key: tensor} from ``layout``, a list of (key, shape, scale, shift):
    each tensor is ``shift + scale * N(0, 1)``, all from one draw. The
    tensors are views of one buffer of ``dtype``."""
    sizes = [math.prod(shape) for _, shape, _, _ in layout]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, GENERATOR_SALT))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    offset = 0
    for (_, _, scale, shift), n in zip(layout, sizes):
        part = flat[offset:offset + n]
        part.mul_(scale)
        if shift:
            part.add_(shift)
        offset += n
    flat = flat.to(dtype)
    out, offset = {}, 0
    for (key, shape, _, _), n in zip(layout, sizes):
        out[key] = flat[offset:offset + n].view(shape)
        offset += n
    return out


def checksum(state_dict: dict) -> float:
    """A float64 sum over every tensor, to show two draws are the same weights."""
    return float(sum(t.double().sum() * (i + 1) for i, t in enumerate(state_dict.values())))


def conv_scale(ci: int, k: int) -> float:
    """Fan-in scale of the neck's convolutions (about unit gain)."""
    return 1.0 / math.sqrt(ci * k * k)
