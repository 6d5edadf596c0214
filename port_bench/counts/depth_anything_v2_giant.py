"""Depth-Anything V2 ViT-Giant: patch embed, the DINOv2 blocks with a SwiGLU
MLP and the DPT neck with readout 'ignore'.

A SwiGLU block on one frame of N tokens at width F with hidden width H:
qkv 2 N 3F F, proj 2 N F F, ``w12`` 2 N 2H F (both gate halves in one
product), ``w3`` 2 N F H, and attention 4 heads N^2 D. ``encoder_dense``
counts every product of the encoder outside attention (the patch embed,
qkv, proj, ``w12``, ``w3``) for one forward of ``batch`` frames: the
operations, each product's weight, input and output moved once in the
configuration's type, and the least time as the sum over the products of
``peaks.bound_s``. ``model_flops_per_frame`` is those operations and the
attention's over the batch, plus the neck's."""

from __future__ import annotations

from ..peaks import ELEMENT_BYTES, bound_s
from . import attention, conv, gemm, neck


def products(config: dict, scaled_hw, batch: int) -> list:
    """(operations, bytes) of each product of one forward's encoder outside
    attention: the patch embed, then per block qkv, proj, ``w12``, ``w3``."""
    p, f, hidden = config["patch_size_px"], config["features_per_token"], config["mlp_hidden"]
    e = ELEMENT_BYTES[config["dtype"]]
    gh, gw = scaled_hw[0] // p, scaled_hw[1] // p
    m = batch * (gh * gw + 1)
    out = [(batch * conv(f, 3, p, gh * gw), e * (f * 3 * p * p + batch * 3 * scaled_hw[0] * scaled_hw[1] + batch * gh * gw * f))]
    for n_out, n_in in ((3 * f, f), (f, f), (2 * hidden, f), (f, hidden)):
        out += [(gemm(m, n_out, n_in), e * (n_out * n_in + m * n_in + m * n_out))] * config["num_blocks"]
    return out


def counts(config: dict, scaled_hw, batch: int) -> dict:
    """``tokens``, ``model_flops_per_frame``, ``attention`` and
    ``encoder_dense`` (one forward of ``batch`` frames) at ``scaled_hw``."""
    p = config["patch_size_px"]
    grid = (scaled_hw[0] // p, scaled_hw[1] // p)
    n = grid[0] * grid[1] + 1
    att = attention(config, n, batch)
    dense = products(config, scaled_hw, batch)
    flops = sum(fl for fl, _ in dense)
    return {"tokens": n, "model_flops_per_frame": (flops + att["flops"]) / batch + neck(config, grid, scaled_hw),
            "attention": att,
            "encoder_dense": {"flops": flops, "bytes": sum(b for _, b in dense),
                              "bound_s": sum(bound_s(fl, b, config["dtype"]) for fl, b in dense)}}
