"""BEiT image encoder (MiDaS v3.1).

The counterpart of ``muggled_dpt_tpu/models/beit.py``: cls token prepend,
no absolute position embedding and no output norm; pre-norm blocks with
gamma LayerScale whose attention adds a learned relative-position bias; the
output after each quarter of the blocks feeds the DPT neck.

The bias: every block holds a LUT of (2bh-1)(2bw-1) + 3 rows by H heads for
its base patch grid (bh, bw). For a patch grid (gh, gw) the token part of the
LUT is resized bilinearly (float32, align_corners=False, no antialias) to
(2gh-1, 2gw-1) and gathered by the (N, N) relative-position index, N =
gh*gw + 1; the 3 special rows give the cls borders. The JAX package expands
the gather as one-hot Toeplitz matmuls for the TPU's matrix unit; a plain
index gather is the GPU's form.

Two modes, as in the JAX package: cached (the facade builds the (L, H, Np,
Np) stack once per grid and each block reads its layer in place) and inline
(each block builds its own (1, H, N, N) bias from its LUT, so memory holds one
layer's bias at a time)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.resize import resize_2d
from .dinov2 import Block, stage_taps


def relative_position_tensor(grid_hw, device=None) -> torch.Tensor:
    """Deterministic (N, N) int32 matrix of relative-offset ids for a patch
    grid, with the special cls entries; N = gh*gw + 1. Built on ``device``
    from aranges: nothing is uploaded and nothing is kept."""
    gh, gw = grid_hw
    ys = torch.arange(gh, dtype=torch.int32, device=device).repeat_interleave(gw)
    xs = torch.arange(gw, dtype=torch.int32, device=device).repeat(gh)
    n = gh * gw + 1
    num_token_ids = (2 * gh - 1) * (2 * gw - 1)
    idx = torch.empty((n, n), dtype=torch.int32, device=device)
    idx[1:, 1:] = (ys[:, None] - ys[None, :] + (gh - 1)) * (2 * gw - 1) + (xs[:, None] - xs[None, :] + (gw - 1))
    idx[0, :] = num_token_ids  # cls-to-token
    idx[:, 0] = num_token_ids + 1  # token-to-cls
    idx[0, 0] = num_token_ids + 2  # cls-to-cls
    return idx


def relative_position_index(grid_hw: tuple[int, int]) -> np.ndarray:
    """``relative_position_tensor`` as a numpy array (the JAX package's form)."""
    return relative_position_tensor(grid_hw).numpy()


BIAS_ROW_MULTIPLE = 8  # bias rows padded to this many elements: even strides, so the kernel loads pairs


def padded_tokens(grid_hw) -> int:
    """N = gh*gw + 1 rounded up to BIAS_ROW_MULTIPLE: the row stride of the
    bias the encoder hands the kernel, in both modes."""
    n = grid_hw[0] * grid_hw[1] + 1
    return (n + BIAS_ROW_MULTIPLE - 1) // BIAS_ROW_MULTIPLE * BIAS_ROW_MULTIPLE


def calculate_bias_bytes(num_layers: int, num_heads: int, grid_hw, bytes_per_element: int = 4) -> int:
    """Device bytes of the (L, H, Np, Np) bias stack the encoder builds for a
    grid, Np = ``padded_tokens(grid_hw)``."""
    return int(num_layers * num_heads * padded_tokens(grid_hw) ** 2 * bytes_per_element)


def bias_build_bytes(num_layers: int, num_heads: int, grid_hw, bytes_per_element: int = 4) -> int:
    """Peak device bytes of ``compute_bias_stack`` for the encoder's stack:
    the stack, one layer's gathered bias and the (N, N) int32 index."""
    index_bytes = 4 * (grid_hw[0] * grid_hw[1] + 1) ** 2
    return calculate_bias_bytes(num_layers + 1, num_heads, grid_hw, bytes_per_element) + index_bytes


def compute_bias_stack(relpos_lut, base_grid_hw, grid_hw, pad_to: int | None = None, dtype=torch.float32, index=None):
    """Per-layer relative-position bias (L, H, N, N) for a patch grid.

    relpos_lut: (L, R, H) stacked LUTs, R = (2bh-1)(2bw-1) + 3. The LUT is
    resized in float32, one layer at a time, cast to ``dtype`` and gathered
    into a stack of ``dtype`` (the cast commutes with the gather). pad_to:
    when larger than N, the last two dims are padded with zeros to that size
    (the cached stack's row stride). index: the grid's
    ``relative_position_tensor`` on the LUT's device, when the caller has it;
    otherwise it is built here and dropped on return."""
    num_layers, _, heads = relpos_lut.shape
    (bh, bw), (gh, gw) = base_grid_hw, grid_hw
    ref_h, ref_w = 2 * bh - 1, 2 * bw - 1
    new_h, new_w = 2 * gh - 1, 2 * gw - 1
    n = gh * gw + 1
    n_pad = pad_to if pad_to is not None and pad_to > n else n
    idx = relative_position_tensor((gh, gw), relpos_lut.device) if index is None else index
    stack = torch.zeros((num_layers, heads, n_pad, n_pad), dtype=dtype, device=relpos_lut.device)
    for layer in range(num_layers):
        lut = relpos_lut[layer].float().t()  # (H, R)
        tok = lut[:, : ref_h * ref_w].reshape(1, heads, ref_h, ref_w)
        if (new_h, new_w) != (ref_h, ref_w):
            tok = resize_2d(tok, (new_h, new_w))  # bilinear, align_corners=False, float32
        full = torch.cat([tok.reshape(heads, new_h * new_w), lut[:, ref_h * ref_w :]], dim=1)  # (H, R')
        stack[layer, :, :n, :n] = full.to(dtype)[:, idx]
    return stack


class BEiTEncoder(nn.Module):
    """cls prepend, blocks with a relative-position bias, 4 taps."""

    def __init__(self, features: int, num_heads: int, num_blocks: int, base_grid_hw, use_kernel: bool = True, device=None):
        super().__init__()
        self.features = features
        self.base_grid_hw = tuple(int(g) for g in base_grid_hw)
        self.taps = stage_taps(num_blocks)
        lut_rows = (2 * self.base_grid_hw[0] - 1) * (2 * self.base_grid_hw[1] - 1) + 3
        self.cls_token = nn.Parameter(torch.empty(1, 1, features, device=device))
        self.relpos_lut = nn.Parameter(torch.empty(num_blocks, lut_rows, num_heads, device=device))
        self.blocks = nn.ModuleList(Block(features, num_heads, use_kernel, device=device) for _ in range(num_blocks))

    def fixed_zero_grads(self) -> list:
        """(parameter, boolean mask) pairs of entries the original model does
        not have: BEiT has no key bias, so the k third of every qkv bias is a
        fixed zero. Training discards their gradients, so they stay zero."""
        return [(b.attn.qkv.bias, b.attn.key_bias_mask(b.num_heads)) for b in self.blocks]

    def embed(self, patch_tokens):
        """(B, N, F) patch tokens -> (B, 1+N, F) with the cls token
        prepended: the first block's input."""
        cls_tok = self.cls_token.to(patch_tokens.dtype).expand(patch_tokens.shape[0], 1, self.features)
        return torch.cat([cls_tok, patch_tokens], dim=1)

    def block_biases(self, grid_hw, bias_stack=None, dtype=torch.float32):
        """Each block's bias argument, in block order: ``(bias_stack, i)``
        for the cached stack, or else block i's own (1, H, Np, Np) bias in
        ``dtype``, padded like the stack and built only when the loop asks
        for it, so memory holds one layer's bias at a time."""
        if bias_stack is not None:
            yield from ((bias_stack, i) for i in range(len(self.blocks)))
            return
        index = relative_position_tensor(grid_hw, self.relpos_lut.device)
        for i in range(len(self.blocks)):
            yield compute_bias_stack(self.relpos_lut[i : i + 1], self.base_grid_hw, grid_hw, padded_tokens(grid_hw),
                                     dtype, index)

    def forward(self, patch_tokens, grid_hw, bias_stack=None):
        """patch_tokens: (B, gh*gw, F). bias_stack: the cached (L, H, Np, Np)
        stack for this grid, or None to build each block's bias inline.
        Returns the 4 tapped (B, 1+gh*gw, F) token tensors."""
        tokens = self.embed(patch_tokens)
        outputs = []
        for i, (block, bias) in enumerate(zip(self.blocks, self.block_biases(grid_hw, bias_stack, tokens.dtype))):
            tokens = block(tokens, bias)
            if i in self.taps:
                outputs.append(tokens)
        return tuple(outputs)

    def forward_capture(self, patch_tokens, grid_hw, bias_stack=None):
        """``forward`` on the plain attention path, keeping what each block
        made: (the 4 tapped stages, {"block_tokens": [(B, 1+N, F)] * L,
        "attention": [(B, H, N, N) float32] * L}). Each block's bias comes
        from the cached stack (its padded rows sliced off) or is built
        inline, as in ``forward``."""
        tokens = self.embed(patch_tokens)
        internals = {"block_tokens": [], "attention": []}
        outputs = []
        for i, (block, bias) in enumerate(zip(self.blocks, self.block_biases(grid_hw, bias_stack, tokens.dtype))):
            tokens, weights = block.forward_capture(tokens, bias)
            internals["block_tokens"].append(tokens)
            internals["attention"].append(weights)
            if i in self.taps:
                outputs.append(tokens)
        return tuple(outputs), internals
