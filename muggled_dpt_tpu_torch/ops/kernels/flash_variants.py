"""The launcher shared by the measurement variants of flash attention #1
(TPU kernels #10-#12): one kernel template (``csrc/flash_variants.cuh``)
instantiated by three sources, each with its own C entry and one argument
layout (``enum Slot``). The entries live beside their plain versions:
``flash_attention_xl.py`` (#10), ``flash_attention_staged.py`` (#11) and
``muggled_dpt_tpu_torch/tools/attn_variants.py`` (#12)."""

from __future__ import annotations

import array
import math

import torch

from ._build import kernel_library
from .flash_attention import HEAD_DIM, MAX_GRID_YZ

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel template's Mode (csrc/flash_variants.cuh)
MODES = {"flash": 0, "ablate": 1, "staged": 2, "mask_exp": 3, "mask_exp2": 4, "padfix": 5, "nosm": 6, "maxonly": 7,
         "exponly": 8}
TILE_KEYS = 64  # the bf16 kernel's key tile: panels are multiples of it
QP_CHOICES = (1, 2, 4)  # q blocks of 64 rows per CTA the kernel is built for


def qkv_dims(qkv, num_heads: int) -> tuple[int, int, int]:
    """(B, N, D) of a head-major (B, N, 3C) qkv slab of ``num_heads`` heads;
    raises ValueError on another shape."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads) != 0:
        raise ValueError(f"qkv must be (B, N, 3 * num_heads * D), got {tuple(qkv.shape)} for {num_heads} heads")
    b, n, c3 = qkv.shape
    return b, n, c3 // 3 // num_heads


def launch_variant(entry: str, shape, dtype, device, q, k, v, out, *, keys: int, mode: str, qk_scale: float, qp: int = 1,
                   pipelined: bool = False, panel: int = TILE_KEYS, chunk: int = 1):
    """Launch ``entry`` of the kernel library over (B, N, H, D) = ``shape``
    on ``device``: q, k, v and out are (address, batch stride, row stride,
    head stride) in elements; ``keys`` is the number of keys taken (rows of
    k and v at or past N read as zeros); logits are (q . k) * ``qk_scale``.
    The arguments cross to C as one int64 array (``enum Slot``); the entry
    launches on the tensors' device and leaves the current device as it was."""
    b, n, h, d = shape
    if d != HEAD_DIM:
        raise ValueError(f"{entry}: the kernel supports head_dim {HEAD_DIM} only, got {d}")
    dtype_code = _DTYPE_CODES.get(dtype)
    if dtype_code is None:
        raise ValueError(f"{entry}: the kernel takes float32 or bfloat16, got {dtype}")
    if not math.isfinite(qk_scale):
        raise ValueError(f"{entry}: needs a finite scale, got {qk_scale}")
    if n < 1 or keys < 1 or b < 1 or b > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"{entry}: bad grid batch={b} heads={h} n={n} keys={keys}")
    if qp not in QP_CHOICES or panel < TILE_KEYS or panel % TILE_KEYS or chunk < 1:
        raise ValueError(f"{entry}: qp={qp} (want one of {QP_CHOICES}), panel={panel} (a multiple of {TILE_KEYS}), "
                         f"chunk={chunk}")
    args = array.array("q", [*q, *k, *v, *out, b, n, keys, h, d, dtype_code, device.index, MODES[mode], qp,
                             int(pipelined), panel, chunk])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(kernel_library(), entry)(args.buffer_info()[0], qk_scale, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
