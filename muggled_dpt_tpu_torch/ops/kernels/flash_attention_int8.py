"""Flash attention with an int8 QK^T: hand-written Hopper kernels behind one
C entry (``csrc/flash_attention_int8.cu``) and two Python entries, each with
its plain PyTorch version beside it.

* ``flash_attention_int8_qk(q, k, v, scale)`` on (BH, N, D) tensors replaces
  ``experiments/flash_attention_int8.py:flash_attention_int8_qk`` (TPU
  kernel #6, ``_online_kernel_i8``): q is quantized per row, k per
  (batch * head), and alpha = sq * sk * scale * log2(e) is the row's logit
  scale in the exp2 domain.
* ``flash_attention_int8_qk_fused(qkv, num_heads, scale)`` on the head-major
  (B, N, 3C) qkv slab replaces ``flash_attention_int8_qk_fused`` (TPU
  kernel #7, ``_onepass_i8qk_kernel``): q is scaled by scale * log2(e) first,
  then quantized per (row, head), k per (batch, head), alpha = sq * sk; v is
  read in place in the slab. Returns (B, N, C).

One call of the C entry runs, on the caller's stream, the quantize prologue
(two launches of ``csrc/flash_attention_int8_sm90.cu``, every dtype) into
scratch that the wrapper allocates, then the attention on it: bfloat16 on
the int8 wgmma/TMA kernel of ``flash_attention_int8_sm90.cu``, float32 on
``fa_int8_f32`` of ``flash_attention_int8.cu``.

The plain prologues (``quantize_rows``, ``quantize_fused``) copy the JAX
package's formula for formula (``:101-107``, ``:263-271``) in torch ops, as
the JAX package runs them in XLA outside its kernels; the kernel prologue
equals them bit for bit. The plain attention (``int8_attention_reference``)
keeps the TPU kernels' rounding points: the exact integer logits times alpha
in float32, p = exp2(s - max) cast to v's dtype, the row sum over that cast
p (the ones column of the TPU kernels' v_ext), one division, one cast.

As in the JAX package, no model serves through these entries: the int8 tier
(``ops/quant.py``) quantizes the qkv projection, and chip_smoke.py holds the
kernels against the int8 DA-V2 ViT-L's own qkv slabs.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels or
raises. The C entry reports the attention route it took, and launches are
counted per route, one per call: ``flash_attention_int8_qk.sm90_launches``
and ``flash_attention_int8_qk_fused.sm90_launches`` (bfloat16), ``.launches``
(float32), as ``flash_attention.launch_counts()`` reports them."""

from __future__ import annotations

import array

import torch

from ._build import kernel_library
from .flash_attention import (HEAD_DIM, LOG2E, MAX_GRID_YZ, _DTYPE_CODES, _device_route, _operand, _qkv_operands,
                              _refuse_grad)
from .window_attention import BF16_FLOPS_PER_S, EX2_PER_S, HBM_BYTES_PER_S

PROLOGUE_ROWS = 64  # rows per chunk of the kernel prologue (PRO_ROWS in csrc/flash_attention_int8_sm90.cu)
MODE_SQSK, MODE_SCALED = 0, 1  # the C entry's SLOT_MODE: alpha = sq sk (#7), ((sq sk) scale) log2(e) (#6)
STAGE_PROLOGUE, STAGE_ATTENTION = 1, 2  # the C entry's SLOT_STAGES, a bit mask
SLOT_STAGES, SLOT_ROUTE = 27, 28  # the argument array's last two slots (enum Slot in csrc/flash_attention_int8.cu)
SM90_ROUTE = 1  # SLOT_ROUTE's value when flash_attention_int8_sm90.cu's attention kernel runs
INT8_OPS_PER_S = 1979e12  # the H100 SXM's dense int8 tensor-core rate


def int8_bound(b: int, n: int, h: int) -> dict:
    """The yardsticks of one bf16 call at (B, N, H, D=64), in ms:
    ``bound_ms``, the larger of the operations (QK^T's 2 B H N^2 D over the
    int8 tensor cores' rate plus PV's as many over the bf16 rate) and q, k,
    v read and out written once in bf16 over HBM's rate (``bound_by`` names
    which); ``prologue_floor_ms``, the prologue's bytes as designed (q and k
    read, k read again, int8 q and k and float32 alpha written) over HBM's
    rate; ``exp_floor_ms``, one exp2 per (q, k) pair over the SFU's rate."""
    ops = 2 * b * h * n * n * HEAD_DIM
    ops_ms = (ops / INT8_OPS_PER_S + ops / BF16_FLOPS_PER_S) * 1e3
    elements = b * n * h * HEAD_DIM
    bytes_ms = 4 * elements * 2 / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "prologue_floor_ms": (3 * elements * 2 + 2 * elements + 4 * b * n * h) / HBM_BYTES_PER_S * 1e3,
            "exp_floor_ms": b * h * n * n / EX2_PER_S * 1e3}


def _per_127(x):
    """x / 127 as one IEEE float32 division on every device (a CUDA tensor
    divided by a Python number is multiplied by the number's float32
    reciprocal instead, which differs in the last bit)."""
    return x / torch.full((), 127.0, device=x.device)


def quantize_rows(q, k, scale: float):
    """#6's prologue on (BH, N, D) q and k: (q_i8, k_i8, alpha (BH, N) float32)."""
    qf, kf = q.float(), k.float()
    sq = _per_127(qf.abs().amax(dim=2).clamp_min(1e-12))  # (BH, N)
    sk = _per_127(kf.abs().amax(dim=(1, 2)).clamp_min(1e-12))  # (BH,)
    q_i8 = torch.round(qf / sq[:, :, None]).to(torch.int8)
    k_i8 = torch.round(kf / sk[:, None, None]).to(torch.int8)
    return q_i8, k_i8, sq * sk[:, None] * scale * LOG2E


def quantize_fused(qkv, num_heads: int, scale: float):
    """#7's prologue on a head-major (B, N, 3C) qkv: (q_i8, k_i8 (B, N, H, D),
    alpha (B, N, H) float32, v (B, N, H, D), a view of the slab)."""
    b, n, c3 = qkv.shape
    hm = qkv.reshape(b, n, num_heads, 3, c3 // 3 // num_heads)
    qf = hm[..., 0, :].float() * (scale * LOG2E)
    kf = hm[..., 1, :].float()
    sq = _per_127(qf.abs().amax(dim=3).clamp_min(1e-12))  # (B, N, H)
    sk = _per_127(kf.abs().amax(dim=(1, 3)).clamp_min(1e-12))  # (B, H)
    q_i8 = torch.round(qf / sq[..., None]).to(torch.int8)
    k_i8 = torch.round(kf / sk[:, None, :, None]).to(torch.int8)
    return q_i8, k_i8, sq * sk[:, None, :], hm[..., 2, :]


REFERENCE_ROWS = 4096  # query rows per step of the plain version: (B, H, 4096, N) logits at a time


def int8_attention_reference(q_i8, k_i8, v, alpha):
    """Plain version of the attention on (B, N, H, D) int8 q and k, v (B, N,
    H, D) and alpha (B, N, H): returns (B, N, H, D) in v's dtype. The integer
    logits are taken as a float32 product of int8 values: every partial sum
    is an integer below 2^24, so it is exact in any summation order. Query
    rows go in steps of ``REFERENCE_ROWS``, which changes no result."""
    kf, vf = k_i8.float(), v.float()
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for i in range(0, q_i8.shape[1], REFERENCE_ROWS):
        rows = slice(i, i + REFERENCE_ROWS)
        s = torch.einsum("bnhd,bmhd->bhnm", q_i8[:, rows].float(), kf)
        s = s * alpha[:, rows].permute(0, 2, 1)[..., None]
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(v.dtype).float()
        l = p.sum(dim=-1).permute(0, 2, 1)[..., None]  # (B, rows, H, 1): the ones column of v_ext
        out[:, rows] = (torch.einsum("bhnm,bmhd->bnhd", p, vf) / l.clamp_min(1e-30)).to(v.dtype)
    return out


def flash_attention_int8_qk_reference(q, k, v, scale=None):
    """Plain version of ``flash_attention_int8_qk``."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    q_i8, k_i8, alpha = quantize_rows(q, k, scale)
    return int8_attention_reference(q_i8[:, :, None], k_i8[:, :, None], v[:, :, None], alpha[..., None])[:, :, 0]


def flash_attention_int8_qk_fused_reference(qkv, num_heads: int, scale=None):
    """Plain version of ``flash_attention_int8_qk_fused``."""
    b, n, c3 = qkv.shape
    scale = (c3 // 3 // num_heads) ** -0.5 if scale is None else float(scale)
    q_i8, k_i8, alpha, v = quantize_fused(qkv, num_heads, scale)
    return int8_attention_reference(q_i8, k_i8, v, alpha).reshape(b, n, c3 // 3)


class Int8Launch:
    """One call's argument array (slots in csrc/flash_attention_int8.cu) and
    the tensors it names: the new output ``out`` (B, N, H, D) in the inputs'
    dtype and one scratch allocation holding the prologue's ``q_i8`` and
    ``k_i8`` (B, N, H, D) int8, ``alpha`` (B, H, N) float32 (views made on
    demand) and its partial maxima (B, H, ceil(N / 64)) float32, each
    16-byte aligned. q, k and v are (address, batch, row and head strides)
    in elements, as ``_operand`` gives them; ``mode`` and ``q_mul``,
    ``scale`` as the C entry takes them. Raises ValueError on what the
    kernels cannot take."""

    def __init__(self, shape, q, k, v, dtype, device, mode: int, q_mul: float, scale: float):
        b, n, h, d = shape
        if d != HEAD_DIM:
            raise ValueError(f"int8 flash attention kernel supports head_dim {HEAD_DIM} only, got {d}")
        if dtype not in _DTYPE_CODES:
            raise ValueError(f"int8 flash attention kernel takes float32 or bfloat16, got {dtype}")
        if n < 1 or b < 1 or h < 1 or b > MAX_GRID_YZ or h > MAX_GRID_YZ:
            raise ValueError(f"int8 flash attention kernel: bad grid batch={b} heads={h} n={n}")
        self.shape = shape
        self.out = torch.empty(shape, dtype=dtype, device=device)
        elements = b * n * h * d
        # byte offsets of q_i8, k_i8, alpha and the partial maxima (each before the last a multiple of 16 bytes)
        self.offsets = (0, elements, 2 * elements, 2 * elements + -(-4 * b * h * n // 16) * 16)
        self.scratch = torch.empty(self.offsets[3] + 4 * b * h * -(-n // PROLOGUE_ROWS), dtype=torch.uint8, device=device)
        base = self.scratch.data_ptr()
        o = (self.out.data_ptr(), n * h * d, h * d, d)
        self.args = array.array("q", [*q, *k, *v, *o, b, n, h, d, _DTYPE_CODES[dtype], mode, device.index,
                                      *(base + offset for offset in self.offsets), 0, 0])
        self.device, self.q_mul, self.scale = device, float(q_mul), float(scale)

    def _part(self, index: int, dtype, shape):
        start = self.offsets[index]
        size = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
        return self.scratch[start:start + size].view(dtype).view(shape)

    @property
    def q_i8(self):
        return self._part(0, torch.int8, self.shape)

    @property
    def k_i8(self):
        return self._part(1, torch.int8, self.shape)

    @property
    def alpha(self):
        b, n, h, _ = self.shape
        return self._part(2, torch.float32, (b, h, n))

    def run(self, stages: int = STAGE_PROLOGUE | STAGE_ATTENTION) -> bool:
        """Launch ``stages`` (the prologue, the attention on the scratch as
        it stands, or both) on the current stream; True if the attention
        route is flash_attention_int8_sm90.cu's kernel. Counts no launch."""
        self.args[SLOT_STAGES] = stages
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = kernel_library().mdpt_flash_attention_int8(self.args.buffer_info()[0], self.q_mul, self.scale, stream)
        if err != 0:
            raise RuntimeError(f"int8 flash attention kernel launch failed: CUDA error {err}")
        return self.args[SLOT_ROUTE] == SM90_ROUTE


def _readable(t: torch.Tensor) -> torch.Tensor:
    """t where the kernels read it in place (the head dim contiguous, the
    base and every other stride a multiple of 16 bytes: 16-byte loads and
    tensor maps), else a contiguous copy of it."""
    step = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(s % step == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def prepare_int8_qk(q, k, v, scale=None) -> Int8Launch:
    """#6's launch on CUDA (BH, N, D) q, k and v of one dtype; a layout the
    kernels cannot read is copied first, and the launch holds the copies
    (``inputs``) so that their memory outlives the kernels' reads."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (BH, N, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, n, d = q.shape
    inputs = [_readable(t) for t in (q, k, v)]
    specs = [_operand(name, t[:, :, None], q.device, q.dtype) for name, t in zip("qkv", inputs)]
    scale = d**-0.5 if scale is None else float(scale)
    launch = Int8Launch((bh, n, 1, d), *specs, q.dtype, q.device, MODE_SCALED, 1.0, scale)
    launch.inputs = inputs
    return launch


def prepare_int8_qk_fused(qkv, num_heads: int, scale=None) -> Int8Launch:
    """#7's launch on a CUDA head-major (B, N, 3C) qkv slab, read in place."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads) != 0:
        raise ValueError(f"qkv must be (B, N, 3 * num_heads * D), got {tuple(qkv.shape)} for {num_heads} heads")
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    scale = d**-0.5 if scale is None else float(scale)
    return Int8Launch((b, n, num_heads, d), *_qkv_operands(qkv, d), qkv.dtype, qkv.device, MODE_SQSK, scale * LOG2E, scale)


def flash_attention_int8_qk(q, k, v, scale=None):
    """Attention with int8 QK^T on (BH, N, D) q, k and v (q unscaled);
    returns (BH, N, D) in v's dtype. Counts its launches in
    ``flash_attention_int8_qk.sm90_launches`` (bfloat16) or ``.launches``."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (BH, N, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if _device_route(q.device, "flash_attention_int8_qk"):
        return flash_attention_int8_qk_reference(q, k, v, scale)
    _refuse_grad("flash_attention_int8_qk", q, k, v)
    launch = prepare_int8_qk(q, k, v, scale)
    if launch.run():
        flash_attention_int8_qk.sm90_launches += 1
    else:
        flash_attention_int8_qk.launches += 1
    return launch.out[:, :, 0]


def flash_attention_int8_qk_fused(qkv, num_heads, scale=None):
    """Attention with int8 QK^T off a head-major (B, N, 3C) qkv slab; returns
    (B, N, C) in qkv's dtype. Counts its launches in
    ``flash_attention_int8_qk_fused.sm90_launches`` (bfloat16) or ``.launches``."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads) != 0:
        raise ValueError(f"qkv must be (B, N, 3 * num_heads * D), got {tuple(qkv.shape)} for {num_heads} heads")
    if _device_route(qkv.device, "flash_attention_int8_qk_fused"):
        return flash_attention_int8_qk_fused_reference(qkv, num_heads, scale)
    _refuse_grad("flash_attention_int8_qk_fused", qkv)
    b, n, c3 = qkv.shape
    launch = prepare_int8_qk_fused(qkv, num_heads, scale)
    if launch.run():
        flash_attention_int8_qk_fused.sm90_launches += 1
    else:
        flash_attention_int8_qk_fused.launches += 1
    return launch.out.reshape(b, n, c3 // 3)


flash_attention_int8_qk.launches = 0
flash_attention_int8_qk.sm90_launches = 0
flash_attention_int8_qk_fused.launches = 0
flash_attention_int8_qk_fused.sm90_launches = 0
