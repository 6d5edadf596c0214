"""Opt-in int8 (w8a8) serving tier: symmetric per-output-channel int8
weights with dynamic per-token int8 activations.

The port of ``muggled_dpt_tpu/ops/quant.py`` (it imports nothing from there):
* weights are quantized once (``quantize_weight``): int8 (out, in) plus one
  float32 scale per output channel;
* activations are quantized per token (row) on the fly, the int8 x int8
  product accumulates in int32 (``torch._int_mm``: cuBLASLt on the card,
  exact on the CPU too) and is dequantized by the two scale vectors
  (``linear_w8a8``), in the JAX package's order of operations;
* SmoothQuant calibration (arXiv:2211.10438): per-channel activation maxima
  recorded at every quantizable encoder product over a few frames
  (``collect_activation_stats``) give per-input-channel factors
  (``compute_smoothing``) folded into the int8 weights, their inverse kept
  as ``act_smooth`` for the runtime divide;
* the neck's 3x3 convolutions go to shiftsum form (``QuantConv3x3``): one
  (ci -> 9 co) per-pixel product, dequantized per pixel, then the 9 shifted
  adds.

Quantized layers are modules (``QuantLinear``, ``QuantConv3x3``) that take
the place of the dense ones; ``linear_p``, ``conv1x1_p`` and ``conv3x3_p``
dispatch on the layer, so the call sites run either. Scales and
``act_smooth`` stay float32 whatever the model's dtype (``is_scale_key``).
``DPTModel.quantize_encoder_int8`` builds a quantized copy of a model."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Encoder products worth quantizing: every linear of a transformer block.
QUANTIZABLE = ("qkv", "proj", "fc1", "fc2", "w12", "w3")
INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA wants more than 16 rows


def is_scale_key(name: str) -> bool:
    """True for the state-dict names that must not follow the model's
    compute dtype: int8 dequant scales and SmoothQuant's ``act_smooth``
    (bf16-rounding them adds per-channel error, and ``act_smooth`` must
    cancel the factor folded into the weights exactly)."""
    return name.rsplit(".", 1)[-1] in ("weight_scale", "act_smooth")


# The active activation-stats collector (calibration runs only; None in serving).
_COLLECTOR: dict | None = None


@contextlib.contextmanager
def collect_activation_stats():
    """Record per-channel |activation| maxima at every quantizable encoder
    product (``linear_p`` with a name) during the forwards run inside the
    context. Yields {name: [amax of layer 0, amax of layer 1, ...]}, each a
    float32 numpy vector, maxed over all forwards."""
    global _COLLECTOR
    stats: dict[str, list] = {}
    _COLLECTOR = {"stats": stats, "cursor": {}}
    try:
        yield stats
    finally:
        _COLLECTOR = None


def _record_activation(name: str, x: torch.Tensor) -> None:
    if _COLLECTOR is None:
        return
    amax = x.detach().float().abs().amax(dim=tuple(range(x.dim() - 1))).cpu().numpy()
    per_name = _COLLECTOR["stats"].setdefault(name, [])
    cursor = _COLLECTOR["cursor"]
    i = cursor.get(name, 0)
    if i < len(per_name):
        per_name[i] = np.maximum(per_name[i], amax)  # max over calibration frames
    else:
        per_name.append(amax)
    cursor[name] = i + 1


def reset_collection_pass() -> None:
    """Mark the start of a new calibration frame: the layer cursor rewinds,
    so occurrence i of a name keeps meaning layer i."""
    if _COLLECTOR is not None:
        _COLLECTOR["cursor"] = {}


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: weight (..., out, in) -> (q8 of
    the same shape, float32 scale (..., out))."""
    w = weight.float()
    scale = w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def quantize_per_token(x: torch.Tensor, act_smooth: torch.Tensor | None = None):
    """x (..., in) -> (int8 of the same shape, float32 scale (..., 1)): one
    symmetric scale per row, after the optional ``act_smooth`` multiply."""
    xf = x.float()
    if act_smooth is not None:
        xf = xf * act_smooth.float()
    x_scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(xf / x_scale).clamp(-127, 127).to(torch.int8), x_scale


def int8_matmul(xq: torch.Tensor, weight_q8: torch.Tensor) -> torch.Tensor:
    """(M, in) int8 times (out, in) int8 transposed -> (M, out) int32, exact.
    The weight goes in as its column-major (in, out) view; fewer than 17
    rows are padded with zero rows, which are cut off again."""
    m = xq.shape[0]
    if m < INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq, weight_q8.t())[:m]


def linear_w8a8(x, weight_q8, weight_scale, bias=None, act_smooth=None):
    """x (..., in) bfloat16/float32 -> (..., out) in x's dtype: per-token int8
    activations times the int8 (out, in) weight, accumulated in int32 and
    dequantized by the row scale and the per-channel ``weight_scale``, bias
    added in float32, one cast at the end."""
    xq, x_scale = quantize_per_token(x, act_smooth)
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), weight_q8)
    y = acc.float().reshape(*x.shape[:-1], -1) * x_scale * weight_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


class QuantLinear(nn.Module):
    """An int8 linear: buffers ``weight_q8`` (out, in) int8, ``weight_scale``
    (out,) float32, ``bias`` (out,) or None and, for a calibrated layer,
    ``act_smooth`` (in,) float32. Made from a dense weight by
    ``from_weight`` (a linear's, or a 1x1 convolution's reshaped)."""

    def __init__(self, weight_q8, weight_scale, bias=None, act_smooth=None):
        super().__init__()
        self.register_buffer("weight_q8", weight_q8.contiguous())
        self.register_buffer("weight_scale", weight_scale.float())
        self.register_buffer("bias", bias)
        self.register_buffer("act_smooth", None if act_smooth is None else act_smooth.float())

    @classmethod
    def from_weight(cls, weight, bias=None, smoothing=None):
        """weight (out, in). smoothing: SmoothQuant factors (in,) from
        ``compute_smoothing``, folded into the weight's columns before it is
        quantized; their inverse becomes ``act_smooth``
        (x @ w.T == (x / s) @ (w * s).T)."""
        act_smooth = None
        if smoothing is not None:
            s = torch.as_tensor(smoothing, dtype=torch.float32, device=weight.device)
            weight = weight.float() * s
            act_smooth = 1.0 / s
        q, scale = quantize_weight(weight)
        return cls(q, scale, None if bias is None else bias.detach().clone(), act_smooth)

    def forward(self, x):
        return linear_w8a8(x, self.weight_q8, self.weight_scale, self.bias, self.act_smooth)


def shiftsum_taps_add(y9, bias=None):
    """Realign and add the 9 per-tap outputs of a 3x3 SAME convolution in
    shiftsum form: y9 (B, H, W, 9, co), taps in row-major (dy, dx) order;
    returns (B, H, W, co) in y9's dtype, the bias added last."""
    b, h, w, _, co = y9.shape
    y9 = F.pad(y9, (0, 0, 0, 0, 1, 1, 1, 1))
    out = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        sl = y9[:, dy : dy + h, dx : dx + w, tap]
        out = sl if out is None else out + sl
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def conv3x3_shiftsum_w8a8(x_nhwc, weight_q8, weight_scale, bias=None):
    """int8 3x3 SAME convolution in shiftsum form on (B, H, W, ci): the
    per-pixel int8 product (ci -> 9 co), dequantized with each pixel's own
    scale before the 9 shifted adds (a direct int8 convolution would need
    one scale shared by all 9 taps). Returns (B, H, W, co)."""
    b, h, w, _ = x_nhwc.shape
    y9 = linear_w8a8(x_nhwc, weight_q8, weight_scale)
    return shiftsum_taps_add(y9.reshape(b, h, w, 9, -1), bias)


class QuantConv3x3(nn.Module):
    """An int8 3x3 stride-1 SAME convolution in shiftsum form: buffers
    ``weight_q8`` (9 co, ci) int8, row (dy * 3 + dx) * co + o, and
    ``weight_scale`` (9 co,) float32; ``bias`` (co,). Runs on NCHW maps."""

    def __init__(self, weight_q8, weight_scale, bias=None):
        super().__init__()
        self.register_buffer("weight_q8", weight_q8.contiguous())
        self.register_buffer("weight_scale", weight_scale.float())
        self.register_buffer("bias", bias)

    @classmethod
    def from_conv(cls, conv: nn.Conv2d):
        co, ci = conv.weight.shape[:2]
        w9 = conv.weight.detach().permute(2, 3, 0, 1).reshape(9 * co, ci)  # OIHW -> (dy, dx, o) x i
        q, scale = quantize_weight(w9)
        return cls(q, scale, None if conv.bias is None else conv.bias.detach().clone())

    def forward(self, x_nchw):
        y = conv3x3_shiftsum_w8a8(x_nchw.permute(0, 2, 3, 1), self.weight_q8, self.weight_scale, self.bias)
        return y.permute(0, 3, 1, 2)


def linear_p(x, layer, name: str | None = None):
    """The encoder's linear: the int8 path for a ``QuantLinear``, the dense
    product otherwise. Under ``collect_activation_stats`` a named call
    records its input's per-channel maxima (the calibration tap)."""
    if name is not None:
        _record_activation(name, x)
    if isinstance(layer, QuantLinear):
        return layer(x)
    return F.linear(x, layer.weight, layer.bias)


def conv1x1_p(x_nchw, layer):
    """A 1x1 convolution on an NCHW map: per pixel over channels for a
    ``QuantLinear``, the dense convolution otherwise."""
    if isinstance(layer, QuantLinear):
        return layer(x_nchw.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    return F.conv2d(x_nchw, layer.weight, layer.bias)


def conv3x3_p(x_nchw, layer):
    """A 3x3 stride-1 SAME convolution on an NCHW map: shiftsum int8 for a
    ``QuantConv3x3``, the dense convolution otherwise."""
    if isinstance(layer, QuantConv3x3):
        return layer(x_nchw)
    return F.conv2d(x_nchw, layer.weight, layer.bias, padding=1)


def compute_smoothing(weights: dict, act_stats: dict, subset=QUANTIZABLE, alpha: float = 0.5) -> dict:
    """SmoothQuant migration factors s_c = act_amax^alpha / weight_amax^(1-alpha)
    per layer and input channel (arXiv:2211.10438 eq. 4). weights: {name:
    (L, out, in) array} of the dense weights; act_stats: from
    ``collect_activation_stats``. Returns {name: (L, in) float32 array},
    normalized so the median channel is untouched and clipped to [1e-2, 1e2]."""
    smoothing = {}
    for name in subset:
        if name not in weights or name not in act_stats:
            continue
        w = np.asarray(weights[name], np.float32)
        w_amax = np.maximum(np.abs(w).max(axis=-2), 1e-8)  # (L, in)
        a_amax = np.maximum(np.stack(act_stats[name], axis=0), 1e-8)  # (L, in)
        if a_amax.shape != w_amax.shape:
            raise ValueError(f"{name}: activation stats {a_amax.shape} do not match the weights' inputs {w_amax.shape}")
        s = (a_amax**alpha) / (w_amax ** (1.0 - alpha))
        s = s / np.median(s, axis=-1, keepdims=True)
        smoothing[name] = np.clip(s, 1e-2, 1e2).astype(np.float32)
    return smoothing


def encoder_linears(block: nn.Module) -> dict:
    """{name: parent module} of the quantizable linears of one encoder block
    (a DINOv2/BEiT ``Block``: attn.qkv, attn.proj, mlp.fc1/fc2 or w12/w3;
    a SwinV2 block: fc1, fc2 and its window qkv and proj)."""
    found = {}
    for parent in (block, getattr(block, "attn", None), getattr(block, "mlp", None)):
        if parent is None:
            continue
        for name in QUANTIZABLE:
            if isinstance(getattr(parent, name, None), (nn.Linear, QuantLinear)):
                found[name] = parent
    return found


def stacked_weights(blocks, subset) -> dict:
    """{name: (L, out, in) float32 numpy array} of each ``subset`` linear
    over the blocks: what ``compute_smoothing`` reads."""
    per_name: dict[str, list] = {}
    for block in blocks:
        for name, parent in encoder_linears(block).items():
            if name in subset:
                per_name.setdefault(name, []).append(getattr(parent, name).weight.detach().float().cpu().numpy())
    return {name: np.stack(ws) for name, ws in per_name.items()}


def quantize_blocks(blocks, subset, smoothing: dict | None = None) -> None:
    """In place: every ``subset`` linear of each block becomes a
    ``QuantLinear``; ``smoothing[name][i]`` (from ``compute_smoothing``)
    folds into block i's weights."""
    for i, block in enumerate(blocks):
        for name, parent in encoder_linears(block).items():
            layer = getattr(parent, name)
            if name not in subset or isinstance(layer, QuantLinear):
                continue
            s = smoothing[name][i] if smoothing is not None and name in smoothing else None
            setattr(parent, name, QuantLinear.from_weight(layer.weight.detach(), layer.bias, s))


def quantize_neck(net: nn.Module) -> None:
    """In place: the whole neck's int8 tier. Each reassembly stage's 1x1
    projection and BEiT's readout projection become ``QuantLinear``s; the
    fusion blocks' residual-unit 3x3 convolutions and the head's conv_in
    and conv_mid become ``QuantConv3x3``s, the fusion 1x1 outputs
    ``QuantLinear``s. The head's final 1x1 projection (32 -> 1) stays dense.
    A stage without a projection (SwinV2's fuse-only stages) is left as is;
    so are the resample and fuse convolutions."""
    for stage in net.reassemble:
        proj = getattr(stage, "proj", None)
        if isinstance(proj, nn.Conv2d):
            stage.proj = QuantLinear.from_weight(proj.weight.detach().flatten(1), proj.bias)
        readout = getattr(stage, "readout", None)
        if isinstance(readout, nn.Linear):
            stage.readout = QuantLinear.from_weight(readout.weight.detach(), readout.bias)
    for block in net.fusion:
        for unit in (block.res1, block.res2):
            if unit is not None:
                unit.conv1, unit.conv2 = QuantConv3x3.from_conv(unit.conv1), QuantConv3x3.from_conv(unit.conv2)
        block.out = QuantLinear.from_weight(block.out.weight.detach().flatten(1), block.out.bias)
    head = net.head
    head.conv_in, head.conv_mid = QuantConv3x3.from_conv(head.conv_in), QuantConv3x3.from_conv(head.conv_mid)
