"""SwinV2 hierarchical image encoder (MiDaS v3.1).

The counterpart of ``muggled_dpt_tpu/models/swinv2.py``: 4 stages with a
patch merge between them; post-norm blocks (attention -> norm1 -> +residual,
MLP -> norm2 -> +residual) whose LayerNorms use eps 1e-5; windowed scaled
cosine attention (l2-normalized q and k, a learned per-head logit scale
stored already clamped and exponentiated, q and v biases only) with a
continuous-position bias (CPB: an MLP 2 -> 512 -> H over a log-scaled
coordinate table, gathered per window and passed through 16 * sigmoid); odd
blocks shift their windows by a cyclic roll where the grid exceeds the window,
with a 0 / -100 mask between the rolled regions; the window size of each grid
comes from a host-side divisor search. On the kernel path each post-norm
residual, x + LayerNorm(h), is one ``postnorm_residual`` launch
(``ops/kernels/postnorm_residual.py``); the attention half's reads proj's
output in window order, so the window merge and the roll back are folded
into it. The plain path, capture and training keep the composite.

Tokens stay channels-last, (B, H, W, C), as in the JAX package: the window
partition, the rolls and every linear act on the last axis. The blocks are an
``nn.ModuleList`` per stage walked by a Python loop.

Per-grid constants (the CPB of every block and the shift mask of every
shifting stage) are built on the device from aranges: once per grid into the
facade's aux cache (``compute_cpb_stack``), or, with caching off, inside each
forward and dropped after it. Nothing is cached outside the aux.

Each block opens, in order (``utils/observability.py``): a ``window`` span
over the roll and the window partition before the qkv projection, a
``cosine`` span from the qkv output to the window-attention call (the
l2-normalize of q and k with the logit scale folded into q: on the kernel
path one ``cosine_qk`` launch, on the plain path the float32 composite), an
``attention`` span around that call, a second ``window`` span over the
window merge and the roll back after ``proj`` (on the kernel path the norm1
residual's ``postnorm_residual`` launch, which does both; on the plain path
the copies, the norm1 residual following outside any span), and an ``mlp``
span around its MLP half and the norm2 residual. Each patch merge opens a
``merge`` span."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.kernels import library  # noqa: F401  (registers torch.ops.mdpt.*)
from ..ops.kernels.cosine_qk import cosine_normalize, cosine_qk
from ..ops.kernels.postnorm_residual import postnorm_residual
from ..ops.kernels.window_attention import window_attention as window_attention_kernel
from ..ops.nn import layer_norm, linear, mlp_gelu
from ..ops.collectives import copy_to_model, row_linear
from ..utils.observability import trace_span

SWIN_LN_EPS = 1e-5
CPB_HIDDEN = 512  # width of the CPB MLP's hidden layer
SHIFT_MASK_VALUE = -100.0  # between tokens of different rolled regions


def window_plan(patch_grid_hw, target_window_hw):
    """Window and shift sizes for a grid, the reference's nearest-divisor
    search in [win/2, 2win). Host ints: ((win_h, win_w), (shift_h, shift_w))."""
    gh, gw = (int(g) for g in patch_grid_hw)
    th, tw = (int(t) for t in target_window_hw)

    def fit(win, grid):
        win = min(win, grid)
        if grid % win != 0:
            divisors = [d for d in range(win // 2, 2 * win) if grid % d == 0]
            win = min(divisors, key=lambda d: abs(grid - d))
        return win

    win_h, win_w = fit(th, gh), fit(tw, gw)
    shift_h = 0 if gh <= win_h else win_h // 2
    shift_w = 0 if gw <= win_w else win_w // 2
    return (win_h, win_w), (shift_h, shift_w)


def partition_windows(x, window_hw):
    """(B, H, W, C) -> (B, nW, A, C), windows in row-major order."""
    b, gh, gw, c = x.shape
    wh, ww = window_hw
    x = x.reshape(b, gh // wh, wh, gw // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (gh // wh) * (gw // ww), wh * ww, c)


def merge_windows(x, window_hw, grid_hw):
    """(B, nW, A, C) -> (B, H, W, C), the inverse of ``partition_windows``."""
    b, _, _, c = x.shape
    (wh, ww), (gh, gw) = window_hw, grid_hw
    x = x.reshape(b, gh // wh, gw // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh, gw, c)


def shift_mask(patch_grid_hw, window_hw, shift_hw, device=None, dtype=torch.float32):
    """(nW, A, A) mask of 0 / -100 between the 3x3 regions of a rolled grid,
    built on ``device``; None where nothing shifts."""
    (gh, gw), (wh, ww), (sh, sw) = patch_grid_hw, window_hw, shift_hw
    if sh == 0 and sw == 0:
        return None

    def bands(size, win, shift):  # 0, 1, 2 for [0, size-win), [size-win, size-shift), [size-shift, size)
        i = torch.arange(size, device=device)
        return (i >= size - win).int() + (i >= size - shift).int()

    region = bands(gh, wh, sh)[:, None] * 3 + bands(gw, ww, sw)[None, :]
    region = partition_windows(region[None, :, :, None], (wh, ww))[0, :, :, 0]  # (nW, A)
    differs = region[:, None, :] != region[:, :, None]
    return torch.where(differs, SHIFT_MASK_VALUE, 0.0).to(dtype)


def cpb_coords_table(window_hw, pretrained_window_size, device=None) -> torch.Tensor:
    """Log-scaled normalized relative coordinates, ((2h-1)(2w-1), 2) float32.
    The coordinates are divided by the pretrained window minus 1 (the own
    window where that is None), then scaled sign(t) log2(8|t| + 1) / 3."""
    wh, ww = window_hw
    ys = torch.arange(-(wh - 1), wh, dtype=torch.float32, device=device)
    xs = torch.arange(-(ww - 1), ww, dtype=torch.float32, device=device)
    div_h = wh if pretrained_window_size is None else pretrained_window_size
    div_w = ww if pretrained_window_size is None else pretrained_window_size
    yy, xx = torch.meshgrid(ys / max(div_h - 1, 1), xs / max(div_w - 1, 1), indexing="ij")
    table = torch.stack([yy, xx], dim=-1)
    scaled = torch.sign(table) * torch.log2(torch.abs(table * 8.0) + 1.0)
    # the JAX package divides by log2(8) in float64 (a numpy scalar) and rounds once
    return (scaled.double() / math.log2(8.0)).float().reshape(-1, 2)


def cpb_index(window_hw, device=None) -> torch.Tensor:
    """(A, A) int64 row of the coordinate table for each (query, key) pair."""
    wh, ww = window_hw
    ys = torch.arange(wh, device=device).repeat_interleave(ww)
    xs = torch.arange(ww, device=device).repeat(wh)
    return (ys[:, None] - ys[None, :] + wh - 1) * (2 * ww - 1) + (xs[:, None] - xs[None, :] + ww - 1)


def cpb_bias(block, window_hw, pretrained_window_size, table=None, index=None) -> torch.Tensor:
    """One block's continuous position bias, (H, A, A) float32:
    16 * sigmoid(MLP(coords))[index]. The MLP's second layer has no bias.
    ``table`` and ``index``: the window's ``cpb_coords_table`` and
    ``cpb_index`` where the caller has them; built here otherwise."""
    device = block.cpb0.weight.device
    table = cpb_coords_table(window_hw, pretrained_window_size, device) if table is None else table
    index = cpb_index(window_hw, device) if index is None else index
    hidden = torch.relu(linear(table, block.cpb0.weight.float(), block.cpb0.bias.float()))
    lut = linear(hidden, block.cpb1.weight.float())  # (R, H)
    return 16.0 * torch.sigmoid(lut[index].permute(2, 0, 1))


def stage_grids(patch_grid_hw):
    """The patch grid of each of the 4 stages: halved by every patch merge."""
    gh, gw = patch_grid_hw
    return [(gh >> s, gw >> s) for s in range(4)]


def compute_cpb_stack(encoder, patch_grid_hw, dtype=torch.float32):
    """Every block's CPB and every stage's shift mask for one patch grid, the
    facade's per-grid aux: per stage {"cpb": (L, H, A, A), one CPB per
    block, "mask": the (nW, A, A) shift mask, or None where the stage does
    not shift}, both in ``dtype``."""
    device = encoder.merges[0].reduction.weight.device
    aux = []
    for blocks, pws, grid in zip(encoder.stages, encoder.pretrained_window_sizes, stage_grids(patch_grid_hw)):
        window_hw, shift_hw = window_plan(grid, encoder.window_size_hw)
        table, index = cpb_coords_table(window_hw, pws, device), cpb_index(window_hw, device)
        area = window_hw[0] * window_hw[1]
        cpb = torch.empty((len(blocks), blocks[0].num_heads, area, area), dtype=dtype, device=device)
        for i, block in enumerate(blocks):
            cpb[i] = cpb_bias(block, window_hw, pws, table, index)
        aux.append({"cpb": cpb, "mask": shift_mask(grid, window_hw, shift_hw, device, dtype)})
    return aux


def aux_bytes(config: dict, patch_grid_hw, bytes_per_element: int = 4) -> int:
    """Device bytes of ``compute_cpb_stack``'s result for a grid: each stage's
    (L, H, A, A) CPB stack and, where the stage shifts, its (nW, A, A) mask."""
    total = 0
    for s, (gh, gw) in enumerate(stage_grids(patch_grid_hw)):
        (wh, ww), (sh, sw) = window_plan((gh, gw), config["window_size_hw"])
        area = wh * ww
        total += config["layers_per_stage"][s] * config["heads_per_stage"][s] * area * area
        if sh or sw:
            total += (gh // wh) * (gw // ww) * area * area
    return total * bytes_per_element


def aux_build_bytes(config: dict, patch_grid_hw, bytes_per_element: int = 4) -> int:
    """Peak device bytes of ``compute_cpb_stack``: what it keeps plus the
    largest stage's transients (one block's float32 CPB, its MLP over the
    coordinate table and the int64 index)."""
    transient = 0
    for s, grid in enumerate(stage_grids(patch_grid_hw)):
        (wh, ww), _ = window_plan(grid, config["window_size_hw"])
        area, rows = wh * ww, (2 * wh - 1) * (2 * ww - 1)
        transient = max(transient, 4 * config["heads_per_stage"][s] * area * area + 8 * area * area + 4 * rows * CPB_HIDDEN)
    return aux_bytes(config, patch_grid_hw, bytes_per_element) + transient


class SwinBlock(nn.Module):
    """Post-norm SwinV2 block: windowed cosine attention with the CPB bias,
    then an MLP, each followed by its LayerNorm before the residual add."""

    # tensor parallelism: the model groups of a split qkv/proj pair and fc1/fc2 pair (parallel/tensor.py)
    attn_group = None
    mlp_group = None

    def __init__(self, features: int, num_heads: int, use_kernel: bool = True, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernel = use_kernel
        self.qkv = nn.Linear(features, 3 * features, device=device)  # rows [q|k|v][head][dim]; k bias zero
        self.logit_scale = nn.Parameter(torch.empty(num_heads, device=device))  # exp(min(ls, log 100))
        self.cpb0 = nn.Linear(2, CPB_HIDDEN, device=device)
        self.cpb1 = nn.Linear(CPB_HIDDEN, num_heads, bias=False, device=device)
        self.proj = nn.Linear(features, features, device=device)
        self.norm1 = nn.LayerNorm(features, eps=SWIN_LN_EPS, device=device)
        self.fc1 = nn.Linear(features, 4 * features, device=device)
        self.fc2 = nn.Linear(4 * features, features, device=device)
        self.norm2 = nn.LayerNorm(features, eps=SWIN_LN_EPS, device=device)

    def fixed_zero_grads(self) -> list:
        """(parameter, boolean mask) pairs of entries the original model does
        not have: SwinV2 has no key bias, so the k third of the qkv bias
        ([q|k|v][head][dim]) is a fixed zero. Training discards their
        gradients, so they stay zero."""
        mask = torch.zeros(3, self.qkv.out_features // 3, dtype=torch.bool, device=self.qkv.bias.device)
        mask[1] = True
        return [(self.qkv.bias, mask.reshape(-1))]

    def attention(self, x, window_hw, shift_hw, cpb, mask, capture: bool = False):
        """Windowed attention on (B, H, W, C) tokens. shift_hw: the roll, (0,
        0) for none; cpb (H, A, A) and mask (nW, A, A) or None, float32 or
        the model's dtype. capture=True takes the plain path whatever
        ``use_kernel`` says and returns (out, weights): the (B, nW, H, A, A)
        float32 softmax weights, in the rolled window frame. Under tensor
        parallelism (``attn_group``) the block holds its rank's
        ``num_heads`` heads: their qkv rows of each third, logit scales and
        CPB rows, and proj's matching columns."""
        out, weights = self.attention_windows(x, window_hw, shift_hw, cpb, mask, capture)
        with trace_span("window"):
            out = merge_windows(out, window_hw, (x.shape[1], x.shape[2]))
            if shift_hw != (0, 0):
                out = torch.roll(out, shifts=shift_hw, dims=(1, 2))
        return (out, weights) if capture else out

    def attention_windows(self, x, window_hw, shift_hw, cpb, mask, capture: bool = False):
        """``attention`` up to proj: (proj's (B, nW, A, C) output in the
        rolled window order, the capture's weights or None)."""
        b = x.shape[0]
        heads = self.num_heads
        shifting = shift_hw != (0, 0)
        with trace_span("window"):
            if shifting:
                x = torch.roll(x, shifts=(-shift_hw[0], -shift_hw[1]), dims=(1, 2))
            x = partition_windows(x, window_hw)
        nw, area = x.shape[1], x.shape[2]
        group = self.attn_group
        if group is not None:
            x = copy_to_model(x, group)
        qkv = linear(x, self.qkv.weight, self.qkv.bias).reshape(b, nw, area, 3, heads, -1)
        q, k, v = qkv.unbind(3)
        kernel = self.use_kernel and not capture
        # while torch.export traces, the kernels are operator nodes (ops/kernels/library.py)
        exporting = kernel and torch.compiler.is_exporting()
        with trace_span("cosine"):
            if kernel:
                # the logit scale folded into q: the kernel adds the biases to q . k
                qf, kf = (torch.ops.mdpt.cosine_qk if exporting else cosine_qk)(q, k, self.logit_scale)
            else:
                qf, kf = cosine_normalize(q), cosine_normalize(k)
                scale = self.logit_scale.float()
        weights = None
        if kernel:
            attend = torch.ops.mdpt.window_attention if exporting else window_attention_kernel
            with trace_span("attention"):
                out = attend(qf, kf, v, cpb, mask)
        else:
            with trace_span("attention"):
                logits = torch.einsum("bwnhd,bwmhd->bwhnm", qf, kf) * scale.reshape(1, 1, heads, 1, 1)
                logits = logits + cpb.float()[None, None]
                if mask is not None:
                    logits = logits + mask.float()[None, :, None]
                weights = torch.softmax(logits, dim=-1)
                out = torch.einsum("bwhnm,bwmhd->bwnhd", weights.to(v.dtype), v)
        out = out.reshape(b, nw, area, -1)
        out = linear(out, self.proj.weight, self.proj.bias) if group is None else row_linear(out, self.proj, group)
        return out, weights

    def _after_attention(self, x, h):
        """The rest of the block on its attention output h: the norm1
        residual, then the MLP's norm2 residual in an ``mlp`` span."""
        x = x + layer_norm(h, self.norm1.weight, self.norm1.bias, eps=SWIN_LN_EPS)
        with trace_span("mlp"):
            h = mlp_gelu(x, self.fc1, self.fc2, self.mlp_group)  # int8 tier: fc1 and fc2 only, qkv and proj stay dense
            return x + layer_norm(h, self.norm2.weight, self.norm2.bias, eps=SWIN_LN_EPS)

    def forward(self, x, window_hw, shift_hw, cpb, mask=None):
        if not self.use_kernel:
            return self._after_attention(x, self.attention(x, window_hw, shift_hw, cpb, mask))
        # each post-norm residual one launch; the norm1 one merges proj's windows and rolls them back as it reads
        residual = torch.ops.mdpt.postnorm_residual if torch.compiler.is_exporting() else postnorm_residual
        h, _ = self.attention_windows(x, window_hw, shift_hw, cpb, mask)
        with trace_span("window"):
            x = residual(x, h, self.norm1.weight, self.norm1.bias, window_hw, shift_hw)
        with trace_span("mlp"):
            h = mlp_gelu(x, self.fc1, self.fc2, self.mlp_group)  # int8 tier: fc1 and fc2 only, qkv and proj stay dense
            return residual(x, h, self.norm2.weight, self.norm2.bias)

    def forward_capture(self, x, window_hw, shift_hw, cpb, mask=None):
        """The block on the plain attention path: (tokens, (B, nW, H, A, A) float32 weights)."""
        h, weights = self.attention(x, window_hw, shift_hw, cpb, mask, capture=True)
        return self._after_attention(x, h), weights


class PatchMerge(nn.Module):
    """2x2 decimate-concat in the order top-left, bottom-left, top-right,
    bottom-right -> Linear 4C -> C' (no bias) -> LayerNorm."""

    def __init__(self, features: int, out_features: int, device=None):
        super().__init__()
        self.reduction = nn.Linear(4 * features, out_features, bias=False, device=device)
        self.norm = nn.LayerNorm(out_features, eps=SWIN_LN_EPS, device=device)

    def forward(self, x):
        with trace_span("merge"):
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            return layer_norm(linear(x, self.reduction.weight), self.norm.weight, self.norm.bias, eps=SWIN_LN_EPS)


class SwinV2Encoder(nn.Module):
    """4 stages of SwinV2 blocks with patch merges between them; returns the
    (B, H, W, C) tokens after each stage."""

    def __init__(self, config: dict, use_kernel: bool = True, device=None):
        super().__init__()
        feats, heads = config["features_per_stage"], config["heads_per_stage"]
        self.window_size_hw = tuple(int(w) for w in config["window_size_hw"])
        self.pretrained_window_sizes = tuple(config["pretrained_window_sizes_per_stage"])
        self.stages = nn.ModuleList(
            nn.ModuleList(SwinBlock(feats[s], heads[s], use_kernel, device=device) for _ in range(n))
            for s, n in enumerate(config["layers_per_stage"])
        )
        self.merges = nn.ModuleList(PatchMerge(feats[s], feats[s + 1], device=device) for s in range(3))

    def block_plans(self, s: int, grid_hw, aux=None, device=None):
        """Each block of stage ``s`` on a (gh, gw) grid with its arguments
        after the tokens: (block, (window_hw, shift_hw, cpb, mask)); odd
        blocks shift where the grid exceeds the window. aux: the grid's
        ``compute_cpb_stack``, or None to build the constants on ``device``
        in float32: the stage's mask, coordinate table and index once, each
        block's CPB only when the loop asks for it, all dropped after use."""
        window_hw, shift_hw = window_plan(grid_hw, self.window_size_hw)
        if aux is None:
            pws = self.pretrained_window_sizes[s]
            table, index = cpb_coords_table(window_hw, pws, device), cpb_index(window_hw, device)
            mask = shift_mask(grid_hw, window_hw, shift_hw, device)
        else:
            mask = aux[s]["mask"]
        for i, block in enumerate(self.stages[s]):
            cpb = cpb_bias(block, window_hw, pws, table, index) if aux is None else aux[s]["cpb"][i]
            shifting = i % 2 == 1 and mask is not None
            yield block, (window_hw, shift_hw if shifting else (0, 0), cpb, mask if shifting else None)

    def stage_input(self, s: int, x):
        """Stage ``s``'s input from the (B, H, W, C) tokens before it: the
        patch merge of the last stage's output, the tokens themselves at stage 0."""
        return x if s == 0 else self.merges[s - 1](x)

    def forward(self, x, aux=None):
        """x: (B, gh, gw, F) patch tokens. aux: the grid's
        ``compute_cpb_stack``, or None to build the constants inside the
        forward (``block_plans``). Returns the (B, H, W, C) tokens after
        each stage."""
        outputs = []
        for s in range(len(self.stages)):
            x = self.stage_input(s, x)
            for block, args in self.block_plans(s, (x.shape[1], x.shape[2]), aux, x.device):
                x = block(x, *args)
            outputs.append(x)
        return tuple(outputs)

    def forward_capture(self, x, aux=None):
        """``forward`` on the plain attention path, keeping what each block
        made: (the 4 stage outputs, {"block_tokens": [(B, gh*gw, C)] per
        block, "attention": [(B, nW, H, A, A) float32] per block}), the
        grid, channels and windows those of the block's stage."""
        internals = {"block_tokens": [], "attention": []}
        outputs = []
        for s in range(len(self.stages)):
            x = self.stage_input(s, x)
            for block, args in self.block_plans(s, (x.shape[1], x.shape[2]), aux, x.device):
                x, weights = block.forward_capture(x, *args)
                internals["block_tokens"].append(x.reshape(x.shape[0], -1, x.shape[-1]))
                internals["attention"].append(weights)
            outputs.append(x)
        return tuple(outputs), internals
