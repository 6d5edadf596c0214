"""Emit the port's DPT forwards as ONNX graphs.

The counterpart of the JAX package's ``onnx_export/emit_dpt.py``: users with
onnxruntime pipelines get a runnable ``.onnx`` of the depth model, with no
``onnx`` package and no torch exporter involved. The graph is emitted
directly from the port's modules: every node mirrors the corresponding op
of ``models/{depth_anything,dinov2,beit,swinv2}.py``, ``models/dpt_neck.py``
and ``ops/nn.py``, and the numpy evaluator (``evaluate.py``) runs the graph
against the live float32 model (``experiments/export_onnx.py``).

Weights are read in torch layouts and written in the JAX emitter's: a
Linear's (out, in) weight becomes a MatMul's (in, out) initializer, OIHW
convolutions and (in, out, k, k) transposed convolutions go as they are,
and the fused qkv rows are head-major ([head][q|k|v][dim],
``checkpoints/convert_common.py:qkv_head_major``), so the columns of the
qkv MatMul are the ones the JAX emitter writes. Every weight is exported in
float32, whatever the model's dtype. The dense model only: an int8 tier's
``QuantLinear`` layers are refused.

Scope: the Depth-Anything families (V1 / V2 / V2-metric / SwiGLU giant),
MiDaS v3.1 BEiT and MiDaS v3.1 SwinV2. Input is the model's normalized
(1, 3, H, W) float32 tensor (the ``DPTModel.forward`` contract); output is
depth (1, H', W'). By default shapes are fixed at export time: grid-dependent
tensors (the resized position embedding, BEiT's per-layer bias, SwinV2's
CPB and shift masks) are evaluated for the grid and baked as initializers,
so mind the artifact at large grids (``models/beit.py:calculate_bias_bytes``).
``dynamic=True`` (Depth-Anything and BEiT) moves them in-graph instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.resize import resize_bicubic_hwc, resize_output_size
from .builder import GraphBuilder


def _np(a) -> np.ndarray:
    """A tensor (or array) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def _kernel(layer) -> np.ndarray:
    """A Linear's (out, in) weight as the (in, out) MatMul operand."""
    if not isinstance(layer, nn.Linear):
        raise NotImplementedError(f"ONNX export takes the dense model only, got {type(layer).__name__}")
    return _np(layer.weight).T


def _bias(layer):
    return None if layer.bias is None else _np(layer.bias)


def _gelu_erf(g: GraphBuilder, x: str) -> str:
    """0.5 * x * (1 + erf(x / sqrt(2))) — the exact (f32-parity) GELU form
    (ops/nn.py:gelu)."""
    inv_sqrt2 = g.init("inv_sqrt2", np.float32(1.0 / math.sqrt(2.0)))
    one = g.init("one", np.float32(1.0))
    half = g.init("half", np.float32(0.5))
    e = g.op("Erf", [g.op("Mul", [x, inv_sqrt2])])
    return g.op("Mul", [g.op("Mul", [x, g.op("Add", [e, one])]), half])


def _linear(g: GraphBuilder, x: str, kernel: np.ndarray, bias: np.ndarray | None, hint: str) -> str:
    y = g.op("MatMul", [x, g.init(hint + "_w", kernel)])
    if bias is not None:
        y = g.op("Add", [y, g.init(hint + "_b", bias)])
    return y


def _linear_layer(g: GraphBuilder, x: str, layer, hint: str) -> str:
    return _linear(g, x, _kernel(layer), _bias(layer), hint)


def _conv(g: GraphBuilder, x: str, conv, hint: str, stride=1, pad=0) -> str:
    """NCHW Conv from an ``nn.Conv2d`` (OIHW weight, ops/nn.py:conv2d); the
    1x1 convolutions (reassembly projections, fusion outputs, the head's
    projection) too."""
    if not isinstance(conv, nn.Conv2d):
        raise NotImplementedError(f"ONNX export takes the dense model only, got {type(conv).__name__}")
    w = _np(conv.weight)
    ins = [x, g.init(hint + "_w", w)]
    if conv.bias is not None:
        ins.append(g.init(hint + "_b", _np(conv.bias)))
    kh, kw = w.shape[2:]
    return g.op(
        "Conv", ins, strides=[stride, stride], pads=[pad, pad, pad, pad],
        kernel_shape=[kh, kw], dilations=[1, 1], group=1,
    )


def _resize(g: GraphBuilder, x: str, out_hw: tuple[int, int], in_chw: tuple[int, int, int]) -> str:
    """Bilinear align_corners resize (the fusion and head upsamples,
    models/dpt_neck.py:FusionBlock, Head)."""
    sizes = g.init("sizes", np.asarray([1, in_chw[0], out_hw[0], out_hw[1]], np.int64))
    return g.op(
        "Resize", [x, "", "", sizes], mode="linear",
        coordinate_transformation_mode="align_corners",
    )


def _resize_scale(g: GraphBuilder, x: str, scale: float) -> str:
    """Scale-driven bilinear align_corners resize for the dynamic-axes graphs:
    ONNX computes output = floor(in * scale), the same rule as
    ops/resize.py:resize_output_size (torch's interpolate(scale_factor=s))."""
    scales = g.init("scales", np.asarray([1.0, 1.0, scale, scale], np.float32))
    return g.op(
        "Resize", [x, "", scales], mode="linear",
        coordinate_transformation_mode="align_corners",
    )


def _slice(g: GraphBuilder, x: str, starts, ends, axes) -> str:
    i64 = lambda hint, v: g.init(hint, np.asarray(v, np.int64))
    return g.op("Slice", [x, i64("starts", starts), i64("ends", ends), i64("axes", axes)])


def _reshape(g: GraphBuilder, x: str, shape) -> str:
    return g.op("Reshape", [x, g.init("shape", np.asarray(shape, np.int64))])


_I32MAX = 2**31 - 1


def _squeeze(g: GraphBuilder, x: str, axis: int) -> str:
    return g.op("Squeeze", [x, g.init("sq_axes", np.asarray([axis], np.int64))])


def _attention(g: GraphBuilder, x: str, attn, heads: int, c: int, bias=None) -> str:
    """Fused-QKV self-attention with the head-major column layout
    (ops/nn.py:self_attention). ``attn`` holds the ``qkv`` and ``proj``
    Linears. bias: optional (1, H, N, N) additive logit bias — a numpy array
    baked as an initializer (BEiT fixed-shape export) or the NAME of a graph
    tensor computed at runtime (BEiT dynamic export). Shape-agnostic over
    batch and token count (0/-1 Reshapes + Squeeze), so the same emitter
    serves the fixed-shape and dynamic-axes graphs."""
    d = c // heads
    qkv = _linear_layer(g, x, attn.qkv, "qkv")
    qkv = _reshape(g, qkv, [0, -1, heads, 3, d])
    qkv = g.op("Transpose", [qkv], perm=[3, 0, 2, 1, 4])  # (3, B, H, N, D)
    parts = []
    for i in range(3):
        p = _slice(g, qkv, [i], [i + 1], [0])
        parts.append(_squeeze(g, p, 0))  # (B, H, N, D)
    q, k, v = parts
    scale = g.init("attn_scale", np.float32(d ** -0.5))
    q = g.op("Mul", [q, scale])  # q pre-scaled
    kt = g.op("Transpose", [k], perm=[0, 1, 3, 2])  # (B, H, D, N)
    logits = g.op("MatMul", [q, kt])  # (B, H, N, N)
    if bias is not None:
        bias_name = bias if isinstance(bias, str) else g.init("attn_bias", np.asarray(bias, np.float32))
        logits = g.op("Add", [logits, bias_name])
    weights = g.op("Softmax", [logits], axis=-1)
    out = g.op("MatMul", [weights, v])  # (B, H, N, D)
    out = g.op("Transpose", [out], perm=[0, 2, 1, 3])
    out = _reshape(g, out, [0, 0, -1])  # (B, N, C)
    return _linear_layer(g, out, attn.proj, "attn_proj")


def _mlp(g: GraphBuilder, x: str, mlp) -> str:
    """The block MLP: SwiGLU (``w12``, ``w3``: w3(silu(a) * b), [a|b] = w12 x,
    ops/nn.py:mlp_swiglu) or GELU (``fc1``, ``fc2``)."""
    if hasattr(mlp, "w12"):
        h = _linear_layer(g, x, mlp.w12, "w12")
        hidden = mlp.w12.weight.shape[0] // 2
        a = _slice(g, h, [0], [hidden], [-1])
        b = _slice(g, h, [hidden], [_I32MAX], [-1])
        silu = g.op("Mul", [a, g.op("Sigmoid", [a])])
        return _linear_layer(g, g.op("Mul", [silu, b]), mlp.w3, "w3")
    h = _linear_layer(g, x, mlp.fc1, "fc1")
    return _linear_layer(g, _gelu_erf(g, h), mlp.fc2, "fc2")


def _layer_norm(g: GraphBuilder, x: str, norm: nn.LayerNorm, hint: str) -> str:
    """An ``nn.LayerNorm`` over the last axis with its own eps: the ViT
    families' 1e-6, SwinV2's 1e-5 (models/swinv2.py:SWIN_LN_EPS)."""
    return g.op(
        "LayerNormalization",
        [x, g.init(hint + "_s", _np(norm.weight)), g.init(hint + "_b", _np(norm.bias))],
        axis=-1, epsilon=float(norm.eps),
    )


def _slice_step(g: GraphBuilder, x: str, starts, ends, axes, steps) -> str:
    i64 = lambda hint, v: g.init(hint, np.asarray(v, np.int64))
    return g.op(
        "Slice",
        [x, i64("starts", starts), i64("ends", ends), i64("axes", axes), i64("steps", steps)],
    )


def _roll_axis(g: GraphBuilder, x: str, shift: int, size: int, axis: int) -> str:
    """torch.roll on one axis as Slice+Concat (ONNX has no Roll). Positive
    shift moves content toward higher indices (models/swinv2.py:SwinBlock.attention
    cyclic shifting)."""
    s = shift % size
    if s == 0:
        return x
    lead = _slice(g, x, [size - s], [_I32MAX], [axis])
    tail = _slice(g, x, [0], [size - s], [axis])
    return g.op("Concat", [lead, tail], axis=axis)


def _l2_normalize(g: GraphBuilder, x: str, hint: str) -> str:
    """x / sqrt(sum(x^2, -1) + 1e-12) — the cosine-attention q/k normalize
    (models/swinv2.py:cosine_normalize)."""
    sq = g.op("Mul", [x, x])
    ss = g.op("ReduceSum", [sq, g.init(hint + "_axes", np.asarray([-1], np.int64))], keepdims=1)
    denom = g.op("Sqrt", [g.op("Add", [ss, g.init(hint + "_eps", np.float32(1e-12))])])
    return g.op("Div", [x, denom])


def _rcu(g: GraphBuilder, x: str, unit, hint: str) -> str:
    """ReLU-Conv3x3-ReLU-Conv3x3 + skip (models/dpt_neck.py:ResidualConvUnit)."""
    h = g.op("Relu", [x])
    h = _conv(g, h, unit.conv1, hint + "_c1", pad=1)
    h = g.op("Relu", [h])
    h = _conv(g, h, unit.conv2, hint + "_c2", pad=1)
    return g.op("Add", [h, x])


def _upsample_projection(g: GraphBuilder, x: str, block, in_chw, hint: str, dyn: bool = False) -> tuple[str, tuple | None]:
    """RCU -> 2x bilinear align_corners -> 1x1 conv (models/dpt_neck.py:FusionBlock).
    dyn=True emits a scale-driven Resize and returns shape None."""
    x = _rcu(g, x, block.res2, hint + "_res2")
    if dyn:
        x = _resize_scale(g, x, 2.0)
        x = _conv(g, x, block.out, hint + "_out")
        return x, None
    c, h, w = in_chw
    oh, ow = resize_output_size((h, w), 2.0)
    x = _resize(g, x, (oh, ow), in_chw)
    x = _conv(g, x, block.out, hint + "_out")
    return x, (int(block.out.weight.shape[0]), oh, ow)


def _emit_neck(g: GraphBuilder, net, stage_tokens, c: int, gh: int, gw: int, grid_shape: str | None = None) -> tuple[str, tuple[int, int] | None]:
    """Reassembly -> fusion -> head, shared across the ViT families
    (models/dpt_neck.py:ReassembleStage). Each stage's readout is its own:
    'project' where it has a readout Linear (BEiT), else 'ignore'. Returns
    (output name, depth (h, w)).

    grid_shape: name of a runtime int64 [B, C, gh, gw] tensor (the Shape of
    the patch-embed conv output). When given, the graph is emitted with
    dynamic batch/height/width: token->grid Reshapes use it and all fusion /
    head Resizes are scale-driven. gh/gw are then ignored and the returned
    depth shape is None."""
    dyn = grid_shape is not None

    maps = []
    map_shapes = []
    for si, (tok, stage) in enumerate(zip(stage_tokens, net.reassemble)):
        if stage.readout is not None:
            # concat cls onto every patch token -> Linear -> GELU
            # (models/dpt_neck.py:readout_project)
            patches = _slice(g, tok, [1], [_I32MAX], [1])
            cls = _slice(g, tok, [0], [1], [1])
            if dyn:
                # (B, A, C) target shape assembled at runtime from the patch
                # grid: B from the Shape tensor, A = gh*gw
                b1 = _slice(g, grid_shape, [0], [1], [0])
                gh1 = _slice(g, grid_shape, [2], [3], [0])
                gw1 = _slice(g, grid_shape, [3], [4], [0])
                a1 = g.op("Mul", [gh1, gw1])
                shape = g.op(
                    "Concat", [b1, a1, g.init(f"re{si}_cls_c", np.asarray([c], np.int64))], axis=0
                )
                cls_e = g.op("Expand", [cls, shape])
            else:
                cls_e = g.op("Expand", [cls, g.init(f"re{si}_cls_shape", np.asarray([1, gh * gw, c], np.int64))])
            merged = g.op("Concat", [patches, cls_e], axis=-1)
            t = _gelu_erf(g, _linear_layer(g, merged, stage.readout, f"re{si}_readout"))
        else:  # 'ignore': drop the cls token
            t = _slice(g, tok, [1], [_I32MAX], [1])
        t = g.op("Transpose", [t], perm=[0, 2, 1])  # (B, C, N)
        if dyn:
            t = g.op("Reshape", [t, grid_shape])  # (B, C, gh, gw) at runtime
        else:
            t = _reshape(g, t, [1, c, gh, gw])
        t = _conv(g, t, stage.proj, f"re{si}_proj")
        h_, w_ = gh, gw
        if stage.scale in (2, 4):
            rk = _np(stage.resample.weight)  # (ci, co, kh, kw): ONNX's ConvTranspose layout
            t = g.op(
                "ConvTranspose", [t, g.init(f"re{si}_up_w", rk), g.init(f"re{si}_up_b", _np(stage.resample.bias))],
                strides=[rk.shape[2], rk.shape[3]], kernel_shape=[rk.shape[2], rk.shape[3]],
                pads=[0, 0, 0, 0], dilations=[1, 1], group=1,
            )
            h_, w_ = gh * rk.shape[2], gw * rk.shape[3]
        elif stage.scale == 0.5:
            kh, kw = stage.resample.weight.shape[2:]
            t = _conv(g, t, stage.resample, f"re{si}_down", stride=2, pad=1)
            h_, w_ = (gh + 2 - kh) // 2 + 1, (gw + 2 - kw) // 2 + 1
        t = _conv(g, t, stage.fuse, f"re{si}_fuse", pad=1)  # 3x3, no bias
        maps.append(t)
        map_shapes.append((int(stage.fuse.weight.shape[0]), h_, w_))

    return _emit_fusion_head(g, net, maps, map_shapes, dyn=dyn)


def _emit_fusion_head(g: GraphBuilder, net, maps, map_shapes, dyn: bool = False) -> tuple[str, tuple[int, int] | None]:
    """Top-down fusion + monocular head (models/dpt_neck.py:fusion_forward,
    Head). maps are NCHW reassembly outputs, finest first.
    dyn=True: scale-driven Resizes, Squeeze instead of a fixed final Reshape,
    returns depth shape None."""
    fusion, head = net.fusion, net.head
    x, shp = _upsample_projection(g, maps[3], fusion[3], map_shapes[3], "fu3", dyn=dyn)
    for mi, bi in ((2, 2), (1, 1), (0, 0)):
        r = _rcu(g, maps[mi], fusion[bi].res1, f"fu{bi}_res1")
        x = g.op("Add", [r, x])
        x, shp = _upsample_projection(g, x, fusion[bi], map_shapes[mi], f"fu{bi}", dyn=dyn)

    x = _conv(g, x, head.conv_in, "head_in", pad=1)
    if dyn:
        out_hw = None
        x = _resize_scale(g, x, float(head.upsample_factor))
    else:
        shp = (int(head.conv_in.weight.shape[0]), shp[1], shp[2])
        out_hw = resize_output_size((shp[1], shp[2]), head.upsample_factor)
        x = _resize(g, x, out_hw, shp)
    x = _conv(g, x, head.conv_mid, "head_mid", pad=1)
    x = g.op("Relu", [x])
    x = _conv(g, x, head.proj, "head_proj")
    x = g.op("Sigmoid" if head.is_metric else "Relu", [x])
    if dyn:
        x = _squeeze(g, x, 1)  # (B, 1, H, W) -> (B, H, W)
    else:
        x = _reshape(g, x, [1, out_hw[0], out_hw[1]])
    return x, out_hw


def _input(g: GraphBuilder, image_hw, p_px: int, dynamic: bool, tiling: int | None = None):
    """The graph's image input: (name, gh, gw); gh = gw = 0 on the dynamic path."""
    if dynamic:
        return g.add_input("image", ("batch", 3, "height", "width")), 0, 0
    ih, iw = int(image_hw[0]), int(image_hw[1])
    step = tiling or p_px
    if ih % step or iw % step:
        raise ValueError(f"image_hw {ih}x{iw} must be multiples of {step} (compute_scaled_hw)")
    return g.add_input("image", (1, 3, ih, iw)), ih // p_px, iw // p_px


def emit_depth_anything_onnx(model, image_hw: tuple[int, int] | None = None, dynamic: bool = False) -> bytes:
    """Build the ONNX ModelProto bytes for a Depth-Anything ``DPTModel``
    (V1, V2, V2-metric, ViT-Giant; any dtype — weights are exported in f32).

    Fixed-shape mode (default): image_hw must satisfy the model's tiling
    constraint (use model.compute_scaled_hw / verify_input); the resized
    position embedding is baked for its grid at export time.

    dynamic=True: the analog of the reference's dynamic-axes export (dynamic
    batch/height/width). The input is declared ("batch", 3, "height",
    "width") and every grid-dependent computation moves in-graph: the
    pos-embed bicubic resize becomes a runtime Resize (mode=cubic, A=-0.75,
    pytorch_half_pixel — the op torch's own exporter emits for
    F.interpolate bicubic, antialias=False), token->grid Reshapes are driven
    by the Shape of the patch-embed output, and the fusion/head upsamples use
    scale-driven Resizes (output = floor(in*s), the resize_output_size rule).
    image_hw is ignored. Feeds must still satisfy the family tiling
    constraint (H, W multiples of 2*patch = 28 px — DPTModel.verify_input),
    which also keeps every internal grid even."""
    net = model.net
    enc = net.encoder
    p_px = model.patch_size_px
    c = enc.features
    bh, bw = enc.base_grid_hw
    heads = enc.blocks[0].num_heads

    g = GraphBuilder("depth_anything_dynamic" if dynamic else "depth_anything")
    grid_shape = None
    x, gh, gw = _input(g, image_hw, p_px, dynamic)

    # Patch embed: stride==kernel conv (ops/nn.py:patchify_embed)
    x = _conv(g, x, net.patch_embed, "patch_embed", stride=p_px)
    if dynamic:
        grid_shape = g.op("Shape", [x])  # int64 [B, C, gh, gw]
        x = _reshape(g, x, [0, c, -1])
    else:
        x = _reshape(g, x, [1, c, gh * gw])
    x = g.op("Transpose", [x], perm=[0, 2, 1])  # (B, N, C)

    pos_base = _np(enc.pos_embed)  # (1, bh*bw, C)
    if dynamic:
        # Position embedding resized in-graph per input grid
        # (models/dinov2.py:DinoV2Encoder.resized_pos_embed)
        pos4 = pos_base.reshape(1, bh, bw, c).transpose(0, 3, 1, 2)
        hw = _slice(g, grid_shape, [2], [4], [0])  # int64 [gh, gw]
        sizes = g.op("Concat", [g.init("pos_nc", np.asarray([1, c], np.int64)), hw], axis=0)
        pos_r = g.op(
            "Resize", [g.init("pos_embed_grid", pos4), "", "", sizes],
            mode="cubic", cubic_coeff_a=-0.75,
            coordinate_transformation_mode="pytorch_half_pixel",
        )
        pos_f = _reshape(g, pos_r, [0, 0, -1])  # (1, C, N)
        x = g.op("Add", [x, g.op("Transpose", [pos_f], perm=[0, 2, 1])])
    else:
        # resized for this grid at export time, in float32 whatever the model's dtype
        pos = pos_base
        if (gh, gw) != (bh, bw):
            grid = resize_bicubic_hwc(torch.from_numpy(pos_base).reshape(bh, bw, c), (gh, gw))
            pos = grid.reshape(1, gh * gw, c).numpy()
        x = g.op("Add", [x, g.init("pos_embed", pos)])

    cls_tok = _np(enc.cls_token) + _np(enc.cls_embed)
    cls_init = g.init("cls_token", cls_tok.reshape(1, 1, c))
    if dynamic:
        b1 = _slice(g, grid_shape, [0], [1], [0])  # int64 [B]
        cls_shape = g.op("Concat", [b1, g.init("cls_tail", np.asarray([1, c], np.int64))], axis=0)
        cls_init = g.op("Expand", [cls_init, cls_shape])
    x = g.op("Concat", [cls_init, x], axis=1)

    stage_tokens = []
    for i, block in enumerate(enc.blocks):
        h = _layer_norm(g, x, block.norm1, f"b{i}_ln1")
        h = _attention(g, h, block.attn, heads, c)
        h = g.op("Mul", [h, g.init(f"b{i}_ls1", _np(block.ls1))])
        x = g.op("Add", [x, h])
        h = _layer_norm(g, x, block.norm2, f"b{i}_ln2")
        h = _mlp(g, h, block.mlp)
        h = g.op("Mul", [h, g.init(f"b{i}_ls2", _np(block.ls2))])
        x = g.op("Add", [x, h])
        if i in enc.taps:
            stage_tokens.append(_layer_norm(g, x, enc.outnorm, f"tap{i}_outnorm"))

    x, out_hw = _emit_neck(g, net, stage_tokens, c, gh, gw, grid_shape=grid_shape)
    if dynamic:
        g.add_output(x, ("batch", "out_height", "out_width"))
        doc = (
            f"Depth-Anything DPT, dynamic input (batch,3,height,width), height/width "
            f"multiples of {2 * p_px}, normalized RGB; depth (batch,out_height,out_width)"
        )
    else:
        g.add_output(x, (1, out_hw[0], out_hw[1]))
        doc = (f"Depth-Anything DPT, fixed input (1,3,{gh * p_px},{gw * p_px}), normalized RGB; "
               f"depth (1,{out_hw[0]},{out_hw[1]})")
    return g.serialize(opset=17, doc=doc)


def _beit_dynamic_bias_setup(g: GraphBuilder, relpos_lut: np.ndarray, base_grid_hw, heads: int, grid_shape: str):
    """Emit the grid-dependent relative-position machinery IN-GRAPH for the
    dynamic BEiT export — the runtime analog of models/beit.py:
    compute_bias_stack:

    * the token LUT's bilinear rescale to (2gh-1, 2gw-1) becomes a runtime
      Resize (mode=linear, pytorch_half_pixel — torch-default bilinear,
      align_corners=False);
    * the deterministic (N-1, N-1) relative-index matrix
      (models/beit.py:relative_position_tensor) is built from Range/Sub/Mul
      over the runtime grid dims;
    * per block, the bias is assembled as Gather(LUT, index) for the
      token-token body plus the 3 special cls rows/columns concatenated as
      borders (the values the index's special entries select).

    Returns (full_lut, specials, idx_tok, a1) graph-tensor names:
    full_lut (L, H, R') resized+flattened LUT, specials (L, H, 3), idx_tok
    (A, A) int64, a1 the 1-element [A] tensor."""
    num_layers = relpos_lut.shape[0]
    bh, bw = base_grid_hw
    ref_h, ref_w = 2 * bh - 1, 2 * bw - 1
    # token part as an (L, H, ref_h, ref_w) image for Resize; specials kept
    # separate, unresized (compute_bias_stack concatenates them back after)
    lut = np.asarray(relpos_lut, np.float32)  # (L, R, H)
    token4 = lut[:, : ref_h * ref_w, :].reshape(num_layers, ref_h, ref_w, heads).transpose(0, 3, 1, 2)
    specials = lut[:, ref_h * ref_w :, :].transpose(0, 2, 1)  # (L, H, 3)
    token_init = g.init("relpos_lut_grid", np.ascontiguousarray(token4))
    specials_name = g.init("relpos_specials", np.ascontiguousarray(specials))

    i64 = lambda hint, v: g.init(hint, np.asarray(v, np.int64))
    gh1 = _slice(g, grid_shape, [2], [3], [0])
    gw1 = _slice(g, grid_shape, [3], [4], [0])
    two = i64("i64_two", [2])
    one = i64("i64_one", [1])
    new_h = g.op("Sub", [g.op("Mul", [gh1, two]), one])  # [2gh-1]
    new_w = g.op("Sub", [g.op("Mul", [gw1, two]), one])
    sizes = g.op("Concat", [i64("lut_lh", [num_layers, heads]), new_h, new_w], axis=0)
    lut_r = g.op(
        "Resize", [token_init, "", "", sizes], mode="linear",
        coordinate_transformation_mode="pytorch_half_pixel",
    )
    lut_flat = _reshape(g, lut_r, [0, 0, -1])  # (L, H, newR)
    full_lut = g.op("Concat", [lut_flat, specials_name], axis=2)  # (L, H, newR+3)

    # relative index over the A = gh*gw patch tokens:
    # idx[(yq,xq),(yk,xk)] = (yq-yk+gh-1)*(2gw-1) + (xq-xk+gw-1)
    zero_s = g.init("i64_zero_s", np.asarray(0, np.int64))
    one_s = g.init("i64_one_s", np.asarray(1, np.int64))
    ys = g.op("Range", [zero_s, _squeeze(g, gh1, 0), one_s])  # (gh,)
    xs = g.op("Range", [zero_s, _squeeze(g, gw1, 0), one_s])  # (gw,)
    y_col = _reshape(g, ys, [-1, 1])
    x_row = _reshape(g, xs, [1, -1])
    zero_like_row = g.op("Mul", [x_row, zero_s])
    zero_like_col = g.op("Mul", [y_col, zero_s])
    y_flat = _reshape(g, g.op("Add", [y_col, zero_like_row]), [-1])  # (A,)
    x_flat = _reshape(g, g.op("Add", [zero_like_col, x_row]), [-1])
    rel_y = g.op("Sub", [_reshape(g, y_flat, [-1, 1]), _reshape(g, y_flat, [1, -1])])
    rel_x = g.op("Sub", [_reshape(g, x_flat, [-1, 1]), _reshape(g, x_flat, [1, -1])])
    gh_m1 = g.op("Sub", [gh1, one])
    gw_m1 = g.op("Sub", [gw1, one])
    idx_tok = g.op(
        "Add",
        [g.op("Mul", [g.op("Add", [rel_y, gh_m1]), new_w]), g.op("Add", [rel_x, gw_m1])],
    )  # (A, A) int64
    a1 = g.op("Mul", [gh1, gw1])  # [A]
    return full_lut, specials_name, idx_tok, a1


def _beit_dynamic_bias_block(g: GraphBuilder, full_lut: str, specials: str, idx_tok: str, a1: str, layer: int, heads: int) -> str:
    """Assemble block `layer`'s (1, H, N, N) bias at runtime: Gather the
    token-token body by the relative index, then concatenate the cls borders
    from the 3 special LUT rows (cls->token row, token->cls column, cls->cls
    corner — models/beit.py:relative_position_tensor's special entries)."""
    i64 = lambda hint, v: g.init(hint, np.asarray(v, np.int64))
    lut_i = _slice(g, full_lut, [layer], [layer + 1], [0])  # (1, H, R')
    body = g.op("Gather", [lut_i, idx_tok], axis=2)  # (1, H, A, A)
    sp_i = _slice(g, specials, [layer], [layer + 1], [0])  # (1, H, 3)
    s_c2t = _reshape(g, _slice(g, sp_i, [0], [1], [2]), [1, heads, 1, 1])
    s_t2c = _reshape(g, _slice(g, sp_i, [1], [2], [2]), [1, heads, 1, 1])
    s_c2c = _reshape(g, _slice(g, sp_i, [2], [3], [2]), [1, heads, 1, 1])
    row_shape = g.op("Concat", [i64(f"b{layer}_row_lh", [1, heads, 1]), a1], axis=0)
    row0 = g.op("Concat", [s_c2c, g.op("Expand", [s_c2t, row_shape])], axis=3)  # (1, H, 1, N)
    col_shape = g.op("Concat", [i64(f"b{layer}_col_lh", [1, heads]), a1, i64(f"b{layer}_col_one", [1])], axis=0)
    col0 = g.op("Expand", [s_t2c, col_shape])  # (1, H, A, 1)
    rows = g.op("Concat", [col0, body], axis=3)  # (1, H, A, N)
    return g.op("Concat", [row0, rows], axis=2)  # (1, H, N, N)


def emit_beit_onnx(model, image_hw: tuple[int, int] | None = None, dynamic: bool = False) -> bytes:
    """Build the ONNX ModelProto bytes for a MiDaS v3.1 BEiT ``DPTModel``.

    Fixed-shape mode (default): the per-layer relative-position bias
    (models/beit.py:compute_bias_stack) is evaluated for this grid at export
    time and baked as one (1, H, N, N) float32 initializer per block — the
    cached stack without its pads. Artifact size grows as L*H*N^2 floats
    (models/beit.py:calculate_bias_bytes): BEiT-L-512 at 512x512 bakes 24 x
    16 x 1025^2 floats, about 1.6 GB.

    dynamic=True: the analog of the reference's dynamic-axes BEiT export.
    The input is declared ("batch", 3, "height", "width") and every
    grid-dependent computation moves in-graph — the LUT bilinear rescale
    becomes a runtime Resize, the relative-index matrix is built from Range
    ops, and each block's bias is a runtime Gather + cls-border Concat (see
    _beit_dynamic_bias_setup). image_hw is ignored; feeds must satisfy the
    BEiT tiling constraint (H, W multiples of 2*patch = 32 px —
    DPTModel.verify_input). The artifact stays small (the LUT is the only
    positional initializer) but the runtime pays the per-block gather the
    fixed-shape export bakes."""
    from ..models.beit import compute_bias_stack

    net = model.net
    enc = net.encoder
    p_px = model.patch_size_px
    c = enc.features
    heads = enc.blocks[0].num_heads

    g = GraphBuilder("beit_dpt_dynamic" if dynamic else "beit_dpt")
    grid_shape = None
    x, gh, gw = _input(g, image_hw, p_px, dynamic)
    if not dynamic:
        with torch.no_grad():
            bias_stack = _np(compute_bias_stack(enc.relpos_lut.float(), enc.base_grid_hw, (gh, gw)))  # (L, H, N, N)

    x = _conv(g, x, net.patch_embed, "patch_embed", stride=p_px)
    if dynamic:
        grid_shape = g.op("Shape", [x])  # int64 [B, C, gh, gw]
        x = _reshape(g, x, [0, c, -1])
    else:
        x = _reshape(g, x, [1, c, gh * gw])
    x = g.op("Transpose", [x], perm=[0, 2, 1])  # (B, N-1, C)

    cls_init = g.init("cls_token", _np(enc.cls_token).reshape(1, 1, c))
    if dynamic:
        b1 = _slice(g, grid_shape, [0], [1], [0])
        cls_shape = g.op("Concat", [b1, g.init("cls_tail", np.asarray([1, c], np.int64))], axis=0)
        cls_init = g.op("Expand", [cls_init, cls_shape])
    x = g.op("Concat", [cls_init, x], axis=1)

    if dynamic:
        full_lut, specials, idx_tok, a1 = _beit_dynamic_bias_setup(
            g, _np(enc.relpos_lut), enc.base_grid_hw, heads, grid_shape,
        )

    stage_tokens = []
    for i, block in enumerate(enc.blocks):
        h = _layer_norm(g, x, block.norm1, f"b{i}_ln1")
        # the qkv bias is head-major with zero k slots (models/beit.py)
        if dynamic:
            bias_i = _beit_dynamic_bias_block(g, full_lut, specials, idx_tok, a1, i, heads)
        else:
            bias_i = bias_stack[i : i + 1]
        h = _attention(g, h, block.attn, heads, c, bias=bias_i)
        h = g.op("Mul", [h, g.init(f"b{i}_ls1", _np(block.ls1))])
        x = g.op("Add", [x, h])
        h = _layer_norm(g, x, block.norm2, f"b{i}_ln2")
        h = _mlp(g, h, block.mlp)
        h = g.op("Mul", [h, g.init(f"b{i}_ls2", _np(block.ls2))])
        x = g.op("Add", [x, h])
        if i in enc.taps:
            stage_tokens.append(x)  # no output norm (models/beit.py:BEiTEncoder)

    x, out_hw = _emit_neck(g, net, stage_tokens, c, gh, gw, grid_shape=grid_shape)
    if dynamic:
        g.add_output(x, ("batch", "out_height", "out_width"))
        doc = (
            f"MiDaS v3.1 BEiT DPT, dynamic input (batch,3,height,width), height/width "
            f"multiples of {2 * p_px}, normalized RGB; depth (batch,out_height,out_width)"
        )
    else:
        g.add_output(x, (1, out_hw[0], out_hw[1]))
        doc = (f"MiDaS v3.1 BEiT DPT, fixed input (1,3,{gh * p_px},{gw * p_px}), normalized RGB; "
               f"depth (1,{out_hw[0]},{out_hw[1]})")
    return g.serialize(opset=17, doc=doc)


def _swin_window_attention(g: GraphBuilder, x: str, block, grid_hw, window_hw, shift_hw, shifting: bool, cpb: np.ndarray, mask, hint: str) -> str:
    """One windowed scaled-cosine attention op on a (1, gh, gw, C) grid tensor
    (models/swinv2.py:SwinBlock.attention). cpb is the block's (H, A, A)
    continuous position bias evaluated at export time; mask the (nW, A, A)
    0/-100 shift mask (or None)."""
    gh, gw = grid_hw
    win_h, win_w = window_hw
    shift_h, shift_w = shift_hw
    heads = block.num_heads
    c = block.qkv.in_features
    d = c // heads
    nwy, nwx = gh // win_h, gw // win_w
    nw, area = nwy * nwx, win_h * win_w

    if shifting:
        x = _roll_axis(g, x, -shift_h, gh, 1)
        x = _roll_axis(g, x, -shift_w, gw, 2)

    # partition into (nW, A, C); batch is fixed at 1 so it folds into nW
    x = _reshape(g, x, [1, nwy, win_h, nwx, win_w, c])
    x = g.op("Transpose", [x], perm=[0, 1, 3, 2, 4, 5])
    x = _reshape(g, x, [nw, area, c])

    # fused qkv, rows [q|k|v][head][dim]; the q and v biases added after the
    # split (the k third of the port's qkv bias is a fixed zero)
    qkv_bias = _np(block.qkv.bias).reshape(3, heads, 1, d)
    qkv = _linear(g, x, _kernel(block.qkv), None, hint + "_qkv")
    qkv = _reshape(g, qkv, [nw, area, 3, heads, d])
    qkv = g.op("Transpose", [qkv], perm=[2, 0, 3, 1, 4])  # (3, nW, H, A, d)
    parts = [_reshape(g, _slice(g, qkv, [i], [i + 1], [0]), [nw, heads, area, d]) for i in range(3)]
    q, k, v = parts
    q = g.op("Add", [q, g.init(hint + "_qb", qkv_bias[0])])
    v = g.op("Add", [v, g.init(hint + "_vb", qkv_bias[2])])

    # cosine attention: normalize(q) @ normalize(k)^T * logit_scale (stored
    # clamped and exponentiated, checkpoints/swinv2.py)
    qn = _l2_normalize(g, q, hint + "_qn")
    kn = _l2_normalize(g, k, hint + "_kn")
    kt = g.op("Transpose", [kn], perm=[0, 1, 3, 2])
    logits = g.op("MatMul", [qn, kt])  # (nW, H, A, A)
    logits = g.op("Mul", [logits, g.init(hint + "_ls", _np(block.logit_scale).reshape(heads, 1, 1))])
    logits = g.op("Add", [logits, g.init(hint + "_cpb", np.asarray(cpb, np.float32))])
    if mask is not None:
        logits = g.op("Add", [logits, g.init(hint + "_mask", np.asarray(mask, np.float32)[:, None])])
    weights = g.op("Softmax", [logits], axis=-1)
    out = g.op("MatMul", [weights, v])  # (nW, H, A, d)
    out = g.op("Transpose", [out], perm=[0, 2, 1, 3])
    out = _reshape(g, out, [nw, area, c])
    out = _linear_layer(g, out, block.proj, hint + "_proj")

    # reverse partition (+ reverse shift)
    out = _reshape(g, out, [1, nwy, nwx, win_h, win_w, c])
    out = g.op("Transpose", [out], perm=[0, 1, 3, 2, 4, 5])
    out = _reshape(g, out, [1, gh, gw, c])
    if shifting:
        out = _roll_axis(g, out, shift_h, gh, 1)
        out = _roll_axis(g, out, shift_w, gw, 2)
    return out


def emit_swinv2_onnx(model, image_hw: tuple[int, int]) -> bytes:
    """Build the ONNX ModelProto bytes for a MiDaS v3.1 SwinV2 ``DPTModel``.

    Everything the forward derives per grid — window plan, cyclic-shift
    masks and each block's CPB relative-position bias
    (models/swinv2.py:window_plan, shift_mask, cpb_bias) — is evaluated for
    this grid at export time and baked as float32 initializers: the tensors
    the facade's aux cache holds. Fixed shape only: the window plan itself
    depends on the grid."""
    from ..models.swinv2 import cpb_bias, shift_mask, window_plan

    net = model.net
    enc = net.encoder
    p_px = model.patch_size_px
    g = GraphBuilder("swinv2_dpt")
    x, gh, gw = _input(g, image_hw, p_px, False, tiling=8 * p_px)  # 3 patch merges halve the grid

    # patch embed: 4px conv + post-projection LayerNorm (models/swinv2_family.py:SwinV2DPT.embed)
    x = _conv(g, x, net.patch_embed, "patch_embed", stride=p_px)
    x = g.op("Transpose", [x], perm=[0, 2, 3, 1])  # grid layout (1, gh, gw, C)
    x = _layer_norm(g, x, net.patch_norm, "pe_norm")

    maps = []
    map_shapes = []
    for s, blocks in enumerate(enc.stages):
        if s > 0:
            # patch merge: 2x2 TL/BL/TR/BR decimate-concat -> Linear (no bias)
            # -> LayerNorm (models/swinv2.py:PatchMerge)
            merge = enc.merges[s - 1]
            corners = [
                _slice_step(g, x, [hs, ws], [_I32MAX, _I32MAX], [1, 2], [2, 2])
                for hs, ws in ((0, 0), (1, 0), (0, 1), (1, 1))
            ]
            x = g.op("Concat", corners, axis=3)
            x = _linear(g, x, _kernel(merge.reduction), None, f"s{s}_merge")
            x = _layer_norm(g, x, merge.norm, f"s{s}_merge_norm")
            gh, gw = gh // 2, gw // 2

        pws = enc.pretrained_window_sizes[s]
        window_hw, shift_hw = window_plan((gh, gw), enc.window_size_hw)
        with torch.no_grad():
            mask = shift_mask((gh, gw), window_hw, shift_hw)
            mask = None if mask is None else _np(mask)
            for j, block in enumerate(blocks):
                cpb = _np(cpb_bias(block, window_hw, pws))
                hint = f"s{s}p{j // 2}b{j % 2}"
                shifting = j % 2 == 1 and mask is not None
                h = _swin_window_attention(
                    g, x, block, (gh, gw), window_hw, shift_hw, shifting,
                    cpb, mask if shifting else None, hint,
                )
                # post-norm block (models/swinv2.py:SwinBlock)
                h = _layer_norm(g, h, block.norm1, hint + "_ln1")
                x = g.op("Add", [x, h])
                h = _mlp(g, x, block)
                h = _layer_norm(g, h, block.norm2, hint + "_ln2")
                x = g.op("Add", [x, h])

        # reassembly: the 3x3 fuse conv only, no readout/resample
        # (models/dpt_neck.py:FuseOnlyStage)
        fuse = net.reassemble[s].fuse
        xm = g.op("Transpose", [x], perm=[0, 3, 1, 2])  # NCHW
        maps.append(_conv(g, xm, fuse, f"s{s}_fuse", pad=1))
        map_shapes.append((int(fuse.weight.shape[0]), gh, gw))

    x, out_hw = _emit_fusion_head(g, net, maps, map_shapes)
    g.add_output(x, (1, out_hw[0], out_hw[1]))
    ih, iw = int(image_hw[0]), int(image_hw[1])
    return g.serialize(
        opset=17,
        doc=f"MiDaS v3.1 SwinV2 DPT, fixed input (1,3,{ih},{iw}), normalized RGB; depth (1,{out_hw[0]},{out_hw[1]})",
    )


def emitter_for(model):
    """The emitter of a ``DPTModel``'s family: ``(emit, supports_dynamic)``."""
    from ..models.beit_family import BEiTDPT
    from ..models.depth_anything import DepthAnything
    from ..models.swinv2_family import SwinV2DPT

    if isinstance(model.net, DepthAnything):
        return emit_depth_anything_onnx, True
    if isinstance(model.net, BEiTDPT):
        return emit_beit_onnx, True
    if isinstance(model.net, SwinV2DPT):
        return emit_swinv2_onnx, False
    raise NotImplementedError(f"no ONNX emitter for {type(model.net).__name__}")
