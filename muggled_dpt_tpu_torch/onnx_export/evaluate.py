"""Reference numpy evaluator for the ONNX op subset this repo emits.

This is the CI-side proof that exported .onnx artifacts are semantically
correct without an onnxruntime dependency: every emitted graph is executed
here, op by op per the public ONNX operator spec, and the
result is compared against the live model's own forward
(``experiments/export_onnx.py``; the CPU tests hold it against the JAX
package's float32 forward too). The evaluator is also validated against an
independent producer: it runs torch's own C++-exported graphs and must match
the torch module outputs. The port's own copy of the JAX package's
``onnx_export/evaluate.py``.

Deliberately simple and numpy-only — this is a correctness oracle, not a
runtime.
"""

from __future__ import annotations

import numpy as np

from .builder import tensor_to_numpy
from .proto import decode_message


def _attrs(node: dict) -> dict:
    out = {}
    for a in node.get("attribute", []):
        for key in ("f", "i", "s", "t", "ints", "floats", "strings"):
            if key in a:
                v = a[key]
                out[a["name"]] = v.decode() if isinstance(v, bytes) else v
                break
    return out


def _conv2d(x, w, b, pads, strides, dilations, group):
    if group != 1 or any(d != 1 for d in dilations):
        raise NotImplementedError("evaluator supports group=1, dilation=1 convs")
    pt, pl, pb, pr = pads  # ONNX order: x1_begin, x2_begin, x1_end, x2_end
    x = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    n, ci, h, wdt = x.shape
    co, _, kh, kw = w.shape
    sh, sw = strides
    oh = (h - kh) // sh + 1
    ow = (wdt - kw) // sw + 1
    # im2col: (N, ci*kh*kw, oh*ow)
    cols = np.empty((n, ci, kh, kw, oh, ow), dtype=x.dtype)
    for i in range(kh):
        for j in range(kw):
            cols[:, :, i, j] = x[:, :, i : i + oh * sh : sh, j : j + ow * sw : sw]
    cols = cols.reshape(n, ci * kh * kw, oh * ow)
    y = np.einsum("ok,nkp->nop", w.reshape(co, ci * kh * kw), cols, optimize=True)
    y = y.reshape(n, co, oh, ow)
    if b is not None:
        y = y + b[None, :, None, None]
    return y


def _conv_transpose2d(x, w, b, strides):
    # stride == kernel, no padding (the only form the DPT reassembly uses):
    # each input pixel expands to an independent (kh, kw) block
    n, ci, h, wdt = x.shape
    _, co, kh, kw = w.shape  # ONNX ConvTranspose weight: (ci, co, kh, kw)
    if tuple(strides) != (kh, kw):
        raise NotImplementedError("evaluator supports stride == kernel ConvTranspose")
    y = np.einsum("nihw,iokl->nohkwl", x, w, optimize=True)
    y = y.reshape(n, co, h * kh, wdt * kw)
    if b is not None:
        y = y + b[None, :, None, None]
    return y


def _resize_cubic_2d(x, out_hw, ctm: str, a: float):
    """Separable cubic (Keys) resize per the ONNX Resize spec with
    exclude_outside=0 (border taps clamp to the edge) — the op torch's
    exporter emits for F.interpolate(bicubic, antialias=False)."""
    n, c, h, w = x.shape
    oh, ow = out_hw

    def axis_matrix(out_len: int, in_len: int) -> np.ndarray:
        i = np.arange(out_len, dtype=np.float64)
        if ctm == "align_corners":
            src = i * (in_len - 1) / max(out_len - 1, 1)
        elif ctm == "pytorch_half_pixel":
            src = (i + 0.5) * in_len / out_len - 0.5 if out_len > 1 else np.zeros_like(i)
        else:  # half_pixel
            src = (i + 0.5) * in_len / out_len - 0.5
        i0 = np.floor(src).astype(np.int64)
        t = src - i0
        # 4-tap weights at distances 1+t, t, 1-t, 2-t (Keys cubic, coeff a)
        def k1(d):  # |d| <= 1
            return ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0

        def k2(d):  # 1 < |d| < 2
            return (((d - 5.0) * d + 8.0) * d - 4.0) * a

        weights = [k2(1.0 + t), k1(t), k1(1.0 - t), k2(2.0 - t)]
        m = np.zeros((out_len, in_len), dtype=np.float64)
        rows = np.arange(out_len)
        for tap, wgt in enumerate(weights):
            cols = np.clip(i0 - 1 + tap, 0, in_len - 1)
            np.add.at(m, (rows, cols), wgt)
        return m

    mh = axis_matrix(oh, h)
    mw = axis_matrix(ow, w)
    y = np.einsum("oh,nchw->ncow", mh, x.astype(np.float64), optimize=True)
    y = np.einsum("pw,nchw->nchp", mw, y, optimize=True)
    return y.astype(x.dtype)


def _resize_linear_2d(x, out_hw, ctm: str):
    n, c, h, w = x.shape
    oh, ow = out_hw

    def src(i, out_len, in_len):
        i = np.asarray(i, np.float64)
        if ctm == "align_corners":
            return i * (in_len - 1) / max(out_len - 1, 1)
        if ctm == "pytorch_half_pixel" and out_len <= 1:
            # torch's rule maps a length-1 output axis to source 0
            return np.zeros_like(i)
        # half_pixel (and pytorch_half_pixel for out_len > 1)
        return np.clip((i + 0.5) * in_len / out_len - 0.5, 0, in_len - 1)

    ys = src(np.arange(oh), oh, h)
    xs = src(np.arange(ow), ow, w)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0).astype(x.dtype)
    fx = (xs - x0).astype(x.dtype)
    top = x[:, :, y0][:, :, :, x0] * (1 - fx) + x[:, :, y0][:, :, :, x1] * fx
    bot = x[:, :, y1][:, :, :, x0] * (1 - fx) + x[:, :, y1][:, :, :, x1] * fx
    return top * (1 - fy[None, None, :, None]) + bot * fy[None, None, :, None]


def _layer_norm(x, scale, bias, axis, eps):
    axis = axis if axis >= 0 else x.ndim + axis
    axes = tuple(range(axis, x.ndim))
    xf = x.astype(np.float32)
    mean = xf.mean(axis=axes, keepdims=True)
    var = ((xf - mean) ** 2).mean(axis=axes, keepdims=True)
    y = (xf - mean) / np.sqrt(var + eps)
    return (y * scale + bias).astype(x.dtype)


def _softmax(x, axis):
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def _erf(x):
    try:
        from math import erf as _scalar_erf  # noqa: F401
        from scipy.special import erf  # type: ignore

        return erf(x)
    except ImportError:
        import math

        return np.vectorize(math.erf, otypes=[np.float64])(x).astype(x.dtype)


def _slice(x, starts, ends, axes, steps):
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax if ax >= 0 else x.ndim + ax)
        sl[ax] = slice(int(st), None if en >= np.iinfo(np.int32).max else int(en), int(sp))
    return x[tuple(sl)]


def evaluate_model(model: dict | bytes, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Run a parsed (or serialized) ModelProto on numpy inputs.

    Returns {output_name: array} for the graph outputs.
    """
    if isinstance(model, (bytes, bytearray)):
        model = decode_message("ModelProto", bytes(model))
    graph = model["graph"]
    env: dict[str, np.ndarray] = {}
    for t in graph.get("initializer", []):
        env[t["name"]] = tensor_to_numpy(t)
    for name, arr in feeds.items():
        env[name] = np.asarray(arr)

    for node in graph.get("node", []):
        op = node["op_type"]
        ins = [env[n] if n else None for n in node.get("input", [])]
        out_name = node["output"][0]
        a = _attrs(node)
        if op == "Conv":
            kh, kw = ins[1].shape[2:]
            y = _conv2d(
                ins[0], ins[1], ins[2] if len(ins) > 2 else None,
                a.get("pads", [0, 0, 0, 0]), a.get("strides", [1, 1]),
                a.get("dilations", [1, 1]), a.get("group", 1),
            )
        elif op == "ConvTranspose":
            y = _conv_transpose2d(ins[0], ins[1], ins[2] if len(ins) > 2 else None, a.get("strides", [1, 1]))
        elif op == "MatMul":
            y = ins[0] @ ins[1]
        elif op == "Gemm":
            alpha, beta = a.get("alpha", 1.0), a.get("beta", 1.0)
            x0 = ins[0].T if a.get("transA", 0) else ins[0]
            x1 = ins[1].T if a.get("transB", 0) else ins[1]
            y = alpha * (x0 @ x1)
            if len(ins) > 2:
                y = y + beta * ins[2]
        elif op == "Add":
            y = ins[0] + ins[1]
        elif op == "Sub":
            y = ins[0] - ins[1]
        elif op == "Mul":
            y = ins[0] * ins[1]
        elif op == "Div":
            y = ins[0] / ins[1]
        elif op == "Relu":
            y = np.maximum(ins[0], 0)
        elif op == "Sigmoid":
            y = 1.0 / (1.0 + np.exp(-ins[0]))
        elif op == "Sqrt":
            y = np.sqrt(ins[0])
        elif op == "ReduceSum":
            axes = ins[1] if len(ins) > 1 and ins[1] is not None else None
            keep = bool(a.get("keepdims", 1))
            y = ins[0].sum(
                axis=None if axes is None else tuple(int(v) for v in axes), keepdims=keep
            )
        elif op == "Erf":
            y = _erf(ins[0])
        elif op == "Softmax":
            y = _softmax(ins[0], int(a.get("axis", -1)))
        elif op == "Transpose":
            y = np.transpose(ins[0], a["perm"])
        elif op == "Reshape":
            # ONNX semantics: 0 copies the input dim (allowzero=0), -1 infers
            shape = [
                ins[0].shape[i] if int(d) == 0 else int(d)
                for i, d in enumerate(ins[1])
            ]
            y = ins[0].reshape(shape)
        elif op == "Shape":
            y = np.asarray(ins[0].shape, np.int64)
        elif op == "Squeeze":
            axes = ins[1] if len(ins) > 1 and ins[1] is not None else a.get("axes")
            y = np.squeeze(ins[0], axis=tuple(int(v) for v in axes))
        elif op == "Unsqueeze":
            axes = ins[1] if len(ins) > 1 and ins[1] is not None else a.get("axes")
            y = np.expand_dims(ins[0], axis=tuple(int(v) for v in axes))
        elif op == "Concat":
            y = np.concatenate(ins, axis=int(a["axis"]))
        elif op == "Slice":
            starts, ends = ins[1], ins[2]
            axes = ins[3] if len(ins) > 3 and ins[3] is not None else list(range(len(starts)))
            steps = ins[4] if len(ins) > 4 and ins[4] is not None else [1] * len(starts)
            y = _slice(ins[0], starts, ends, axes, steps)
        elif op == "LayerNormalization":
            y = _layer_norm(ins[0], ins[1], ins[2], int(a.get("axis", -1)), float(a.get("epsilon", 1e-5)))
        elif op == "Resize":
            mode = a.get("mode", "nearest")
            ctm = a.get("coordinate_transformation_mode", "half_pixel")
            if len(ins) > 3 and ins[3] is not None:
                sizes = ins[3]
                out_hw = (int(sizes[2]), int(sizes[3]))
            else:  # scales input: output = floor(in * scale) per the spec
                scales = ins[2]
                out_hw = (
                    int(np.floor(ins[0].shape[2] * float(scales[2]))),
                    int(np.floor(ins[0].shape[3] * float(scales[3]))),
                )
            if mode == "linear":
                y = _resize_linear_2d(ins[0], out_hw, ctm)
            elif mode == "cubic":
                y = _resize_cubic_2d(ins[0], out_hw, ctm, float(a.get("cubic_coeff_a", -0.75)))
            else:
                raise NotImplementedError(f"Resize mode {mode!r}")
        elif op == "Expand":
            y = ins[0] * np.ones([int(d) for d in ins[1]], dtype=ins[0].dtype)
        elif op == "Range":
            start, limit, delta = (np.asarray(v).reshape(()).item() for v in ins[:3])
            y = np.arange(start, limit, delta)
        elif op == "Gather":
            y = np.take(ins[0], ins[1], axis=int(a.get("axis", 0)))
        elif op == "Identity":
            y = ins[0]
        elif op == "Constant":
            y = tensor_to_numpy(a["value"]) if isinstance(a.get("value"), dict) else np.asarray(a["value"])
        else:
            raise NotImplementedError(f"evaluator has no op {op!r}")
        env[out_name] = y

    return {v["name"]: env[v["name"]] for v in graph["output"]}
