"""The port's ONNX export (``muggled_dpt_tpu_torch/onnx_export/``): its wire
codec, its emitted graphs and its numpy evaluator, every case of
tests/test_onnx_export.py.

1. The port's codec parses a file from an independent producer (torch's
   C++ torchscript ONNX exporter) and round-trips it; its evaluator runs that
   graph and matches the torch module.
2. The port's emitted graph, run by the port's evaluator, against the JAX
   package's float32 forward on the same random original-format checkpoint
   (both packages' builders with one seed make byte-identical checkpoints)
   and the same input, made with numpy: the JAX tests' tolerance, 2e-5
   mean abs-rel (the float32 arithmetic differs only in summation order).
3. Both packages' emitted graphs for one tiny DA-V2, decoded, node for node
   and initializer for initializer; the producer name is the port's."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muggled_dpt_tpu.make_beit_dpt import make_beit_dpt as jax_make_beit
from muggled_dpt_tpu.make_depthanythingv1_dpt import make_depthanythingv1_dpt as jax_make_v1
from muggled_dpt_tpu.make_depthanythingv2_dpt import make_depthanythingv2_dpt as jax_make_v2
from muggled_dpt_tpu.make_swinv2_dpt import make_swinv2_dpt as jax_make_swinv2
from muggled_dpt_tpu.onnx_export import decode_message as jax_decode
from muggled_dpt_tpu.onnx_export import emit_depth_anything_onnx as jax_emit_da
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv1_dpt, make_depthanythingv2_dpt, make_swinv2_dpt
from muggled_dpt_tpu_torch.onnx_export import (
    decode_message,
    emit_beit_onnx,
    emit_depth_anything_onnx,
    emit_swinv2_onnx,
    encode_message,
    evaluate_model,
)
from muggled_dpt_tpu_torch.onnx_export.proto import DT_FLOAT, DT_INT64

DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
TOL = 2e-5  # tests/test_onnx_export.py's mean abs-rel budget
SEED = 7
DA_ARGS = (64, 2, 4, (8, 16, 32, 64), (8, 8), 16)
BEIT_ARGS = (64, 4, 8, (8, 16, 32, 64), (6, 6), 16)
SWIN_ARGS = ((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16)


def _pair(jax_make, port_make, *args, **kwargs):
    """(JAX model, port model) from one random original checkpoint: both
    builders draw it with numpy from the same seed."""
    return jax_make(*args, **kwargs, seed=SEED), port_make(*args, **kwargs, seed=SEED, device=DEVICE)


def _da(**kwargs):
    return _pair(jax_make_v2, make_depthanythingv2_dpt, *DA_ARGS, **kwargs)


def _beit():
    return _pair(jax_make_beit, make_beit_dpt, *BEIT_ARGS)


def _swinv2():
    return _pair(jax_make_swinv2, make_swinv2_dpt, *SWIN_ARGS)


def _abs_rel(got, want) -> float:
    return float(np.abs(got.astype(np.float32) - want).mean() / max(np.abs(want).mean(), 1e-9))


def _torch_tiny_onnx():
    """Export a small conv net with torch's torchscript exporter, bypassing
    its onnxscript post-processing step (a no-op for graphs without custom
    onnx-script functions; the actual protobuf serialization is C++-side)."""
    import warnings

    import torch.nn as nn
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    original = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        torch.manual_seed(0)
        m = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1), nn.ReLU(), nn.Conv2d(4, 2, 1))
        buf = io.BytesIO()
        x = torch.randn(1, 3, 8, 8)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.onnx.export(m, (x,), buf, dynamo=False)
        return m, x, buf.getvalue()
    finally:
        onnx_proto_utils._add_onnxscript_fn = original


def test_codec_parses_independent_producer_and_roundtrips():
    _, _, data = _torch_tiny_onnx()
    model = decode_message("ModelProto", data)
    assert model["producer_name"] == "pytorch"
    graph = model["graph"]
    assert [n["op_type"] for n in graph["node"]] == ["Conv", "Relu", "Conv"]
    assert {t["name"] for t in graph["initializer"]} == {"0.weight", "0.bias", "2.weight", "2.bias"}
    again = decode_message("ModelProto", encode_message("ModelProto", model))
    assert again == model


def test_evaluator_matches_torch_on_torch_produced_graph():
    module, x, data = _torch_tiny_onnx()
    with torch.no_grad():
        want = module(x).numpy()
    graph = decode_message("ModelProto", data)["graph"]
    (input_name,) = [v["name"] for v in graph["input"]]
    (got,) = evaluate_model(decode_message("ModelProto", data), {input_name: x.numpy()}).values()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _export_and_compare(models, image_hw, tol=TOL, emit=emit_depth_anything_onnx):
    """The port's graph for the port model, run by the port's evaluator,
    against the JAX model's float32 forward on one numpy input."""
    jax_model, port_model = models
    onnx_bytes = emit(port_model, image_hw)
    x = np.random.default_rng(0).standard_normal((1, 3, *image_hw)).astype(np.float32) * 0.5
    want = np.asarray(jax_model.forward(jnp.asarray(x)), np.float32)
    (got,) = evaluate_model(onnx_bytes, {"image": x}).values()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert _abs_rel(got, want) < tol
    return onnx_bytes


def test_emitted_dav2_matches_jax_forward():
    data = _export_and_compare(_da(), (112, 112))
    parsed = decode_message("ModelProto", data)
    assert parsed["opset_import"][0]["version"] == 17
    assert parsed["graph"]["input"][0]["name"] == "image"
    assert parsed["producer_name"] == "muggled_dpt_tpu_torch"


def test_emitted_dav2_nonsquare_and_posenc_resize():
    # non-square grid (8x12 patches) exercises the baked pos-embed resize
    _export_and_compare(_da(), (112, 168))


def test_emitted_metric_variant_uses_sigmoid():
    data = _export_and_compare(_da(is_metric=True), (112, 112))
    ops = [n["op_type"] for n in decode_message("ModelProto", data)["graph"]["node"]]
    assert ops[-2] == "Sigmoid"  # the metric head (models/dpt_neck.py:Head.tail)


def test_emitted_giant_swiglu():
    data = _export_and_compare(_da(is_giant=True), (112, 112))
    names = [t["name"] for t in decode_message("ModelProto", data)["graph"]["initializer"]]
    assert any(n.startswith("w12_w") for n in names) and not any(n.startswith("fc1_w") for n in names)


def test_emitted_dav1_last4_taps():
    models = _pair(jax_make_v1, make_depthanythingv1_dpt, 64, 2, 6, (8, 16, 32, 64), (8, 8), 16)
    data = _export_and_compare(models, (112, 112))
    names = [t["name"] for t in decode_message("ModelProto", data)["graph"]["initializer"]]
    assert [n.split("_outnorm")[0] for n in names if "_outnorm_s" in n] == ["tap2", "tap3", "tap4", "tap5"]


def test_emitted_beit_matches_jax_forward():
    """BEiT: relpos bias baked per layer, q/v-only qkv bias, readout-project
    reassembly, no encoder output norm."""
    data = _export_and_compare(_beit(), (96, 96), emit=emit_beit_onnx)
    graph = decode_message("ModelProto", data)["graph"]
    assert "Expand" in [n["op_type"] for n in graph["node"]]  # readout-project cls broadcast
    biases = [t for t in graph["initializer"] if t["name"].startswith("attn_bias")]
    assert len(biases) == 8 and biases[0]["dims"] == [1, 4, 37, 37]


def test_emitted_beit_nonbase_grid_rescales_lut():
    # 96x128 -> grid (6, 8): the export-time LUT bilinear rescale on the non-square axis
    _export_and_compare(_beit(), (96, 128), emit=emit_beit_onnx)


def test_emitted_swinv2_matches_jax_forward():
    """SwinV2: cyclic-shift rolls as Slice+Concat, baked 0/-100 shift masks,
    cosine attention (l2 normalize + logit_scale), per-block baked CPB bias,
    patch-merge strided slices, eps=1e-5 LayerNorms."""
    data = _export_and_compare(_swinv2(), (64, 64), emit=emit_swinv2_onnx)
    graph = decode_message("ModelProto", data)["graph"]
    inits = graph["initializer"]
    assert len([t for t in inits if "_cpb" in t["name"]]) == 8  # one per block: 4 stages x 2
    masks = [t for t in inits if "_mask" in t["name"]]
    assert masks and all(t["dims"][1] == 1 for t in masks)  # (nW, 1, A, A)
    ln_eps = {a["f"] for n in graph["node"] if n["op_type"] == "LayerNormalization"
              for a in n.get("attribute", []) if a["name"] == "epsilon"}
    assert len(ln_eps) == 1 and next(iter(ln_eps)) == pytest.approx(1e-5)


def test_emitted_swinv2_nonsquare_window_replan():
    # 96x64 -> grid (24, 16): stage 2's (6, 4) grid forces the nearest-divisor
    # window replan to a non-square (6, 4) window (models/swinv2.py:window_plan)
    _export_and_compare(_swinv2(), (96, 64), emit=emit_swinv2_onnx)


def test_bf16_model_exports_f32_weights():
    jax_model = jax_make_v2(*DA_ARGS, seed=SEED)  # float32: the parity mode the bf16 model's graph is held to
    port_model = make_depthanythingv2_dpt(*DA_ARGS, seed=SEED, dtype=torch.bfloat16, device=DEVICE)
    onnx_bytes = emit_depth_anything_onnx(port_model, (112, 112))
    for t in decode_message("ModelProto", onnx_bytes)["graph"]["initializer"]:
        assert t["data_type"] in (DT_FLOAT, DT_INT64), t["name"]
    # the f32 graph of bf16-rounded weights against the f32 JAX forward of the same rounded weights
    rounded = jax_make_v2(*DA_ARGS, seed=SEED, dtype=jnp.bfloat16).to(jnp.float32)
    x = np.random.default_rng(1).standard_normal((1, 3, 112, 112)).astype(np.float32) * 0.5
    want = np.asarray(rounded.forward(jnp.asarray(x)), np.float32)
    (got,) = evaluate_model(onnx_bytes, {"image": x}).values()
    assert _abs_rel(got, want) < TOL
    assert _abs_rel(got, np.asarray(jax_model.forward(jnp.asarray(x)), np.float32)) > TOL  # the rounding shows


def test_codec_preserves_unknown_fields_through_roundtrip():
    """Fields outside the transcribed schema subset survive a parse ->
    serialize round trip verbatim (ModelProto.functions or training_info of
    a foreign file, say)."""
    foreign = bytes([0x08, 0x08]) + bytes([0xA2, 0x01, 0x03]) + b"xyz" + bytes([0x98, 0x06, 0x2A])
    msg = decode_message("ModelProto", foreign)
    assert msg["ir_version"] == 8
    assert ("_unknown" in msg) and len(msg["_unknown"]) == 2
    assert decode_message("ModelProto", encode_message("ModelProto", msg)) == msg


def _dims(value_info):
    return [d.get("dim_param", d.get("dim_value")) for d in value_info["type"]["tensor_type"]["shape"]["dim"]]


def test_emitted_dav2_dynamic_axes():
    """Dynamic batch/height/width export: ONE artifact runs at several sizes
    and batch > 1. The pos-embed bicubic resize, the token->grid reshapes and
    the fusion/head upsamples move in-graph."""
    jax_model, port_model = _da()
    data = emit_depth_anything_onnx(port_model, dynamic=True)
    parsed = decode_message("ModelProto", data)
    assert _dims(parsed["graph"]["input"][0]) == ["batch", 3, "height", "width"]
    assert all(isinstance(d, str) for d in _dims(parsed["graph"]["output"][0]))
    assert any(t["name"].startswith("pos_embed_grid") for t in parsed["graph"]["initializer"])
    rng = np.random.default_rng(1)
    # (112,112): base grid (identity resize); (84,140): non-square in-graph bicubic resize; (56,56) B=2: dynamic batch
    for b, hw in ((1, (112, 112)), (1, (84, 140)), (2, (56, 56))):
        x = rng.standard_normal((b, 3, *hw)).astype(np.float32) * 0.5
        want = np.asarray(jax_model.forward(jnp.asarray(x)), np.float32)
        (got,) = evaluate_model(data, {"image": x}).values()
        assert got.shape == want.shape, (b, hw, got.shape, want.shape)
        assert _abs_rel(got, want) < TOL, (b, hw)


def test_emitted_dav1_dynamic_axes():
    """DA-V1 (last-4-blocks taps) through the same dynamic emitter."""
    jax_model, port_model = _pair(jax_make_v1, make_depthanythingv1_dpt, 64, 2, 6, (8, 16, 32, 64), (8, 8), 16)
    data = emit_depth_anything_onnx(port_model, dynamic=True)
    x = np.random.default_rng(2).standard_normal((1, 3, 84, 112)).astype(np.float32) * 0.5
    want = np.asarray(jax_model.forward(jnp.asarray(x)), np.float32)
    (got,) = evaluate_model(data, {"image": x}).values()
    assert _abs_rel(got, want) < TOL


def test_emitted_beit_dynamic_axes():
    """Dynamic batch/height/width BEiT export: ONE artifact runs at several
    grids and batch > 1. The relpos LUT bilinear rescale, the (N-1, N-1)
    relative-index build and the per-block bias gather move in-graph."""
    jax_model, port_model = _beit()
    data = emit_beit_onnx(port_model, dynamic=True)
    parsed = decode_message("ModelProto", data)
    assert _dims(parsed["graph"]["input"][0]) == ["batch", 3, "height", "width"]
    assert all(isinstance(d, str) for d in _dims(parsed["graph"]["output"][0]))
    names = {t["name"] for t in parsed["graph"]["initializer"]}
    assert any(n.startswith("relpos_lut_grid") for n in names)  # the LUT rides along unbaked
    assert not any(n.startswith("attn_bias") for n in names)
    rng = np.random.default_rng(3)
    for b, hw in ((1, (96, 96)), (1, (96, 128)), (2, (64, 64))):
        x = rng.standard_normal((b, 3, *hw)).astype(np.float32) * 0.5
        want = np.asarray(jax_model.forward(jnp.asarray(x)), np.float32)
        (got,) = evaluate_model(data, {"image": x}).values()
        assert got.shape == want.shape, (b, hw, got.shape, want.shape)
        assert _abs_rel(got, want) < TOL, (b, hw)


def _decoded(data: bytes, jax_decode_fn):
    model = jax_decode_fn("ModelProto", data)
    return model.pop("producer_name"), model


@pytest.mark.parametrize("image_hw", [(112, 112), (112, 168)])
def test_both_packages_emit_the_same_graph(image_hw):
    """A tiny DA-V2 from one checkpoint: the port's graph decodes to the JAX
    package's node for node (op, inputs, outputs, names, attributes) and
    initializer for initializer, byte for byte, but for the producer name. At
    the base grid (112x112) every initializer matches. Off it (112x168) the
    position embedding is resized at export time, by
    ``ops/resize.py:resize_bicubic_hwc`` in the port and by the JAX
    package's resize matrices: the same bicubic weights, summed in another
    float32 order, so ``pos_embed`` alone differs, within 1e-6."""
    jax_model, port_model = _da()
    port_producer, ours = _decoded(emit_depth_anything_onnx(port_model, image_hw), jax_decode)
    jax_producer, theirs = _decoded(jax_emit_da(jax_model, image_hw), jax_decode)
    assert (port_producer, jax_producer) == ("muggled_dpt_tpu_torch", "muggled_dpt_tpu")
    ours_graph, theirs_graph = ours.pop("graph"), theirs.pop("graph")
    assert ours == theirs  # ir_version, opset, producer_version
    assert ours_graph["node"] == theirs_graph["node"]
    assert [ours_graph[k] for k in ("name", "input", "output", "doc_string")] == \
        [theirs_graph[k] for k in ("name", "input", "output", "doc_string")]
    ours_inits = {t["name"]: t for t in ours_graph["initializer"]}
    theirs_inits = {t["name"]: t for t in theirs_graph["initializer"]}
    assert list(ours_inits) == list(theirs_inits)
    differ = [name for name in ours_inits if ours_inits[name] != theirs_inits[name]]
    if image_hw == (112, 112):
        assert differ == []
    else:
        assert [name.rsplit("_", 1)[0] for name in differ] == ["pos_embed"]
        a, b = (np.frombuffer(inits[differ[0]]["raw_data"], np.float32) for inits in (ours_inits, theirs_inits))
        assert ours_inits[differ[0]]["dims"] == theirs_inits[differ[0]]["dims"]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
