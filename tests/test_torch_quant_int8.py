"""The port's opt-in int8 (w8a8) tier (``muggled_dpt_tpu_torch/ops/quant.py``,
``DPTModel.quantize_encoder_int8``) against its own dense models and
against the JAX package's int8 tier (``muggled_dpt_tpu/ops/quant.py``).

The cases of tests/test_quant_int8.py, each with its JAX gate (the
StableHLO export and the phase-fused reassembly taps have no counterpart in
the port: export is a later item, and the port's reassembly keeps the
dense transposed-conv + 3x3 pair), plus parity: the port's float32 int8
model against the JAX package's float32 int8 model from the same seed,
with the JAX package's quantized leaves carried across by
``checkpoints/from_jax.py``, within the repo's 1e-3 abs-rel budget.

Parity runs both models on the JAX package's preprocessed frame, the JAX
forward op by op (``_jax_depth``), not under ``jax.jit``: on the CPU, XLA's
jit rewrites the scale's division by 127 into a multiply by its reciprocal,
which moves 4 % of the per-token quotients by one ulp, and the JAX int8
SwinV2 model's jitted and op-by-op forwards differ by 2.5e-3 abs-rel on the
frame below (its dense forwards agree to 0). The port follows the op-by-op
arithmetic. Parity is still looser than the dense models' ~1e-7: a float32
summation-order difference that moves an activation across a rounding
boundary becomes a whole int8 step; the port's int8 DA-V2 model moves by
1e-5 to 4e-5 under a 1e-7 relative change of its own input, the dense one by
5e-8."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from muggled_dpt_tpu.make_beit_dpt import make_beit_dpt as jax_make_beit
from muggled_dpt_tpu.make_depthanythingv2_dpt import make_depthanythingv2_dpt as jax_make_da
from muggled_dpt_tpu.make_swinv2_dpt import make_swinv2_dpt as jax_make_swin
from muggled_dpt_tpu.ops import nn as jnn
from muggled_dpt_tpu.ops import quant as jq
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv2_dpt, make_swinv2_dpt
from muggled_dpt_tpu_torch.checkpoints.from_jax import beit_params_from_jax, params_from_jax, swinv2_params_from_jax
from muggled_dpt_tpu_torch.ops import quant as tq

DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
PARITY_BUDGET = 1e-3
DA = (64, 2, 4, (8, 16, 32, 64), (8, 8), 16)  # F, heads, blocks, reassembly, base grid, fusion
BEIT = (64, 4, 8, (8, 16, 32, 64), (6, 6), 16)
SWIN = ((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16)
FACTORIES = {  # family: (port factory, JAX factory, positional config, from_jax)
    "da": (make_depthanythingv2_dpt, jax_make_da, DA, params_from_jax),
    "beit": (make_beit_dpt, jax_make_beit, BEIT, beit_params_from_jax),
    "swin": (make_swinv2_dpt, jax_make_swin, SWIN, swinv2_params_from_jax),
}


def _frame(seed):
    return np.random.default_rng(seed).integers(0, 256, (120, 160, 3), np.uint8)


def _abs_rel(ours, ref) -> float:
    ours, ref = (np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32) for a in (ours, ref))
    return float(np.mean(np.abs(ours - ref)) / max(np.abs(ref).mean(), 1e-9))


def _pair(family, dtype=torch.float32, **kw):
    """The port's and the JAX package's model of a family, same seed."""
    make, jax_make, cfg, _ = FACTORIES[family]
    jax_dtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return make(*cfg, dtype=dtype, device=DEVICE, **kw), jax_make(*cfg, dtype=jax_dtype, **kw)


def _jax_depth(jax_model, frame):
    """The JAX model's depth for a frame, its forward run op by op (f32
    parity mode: highest matmul precision), and the preprocessed frame."""
    x = np.asarray(jax_model.prepare_image_bgr(frame))
    p = jax_model.patch_size_px
    aux = jax_model._get_aux((x.shape[2] // p, x.shape[3] // p))
    with jax.default_matmul_precision("highest"):
        depth = jax_model.spec["forward"](jax_model.params, jnp.asarray(x.transpose(0, 2, 3, 1)), aux)
    return np.asarray(depth), torch.from_numpy(x)


def _parity(port_int8, jax_int8, frame) -> float:
    """Depth abs-rel of the port's model against the JAX model on the JAX
    package's preprocessed frame."""
    want, x = _jax_depth(jax_int8, frame)
    return _abs_rel(port_int8.forward(x), want)


def _carry(family, port_int8, jax_int8, same_q8=True):
    """Load the JAX int8 model's leaves into the port's int8 model (strict:
    both tiers quantized the same layers), after checking, with
    ``same_q8``, that the port's own int8 weights are the JAX package's, bit
    for bit (calibrated weights are not: their smoothing factors come from
    activations that differ in the last float32 bits between the packages)."""
    sd = FACTORIES[family][3](jax.tree_util.tree_map(np.asarray, jax_int8.params))
    for k, v in port_int8.net.state_dict().items():
        if same_q8 and k.endswith("weight_q8"):
            assert torch.equal(v, sd[k]), k
    port_int8.net.load_state_dict(sd, strict=True)
    return port_int8


def _quant_layers(net, cls):
    return {name for name, m in net.named_modules() if isinstance(m, cls)}


def test_quantize_weight_roundtrip():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 24, 16)) * 0.2).astype(np.float32)  # stacked (L, out, in)
    q, s = tq.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (3, 24)
    deq = q.float() * s[..., None]
    assert torch.all((deq - torch.from_numpy(w)).abs() <= s[..., None] / 2 + 1e-7)  # half a step at worst
    jax_q, jax_s = jq.quantize_weight(jnp.asarray(w.transpose(0, 2, 1)))  # the JAX layout (L, in, out)
    assert np.array_equal(q.numpy(), np.asarray(jax_q).transpose(0, 2, 1))
    assert np.array_equal(s.numpy(), np.asarray(jax_s)[:, 0, :])


def test_linear_w8a8_close_to_dense():
    """Close to the dense product (the JAX gate), and equal to the JAX
    function on the same input: the same int8 activations, the same int32
    accumulators and the same output."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 37, 64)).astype(np.float32)
    w = (rng.standard_normal((96, 64)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(96) * 0.1).astype(np.float32)
    q, s = tq.quantize_weight(torch.from_numpy(w))
    got = tq.linear_w8a8(torch.from_numpy(x), q, s, torch.from_numpy(b)).numpy()
    ref = x @ w.T + b
    assert np.abs(got - ref).mean() / np.abs(ref).mean() < 2e-2

    jax_q, jax_s = jq.quantize_weight(jnp.asarray(w.T))
    xf = jnp.asarray(x)
    jax_scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0  # quant.py:119-124
    jax_xq = jnp.clip(jnp.round(xf / jax_scale), -127, 127).astype(jnp.int8)
    jax_acc = jax.lax.dot_general(jax_xq, jax_q, (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    xq, x_scale = tq.quantize_per_token(torch.from_numpy(x))
    assert np.array_equal(xq.numpy(), np.asarray(jax_xq)) and np.array_equal(x_scale.numpy(), np.asarray(jax_scale))
    acc = tq.int8_matmul(xq.reshape(-1, 64), q).reshape(4, 37, 96)
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), np.asarray(jax_acc))
    assert np.array_equal(got, np.asarray(jq.linear_w8a8(xf, jax_q, jax_s, jnp.asarray(b))))


@pytest.mark.parametrize("rows", [1, 5, 16, 17, 40])
def test_int8_matmul_pads_short_inputs_without_changing_rows(rows):
    """torch._int_mm on CUDA wants more than 16 rows: fewer are padded with
    zero rows, which change no other row and are cut off."""
    rng = np.random.default_rng(rows)
    xq = torch.from_numpy(rng.integers(-127, 128, (rows, 64)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (48, 64)).astype(np.int8))
    got = tq.int8_matmul(xq, wq)
    assert got.shape == (rows, 48) and got.dtype == torch.int32
    assert torch.equal(got, (xq.long() @ wq.long().t()).int())


@pytest.mark.parametrize("is_giant,include_qkv", [(False, False), (False, True), (True, False)])
def test_int8_model_end_to_end(is_giant, include_qkv):
    m = make_depthanythingv2_dpt(*DA, is_giant=is_giant, dtype=torch.float32, device=DEVICE)
    q = m.quantize_encoder_int8(include_qkv=include_qkv)
    quantized = _quant_layers(q.net, tq.QuantLinear)
    mlp = ("w12", "w3") if is_giant else ("fc1", "fc2")
    want = {f"encoder.blocks.{i}.{n}" for i in range(4) for n in ("attn.proj", *(f"mlp.{m}" for m in mlp))}
    want |= {f"encoder.blocks.{i}.attn.qkv" for i in range(4)} if include_qkv else set()
    assert quantized == want
    assert not _quant_layers(m.net, tq.QuantLinear)  # the original is untouched
    img = _frame(0)
    d0, d1 = m.inference(img), q.inference(img)
    assert d1.shape == d0.shape
    assert _abs_rel(d1, d0) < 1e-2


@pytest.mark.parametrize("variant", ["default", "qkv", "giant", "qkv+neck"])
def test_int8_model_matches_jax(variant):
    """Measured: 9.3e-8 (default), 1.0e-5 (qkv), 1.1e-7 (giant), 4.6e-4 (qkv+neck)."""
    kw = {"is_giant": True} if variant == "giant" else {}
    opts = {"include_qkv": "qkv" in variant, "include_neck": "neck" in variant}
    tm, jm = _pair("da", **kw)
    jax_int8 = jm.quantize_encoder_int8(**opts)
    assert _parity(_carry("da", tm.quantize_encoder_int8(**opts), jax_int8), jax_int8, _frame(0)) < PARITY_BUDGET


@pytest.mark.parametrize("include_qkv", [False, True])
def test_int8_beit_end_to_end(include_qkv):
    """Parity measured: 1.4e-4 (qkv dense), 1.0e-7 (qkv)."""
    tm, jm = _pair("beit")
    img = _frame(0)
    d0 = tm.inference(img)
    q = tm.quantize_encoder_int8(include_qkv)
    assert _abs_rel(q.inference(img), d0) < 1e-2
    jax_int8 = jm.quantize_encoder_int8(include_qkv)
    assert _parity(_carry("beit", q, jax_int8), jax_int8, img) < PARITY_BUDGET


def test_int8_swinv2_mlp_only():
    tm, jm = _pair("swin")  # parity measured: 1.7e-7
    q = tm.quantize_encoder_int8()
    blocks = [b for stage in q.net.encoder.stages for b in stage]
    assert all(isinstance(b.fc1, tq.QuantLinear) and isinstance(b.fc2, tq.QuantLinear) for b in blocks)
    assert not any(isinstance(b.qkv, tq.QuantLinear) or isinstance(b.proj, tq.QuantLinear) for b in blocks)
    img = _frame(0)
    assert _abs_rel(q.inference(img), tm.inference(img)) < 2e-2  # the JAX gate (test_quant_int8.py:80-83)
    jax_int8 = jm.quantize_encoder_int8()
    assert _parity(_carry("swin", q, jax_int8), jax_int8, img) < PARITY_BUDGET


def test_int8_swinv2_calibration_is_refused():
    m = make_swinv2_dpt(*SWIN, device=DEVICE)
    with pytest.raises(NotImplementedError):
        m.quantize_encoder_int8(calibration_images=[_frame(1)])


def test_int8_calibration_without_stats_raises(monkeypatch):
    m = make_depthanythingv2_dpt(*DA, device=DEVICE)
    monkeypatch.setattr(tq, "_record_activation", lambda name, x: None)
    with pytest.raises(RuntimeError, match="no activation stats"):
        m.quantize_encoder_int8(include_qkv=True, calibration_images=[_frame(1)])


def test_int8_calibrated_qkv():
    """SmoothQuant calibration keeps include_qkv=True close to dense and no
    worse than the uncalibrated qkv tier (the JAX gates); the port's
    calibrated model matches the JAX package's with its leaves carried."""
    m, jm = make_depthanythingv2_dpt(*DA[:2], 8, *DA[3:], device=DEVICE), jax_make_da(*DA[:2], 8, *DA[3:], dtype=jnp.float32)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(2)]
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    d0 = m.inference(img)
    q_plain = m.quantize_encoder_int8(include_qkv=True)
    q_cal = m.quantize_encoder_int8(include_qkv=True, calibration_images=frames)
    blocks = q_cal.net.encoder.blocks
    assert all(b.attn.qkv.act_smooth is not None and b.mlp.fc1.act_smooth is not None for b in blocks)
    assert len(blocks) == 8 and blocks[0].attn.qkv.act_smooth.shape == (64,)
    e_plain, e_cal = _abs_rel(q_plain.inference(img), d0), _abs_rel(q_cal.inference(img), d0)
    assert e_cal < 5e-2, e_cal
    assert e_cal <= e_plain * 1.25 + 1e-3, (e_cal, e_plain)

    jax_cal = jm.quantize_encoder_int8(include_qkv=True, calibration_images=frames)
    theirs = np.asarray(jax_cal.params["encoder"]["blocks"]["qkv_act_smooth"])
    ours = np.stack([b.attn.qkv.act_smooth.numpy() for b in blocks])
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)  # calibrated on activations equal to ~1e-6
    assert _parity(_carry("da", q_cal, jax_cal, same_q8=False), jax_cal, img) < PARITY_BUDGET


def test_int8_calibrated_qkv_beit():
    """BEiT reuses the DINOv2 block, so its qkv and proj carry their
    act_smooth (the JAX package had to pass them through by hand: without
    them the folded factors go uncancelled and the model diverges)."""
    tm, jm = _pair("beit")
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(2)]
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    q_cal = tm.quantize_encoder_int8(include_qkv=True, calibration_images=frames)
    assert all(b.attn.qkv.act_smooth is not None and b.attn.proj.act_smooth is not None for b in q_cal.net.encoder.blocks)
    assert _abs_rel(q_cal.inference(img), tm.inference(img)) < 2e-2
    jax_cal = jm.quantize_encoder_int8(include_qkv=True, calibration_images=frames)
    assert _parity(_carry("beit", q_cal, jax_cal, same_q8=False), jax_cal, img) < PARITY_BUDGET


def _scales(net):
    """(name, dtype) of every int8 weight's scale sibling and every act_smooth."""
    buffers = dict(net.named_buffers())
    found = [(k[: -len("weight_q8")] + "weight_scale") for k in buffers if k.endswith("weight_q8")]
    found += [k for k in buffers if k.endswith("act_smooth")]
    return {k: buffers[k].dtype if k in buffers else None for k in found}


def test_act_smooth_stays_f32_under_bf16_model():
    m = make_depthanythingv2_dpt(*DA, dtype=torch.bfloat16, device=DEVICE)
    rng = np.random.default_rng(6)
    q = m.quantize_encoder_int8(include_qkv=True, calibration_images=[rng.integers(0, 256, (120, 160, 3), np.uint8)])
    b = q.net.encoder.blocks[0]
    assert b.attn.qkv.act_smooth.dtype == torch.float32 and b.mlp.fc1.weight_scale.dtype == torch.float32
    assert b.mlp.fc1.bias.dtype == torch.bfloat16  # biases follow the compute dtype
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    assert q.inference(img).shape == m.inference(img).shape


def test_scales_stay_f32_under_to():
    """DPTModel.to casts every float tensor to the new dtype but the int8
    scales and act_smooth (the JAX package's ``_cast_dtype`` exemption)."""
    m = make_beit_dpt(*BEIT, device=DEVICE)
    rng = np.random.default_rng(7)
    q = m.quantize_encoder_int8(include_qkv=True, calibration_images=[rng.integers(0, 256, (120, 160, 3), np.uint8)],
                                include_neck=True)
    before = {k: v.clone() for k, v in q.net.named_buffers() if tq.is_scale_key(k)}
    q16 = q.to(torch.bfloat16)
    scales = _scales(q16.net)
    assert scales and set(scales.values()) == {torch.float32}, scales
    assert all(torch.equal(v, dict(q16.net.named_buffers())[k]) for k, v in before.items())
    assert q16.net.encoder.blocks[0].attn.qkv.bias.dtype == torch.bfloat16
    assert q16.net.encoder.blocks[0].attn.qkv.weight_q8.dtype == torch.int8
    assert _abs_rel(q16.inference(_frame(8)), q.inference(_frame(8))) < 3e-2


def test_all_quant_scales_stay_f32_under_bf16_full_tier():
    """Every int8 weight's scale exists and is float32 in a bf16 model of
    the whole tier, the BEiT readout's and the shiftsum convolutions'
    included."""
    m = make_beit_dpt(*BEIT, dtype=torch.bfloat16, device=DEVICE)
    q = m.quantize_encoder_int8(include_qkv=True, include_neck=True)
    scales = _scales(q.net)
    assert set(scales.values()) == {torch.float32}, scales
    assert "reassemble.0.readout.weight_scale" in scales
    assert any(k.startswith("fusion.") and k.endswith("conv1.weight_scale") for k in scales)
    assert "head.conv_in.weight_scale" in scales and "head.conv_mid.weight_scale" in scales


def test_smoothing_factorization_is_exact():
    """x @ w.T == (x / s) @ (w * s).T before quantization: the smoothing
    transform adds no error beyond float rounding."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 8, 16)).astype(np.float32)  # (L, out, in)
    acts = {"fc1": [np.abs(rng.standard_normal(16)).astype(np.float32) * (10 ** rng.uniform(-2, 2)) for _ in range(3)]}
    s = tq.compute_smoothing({"fc1": w}, acts, subset=("fc1",))["fc1"]
    x = rng.standard_normal((5, 16)).astype(np.float32)
    for layer in range(3):
        np.testing.assert_allclose((x / s[layer]) @ (w[layer] * s[layer]).T, x @ w[layer].T, rtol=2e-5, atol=2e-5)


def test_compute_smoothing_matches_jax():
    rng = np.random.default_rng(9)
    weights = {"qkv": rng.standard_normal((4, 24, 8)).astype(np.float32), "fc2": rng.standard_normal((4, 8, 32)).astype(np.float32)}
    acts = {name: [np.abs(rng.standard_normal(w.shape[-1])).astype(np.float32) * (10 ** rng.uniform(-2, 2)) for _ in range(4)]
            for name, w in weights.items()}
    ours = tq.compute_smoothing(weights, acts)
    theirs = jq.compute_smoothing({f"{n}_kernel": w.transpose(0, 2, 1) for n, w in weights.items()}, acts)
    assert set(ours) == set(theirs) == {"qkv", "fc2"}
    for name in ours:
        assert ours[name].dtype == np.float32 and np.array_equal(ours[name], theirs[name]), name


def test_int8_include_neck_end_to_end():
    """The whole tier (encoder, reassembly and readout projections, fusion
    convolutions and outputs, head conv_in and conv_mid) in bf16 stays close
    to the bf16 model; the head's final 1x1 stays dense. The port keeps the
    resample and fuse convolutions dense in both dtypes (the JAX package's
    bf16 tier also quantizes its phase-fused form of them, which the port
    does not have)."""
    m = make_depthanythingv2_dpt(*DA, dtype=torch.bfloat16, device=DEVICE)
    q = m.quantize_encoder_int8(include_neck=True)
    net = q.net
    for stage in net.reassemble:
        assert isinstance(stage.proj, tq.QuantLinear) and isinstance(stage.fuse, torch.nn.Conv2d)
    for blk in net.fusion:
        assert isinstance(blk.out, tq.QuantLinear) and isinstance(blk.res2.conv1, tq.QuantConv3x3)
        assert blk.res2.conv1.weight_scale.dtype == torch.float32
    assert isinstance(net.head.conv_in, tq.QuantConv3x3) and isinstance(net.head.conv_mid, tq.QuantConv3x3)
    assert isinstance(net.head.proj, torch.nn.Conv2d)  # final 1x1 stays dense
    img = _frame(2)
    d0, d1 = m.inference(img), q.inference(img)
    assert d1.shape == d0.shape and bool(torch.isfinite(d1).all())
    assert _abs_rel(d1, d0) < 3e-2
    s = make_swinv2_dpt(*SWIN, device=DEVICE)
    assert bool(torch.isfinite(s.quantize_encoder_int8(include_neck=True).inference(img)).all())


def test_int8_include_neck_beit():
    m = make_beit_dpt(*BEIT, dtype=torch.bfloat16, device=DEVICE)
    q = m.quantize_encoder_int8(include_neck=True)
    assert all(isinstance(stage.readout, tq.QuantLinear) for stage in q.net.reassemble)
    img = _frame(3)
    d1 = q.inference(img)
    assert bool(torch.isfinite(d1).all()) and _abs_rel(d1, m.inference(img)) < 3e-2


def test_int8_include_neck_beit_matches_jax_f32():
    """In float32 the JAX package's neck tier is the port's (its phase-fused
    taps exist only in bf16): BEiT int8+qkv+neck parity with every leaf
    carried (measured 4.8e-4). Not for the toy SwinV2: its int8 neck (fusion
    16 channels, head 8 -> 32) moves by 4.0e-3 to 4.8e-3 abs-rel under a
    1e-7 relative change of its own input (its dense model by 2e-7), so no
    implementation can hold it to 1e-3; its layers are the DA and BEiT ones
    held here."""
    tm, jm = _pair("beit")
    opts = {"include_qkv": True, "include_neck": True}
    jax_int8 = jm.quantize_encoder_int8(**opts)
    assert _parity(_carry("beit", tm.quantize_encoder_int8(**opts), jax_int8), jax_int8, _frame(4)) < PARITY_BUDGET


def test_int8_shiftsum_conv_close_to_dense():
    """The shiftsum int8 3x3 convolution against the dense one (the JAX
    gate) and against the JAX package's on the same int8 weights."""
    rng = np.random.default_rng(7)
    ci, co = 32, 24
    weight = rng.normal(0, 0.2, (co, ci, 3, 3)).astype(np.float32)  # OIHW
    bias = rng.normal(0, 0.1, (co,)).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 1.0, (1, ci, 9, 11)).astype(np.float32)).to(torch.bfloat16)
    conv = torch.nn.Conv2d(ci, co, 3, padding=1)
    conv.weight.data, conv.bias.data = torch.from_numpy(weight), torch.from_numpy(bias)
    layer = tq.QuantConv3x3.from_conv(conv)
    assert layer.weight_q8.shape == (9 * co, ci) and layer.weight_q8.dtype == torch.int8
    with torch.no_grad():
        dense = torch.nn.functional.conv2d(x.float(), conv.weight, conv.bias, padding=1)
        got = tq.conv3x3_p(x, layer)
    assert got.shape == dense.shape and got.dtype == torch.bfloat16
    assert float((got.float() - dense).abs().mean() / dense.abs().mean()) < 2e-2

    jax_q, jax_s = jq.quantize_conv3x3_weight(jnp.asarray(weight.transpose(2, 3, 1, 0)))  # HWIO
    assert np.array_equal(layer.weight_q8.numpy(), np.asarray(jax_q).T)
    x_nhwc = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
    want = jq.conv3x3_shiftsum_w8a8(x_nhwc, jax_q, jax_s, jnp.asarray(bias))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(), np.asarray(want.astype(jnp.float32)))
    dense_jax = jnn.conv2d(jnp.asarray(x_nhwc, jnp.float32), jnp.asarray(weight.transpose(2, 3, 1, 0)), jnp.asarray(bias), padding=1)
    np.testing.assert_allclose(dense.permute(0, 2, 3, 1).numpy(), np.asarray(dense_jax), rtol=1e-4, atol=1e-4)
