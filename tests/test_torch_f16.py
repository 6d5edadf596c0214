"""float16 serving of the PyTorch port (the apps' ``-u``), on the CPU: no
card, nvcc or triton needed.

1. The plain versions of TPU kernels #1/#2 (``flash_attention_fused_qkv``:
   no bias, a bias, ``bias_stack`` + ``layer``) and #3
   (``window_attention``: with and without the shift mask; float16 biases,
   and float32 biases beside float16 q, k, v, the route of SwinV2's inline
   tables) in float16, against the JAX package's Pallas kernels in
   interpret mode fed the same float16 inputs, at ragged N and with every
   logit far below 0. Tolerance 2e-3 max abs: one float16 ulp at outputs in
   [2, 4) (both sides round p to float16 before PV and the output once);
   measured 4.9e-4 to 9.8e-4 here, one ulp at [0.5, 2). The unbiased JAX
   kernel also rounds q * scale * log2(e) to float16 a second time
   (``muggled_dpt_tpu/ops/pallas/flash_attention.py:174``), which the port
   does not; on the all-negative slab (|logit| about 50) that moves each
   logit by up to |logit| 2^-11, about 0.03, and the outputs by a few ulps:
   4e-3 there (measured 2.9e-3).
2. The slice: tiny DA-V2, BEiT (aux cache on and off) and SwinV2 (aux cache
   on and off) models built in float16 on the CPU (the kernels' plain
   versions), against the JAX package's float32 model on the same
   checkpoint and frame. The JAX float16 model cannot run on the CPU:
   ``jax.nn.dot_product_attention`` in float16 raises "The precision
   'F16_F16_F32' is not supported by dot_general on CPU"
   (``muggled_dpt_tpu/ops/nn.py:112``), so float16 is held against float32.
   The output is float16 and finite, lies within ``F16_VS_F32`` of the JAX
   float32 depth (mean abs-rel; measured 3.3e-4 DA-V2, 2.4e-4 BEiT, 6.7e-4
   and 7.7e-4 SwinV2 cached and inline; each limit about 3x its
   measurement), and nearer to it than the port's bfloat16 model (measured
   2.4e-3, 2.0e-3, 4.9e-3 and 4.4e-3). The aux caches build in float16;
   SwinV2's inline tables stay float32. The int8 tier runs on a float16
   model with float32 scales, within the tier's own error of the float16
   dense model (3e-2 mean abs-rel, the bf16 tier's gate in
   tests/test_torch_quant_int8.py); ``DPTModel.to(torch.float16)`` serves
   float16.
3. The wrappers' float16 contract on the CUDA route, through the stub
   libraries of tests/test_torch_flash_sm90_bias.py and
   tests/test_torch_window_sm90.py: float16 q, k, v pack dtype code 2, a
   float16 bias bias code 2, a float16 bias a tensor map reads gets
   ``BIAS_FILL_TMA``; float16 with float32 window biases keeps them float32
   (window_attention.cu); float16 launches count on routes of their own
   (``fused_f16``, ``fused_biased_f16``, ``bnhd_f16``, ``window_f16``,
   ``window_sm90_f16``); a float16 bias beside bfloat16 or float32 q and a
   bfloat16 bias beside float16 q are refused, as are float64 and the meta
   device; and whole float16
   forwards of the toy DA-V2, BEiT and SwinV2 models launch only on the
   float16 routes; the ``mdpt::`` operators pass float16 through.
4. ``make_device_config``: float16 for ``-u`` on a (stubbed) card, float32
   on the CPU, as the JAX package's."""

import array
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muggled_dpt_tpu.make_dpt import make_dpt_from_state_dict as jax_make_dpt
from muggled_dpt_tpu.ops.pallas.flash_attention import flash_attention_fused_qkv as jax_fused_qkv
from muggled_dpt_tpu.ops.pallas.window_attention import window_flash_attention as jax_window
from muggled_dpt_tpu_torch import make_dpt_from_state_dict
from muggled_dpt_tpu_torch.checkpoints.beit import random_original_state_dict as beit_state_dict
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.checkpoints.swinv2 import random_original_state_dict as swinv2_state_dict
from muggled_dpt_tpu_torch.demo_helpers import misc
from muggled_dpt_tpu_torch.ops import quant as tq
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import window_attention as wa
from test_torch_flash_sm90_bias import StubLibrary, _slots
from test_torch_parity_beit import CFG as BEIT_CFG
from test_torch_parity_da_v2 import CFG as DA_CFG
from test_torch_parity_swinv2 import D32_CFG as SWIN_CFG
from test_torch_window_sm90 import Sm90Stub

F16 = torch.float16
KERNEL_MAX_ABS = 2e-3  # one float16 ulp at outputs in [2, 4)
ALL_NEGATIVE_UNBIASED_MAX_ABS = 4e-3  # the JAX unbiased kernel's second rounding of q * scale at |logit| ~ 50
# mean abs-rel of the port's float16 model from the JAX float32 model: about 3x each family's measurement
F16_VS_F32 = {"DA-V2": 1e-3, "BEiT": 1e-3, "SwinV2": 2e-3}
INT8_TIER_REL = 3e-2  # the int8 tier against its dense model (tests/test_torch_quant_int8.py, bf16)
DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
D, WD = 64, 32  # head widths of #1/#2 and of #3


def _rand(seed, *shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _t(a, dtype=F16):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _max_abs(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, dtype=np.float32)).max())


def _abs_rel(ours, ref) -> float:
    ours, ref = np.asarray(ours, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    return float(np.abs(ours - ref).mean() / (np.abs(ref).mean() + 1e-12))


def _qkv(seed, b, n, h, all_negative=False):
    """A head-major (B, N, 3 H D) slab; all_negative: q = -8|x|, k = |y|,
    so every logit lies far below 0."""
    x = _rand(seed, b, n, h, 3, D)
    if all_negative:
        x[..., 0, :] = -8.0 * np.abs(x[..., 0, :])
        x[..., 1, :] = np.abs(x[..., 1, :])
    return x.reshape(b, n, h * 3 * D)


def _bias_kw(kind, seed, n, h):
    if kind == "none":
        return {}
    if kind == "bias":
        return {"bias": _rand(seed, 1, h, n, n)}
    n_pad = (n + 127) // 128 * 128  # the JAX kernel's stack layout
    stack = _rand(seed, 3, h, n_pad, n_pad)
    stack[..., n:, :] = 1e4  # pads, never read (float16 holds 1e4)
    stack[..., :, n:] = 1e4
    return {"bias_stack": stack, "layer": 2}


FUSED_CASES = [(n, kind, False) for n in (33, 130) for kind in ("none", "bias", "stack")]
FUSED_CASES += [(130, kind, True) for kind in ("none", "bias", "stack")]  # every logit far below 0


@pytest.mark.parametrize("n,kind,all_negative", FUSED_CASES)
def test_fused_plain_version_matches_jax_kernel_in_f16(n, kind, all_negative):
    """#1 and #2 in float16: the CPU wrapper (the plain version) against
    flash_attention_fused_qkv in interpret mode, both fed float16."""
    h = 2
    qkv = _qkv(n, 2, n, h, all_negative)
    kw = _bias_kw(kind, n + 1, n, h)
    jkw = {k: jnp.asarray(v, jnp.float16) if isinstance(v, np.ndarray) else np.int32(v) for k, v in kw.items()}
    want = np.asarray(jax_fused_qkv(jnp.asarray(qkv, jnp.float16), h, interpret=True, **jkw))
    got = fa.flash_attention_fused_qkv(_t(qkv), h, **{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    assert got.dtype == F16 and want.dtype == np.float16 and got.shape == want.shape
    assert _max_abs(got, want) <= (ALL_NEGATIVE_UNBIASED_MAX_ABS if all_negative and kind == "none" else KERNEL_MAX_ABS)


def _windows(area, with_mask, seed):
    """#3's operands as the SwinV2 block hands them over: q l2-normalized
    times a logit scale of 10, k l2-normalized, cpb = 16 sigmoid(N(0, 1)),
    a 0 / -100 mask."""
    q, k, v = (_rand(seed + i, 1, 2, area, 2, WD) for i in range(3))
    q *= 10.0 / np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    cpb = 16.0 / (1.0 + np.exp(-_rand(seed + 3, 2, area, area)))
    mask = np.where(np.random.default_rng(seed).random((2, area, area)) < 0.3, -100.0, 0.0).astype(np.float32)
    return q, k, v, cpb, mask if with_mask else None


@pytest.mark.parametrize("area", [65, 144])  # ragged past one 64-key tile; SwinV2-L-384's stage 4
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("bias_dtype", [F16, torch.float32])
def test_window_plain_version_matches_jax_kernel_in_f16(area, with_mask, bias_dtype):
    """#3 with float16 q, k, v: float16 biases (the cached CPB and mask) and
    float32 ones (the inline tables), the JAX kernel fed the same."""
    q, k, v, cpb, mask = _windows(area, with_mask, area)
    jdt = jnp.float16 if bias_dtype == F16 else jnp.float32
    jb = [None if t is None else jnp.asarray(t, jdt) for t in (cpb, mask)]
    want = np.asarray(jax_window(*(jnp.asarray(t, jnp.float16) for t in (q, k, v)), *jb, interpret=True))
    got = wa.window_attention(_t(q), _t(k), _t(v), _t(cpb, bias_dtype), _t(mask, bias_dtype))
    assert got.dtype == F16 and want.dtype == np.float16
    assert _max_abs(got, want) <= KERNEL_MAX_ABS


def _save(sd, path) -> str:
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, str(path))
    return str(path)


FAMILIES = {  # name: (state dict, file name, inference side)
    "DA-V2": (lambda: random_original_depth_anything_state_dict(DA_CFG, seed=5), "depth_anything_v2_tiny.pth", 112),
    "BEiT": (lambda: beit_state_dict(BEIT_CFG, seed=5), "dpt_beit_tiny_512.pt", 128),
    "SwinV2": (lambda: swinv2_state_dict(SWIN_CFG, seed=21), "swin2_tiny_256.pt", 128),
}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    folder = tmp_path_factory.mktemp("ckpts")
    return {name: _save(make(), folder / file) for name, (make, file, _) in FAMILIES.items()}


def _frame(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (120, 160, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_f32_depth(ckpts):
    """name -> the JAX package's float32 depth of ``_frame()`` at the
    family's side, computed once (its aux cache on: the JAX float32 model
    gives the same depth with it off, to float32 round-off)."""
    depths = {}

    def depth(name):
        if name not in depths:
            depths[name] = np.asarray(jax_make_dpt(ckpts[name])[1].inference(_frame(), FAMILIES[name][2]))
        return depths[name]

    return depth


@pytest.mark.parametrize("name,enable_cache", [("DA-V2", True), ("BEiT", True), ("BEiT", False), ("SwinV2", True),
                                                ("SwinV2", False)])
def test_f16_model_is_nearer_jax_f32_than_bf16(ckpts, jax_f32_depth, name, enable_cache):
    """The slice on the CPU: the float16 model, with its aux cache on and
    off, against the JAX float32 model, gated at F16_VS_F32 and below the
    port's bfloat16 model's own distance."""
    side = FAMILIES[name][2]
    frame = _frame()
    want = jax_f32_depth(name)
    depths = {}
    for dtype in (F16, torch.bfloat16):
        model = make_dpt_from_state_dict(ckpts[name], dtype=dtype, device=DEVICE)[1]
        model.config["enable_cache"] = enable_cache
        depths[dtype] = model.inference(frame, side)
        if dtype == F16 and enable_cache and name != "DA-V2":
            aux = next(iter(model._aux_cache.values()))
            tables = [aux] if name == "BEiT" else [t for stage in aux for t in stage.values() if t is not None]
            assert tables and {t.dtype for t in tables} == {F16}  # the aux builds in the model's dtype
    d16 = depths[F16]
    assert d16.dtype == F16 and tuple(d16.shape) == want.shape and bool(torch.isfinite(d16).all())
    rel16, rel_bf16 = _abs_rel(d16.float().numpy(), want), _abs_rel(depths[torch.bfloat16].float().numpy(), want)
    assert rel16 <= F16_VS_F32[name] and rel16 < rel_bf16, (rel16, rel_bf16)


def test_swinv2_inline_tables_stay_f32_in_f16(ckpts, monkeypatch):
    """With the aux cache off a float16 SwinV2 block hands its window
    attention float32 CPB tables and masks beside float16 q, k and v, as
    the bfloat16 model does (route ``window_f16`` on the card)."""
    model = make_dpt_from_state_dict(ckpts["SwinV2"], dtype=F16, device=DEVICE)[1]
    model.config["enable_cache"] = False
    seen = []
    real = wa.window_attention

    def record(q, k, v, cpb, mask=None):
        seen.append((q.dtype, cpb.dtype, None if mask is None else mask.dtype))
        return real(q, k, v, cpb, mask)

    monkeypatch.setattr("muggled_dpt_tpu_torch.models.swinv2.window_attention_kernel", record)
    model.inference(_frame(), 128)
    assert len(seen) == sum(SWIN_CFG["layers_per_stage"])
    assert {(q, c) for q, c, _ in seen} == {(F16, torch.float32)} and {m for *_, m in seen} <= {None, torch.float32}


def test_int8_tier_runs_on_an_f16_model(ckpts):
    """``-u --int8-full``: the int8 tier of a float16 model keeps its scales
    float32 and serves float16 within the tier's own error of the float16
    dense model."""
    dense = make_dpt_from_state_dict(ckpts["DA-V2"], dtype=F16, device=DEVICE)[1]
    q = misc.maybe_quantize_int8(dense, int8=True, int8_full=True)
    scales = {name: t.dtype for name, t in q.net.named_buffers() if tq.is_scale_key(name) and t is not None}
    assert scales and set(scales.values()) == {torch.float32}
    frame = _frame(4)
    got, want = q.inference(frame, 112), dense.inference(frame, 112)
    assert got.dtype == F16 and bool(torch.isfinite(got).all())
    assert _abs_rel(got.float().numpy(), want.float().numpy()) < INT8_TIER_REL


def test_model_to_f16_serves_f16(ckpts):
    """``DPTModel.to(torch.float16)`` of a float32 model and of a bfloat16
    int8 tier: float16 depth, the int8 scales kept float32."""
    m32 = make_dpt_from_state_dict(ckpts["DA-V2"], device=DEVICE)[1]
    m16 = m32.to(F16)
    q16 = make_dpt_from_state_dict(ckpts["DA-V2"], dtype=torch.bfloat16, device=DEVICE)[1].quantize_encoder_int8().to(F16)
    scales = {t.dtype for name, t in q16.net.named_buffers() if tq.is_scale_key(name) and t is not None}
    assert m16.dtype == q16.dtype == F16 and scales == {torch.float32}
    for model in (m16, q16):
        depth = model.inference(_frame(5), 112)
        assert depth.dtype == F16 and bool(torch.isfinite(depth).all())


class CodesStub(StubLibrary):
    """The flash stub, recording each launch's dtype and bias codes and fill."""

    def __init__(self):
        super().__init__(_slots())
        self.codes = []

    def mdpt_flash_attention(self, args_ptr, scale_log2, stream):
        import ctypes

        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        self.codes.append((a[s["SLOT_DTYPE"]], a[s["SLOT_BIAS_DTYPE"]], a[s["SLOT_BIAS_FILL"]]))
        return super().mdpt_flash_attention(args_ptr, scale_log2, stream)


class WindowCodesStub(Sm90Stub):
    """The window stub, recording each launch's dtype and bias codes."""

    def mdpt_window_attention(self, args_ptr, stream):
        import ctypes

        s = self.slots
        a = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        out = super().mdpt_window_attention(args_ptr, stream)
        self.calls[-1]["codes"] = (a[s["SLOT_DTYPE"]], a[s["SLOT_BIAS_DTYPE"]])
        return out


@pytest.fixture()
def stubs(monkeypatch):
    """Both kernel libraries stubbed; every wrapper takes its CUDA route."""
    flash, window = CodesStub(), WindowCodesStub()

    def record(code, values):  # a CPU tensor's device index is None: the stub has no device
        return array.array(code, [0 if x is None else x for x in values])

    real_route = fa._device_route

    def route(device, name):  # a CPU tensor takes the CUDA route; any other device is refused as ever
        return real_route(torch.device("cuda") if device.type == "cpu" else device, name)

    for module in (fa, wa):
        monkeypatch.setattr(module, "array", types.SimpleNamespace(array=record))
        monkeypatch.setattr(module, "_device_route", route)
    libs = {"mdpt_flash_attention": flash, "mdpt_window_attention": window}  # each C entry's stub
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(libs[name], name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    fa.reset_launch_counts()
    return flash, window


def _moved(before: dict) -> dict:
    return {r: n - before[r] for r, n in fa.launch_counts().items() if n != before[r]}


def test_f16_flash_operands_pack_code_2_and_count_on_f16_routes(stubs):
    flash, _ = stubs
    h, n = 2, 60
    qkv = _t(_qkv(3, 1, n, h))
    n_pad = (n + 7) // 8 * 8  # the port's cached stack layout: rows padded to 8 elements
    stack = _t(_rand(4, 2, h, n_pad, n_pad))
    before = fa.launch_counts()
    outs = [fa.flash_attention_fused_qkv(qkv, h),
            fa.flash_attention_fused_qkv(qkv, h, bias_stack=stack, layer=1),
            fa.flash_attention_fused_qkv(qkv, h, bias=_t(_rand(5, 1, h, n, n))),
            fa.flash_attention_fused_qkv(qkv, h, bias=_t(_rand(6, 1, h, n, n), torch.float32))]
    x = qkv.unflatten(2, (h, 3, D))
    q, k, v = x[..., 0, :], x[..., 1, :], x[..., 2, :]
    outs.append(fa.flash_attention(q, k, v))
    assert all(o.dtype == F16 for o in outs)
    assert [c[:2] for c in flash.codes] == [(2, -1), (2, 2), (2, 2), (2, 0), (2, -1)]
    assert flash.codes[1][2] == fa.BIAS_FILL_TMA  # a padded float16 stack layer: a tensor map reads it
    assert flash.codes[2][2] == fa.BIAS_FILL_COPY  # rows of 60 elements, 120 bytes: not 16-byte aligned
    assert _moved(before) == {"fused_f16": 1, "fused_biased_f16": 3, "bnhd_f16": 1}
    # the stub runs the (B, N, H, D) plain version on the float16 views it was handed
    torch.testing.assert_close(outs[1], fa.flash_attention_reference(q, k, v, bias=stack[1][None]).flatten(2), rtol=0, atol=0)


def test_f16_window_routes_and_mixed_biases(stubs):
    _, window = stubs
    q, k, v, cpb, mask = (_t(a) for a in _windows(36, True, 7))
    before = fa.launch_counts()
    got = wa.window_attention(q, k, v, cpb, mask)
    mixed = wa.window_attention(q, k, v, cpb.float(), mask.float())  # the inline tables: float32 kept
    other = wa.window_attention(q, k, v, cpb.to(torch.bfloat16), mask.to(torch.bfloat16))  # no f16/bf16 instance: float32
    assert [(c["sm90"], c["codes"]) for c in window.calls] == [(True, (2, 2)), (False, (2, 0)), (False, (2, 0))]
    assert _moved(before) == {"window_sm90_f16": 1, "window_f16": 2}
    assert all(o.dtype == F16 for o in (got, mixed, other))
    torch.testing.assert_close(got, wa.window_attention_reference(q, k, v, cpb, mask), rtol=0, atol=0)
    torch.testing.assert_close(mixed, wa.window_attention_reference(q, k, v, cpb.float(), mask.float()), rtol=0, atol=0)


def test_f16_refusals(stubs):
    """Before any launch: a bias that no instance takes beside q's dtype
    (float16 beside bfloat16 or float32, bfloat16 beside float16),
    float64, the meta device."""
    h, n = 2, 40
    qkv = _t(_qkv(8, 1, n, h))
    for bad_qkv, bias in ((qkv, _t(_rand(9, 1, h, n, n), torch.bfloat16)),
                          (qkv.to(torch.bfloat16), _t(_rand(9, 1, h, n, n))),
                          (qkv.float(), _t(_rand(9, 1, h, n, n))),
                          (qkv, _t(_rand(9, 1, h, n, n), torch.float64)),
                          (qkv.double(), None),
                          (qkv.to("meta"), None)):
        with pytest.raises(ValueError):
            fa.flash_attention_fused_qkv(bad_qkv, h, bias=bias)
    q, k, v, cpb, mask = (_t(a) for a in _windows(16, True, 9))
    for args in ((q.double(), k.double(), v.double(), cpb, mask), (q, k, v, cpb.double(), mask)):
        with pytest.raises(ValueError):
            wa.window_attention(*args)
    assert not stubs[0].codes and not stubs[1].calls


@pytest.mark.parametrize("name,enable_cache,routes", [
    ("DA-V2", True, {"fused_f16": 4}),
    ("BEiT", True, {"fused_biased_f16": 4}),
    ("BEiT", False, {"fused_biased_f16": 4}),
    ("SwinV2", True, {"window_sm90_f16": 8}),
    ("SwinV2", False, {"window_f16": 8}),
])
def test_f16_forward_launches_only_f16_routes(stubs, ckpts, name, enable_cache, routes):
    """A whole float16 forward with every wrapper on its CUDA route: each
    attention launches the float16 instance its operands call for (the
    cached BEiT stack through TMA, SwinV2's cached tables on the sm_90
    kernel, its inline float32 tables on window_attention.cu), and the
    depth equals the CPU route's."""
    side = FAMILIES[name][2]
    model = make_dpt_from_state_dict(ckpts[name], dtype=F16, device=DEVICE)[1]
    model.config["enable_cache"] = enable_cache
    before = fa.launch_counts()
    got = model.inference(_frame(2), side)
    assert _moved(before) == routes
    if name == "BEiT":
        assert {c[:2] for c in stubs[0].codes} == {(2, 2)}
        assert {c[2] for c in stubs[0].codes} == {fa.BIAS_FILL_TMA}
    assert got.dtype == F16 and bool(torch.isfinite(got).all())


def test_library_ops_pass_f16_through(stubs):
    """The ``mdpt::`` operators (an exported program's attention nodes)
    call the wrappers: float16 in, the float16 routes launched, float16
    out, equal to the wrappers' own call."""
    from muggled_dpt_tpu_torch.ops.kernels import library  # noqa: F401  (registers torch.ops.mdpt.*)

    qkv = _t(_qkv(11, 1, 40, 2))
    q, k, v, cpb, mask = (_t(a) for a in _windows(16, True, 12))
    before = fa.launch_counts()
    fused = torch.ops.mdpt.flash_attention_fused_qkv(qkv, 2)
    window = torch.ops.mdpt.window_attention(q, k, v, cpb, mask)
    assert _moved(before) == {"fused_f16": 1, "window_sm90_f16": 1}
    assert fused.dtype == window.dtype == F16
    torch.testing.assert_close(fused, fa.flash_attention_fused_qkv(qkv, 2), rtol=0, atol=0)
    torch.testing.assert_close(window, wa.window_attention(q, k, v, cpb, mask), rtol=0, atol=0)


def test_device_config_serves_f16_on_the_card(monkeypatch):
    assert misc.make_device_config("cpu", prefer_bfloat16=False)["dtype"] == torch.float32  # as JAX: the CPU is f32
    monkeypatch.setattr(misc, "resolve_device", lambda d: torch.device("cuda", 0))
    assert misc.make_device_config(None, prefer_bfloat16=False) == {"device": torch.device("cuda", 0), "dtype": F16}
    assert misc.make_device_config(None, use_float32=True, prefer_bfloat16=False)["dtype"] == torch.float32
