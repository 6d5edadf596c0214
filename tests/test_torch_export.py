"""``torch.export`` of the port's kernel forward
(``experiments/export_model.py``) through the serving kernels' operators
(``ops/kernels/library.py``: ``mdpt::flash_attention_fused_qkv`` for TPU
kernels #1 and #2, ``mdpt::window_attention`` for #3,
``mdpt::cosine_qk`` for SwinV2's q and k normalization,
``mdpt::postnorm_residual`` for SwinV2's post-norm residuals,
``mdpt::swiglu_gate`` for ViT-Giant's SwiGLU gate,
``mdpt::upsample_bilinear_ac`` for the neck's upsamples), on the CPU.

1. ``torch.library.opcheck`` on the ops, float32 and bfloat16, with every
   bias form of #1/#2 (none, dense, stack + layer), #3 with and without
   its shift mask, the cosine normalization on strided q and k views, the
   post-norm residual in token and window order, the SwiGLU gate, and the
   upsample in both memory formats.
2. Each family's tiny model, exported: the graph holds one ``mdpt`` node per
   attention block (SwinV2: and one ``cosine_qk`` node and two
   ``postnorm_residual`` nodes per block; ViT-Giant: and one
   ``swiglu_gate`` node per block), five
   upsample nodes (four fusion blocks and the head) and
   no ``scaled_dot_product_attention``; saved, reloaded,
   it equals the live port model (max abs 1e-6: the same ops, on the
   kernels' plain versions here) and the JAX package's float32 forward on
   the same random original checkpoint (both builders draw it with numpy
   from one seed) and input (the repo's 1e-3 mean abs-rel). BEiT and SwinV2
   with the aux cached (lifted constants) and built in-graph; the int8 tier
   too (tests/test_quant_int8.py:86 for the JAX export).
3. A program loads and runs in a fresh process once
   ``muggled_dpt_tpu_torch.ops.kernels.library`` is imported.
4. Through stub kernel libraries (tests/test_torch_flash_sm90_bias.py,
   tests/test_torch_window_sm90.py) the CPU tensors take the kernels'
   route: tracing launches nothing, and a reloaded program counts one launch
   per block on its route when it is called. The autograd guard raises
   through the ops as it does in eager mode, and the ops never fall back."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muggled_dpt_tpu.make_beit_dpt import make_beit_dpt as jax_make_beit
from muggled_dpt_tpu.make_depthanythingv1_dpt import make_depthanythingv1_dpt as jax_make_v1
from muggled_dpt_tpu.make_depthanythingv2_dpt import make_depthanythingv2_dpt as jax_make_v2
from muggled_dpt_tpu.make_swinv2_dpt import make_swinv2_dpt as jax_make_swinv2
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv1_dpt, make_depthanythingv2_dpt, make_swinv2_dpt
from muggled_dpt_tpu_torch.experiments import export_model
from muggled_dpt_tpu_torch.experiments.export_model import export_forward, kernel_nodes
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import cosine_qk as cq
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import library  # noqa: F401  (registers torch.ops.mdpt.*)
from muggled_dpt_tpu_torch.ops.kernels import postnorm_residual as pr
from muggled_dpt_tpu_torch.ops.kernels import swiglu_gate as sg
from muggled_dpt_tpu_torch.ops.kernels import window_attention as wa
from test_torch_flash_sm90_bias import StubLibrary, _slots
from test_torch_window_sm90 import Sm90Stub

DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11
LIVE_MAX_ABS = 1e-6
JAX_ABS_REL = 1e-3  # the repo's float32 parity budget
DA_ARGS = (128, 2, 4, (16, 24, 32, 40), (8, 8), 16)  # two heads of 64, the kernel's head width
BEIT_ARGS = (128, 2, 4, (16, 24, 32, 40), (6, 6), 16)
SWIN_ARGS = ((64, 128, 256, 512), (2, 4, 8, 16), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16)  # heads of 32

NECK_UPSAMPLES = 5  # an upsample node per fusion block and one in the head, in every family
FAMILIES = {  # name -> (JAX builder, port builder, args, keyword args, input hw, attention op, blocks)
    "da_v2": (jax_make_v2, make_depthanythingv2_dpt, DA_ARGS, {}, (112, 140), "flash_attention_fused_qkv", 4),
    "da_v1": (jax_make_v1, make_depthanythingv1_dpt, (128, 2, 6) + DA_ARGS[3:], {}, (112, 112),
              "flash_attention_fused_qkv", 6),
    "giant": (jax_make_v2, make_depthanythingv2_dpt, DA_ARGS, {"is_giant": True}, (112, 112),
              "flash_attention_fused_qkv", 4),
    "metric": (jax_make_v2, make_depthanythingv2_dpt, DA_ARGS, {"is_metric": True}, (112, 112),
               "flash_attention_fused_qkv", 4),
    "beit_cached": (jax_make_beit, make_beit_dpt, BEIT_ARGS, {}, (96, 128), "flash_attention_fused_qkv", 4),
    "beit_inline": (jax_make_beit, make_beit_dpt, BEIT_ARGS, {"enable_cache": False}, (96, 128),
                    "flash_attention_fused_qkv", 4),
    "swinv2_cached": (jax_make_swinv2, make_swinv2_dpt, SWIN_ARGS, {}, (64, 96), "window_attention", 8),
    "swinv2_inline": (jax_make_swinv2, make_swinv2_dpt, SWIN_ARGS, {"enable_cache": False}, (64, 96),
                      "window_attention", 8),
}


def _rand(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _image(hw, seed=0):
    return np.random.default_rng(seed).standard_normal((1, 3, *hw)).astype(np.float32) * 0.5


def _aten_targets(program) -> set:
    return {str(node.target) for module in program.graph_module.modules() if isinstance(module, torch.fx.GraphModule)
            for node in module.graph.nodes if node.op == "call_function"}


# -- 1. opcheck ---------------------------------------------------------------


def _fused_args(form, dtype, b=2, n=20, h=2, d=64):
    qkv = _rand(1, b, n, 3 * h * d).to(dtype)
    if form == "dense":
        return (qkv, h), {"bias": _rand(2, b, h, n, n).to(dtype)}
    if form == "stack":
        stack = torch.zeros(3, h, 24, 24, dtype=dtype)
        stack[..., :n, :n] = _rand(3, 3, h, n, n).to(dtype)
        return (qkv, h), {"bias_stack": stack, "layer": 1}
    return (qkv, h), {"scale": 0.1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["none", "dense", "stack"])
def test_opcheck_fused_qkv(form, dtype):
    args, kwargs = _fused_args(form, dtype)
    torch.library.opcheck(torch.ops.mdpt.flash_attention_fused_qkv, args, kwargs)
    got = torch.ops.mdpt.flash_attention_fused_qkv(*args, **kwargs)
    torch.testing.assert_close(got, fa.flash_attention_fused_qkv(*args, **kwargs), rtol=0, atol=0)


def _window_args(with_mask, dtype, b=2, nw=4, a=16, h=2, d=32):
    q, k, v = _rand(4, b, nw, a, 3, h, d).to(dtype).unbind(3)  # strided views, as the SwinV2 block hands v over
    mask = torch.where(_rand(6, nw, a, a) > 0, 0.0, -100.0).to(dtype) if with_mask else None
    return (q, k, v, _rand(5, h, a, a).to(dtype), mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mask", [False, True])
def test_opcheck_window(with_mask, dtype):
    args = _window_args(with_mask, dtype)
    torch.library.opcheck(torch.ops.mdpt.window_attention, args)
    torch.testing.assert_close(torch.ops.mdpt.window_attention(*args), wa.window_attention(*args), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_cosine_qk(dtype):
    q, k, _ = _rand(8, 2, 4, 16, 3, 2, 32).to(dtype).unbind(3)  # strided views of a qkv output, as the block has them
    scale = _rand(9, 2).abs().to(dtype)
    torch.library.opcheck(torch.ops.mdpt.cosine_qk, (q, k, scale))
    for got, want in zip(torch.ops.mdpt.cosine_qk(q, k, scale), cq.cosine_qk(q, k, scale)):
        assert got.is_contiguous() and got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("windowed", [False, True], ids=["token_order", "shifted_windows"])
def test_opcheck_postnorm_residual(windowed, dtype):
    x, weight, bias = _rand(10, 2, 8, 12, 16).to(dtype), _rand(11, 16).to(dtype), _rand(12, 16).to(dtype)
    # 4x4 windows of the 8x12 grid, rolled by 2: h in window order, as proj leaves it
    args = (x, _rand(13, 2, 6, 16, 16).to(dtype), weight, bias, [4, 4], [2, 2]) if windowed else \
        (x, _rand(13, 2, 8, 12, 16).to(dtype), weight, bias)
    torch.library.opcheck(torch.ops.mdpt.postnorm_residual, args)
    got = torch.ops.mdpt.postnorm_residual(*args)
    assert got.is_contiguous() and got.dtype == dtype
    torch.testing.assert_close(got, pr.postnorm_residual(*args), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(6, 352), (2, 5, 24), (3, 10)], ids=["rows", "batch_tokens", "ragged"])
def test_opcheck_swiglu_gate(shape, dtype):
    x12 = (_rand(14, *shape) * 4).to(dtype)
    torch.library.opcheck(torch.ops.mdpt.swiglu_gate, (x12,))
    got = torch.ops.mdpt.swiglu_gate(x12)
    assert got.is_contiguous() and got.dtype == dtype and got.shape == (*shape[:-1], shape[-1] // 2)
    torch.testing.assert_close(got, sg.swiglu_gate_reference(x12), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
def test_opcheck_upsample(channels_last, dtype):
    x = _rand(7, 2, 8, 9, 12).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last) if channels_last else x
    torch.library.opcheck(torch.ops.mdpt.upsample_bilinear_ac, (x, [18, 21]))
    got = torch.ops.mdpt.upsample_bilinear_ac(x, [18, 21])
    want = torch.nn.functional.interpolate(x, size=(18, 21), mode="bilinear", align_corners=True)
    assert got.stride() == want.stride()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- 2. each family, exported -------------------------------------------------


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """name -> (JAX model, port model, reloaded program, input hw), built on first use."""
    root, built = tmp_path_factory.mktemp("export"), {}

    def get(name):
        if name not in built:
            jax_make, port_make, args, kwargs, hw, _, _ = FAMILIES[name]
            jax_model = jax_make(*args, **kwargs, seed=SEED)
            port_model = port_make(*args, **kwargs, seed=SEED, device=DEVICE)
            path = str(root / f"{name}.pt2")
            torch.export.save(export_forward(port_model, hw), path)
            built[name] = (jax_model, port_model, torch.export.load(path), hw)
        return built[name]

    return get


@pytest.mark.parametrize("name", list(FAMILIES))
def test_exported_graph_holds_one_kernel_node_per_block(exported, name):
    _, _, program, _ = exported(name)
    op, blocks = FAMILIES[name][5:]
    swin = {"cosine_qk": blocks, "postnorm_residual": 2 * blocks} if op == "window_attention" else {}
    gates = {"swiglu_gate": blocks} if name == "giant" else {}
    assert kernel_nodes(program) == {op: blocks, **swin, **gates, "upsample_bilinear_ac": NECK_UPSAMPLES}
    assert not [t for t in _aten_targets(program) if "scaled_dot_product_attention" in t]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_reloaded_program_matches_live_port_and_jax(exported, name):
    jax_model, port_model, program, hw = exported(name)
    x = _image(hw)
    got = program.module()(torch.from_numpy(x))
    live = port_model.forward(torch.from_numpy(x))
    assert got.shape == live.shape and got.dtype == live.dtype
    assert float((got - live).abs().max()) <= LIVE_MAX_ABS
    want = np.asarray(jax_model.forward(jnp.asarray(x)), np.float32)
    assert float(np.abs(got.numpy() - want).mean() / np.abs(want).mean()) < JAX_ABS_REL


@pytest.mark.parametrize("batch", [1, 2])
def test_exported_neck_upsamples_are_operator_nodes_bit_equal_to_the_live_forward(tmp_path, batch):
    """DA-V2 exported at B=1 (NCHW maps) and B=2 (channels-last maps): five
    ``mdpt.upsample_bilinear_ac`` nodes and no ``upsample_bilinear2d``; the
    reloaded program equals the live forward bit for bit."""
    _, port_make, args, kwargs, hw, _, _ = FAMILIES["da_v2"]
    model = port_make(*args, **kwargs, seed=SEED, device=DEVICE)
    x = torch.from_numpy(np.concatenate([_image(hw, seed) for seed in range(batch)]))
    path = str(tmp_path / "program.pt2")
    torch.export.save(torch.export.export(export_model.ExportedForward(model.net, None), (x,)), path)
    program = torch.export.load(path)
    assert kernel_nodes(program)["upsample_bilinear_ac"] == NECK_UPSAMPLES
    assert not [t for t in _aten_targets(program) if "upsample_bilinear2d" in t]
    with torch.no_grad():
        live = model.net(x)
    torch.testing.assert_close(program.module()(x), live, rtol=0, atol=0)


def test_cached_aux_is_lifted_as_constants(exported):
    """The cached aux becomes the program's constants; built in-graph, it
    leaves none (BEiT: the (L, H, Np, Np) stack)."""
    cached, inline = exported("beit_cached")[2], exported("beit_inline")[2]
    stack_shape = (4, 2, 56, 56)  # 4 layers, 2 heads, N = 6 * 8 + 1 = 49 padded to 56
    assert [tuple(t.shape) for t in cached.constants.values()] == [stack_shape]
    assert not [t for t in inline.constants.values() if t.dim() == 4]


def test_int8_tier_exports_and_round_trips(tmp_path):
    """The int8 tier's QuantLinear layers (torch._int_mm) survive export,
    save and load: the reloaded program equals the live int8 model."""
    model = make_depthanythingv2_dpt(*DA_ARGS, seed=SEED, device=DEVICE).quantize_encoder_int8(include_qkv=True)
    path = str(tmp_path / "int8.pt2")
    torch.export.save(export_forward(model, (112, 112)), path)
    program = torch.export.load(path)
    assert kernel_nodes(program) == {"flash_attention_fused_qkv": 4, "upsample_bilinear_ac": NECK_UPSAMPLES}
    x = torch.from_numpy(_image((112, 112)))
    torch.testing.assert_close(program.module()(x), model.forward(x), rtol=1e-6, atol=1e-6)


def test_export_model_main_writes_and_checks_the_artifact(tmp_path):
    out = export_model.main(["-d", "cpu", "-o", str(tmp_path), "--timing_iters", "1"])
    assert out["path"] == str(tmp_path / "tiny_dav2_224x224.pt2") and os.path.getsize(out["path"]) == out["bytes"]
    assert out["nodes"] == {"flash_attention_fused_qkv": 8, "upsample_bilinear_ac": NECK_UPSAMPLES}
    assert out["abs_rel"] == 0.0 and out["ms"] > 0


FRESH = r"""
import sys
import numpy as np
import torch
import muggled_dpt_tpu_torch.ops.kernels.library  # the mdpt ops the program holds
program = torch.export.load(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2]))
np.save(sys.argv[3], program.module()(x).numpy())
"""


def test_program_loads_in_a_fresh_process(exported, tmp_path):
    _, port_model, _, hw = exported("beit_cached")
    path, x_path, out_path = (str(tmp_path / f) for f in ("beit.pt2", "x.npy", "out.npy"))
    torch.export.save(export_forward(port_model, hw), path)
    np.save(x_path, _image(hw, seed=3))
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", FRESH, path, x_path, out_path], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    live = port_model.forward(torch.from_numpy(np.load(x_path)))
    assert float(np.abs(np.load(out_path) - live.numpy()).max()) <= LIVE_MAX_ABS


# -- 4. the kernels' route, through stub libraries ----------------------------


def _record(real_array):
    def array(code, values):  # a CPU tensor's device index is None: the stub has no device
        return real_array(code, [0 if x is None else x for x in values])

    return types.SimpleNamespace(array=array)


@pytest.fixture()
def stubs(monkeypatch):
    """CPU tensors take the kernels' route; the stubs run the plain versions."""
    flash, window = StubLibrary(_slots()), Sm90Stub()
    monkeypatch.setattr(fa, "array", _record(fa.array.array))
    monkeypatch.setattr(fa, "_device_route", lambda device, name: False)
    monkeypatch.setattr(wa, "array", _record(wa.array.array))
    monkeypatch.setattr(wa, "_device_route", lambda device, name: False)
    libs = {"mdpt_flash_attention": flash, "mdpt_window_attention": window}  # each C entry's stub
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(libs[name], name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    fa.reset_launch_counts()
    return flash, window


@pytest.mark.parametrize("name,route", [("da_v2", "fused"), ("beit_cached", "fused_biased"),
                                        ("beit_inline", "fused_biased"), ("swinv2_cached", "window_sm90")])
def test_reloaded_program_counts_launches_when_called(stubs, tmp_path, name, route):
    """bf16, as served: tracing and saving launch nothing; each call of the
    reloaded program launches one kernel per block on the route the eager
    model takes, and its depth equals the eager model's through the same
    stubs. The window stub checks every operand against the tensor maps, so
    the program hands q, k and v over in layouts a tensor map reads."""
    _, port_make, args, kwargs, hw, _, blocks = FAMILIES[name]
    model = port_make(*args, **kwargs, seed=SEED, dtype=torch.bfloat16, device=DEVICE)
    path = str(tmp_path / "program.pt2")
    torch.export.save(export_forward(model, hw), path)
    program = torch.export.load(path)
    assert all(n == 0 for n in fa.launch_counts().values())
    x = torch.from_numpy(_image(hw)).to(torch.bfloat16)
    got = program.module()(x)
    assert fa.launch_counts()[route] == blocks and sum(fa.launch_counts().values()) == blocks
    fa.reset_launch_counts()
    torch.testing.assert_close(got, model.forward(x), rtol=0, atol=0)
    assert fa.launch_counts()[route] == blocks


def test_autograd_guard_raises_through_the_ops(stubs):
    """An operand that requires grad under autograd: the ops raise as the
    wrappers do, and both launch under no_grad."""
    qkv = _rand(1, 1, 20, 3 * 64).requires_grad_()
    q, k, v, cpb, mask = _window_args(True, torch.float32)
    q.requires_grad_()
    for call in (lambda: fa.flash_attention_fused_qkv(qkv, 1), lambda: torch.ops.mdpt.flash_attention_fused_qkv(qkv, 1),
                 lambda: wa.window_attention(q, k, v, cpb, mask), lambda: torch.ops.mdpt.window_attention(q, k, v, cpb, mask)):
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            assert not call().requires_grad


def test_ops_never_fall_back(stubs, monkeypatch):
    """On the kernels' route the ops launch or raise: an operand the kernel
    cannot read, or a launch the library refuses, raises through the op."""
    qkv = _rand(1, 1, 20, 3 * 64 + 1)[..., 1:]  # rows 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        torch.ops.mdpt.flash_attention_fused_qkv(qkv, 1)
    flash, window = stubs
    monkeypatch.setattr(flash, "mdpt_flash_attention", lambda *args: 1)
    monkeypatch.setattr(window, "mdpt_window_attention", lambda *args: 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        torch.ops.mdpt.flash_attention_fused_qkv(_rand(1, 1, 20, 3 * 64), 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        torch.ops.mdpt.window_attention(*_window_args(False, torch.float32))
