"""TPU kernel #8's sm_90 kernels (``csrc/fused_mlp_sm90.cu``) without a card:

* which kernels the C entry ``mdpt_fused_mlp`` runs (``sm90_takes``),
  transcribed by ``c_entry_route`` and pinned to the C text: every bfloat16
  launch -> ``fused_mlp_sm90``, float32 -> ``fused_mlp`` (``mlp_f32``). A
  stub library takes the route as the C entry does, writes it to the
  argument array's last slot and runs the design's three stages through
  the wrapper's scratch (the normalized rows, then the GELU output), so the
  scratch's shapes and slots are what the stages read and write; the
  wrapper counts each call on its route;
* a numpy model of the design at its rounding points: LayerNorm in f32
  rounded to bf16; fc1 and fc2 as tile-wise f32 GEMMs over 128-row tiles,
  64-wide K slabs and 256- or 128-wide N tiles, every tile zero-filled past
  the edges as TMA fills it; + b1 and exact GELU, rounded to bf16; + b2,
  times ls, plus the f32 residual, rounded once. It is held against the
  JAX kernel (``experiments/pallas_fused_mlp.py``) in interpret mode at
  rows no multiple of 128 and H no multiple of 256, and against the plain
  version. Tolerance: bfloat16 rtol = atol = 1e-2, as
  ``tests/test_torch_fused_mlp.py`` states it (one bf16 ulp at any output
  below 2: the same rounding points, another summation order);
* the design variants of ``tools/mlp_sm90_variants.py``: each constant edit
  still applies to the source, and each build binds its own C entry through
  the shared harness ``tools/variant_build.py``."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.special import erf

import jax.numpy as jnp
from experiments.pallas_fused_mlp import fused_ln_mlp_residual as jax_fused_ln_mlp_residual
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import fused_mlp as fm
from muggled_dpt_tpu_torch.tools import mlp_sm90_variants as mv
from muggled_dpt_tpu_torch.tools import variant_build as vb

CSRC = Path(fm.__file__).resolve().parents[2] / "csrc"
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
BM, BK = 128, 64  # fused_mlp_sm90.cu's row tile and K slab


def _slots() -> dict:
    """``enum Slot`` of csrc/fused_mlp.cu: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", (CSRC / "fused_mlp.cu").read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


def _c_text(name):
    return " ".join((CSRC / name).read_text().split())


# fused_mlp.cu's choice, whitespace collapsed: c_entry_route transcribes exactly this text
C_ROUTE = "bool sm90_takes(const long long* args) { return args[SLOT_DTYPE] == 1; }"


def c_entry_route(slots: dict, args: list) -> str:
    """The kernels mdpt_fused_mlp runs for the argument array (C_ROUTE)."""
    return "fused_mlp_sm90" if args[slots["SLOT_DTYPE"]] == 1 else "fused_mlp"


def test_stub_transcribes_the_c_entrys_route():
    src = _c_text("fused_mlp.cu")
    assert C_ROUTE in src
    assert "const bool sm90 = sm90_takes(args); args[SLOT_ROUTE] = sm90 ? ROUTE_SM90 : ROUTE_FMA;" in src
    assert "constexpr long long ROUTE_FMA = 0, ROUTE_SM90 = 1;" in src
    slots = _slots()
    assert fm.SLOT_ROUTE == slots["SLOT_ROUTE"] == slots["NUM_SLOTS"] - 1 and fm.SM90_ROUTE == 1
    assert list(slots)[-5:] == ["SLOT_XN", "SLOT_GELU", "SLOT_EVENTS", "SLOT_ROUTE", "NUM_SLOTS"]
    assert f"constexpr int HIDDEN_STEP = {fm.HIDDEN_STEP};" in src
    kernel = _c_text("fused_mlp_sm90.cu")  # what the sm_90 route takes covers every shape the wrapper accepts
    assert "if (rows < 1 || f < 64 || f > MAX_F || f % 64 != 0 || hidden < 8 || hidden % 8 != 0) return cudaErrorInvalidValue;" in kernel
    assert f"constexpr int MAX_F = {fm.MAX_FEATURES};" in kernel and fm.FEATURE_STEP == 64 and fm.HIDDEN_STEP % 8 == 0
    assert f"constexpr int BM = {BM};" in kernel and f"constexpr int BK = {BK};" in kernel
    assert "mlp_bf16" not in _c_text("fused_mlp.cu")  # the mma.sync kernel is gone: no route reaches it


@pytest.mark.parametrize("dtype_code,want", [(1, "fused_mlp_sm90"), (0, "fused_mlp")])
def test_c_entry_route(dtype_code, want):
    s = _slots()
    args = [0] * s["NUM_SLOTS"]
    args[s["SLOT_DTYPE"]] = dtype_code
    assert c_entry_route(s, args) == want


def _view(addr, shape, dtype):
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_byte * n).from_address(addr), dtype=dtype).view(shape)


class RouteStub:
    """Stands in for the kernel library: takes the route as the C entry does,
    writes it to SLOT_ROUTE and, on the sm_90 route, runs the three stages
    at the plain version's rounding points through the scratch slots (xn,
    then the GELU output, then out); on the FMA route, the plain version."""

    def __init__(self):
        self.slots, self.routes, self.scratch = _slots(), [], []

    def mdpt_fused_mlp(self, args_ptr, eps, stream):
        s = self.slots
        a = (ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr)
        route = c_entry_route(s, list(a))
        a[s["SLOT_ROUTE"]] = 1 if route == "fused_mlp_sm90" else 0
        self.routes.append(route)
        rows, f, hidden = a[s["SLOT_ROWS"]], a[s["SLOT_FEATURES"]], a[s["SLOT_HIDDEN"]]
        dtype = [torch.float32, torch.bfloat16][a[s["SLOT_DTYPE"]]]
        shapes = {"SLOT_X": (rows, f), "SLOT_LN_W": (f,), "SLOT_LN_B": (f,), "SLOT_W1": (hidden, f), "SLOT_B1": (hidden,),
                  "SLOT_W2": (f, hidden), "SLOT_B2": (f,), "SLOT_LS": (f,), "SLOT_OUT": (rows, f)}
        t = {k: _view(a[s[k]], shape, dtype) for k, shape in shapes.items()}
        assert a[s["SLOT_EVENTS"]] == 0
        self.scratch.append((a[s["SLOT_XN"]], a[s["SLOT_GELU"]]))
        if route == "fused_mlp":
            params = [t[k] for k in ("SLOT_LN_W", "SLOT_LN_B", "SLOT_W1", "SLOT_B1", "SLOT_W2", "SLOT_B2", "SLOT_LS")]
            t["SLOT_OUT"].copy_(fm.fused_ln_mlp_residual_reference(t["SLOT_X"], *params, eps=eps))
            return 0
        xn, g = _view(a[s["SLOT_XN"]], (rows, f), dtype), _view(a[s["SLOT_GELU"]], (rows, hidden), dtype)
        xf = t["SLOT_X"].float()
        xn.copy_(torch.nn.functional.layer_norm(xf, (f,), t["SLOT_LN_W"].float(), t["SLOT_LN_B"].float(), eps))
        g.copy_(torch.nn.functional.gelu(torch.nn.functional.linear(xn.float(), t["SLOT_W1"].float(), t["SLOT_B1"].float())))
        y = torch.nn.functional.linear(g.float(), t["SLOT_W2"].float(), t["SLOT_B2"].float())
        t["SLOT_OUT"].copy_(xf + t["SLOT_LS"].float() * y)
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = RouteStub()
    # a CPU tensor's device index is None: the stub has no device
    monkeypatch.setattr(fm, "array", types.SimpleNamespace(array=lambda code, v: array.array(code, [x or 0 for x in v])))
    monkeypatch.setattr(fm, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _inputs(shape, hidden, seed=0):
    """x N(0, 1) and the block's parameters in torch layout, as numpy float32
    (fc1 and fc2 scaled by 1/sqrt(fan-in), as chip_smoke.py's mlp_inputs)."""
    rng = np.random.default_rng(seed)
    f = shape[-1]

    def w(*s, scale=0.05, shift=0.0):
        return (rng.standard_normal(s) * scale + shift).astype(np.float32)

    x = w(*shape, scale=1.0)
    params = [w(f, shift=1.0), w(f), w(hidden, f, scale=f**-0.5), w(hidden), w(f, hidden, scale=hidden**-0.5), w(f),
              w(f, shift=1.0)]
    return x, params


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("dtype,shape,hidden", [
    (torch.bfloat16, (2, 37, 128), 352),  # 74 rows, H no multiple of 256
    (torch.bfloat16, (3, 64), 96),
    (torch.float32, (1, 9, 64), 128),
])
def test_wrapper_counts_each_call_on_its_route(stub, dtype, shape, hidden):
    """One call counts one launch on its route; a bfloat16 call hands the C
    entry two scratch tensors, (rows, F) and (rows, H), 16-byte aligned and
    apart from each other, which the three stages write and read; a
    float32 call hands it none."""
    x, params = _inputs(shape, hidden, seed=5)
    x, params = _t(x, dtype), [_t(p, dtype) for p in params]
    fa.reset_launch_counts()
    got = fm.fused_ln_mlp_residual(x, *params)
    route = "fused_mlp_sm90" if dtype == torch.bfloat16 else "fused_mlp"
    assert stub.routes == [route]
    counts = fa.launch_counts()
    assert (counts["fused_mlp_sm90"], counts["fused_mlp"]) == ((1, 0) if route == "fused_mlp_sm90" else (0, 1))
    (xn, g), = stub.scratch
    rows, f = x.numel() // shape[-1], shape[-1]
    if route == "fused_mlp_sm90":
        spans = sorted([(xn, xn + rows * f * 2), (g, g + rows * hidden * 2)])
        assert xn % 16 == 0 and g % 16 == 0 and spans[0][1] <= spans[1][0]
    else:
        assert (xn, g) == (0, 0)
    torch.testing.assert_close(got, fm.fused_ln_mlp_residual_reference(x, *params), rtol=0, atol=0)


def test_stage_times_need_the_card():
    x, params = _inputs((1, 4, 64), 128)
    with pytest.raises(ValueError):
        fm.sm90_stage_ms(_t(x, torch.bfloat16), *(_t(p, torch.bfloat16) for p in params))


def _bf16(a):
    """float32 numpy values rounded to the nearest bfloat16 (ties to even), kept as float32."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).view(np.float32)


def _tiled_gemm(a, b, bn):
    """A (M, K) B^T (N, K) in f32 as the sm_90 GEMM computes it: per 128 x bn
    output tile, the K slabs of 64 summed in order, each operand tile
    zero-filled past the matrices' edges (TMA's boxes); the rows and
    columns past the edges computed and dropped, as the epilogue drops them."""
    m, k = a.shape
    n = b.shape[0]
    mp, np_, kp = -(-m // BM) * BM, -(-n // bn) * bn, -(-k // BK) * BK
    ap, bp = np.zeros((mp, kp), np.float32), np.zeros((np_, kp), np.float32)
    ap[:m, :k], bp[:n, :k] = a, b
    out = np.zeros((mp, np_), np.float32)
    for m0 in range(0, mp, BM):
        for n0 in range(0, np_, bn):
            acc = np.zeros((BM, bn), np.float32)
            for k0 in range(0, kp, BK):
                acc += ap[m0:m0 + BM, k0:k0 + BK] @ bp[n0:n0 + bn, k0:k0 + BK].T
            out[m0:m0 + BM, n0:n0 + bn] = acc
    return out[:m, :n]


def _design(x, params, fc1_bn, fc2_bn, eps=1e-6):
    """The three stages in numpy at the sm_90 route's rounding points, on
    bf16 values held as float32; returns (rows, F) bf16 values."""
    ln_w, ln_b, w1, b1, w2, b2, ls = (_bf16(p) for p in params)
    xr = _bf16(x).reshape(-1, x.shape[-1])
    mean = xr.mean(-1, keepdims=True, dtype=np.float32)
    var = np.square(xr - mean).mean(-1, keepdims=True, dtype=np.float32)  # the second pass over the row
    xn = _bf16((xr - mean) / np.sqrt(var + np.float32(eps)) * ln_w + ln_b)
    h = _tiled_gemm(xn, w1, fc1_bn) + b1
    g = _bf16(np.float32(0.5) * h * (1 + erf(h / np.float32(np.sqrt(2)))).astype(np.float32))
    y = _tiled_gemm(g, w2, fc2_bn) + b2
    return _bf16(xr + ls * y).reshape(x.shape)


def _jax_bf16(x, params):
    ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, ls = (jnp.asarray(p, jnp.bfloat16) for p in params)
    out = jax_fused_ln_mlp_residual(jnp.asarray(x, jnp.bfloat16), ln_w, ln_b, fc1_w.T, fc1_b, fc2_w.T, fc2_b, ls,
                                    block_rows=64, block_hidden=128, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape,hidden,fc1_bn,fc2_bn", [
    ((2, 100, 64), 352, 256, 256),   # 200 rows: a ragged second tile; H = 352: fc1's second N tile and fc2's last K slab ragged
    ((1, 130, 128), 512, 128, 128),  # 130 rows: two rows past the first tile; 128-wide N tiles
    ((1, 257, 192), 224, 256, 128),  # F = 192: fc2's N tile past F; H = 224 < one N tile
])
def test_design_model_matches_jax_kernel(shape, hidden, fc1_bn, fc2_bn):
    x, params = _inputs(shape, hidden, seed=shape[1])
    got = _design(x, params, fc1_bn, fc2_bn)
    np.testing.assert_allclose(got, _jax_bf16(x, params), **BF16_TOL)
    plain = fm.fused_ln_mlp_residual_reference(_t(x, torch.bfloat16), *(_t(p, torch.bfloat16) for p in params))
    np.testing.assert_allclose(got, plain.float().numpy(), **BF16_TOL)


def test_tiled_gemm_zero_fill_is_the_plain_product():
    """Zero-filled edge tiles add nothing: the tile-wise f32 sum equals the
    plain product to f32 round-off at every ragged edge."""
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((131, 96)).astype(np.float32), rng.standard_normal((300, 96)).astype(np.float32)
    for bn in (128, 256):
        np.testing.assert_allclose(_tiled_gemm(a, b, bn), a @ b.T, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", list(mv.VARIANTS))
def test_mlp_variant_edits_apply(name):
    """Each design variant is the committed source with its constants set
    (every constant still declared), its ablation's text edits applied
    (every old text still found) and the raw C entry appended."""
    committed = (CSRC / mv.SOURCE).read_text()
    constants, edits = mv.VARIANTS[name]
    text = mv.variant_source(constants, edits)
    assert text.endswith(mv.ENTRY)
    body = text[:-len(mv.ENTRY)]
    want = {c: f"constexpr {'bool' if isinstance(v, bool) else 'int'} {c} = {str(v).lower()};" for c, v in constants.items()}
    assert all(line in body for line in want.values())
    assert all(old in committed and old not in body for old, _ in edits)  # each edit found and applied
    if not edits:  # a schedule variant changes its constants' lines and nothing else
        changed = [b for a, b in zip(committed.splitlines(), body.splitlines()) if a != b]
        assert len(committed.splitlines()) == len(body.splitlines())
        assert all(any(b.strip().startswith(w) for w in want.values()) for b in changed)


def test_mlp_variants_build_binds_each_entry(monkeypatch, tmp_path):
    """The shared harness builds every variant at once, one nvcc each with
    csrc/ on the include path, binds the raw C entry, and names the GEMM
    kernels of ptxas's report by tile width and schedule."""
    cmds = []
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112mlp_fc1_sm90ILi128ELb1EEEv14CUtensorMap_stS1_10GemmParams' "
           "for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n")
    proc = types.SimpleNamespace(returncode=0, communicate=lambda: (log, None))
    monkeypatch.setattr(vb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(vb, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(vb.subprocess, "Popen", lambda cmd, **kw: cmds.append(cmd) or proc)
    monkeypatch.setattr(vb.ctypes, "CDLL", lambda path: types.SimpleNamespace(run=types.SimpleNamespace()))
    names = ["committed", "fc1 pingpong 128"]
    libs = mv.build(names, str(tmp_path))
    assert list(libs) == names and len(cmds) == 2 and all(cmd[cmd.index("-I") + 1] == str(CSRC) for cmd in cmds)
    assert all(lib.run.argtypes == mv.ARGS for lib in libs.values())
    assert (tmp_path / "mlp_sm90_variant_1.txt").read_text().startswith("fc1 pingpong 128\n")
    assert vb.ptxas_summary(log, mv.kernel_label) == ["mlp_fc1_sm90<128, pingpong>: spill stores 0 B, loads 0 B",
                                                      "mlp_fc1_sm90<128, pingpong>: 168 registers"]
    assert mv.kernel_label("_ZN12_GLOBAL__N_111mlp_ln_sm90EPK13__nv_bfloat16") == "mlp_ln_sm90"
