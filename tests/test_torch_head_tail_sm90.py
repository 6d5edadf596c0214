"""TPU kernel #9's sm_90 kernel (``csrc/head_tail_sm90.cu``) without a card:

* which kernel the C entry ``mdpt_head_tail`` takes (``sm90_takes``),
  transcribed by ``c_entry_route`` and pinned to the C text: bfloat16 at a
  width whose rows a tensor map steps over (W % 8 == 0), a 16-byte aligned
  map and ci a multiple of 16 up to 192 -> ``head_tail_sm90``; other
  widths, and float32 -> ``head_tail``. A stub library takes the route as
  the C entry does and writes it to the argument array's last slot; the
  wrapper counts each launch on its route;
* the plain version against the JAX kernel
  (``experiments/pallas_head_conv.py``) in interpret mode at a width the
  sm_90 route takes and at one it does not (float32: 1e-5 relative, 1e-6
  absolute, as ``tests/test_torch_head_tail.py``);
* the kernel's own decomposition, in numpy: the shifted copies of a centre
  box made from 16-byte units by funnel shifts, with the pixels that enter
  from the 8-column edge boxes (bit for bit against the image shifted with
  zero fill, at the first, a middle and a ragged last column block), and
  the implicit GEMM over units of ROWS output rows x 64 columns (box rows
  y0 - 1 .., A of output row r and tap row dy the box's row r + dy) against
  the plain version, at both instantiations' ROWS;
* the design variants of ``tools/shootout_head_variants.py`` (#12's CTA
  heights, #9's rows, loads and unaligned box): each text edit still
  applies to its source, and each build binds its own C entry through the
  shared harness ``tools/variant_build.py``."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from experiments.pallas_head_conv import fused_head_tail as jax_fused_head_tail
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import head_tail as ht
from muggled_dpt_tpu_torch.tools import shootout_head_variants as shv
from muggled_dpt_tpu_torch.tools import variant_build as vb

CSRC = Path(ht.__file__).resolve().parents[2] / "csrc"
TOL = dict(rtol=1e-5, atol=1e-6)
CO = 32
CUDA_ERROR_INVALID_VALUE = 1


def _slots() -> dict:
    """``enum Slot`` of csrc/head_tail.cu: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", (CSRC / "head_tail.cu").read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


# head_tail.cu's choice, whitespace collapsed: c_entry_route transcribes exactly this text
C_ROUTE = ("const long long ci = args[SLOT_CHANNELS]; return args[SLOT_DTYPE] == 1 && args[SLOT_X] % 16 == 0 && "
           "args[SLOT_WIDTH] % 8 == 0 && ci % 16 == 0 && ci <= SM90_MAX_CHANNELS;")
SM90_MAX_CHANNELS = 192


def _c_text(name):
    return " ".join((CSRC / name).read_text().split())


def test_stub_transcribes_the_c_entrys_route():
    src = _c_text("head_tail.cu")
    assert re.search(r"bool sm90_takes\(const long long\* args\) \{ (.*?) \}", src).group(1) == C_ROUTE
    assert f"constexpr long long SM90_MAX_CHANNELS = {SM90_MAX_CHANNELS};" in src
    assert "const bool sm90 = sm90_takes(args); args[SLOT_ROUTE] = sm90 ? ROUTE_SM90 : ROUTE_FMA;" in src
    assert "constexpr long long ROUTE_FMA = 0, ROUTE_SM90 = 1;" in src
    assert ht.SLOT_ROUTE == _slots()["SLOT_ROUTE"] and ht.SM90_ROUTE == 1
    kernel = _c_text("head_tail_sm90.cu")
    assert f"constexpr int MAX_CHANNELS = {SM90_MAX_CHANNELS};" in kernel  # the two sources agree
    assert "if (ci % CH != 0 || ci > MAX_CHANNELS || w % 8 != 0) return cudaErrorInvalidValue;" in kernel


def c_entry_route(slots: dict, args: list) -> str:
    """The kernel mdpt_head_tail takes for the argument array (C_ROUTE)."""
    s = slots
    ci = args[s["SLOT_CHANNELS"]]
    sm90 = (args[s["SLOT_DTYPE"]] == 1 and args[s["SLOT_X"]] % 16 == 0 and args[s["SLOT_WIDTH"]] % 8 == 0
            and ci % 16 == 0 and ci <= SM90_MAX_CHANNELS)
    return "head_tail_sm90" if sm90 else "head_tail"


@pytest.mark.parametrize("ci,w,dtype_code,addr,want", [
    (128, 504, 1, 4096, "head_tail_sm90"),  # ViT-L's head at 504x504
    (192, 504, 1, 4096, "head_tail_sm90"),  # ViT-Giant's
    (32, 56, 1, 4096, "head_tail_sm90"),
    (128, 52, 1, 4096, "head_tail"),  # 37x52: rows 104 bytes apart
    (128, 518, 1, 4096, "head_tail"),  # 392x518
    (128, 504, 0, 4096, "head_tail"),  # float32
    (128, 504, 1, 4098, "head_tail"),  # a base off 16 bytes
    (24, 504, 1, 4096, "head_tail"),  # channels off 16
    (256, 504, 1, 4096, "head_tail"),  # weights past the kernel's shared memory
])
def test_c_entry_route(ci, w, dtype_code, addr, want):
    s = _slots()
    args = [0] * s["NUM_SLOTS"]
    args[s["SLOT_X"]], args[s["SLOT_CHANNELS"]], args[s["SLOT_WIDTH"]], args[s["SLOT_DTYPE"]] = addr, ci, w, dtype_code
    assert c_entry_route(s, args) == want


class RouteStub:
    """Stands in for the kernel library: takes the route as the C entry does,
    writes it to SLOT_ROUTE, and runs the plain version into ``out``."""

    def __init__(self):
        self.slots, self.routes = _slots(), []

    def mdpt_head_tail(self, args_ptr, stream):
        s = self.slots
        a = (ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr)
        route = c_entry_route(s, list(a))
        a[s["SLOT_ROUTE"]] = 1 if route == "head_tail_sm90" else 0
        self.routes.append(route)
        b, ci, h, w = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_CHANNELS", "SLOT_HEIGHT", "SLOT_WIDTH"))
        dtype = [torch.float32, torch.bfloat16][a[s["SLOT_DTYPE"]]]
        shapes = {"SLOT_X": (b, ci, h, w), "SLOT_CONV_W": (CO, ci, 3, 3), "SLOT_CONV_B": (CO,), "SLOT_PROJ_W": (1, CO, 1, 1),
                  "SLOT_PROJ_B": (1,), "SLOT_OUT": (b, h, w)}
        t = {}
        for k, shape in shapes.items():
            n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            t[k] = torch.frombuffer((ctypes.c_byte * n).from_address(a[s[k]]), dtype=dtype).view(shape)
        params = [t[k] for k in ("SLOT_CONV_W", "SLOT_CONV_B", "SLOT_PROJ_W", "SLOT_PROJ_B")]
        t["SLOT_OUT"].copy_(ht.fused_head_tail_reference(t["SLOT_X"], *params, is_metric=bool(a[s["SLOT_IS_METRIC"]])))
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = RouteStub()
    # a CPU tensor's device index is None: the stub has no device
    monkeypatch.setattr(ht, "array", types.SimpleNamespace(array=lambda code, v: array.array(code, [x or 0 for x in v])))
    monkeypatch.setattr(ht, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _inputs(b, ci, h, w, seed=0):
    """An NCHW map and the tail's weights in torch layout, as numpy float32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, ci, h, w)) * 0.3).astype(np.float32)
    conv_w = (rng.standard_normal((CO, ci, 3, 3)) * 0.2).astype(np.float32)
    conv_b = (rng.standard_normal(CO) * 0.2).astype(np.float32)
    proj_w = (rng.standard_normal((1, CO, 1, 1)) * 0.3).astype(np.float32)
    proj_b = (rng.standard_normal(1) * 0.1).astype(np.float32)
    return x, [conv_w, conv_b, proj_w, proj_b]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("dtype,shape,route", [
    (torch.bfloat16, (2, 32, 19, 24), "head_tail_sm90"),
    (torch.bfloat16, (1, 16, 37, 52), "head_tail"),
    (torch.float32, (1, 16, 9, 24), "head_tail"),
])
def test_wrapper_counts_each_launch_on_its_route(stub, dtype, shape, route):
    x, params = _inputs(*shape, seed=3)
    x, params = _t(x, dtype), [_t(p, dtype) for p in params]
    fa.reset_launch_counts()
    got = ht.fused_head_tail(x, *params, is_metric=True)
    assert stub.routes == [route]
    counts = fa.launch_counts()
    assert (counts["head_tail_sm90"], counts["head_tail"]) == ((1, 0) if route == "head_tail_sm90" else (0, 1))
    torch.testing.assert_close(got, ht.fused_head_tail_reference(x, *params, is_metric=True), rtol=0, atol=0)


def _jax(x_nchw, params, is_metric):
    """The Pallas kernel, one NHWC image at a time (it takes B = 1)."""
    conv_w, conv_b, proj_w, proj_b = params
    ck = jnp.asarray(conv_w.transpose(2, 3, 1, 0))  # OIHW -> HWIO
    pk = jnp.asarray(proj_w[:, :, 0, 0].T)
    outs = [jax_fused_head_tail(jnp.asarray(img.transpose(1, 2, 0)[None]), ck, jnp.asarray(conv_b), pk, jnp.asarray(proj_b),
                                is_metric=is_metric, interpret=True) for img in x_nchw]
    return np.concatenate([np.asarray(o) for o in outs])


@pytest.mark.parametrize("metric", [False, True])
@pytest.mark.parametrize("b,ci,h,w", [(1, 16, 21, 72), (2, 32, 13, 37)])  # W % 8 == 0 (the sm_90 route's) and not
def test_plain_version_matches_jax_kernel(b, ci, h, w, metric):
    x, params = _inputs(b, ci, h, w, seed=b + w)
    want = _jax(x, params, metric)
    got = ht.fused_head_tail_reference(_t(x), *(_t(p) for p in params), is_metric=metric)
    assert tuple(got.shape) == want.shape == (b, h, w)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _rows() -> tuple:
    """(ROWS_WIDE, ROWS_NARROW, WIDE_CHANNELS) of head_tail_sm90.cu."""
    m = re.search(r"constexpr int ROWS_WIDE = (\d+), ROWS_NARROW = (\d+), WIDE_CHANNELS = (\d+);",
                  (CSRC / "head_tail_sm90.cu").read_text())
    return tuple(int(g) for g in m.groups())


def funnelshift_r(lo, hi):
    """CUDA's __funnelshift_r(lo, hi, 16): the low 32 bits of (hi:lo) >> 16."""
    return ((hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)) >> np.uint64(16)).astype(np.uint32)


def shift_copies(centre, left_edge, right_edge):
    """shift_copies of head_tail_sm90.cu on one box row: `centre` the 64
    pixels x0.. as uint16, the edge boxes' 8 pixels x0 - 8.. and x0 + 64..;
    each 16-byte unit is 4 words of 2 pixels (the lower one in the low half),
    its neighbours' words come by shuffle, the ends' from the edge boxes.
    Returns the dx = 0 and dx = 2 copies as uint16."""
    words = centre.view(np.uint32).reshape(8, 4)
    prev = np.roll(words[:, 3], 1)  # __shfl_up_sync(w.w, 1, 8)
    nxt = np.roll(words[:, 0], -1)  # __shfl_down_sync(w.x, 1, 8)
    prev[0] = np.uint32(left_edge[7]) << np.uint32(16)
    nxt[7] = np.uint32(right_edge[0])
    left = np.stack([funnelshift_r(prev, words[:, 0]), funnelshift_r(words[:, 0], words[:, 1]),
                     funnelshift_r(words[:, 1], words[:, 2]), funnelshift_r(words[:, 2], words[:, 3])], axis=1)
    right = np.stack([funnelshift_r(words[:, 0], words[:, 1]), funnelshift_r(words[:, 1], words[:, 2]),
                      funnelshift_r(words[:, 2], words[:, 3]), funnelshift_r(words[:, 3], nxt)], axis=1)
    return left.reshape(-1).view(np.uint16), right.reshape(-1).view(np.uint16)


def _padded_row(row, x0, cols):
    """Pixels x0 .. x0 + cols - 1 of a row, zero past its ends (TMA's fill)."""
    out = np.zeros(cols, row.dtype)
    lo, hi = max(x0, 0), min(x0 + cols, row.size)
    if hi > lo:
        out[lo - x0:hi - x0] = row[lo:hi]
    return out


@pytest.mark.parametrize("x0", [0, 192, 448])  # the first, a middle and W = 504's ragged last column block
def test_shift_copies_are_the_image_shifted_with_zero_fill(x0):
    row = np.random.default_rng(x0).integers(1, 2**16, size=504, dtype=np.uint16)
    left, right = shift_copies(_padded_row(row, x0, 64), _padded_row(row, x0 - 8, 8), _padded_row(row, x0 + 64, 8))
    np.testing.assert_array_equal(left, _padded_row(row, x0 - 1, 64))
    np.testing.assert_array_equal(right, _padded_row(row, x0 + 1, 64))


def implicit_gemm(x, conv_w, rows):
    """The 3x3 conv as head_tail_sm90.cu computes it, unit by unit: per
    (image, ROWS output rows from y0, 64 columns from x0) the centre box
    (ROWS + 2 rows from y0 - 1) and its shifted copies, zero past the image;
    output row r's accumulator is the sum over dx, dy of the copy dx's box
    row r + dy (64 pixels x ci) times tap (dy, dx)'s weights (ci x 32)."""
    b, ci, h, w = x.shape
    out = np.zeros((b, CO, h, w))
    pad = np.zeros((b, ci, h + rows + 2, w + 64 + 2))  # room for the last unit's rows and columns
    pad[:, :, 1:h + 1, 1:w + 1] = x
    for img in range(b):
        for y0 in range(0, h, rows):
            for x0 in range(0, w, 64):
                # copy dx holds pixels x0 + dx - 1 ..; in pad, column j is pixel j - 1
                boxes = [pad[img, :, y0:y0 + rows + 2, x0 + dx:x0 + dx + 64] for dx in range(3)]
                for r in range(min(rows, h - y0)):
                    acc = sum(boxes[dx][:, r + dy].T @ conv_w[:, :, dy, dx].T for dy in range(3) for dx in range(3))
                    cols = min(64, w - x0)
                    out[img, :, y0 + r, x0:x0 + cols] = acc[:cols].T
    return out


@pytest.mark.parametrize("which", ["wide", "narrow"])
def test_implicit_gemm_units_compute_the_conv(which):
    rows_wide, rows_narrow, _ = _rows()
    rows = rows_wide if which == "wide" else rows_narrow
    x, (conv_w, conv_b, proj_w, proj_b) = _inputs(2, 16, rows + 5, 72, seed=rows)  # ragged rows and a 8-column block
    conv = implicit_gemm(x.astype(np.float64), conv_w.astype(np.float64), rows) + conv_b[None, :, None, None]
    t = np.maximum(conv, 0.0)
    y = np.maximum(np.einsum("bohw,o->bhw", t, proj_w[0, :, 0, 0]) + proj_b[0], 0.0)
    want = ht.fused_head_tail_reference(_t(x), _t(conv_w), _t(conv_b), _t(proj_w), _t(proj_b)).numpy()
    np.testing.assert_allclose(y, want, **TOL)


@pytest.mark.parametrize("name", list(shv.VARIANTS))
def test_shootout_variant_edits_apply(name):
    """Each design variant is its committed source with the header inlined,
    its edits applied (every old text still found) and the raw C entry
    appended."""
    source, replacements = shv.VARIANTS[name]
    text = shv.variant_source(source, replacements)
    committed = vb.with_header(source, shv.HEADER)
    assert '#include "flash_variants_sm90.cuh"' in (CSRC / source).read_text()
    assert '#include "flash_variants_sm90.cuh"' not in text and (CSRC / shv.HEADER).read_text() in committed
    changed = any(old != new for old, new in replacements)
    assert text.endswith(shv.ENTRY[source]) and (text != committed + shv.ENTRY[source]) == changed


def test_shootout_build_binds_each_entry(monkeypatch, tmp_path):
    """The shared harness builds every variant at once, one nvcc each with
    csrc/ on the include path, binds #12's or #9's C entry by the variant's
    source, and names the kernels of ptxas's report."""
    cmds = []
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_17fv_sm90ILi3ELi1EEEv14CUtensorMap_stS0_S0_8FvParams' "
           "for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n")
    proc = types.SimpleNamespace(returncode=0, communicate=lambda: (log, None))
    monkeypatch.setattr(vb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(vb, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(vb.subprocess, "Popen", lambda cmd, **kw: cmds.append(cmd) or proc)
    monkeypatch.setattr(vb.ctypes, "CDLL", lambda path: types.SimpleNamespace(run=types.SimpleNamespace()))
    names = ["fv height 3", "ht"]
    libs = shv.build(names, str(tmp_path))
    assert list(libs) == names and len(cmds) == 2 and all(cmd[cmd.index("-I") + 1] == str(CSRC) for cmd in cmds)
    assert libs["fv height 3"].run.argtypes == shv.FV_ARGS and libs["ht"].run.argtypes == shv.HT_ARGS
    assert (tmp_path / "shootout_head_variant_1.txt").read_text().startswith("ht\n")
    assert vb.ptxas_summary(log, shv.kernel_label) == ["fv_sm90<3, 1>: spill stores 0 B, loads 0 B",
                                                       "fv_sm90<3, 1>: 168 registers"]
