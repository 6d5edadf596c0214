"""The attention sweep's sm_90 kernels, #10 (``csrc/flash_xl_sm90.cu``),
#11 (``csrc/flash_staged_sm90.cu``) and #12 (``csrc/flash_variant_sm90.cu``),
without a card:

* the plain versions against the JAX package's kernels
  (``experiments/flash_attention_{xl,staged}.py``) in interpret mode at the
  new tiles' edges: N = 63-65, 127-129 and 191-193 straddle the q tiles of
  64 qp and 192 rows and the key tiles of 64 and 128 keys; both XL
  schedules at qp = 1, 2, 4, the ablation, staged at 1, 2 and 3 panels, and
  a slab whose every logit is negative. Tolerance: 1e-5 absolute in float32
  (the two differ only in summation order);
* which kernel the C entries take, through a stub library that reads
  ``enum Slot`` of ``csrc/flash_variants.cuh`` and chooses as
  ``variant_entry`` does (a test pins the stub's choice to the text of the
  C code): bf16 slabs of every sweep shape go to the sm_90 kernels with
  qp, pipelining, the mode and the panel width in their slots, float32 to
  ``fv_f32``, #12's bf16 in every mode to its sm_90 kernel (keys other than
  N allowed), and a bf16 layout that a tensor map cannot read raises;
* the design-variant tools' text edits still apply to the sources
  (``tools/flash_sm90_variants.py`` after the move of kernel #1's helpers to
  ``csrc/sm90_attention.cuh``, ``tools/sweep_sm90_variants.py``), and their
  nvcc has ``csrc/`` on its include path."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from experiments.flash_attention_staged import flash_attention_fused_qkv_staged as jax_staged
from experiments.flash_attention_xl import flash_attention_fused_qkv_xl as jax_xl
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_staged as st
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_xl as xl
from muggled_dpt_tpu_torch.ops.kernels import flash_variants as fv
from muggled_dpt_tpu_torch.tools import attn_variants as av
from muggled_dpt_tpu_torch.tools import flash_sm90_variants as fsv
from muggled_dpt_tpu_torch.tools import flash_tune as ft
from muggled_dpt_tpu_torch.tools import sweep_sm90_variants as ssv
from muggled_dpt_tpu_torch.tools import variant_build as vb

TOL = dict(rtol=0, atol=1e-5)
EDGE_N = [63, 64, 65, 127, 128, 129, 191, 192, 193]
SCHEDULES = [(1, False), (1, True), (2, False), (2, True), (4, False), (4, True)]  # (qp, pipelined)
CSRC = Path(fv.__file__).resolve().parents[2] / "csrc"
CUDA_ERROR_INVALID_VALUE = 1


def _qkv(rng, b, n, h, d=64, all_negative=False):
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    if all_negative:  # q > 0, k < 0: every logit negative, about -20 in log2 units
        q, k = np.abs(q) + 0.5, -(np.abs(k) + 0.5)
    return np.stack([q, k, v], axis=3).reshape(b, n, 3 * h * d)


@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("qp,pipelined", SCHEDULES)
def test_xl_plain_version_matches_jax_at_tile_edges(n, qp, pipelined):
    qkv = _qkv(np.random.default_rng(n), 1, n, 2)
    want = np.asarray(jax_xl(jnp.asarray(qkv), 2, qp=qp, pipelined=pipelined, interpret=True))
    got = xl.flash_attention_fused_qkv_xl(torch.from_numpy(qkv), 2, qp=qp, pipelined=pipelined).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("qp,pipelined", SCHEDULES)
def test_xl_plain_version_matches_jax_all_logits_negative(qp, pipelined):
    """Keys past N are masked before the max: the real logits, all below
    zero, never lose to the pad keys' logit 0."""
    qkv = _qkv(np.random.default_rng(2), 1, 129, 2, all_negative=True)
    want = np.asarray(jax_xl(jnp.asarray(qkv), 2, qp=qp, pipelined=pipelined, interpret=True))
    got = xl.flash_attention_fused_qkv_xl(torch.from_numpy(qkv), 2, qp=qp, pipelined=pipelined).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", [65, 129, 193])
@pytest.mark.parametrize("qp,pipelined", [(1, True), (2, True), (4, False)])
def test_xl_ablation_plain_version_matches_jax_at_tile_edges(n, qp, pipelined):
    qkv = _qkv(np.random.default_rng(n + 1), 1, n, 2)
    want = np.asarray(jax_xl(jnp.asarray(qkv), 2, qp=qp, pipelined=pipelined, ablate_softmax=True, interpret=True))
    got = xl.flash_attention_fused_qkv_xl(torch.from_numpy(qkv), 2, qp=qp, pipelined=pipelined, ablate_softmax=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("panels", [1, 2, 3])
def test_staged_plain_version_matches_jax_at_tile_edges(n, panels):
    qkv = _qkv(np.random.default_rng(n + 2), 1, n, 2)
    want = np.asarray(jax_staged(jnp.asarray(qkv), 2, panels=panels, interpret=True))
    got = st.flash_attention_fused_qkv_staged(torch.from_numpy(qkv), 2, panels=panels).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("panels", [1, 2, 3])
def test_staged_plain_version_matches_jax_all_logits_negative(panels):
    qkv = _qkv(np.random.default_rng(4), 1, 193, 2, all_negative=True)
    want = np.asarray(jax_staged(jnp.asarray(qkv), 2, panels=panels, interpret=True))
    got = st.flash_attention_fused_qkv_staged(torch.from_numpy(qkv), 2, panels=panels).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def _slots() -> dict:
    """``enum Slot`` of csrc/flash_variants.cuh: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", (CSRC / "flash_variants.cuh").read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


# The C entries' choice in csrc/flash_variants.cuh, whitespace collapsed: the
# body of tma_readable and the `sm90` choice of variant_entry. c_entry_route
# transcribes exactly this text; a change to it fails
# test_stub_transcribes_the_c_entries_route until the stub follows.
C_ROUTE = (
    "const long long sizes[3] = {args[SLOT_BATCH], args[SLOT_N], args[SLOT_HEADS]}; for (int slot = SLOT_Q; slot <= "
    "SLOT_O; slot += 4) { if (args[slot] % 16 != 0) return false; for (int i = 0; i < 3; ++i) { const long long st = "
    "args[slot + 1 + i]; if (sizes[i] > 1 && (st <= 0 || st % 8 != 0 || st >= (1ll << 39))) return false; } } return true;",
    "const bool sm90 = dtype == 1; if (sm90 && !((any_keys || kend == n) && tma_readable(args))) return "
    "(int)cudaErrorInvalidValue;",
)
# variant_entry's any_keys argument in each C entry: #10 and #11 take all N keys, #12 the keys of its mode
ENTRY_ANY_KEYS = {"mdpt_flash_attention_xl": False, "mdpt_flash_attention_staged": False, "mdpt_flash_variant": True}


def _c_route() -> tuple:
    src = " ".join((CSRC / "flash_variants.cuh").read_text().split())
    readable = re.search(r"bool tma_readable\(const long long\* args\) \{ (.*?) \} // The \(batch", src)
    choice = re.search(r"(const bool sm90 = .*?;\s*if \(sm90 .*?;)", src)
    return readable.group(1), choice.group(1)


def _entry_flags() -> dict:
    flags = {}
    for source in ("flash_attention_xl.cu", "flash_attention_staged.cu", "flash_variant.cu"):
        m = re.search(r'extern "C" int (\w+)\(.*?variant_entry\(args, qk_scale, stream, (true|false),',
                      (CSRC / source).read_text(), re.S)
        flags[m.group(1)] = m.group(2) == "true"
    return flags


def _staged_tile_keys() -> int:
    """#11's sm_90 key tile: its C launch refuses a panel width that is not a multiple of it."""
    return int(re.search(r"constexpr int BKV = (\d+);", (CSRC / "flash_staged_sm90.cu").read_text()).group(1))


def test_stub_transcribes_the_c_entries_route():
    assert _c_route() == C_ROUTE
    assert _entry_flags() == ENTRY_ANY_KEYS
    assert "if (panel < BKV || panel % BKV != 0) return cudaErrorInvalidValue;" in (CSRC / "flash_staged_sm90.cu").read_text()


def c_entry_route(slots: dict, args: list, entry: str):
    """The kernel a C entry takes for the int64 argument array ``args``, as
    variant_entry chooses (C_ROUTE): "sm90" or "fv_f32", or None where the
    entry refuses the launch (cudaErrorInvalidValue)."""
    s = slots
    if args[s["SLOT_DTYPE"]] != 1:
        return "fv_f32"
    sizes = (args[s["SLOT_BATCH"]], args[s["SLOT_N"]], args[s["SLOT_HEADS"]])
    readable = all(args[slot] % 16 == 0 and all(size <= 1 or 0 < args[slot + 1 + i] < 2**39 and args[slot + 1 + i] % 8 == 0
                                                for i, size in enumerate(sizes))
                   for slot in range(s["SLOT_Q"], s["SLOT_O"] + 1, 4))
    if not ((ENTRY_ANY_KEYS[entry] or args[s["SLOT_KEYS"]] == args[s["SLOT_N"]]) and readable):
        return None
    if entry == "mdpt_flash_attention_staged" and args[s["SLOT_PANEL"]] % _staged_tile_keys():
        return None
    return "sm90"


class RouteStub:
    """Stands in for the kernel library's three sweep entries: reads the
    argument array, takes the route as the C entry does and records it with
    the slots that configure the kernel; returns cudaErrorInvalidValue where
    the entry refuses. Computes nothing (the output is left as allocated)."""

    def __init__(self):
        self.slots, self.calls = _slots(), []

    def _call(self, entry, args_ptr):
        s = self.slots
        args = list((ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr))
        route = c_entry_route(s, args, entry)
        self.calls.append({"entry": entry, "route": route, **{k: args[s[k]] for k in (
            "SLOT_N", "SLOT_KEYS", "SLOT_MODE", "SLOT_QP", "SLOT_PIPELINED", "SLOT_PANEL")}})
        return CUDA_ERROR_INVALID_VALUE if route is None else 0

    def mdpt_flash_attention_xl(self, args_ptr, qk_scale, stream):
        return self._call("mdpt_flash_attention_xl", args_ptr)

    def mdpt_flash_attention_staged(self, args_ptr, qk_scale, stream):
        return self._call("mdpt_flash_attention_staged", args_ptr)

    def mdpt_flash_variant(self, args_ptr, qk_scale, stream):
        return self._call("mdpt_flash_variant", args_ptr)


@pytest.fixture()
def stub(monkeypatch):
    lib = RouteStub()
    # a CPU tensor's device index is None: the stub has no device
    monkeypatch.setattr(fv, "array", types.SimpleNamespace(array=lambda code, v: array.array(code, [x or 0 for x in v])))
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    for module in (xl, st, av):
        monkeypatch.setattr(module, "_device_route", lambda device, name: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("n", sorted(ft.LADDER.values()))
def test_bf16_sweep_slabs_take_the_sm90_kernels(stub, n):
    """Every #10 case and #11 panel count of the sweep on a (1, N, 3072)
    bf16 slab of the ladder: the sm_90 route, qp, pipelining, the mode and
    the panel width of _panel_bounds (whole 128-key tiles) in their slots."""
    slab = torch.empty((1, n, 3 * ft.HEADS * ft.HEAD_DIM), dtype=torch.bfloat16)
    for _, kw in ft.XL_CASES:
        xl.flash_attention_fused_qkv_xl(slab, ft.HEADS, **kw)
        mode = fv.MODES["ablate" if kw.get("ablate_softmax") else "flash"]
        assert stub.calls.pop() == {"entry": "mdpt_flash_attention_xl", "route": "sm90", "SLOT_N": n, "SLOT_KEYS": n,
                                    "SLOT_MODE": mode, "SLOT_QP": kw.get("qp", 1),
                                    "SLOT_PIPELINED": int(kw.get("pipelined", True)), "SLOT_PANEL": fv.TILE_KEYS}
    for panels in (1, 2, 4, 8):
        st.flash_attention_fused_qkv_staged(slab, ft.HEADS, panels=panels)
        panel = st._panel_bounds((n + 127) // 128 * 128, panels)[1]
        assert panel % _staged_tile_keys() == 0
        assert stub.calls.pop() == {"entry": "mdpt_flash_attention_staged", "route": "sm90", "SLOT_N": n, "SLOT_KEYS": n,
                                    "SLOT_MODE": fv.MODES["staged"], "SLOT_QP": 1, "SLOT_PIPELINED": 0, "SLOT_PANEL": panel}


def test_float32_and_variant_bf16_take_the_template(stub):
    """float32 #10 and #11 run fv_f32; #12's bf16 modes run its sm_90
    kernel (flash_variant_sm90.cu), with the keys of each mode."""
    slab = torch.zeros((2, 70, 3 * 2 * 64), dtype=torch.float32)
    for _, kw in ft.XL_CASES:
        xl.flash_attention_fused_qkv_xl(slab, 2, **kw)
    st.flash_attention_fused_qkv_staged(slab, 2, panels=2)
    assert [c["route"] for c in stub.calls] == ["fv_f32"] * (len(ft.XL_CASES) + 1)
    stub.calls.clear()
    q = torch.zeros((2, 705, 64), dtype=torch.bfloat16)  # past the sweep's 704-key chunks
    for _, kw in ft.VARIANT_CASES:
        av.flash_variant(q, q, q, **kw)
    assert [c["route"] for c in stub.calls] == ["sm90"] * len(ft.VARIANT_CASES)
    n_pad = 768
    assert [c["SLOT_KEYS"] for c in stub.calls] == [{"mask_exp": 705, "mask_exp2": 705}.get(kw.get("mode"), n_pad)
                                                    if "chunk" not in kw else n_pad // kw["chunk"] * kw["chunk"]
                                                    for _, kw in ft.VARIANT_CASES]


def test_unreadable_bf16_layouts_raise(stub):
    """A bf16 layout that the tensor maps cannot read never launches: the
    wrapper refuses rows off 16 bytes before the C entry, and the C entry
    refuses a base or stride off 16 bytes, or (#10, #11) fewer keys than
    rows; #12 takes other key counts, not other layouts."""
    wide = torch.zeros((1, 70, 3 * 2 * 64 + 1), dtype=torch.bfloat16)
    for fn in (lambda x: xl.flash_attention_fused_qkv_xl(x, 2), lambda x: st.flash_attention_fused_qkv_staged(x, 2)):
        with pytest.raises(ValueError):
            fn(wide[..., 1:])  # base 2 bytes past 16-byte alignment
    assert stub.calls == []
    out = torch.zeros((1, 70, 128), dtype=torch.bfloat16)
    base = out.data_ptr()
    o = (base, 70 * 128, 128, 64)
    aligned = (base, 70 * 384, 384, 192)
    for entry in ("mdpt_flash_attention_xl", "mdpt_flash_attention_staged"):
        mode = "staged" if "staged" in entry else "flash"
        panel = 128 if mode == "staged" else fv.TILE_KEYS
        for q, keys in (((base + 2, 70 * 384, 384, 192), 70), ((base, 70 * 384, 388, 192), 70),
                        ((base, 70 * 384, 384, 196), 70), (aligned, 64)):
            with pytest.raises(RuntimeError, match="CUDA error 1"):
                fv.launch_variant(entry, (1, 70, 2, 64), torch.bfloat16, torch.device("cpu"), q, aligned, aligned, o,
                                  keys=keys, mode=mode, qk_scale=0.18, panel=panel)
            assert stub.calls.pop()["route"] is None
        fv.launch_variant(entry, (1, 70, 2, 64), torch.bfloat16, torch.device("cpu"), aligned, aligned, aligned, o, keys=70,
                          mode=mode, qk_scale=0.18, panel=panel)
        assert stub.calls.pop()["route"] == "sm90"
    for q in ((base + 2, 70 * 384, 384, 192), (base, 70 * 384, 388, 192), (base, 70 * 384, 384, 196)):
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            fv.launch_variant("mdpt_flash_variant", (1, 70, 2, 64), torch.bfloat16, torch.device("cpu"), q, aligned, aligned,
                              o, keys=128, mode="padfix", qk_scale=1.0, chunk=128)
        assert stub.calls.pop()["route"] is None
    for keys in (64, 70, 128):
        fv.launch_variant("mdpt_flash_variant", (1, 70, 2, 64), torch.bfloat16, torch.device("cpu"), aligned, aligned,
                          aligned, o, keys=keys, mode="padfix", qk_scale=1.0, chunk=keys)
        assert stub.calls.pop()["route"] == "sm90"
    with pytest.raises(RuntimeError, match="CUDA error 1"):  # #11's sm_90 kernel takes whole 128-key tiles per panel
        fv.launch_variant("mdpt_flash_attention_staged", (1, 70, 2, 64), torch.bfloat16, torch.device("cpu"), aligned,
                          aligned, aligned, o, keys=70, mode="staged", qk_scale=0.18, panel=192)


def test_flash_sm90_variants_text_edits_apply(monkeypatch, tmp_path):
    """Kernel #1's design variants are text edits of flash_attention_sm90.cu,
    whose helpers now live in csrc/sm90_attention.cuh: every edit still
    applies, and the build gives nvcc csrc/ on its include path."""
    source = (CSRC / "flash_attention_sm90.cu").read_text()
    assert '#include "sm90_attention.cuh"' in source
    for replacements in fsv.VARIANTS.values():
        assert fsv.variant_source(source, replacements).endswith(fsv.ENTRY)
    cmds = []
    proc = types.SimpleNamespace(returncode=0, communicate=lambda: ("ptxas info    : Used 168 registers", None))
    monkeypatch.setattr(vb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(vb, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(vb.subprocess, "Popen", lambda cmd, **kw: cmds.append(cmd) or proc)
    monkeypatch.setattr(vb.ctypes, "CDLL", lambda path: types.SimpleNamespace(run=types.SimpleNamespace()))
    assert set(fsv.build()) == set(fsv.VARIANTS)
    assert len(cmds) == len(fsv.VARIANTS) and all(cmd[cmd.index("-I") + 1] == str(CSRC) for cmd in cmds)
    assert all('#include "sm90_attention.cuh"' in Path(cmd[-1]).read_text() for cmd in cmds)


def test_sweep_sm90_variants_text_edits_apply():
    """The sweep kernels' design variants: every edit applies to its source,
    and the ptxas report reads registers, spills and serialization warnings."""
    for source, replacements, _ in ssv.VARIANTS.values():
        text = ssv.variant_source(source, replacements)
        assert text.endswith(ssv.ENTRY[source]) and "struct VParams" in text  # the header inlined
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_18fxl_sm90ILi2ELb1ELi0EEEv14CUtensorMap_stS1_S1_NS_7VParamsE' "
           "for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "ptxas /tmp/x.ptx, line 9; warning : (C7512) Potential Performance Loss: wgmma.mma_async instructions are "
           "serialized in the function '_ZN12_GLOBAL__N_18fst_sm90E14CUtensorMap_stS0_S0_NS_7VParamsE'\n")
    assert ssv.ptxas_summary(log) == [
        "fxl_sm90<qp=2, pipelined=1, flash>: spill stores 0 B, loads 0 B",
        "fxl_sm90<qp=2, pipelined=1, flash>: 168 registers",
        "fst_sm90: ptxas C7512: Potential Performance Loss: wgmma.mma_async instructions are serialized",
    ]
