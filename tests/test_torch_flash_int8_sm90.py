"""TPU kernels #6 and #7 on Hopper (``csrc/flash_attention_int8_sm90.cu``:
the quantize prologue and the int8 wgmma/TMA attention kernel) without a card:

* which kernels the C entry ``mdpt_flash_attention_int8`` runs
  (``sm90_takes``), transcribed by ``c_entry_route`` and pinned to the C
  text: every bfloat16 launch -> ``flash_attention_int8_sm90``'s attention
  kernel, float32 -> ``fa_int8_f32``, both after the prologue. A stub
  library takes the route as the C entry does, writes it to SLOT_ROUTE and
  runs the design's stages through the wrapper's scratch slots: pass A
  (q_i8, sq in alpha, each row chunk's max |k| in kmax), pass B (k_i8 and
  alpha from the chunks' maxima), the attention from the scratch alone; the
  wrapper counts each call on its route;
* a numpy model of the prologue's two passes (chunks of 64 rows, partial
  maxima combined by max, each step one IEEE float32 operation) equal bit
  for bit to the plain prologues (``quantize_fused``, ``quantize_rows``)
  and to the JAX package's XLA prologue (``experiments/flash_attention_int8.py``
  ``:101-107``, ``:263-271``, op by op) at ragged N, in float32 and bfloat16;
* a numpy model of the attention kernels' tiling (the sm_90 kernel: 192-row
  q tiles, 128-key int8 tiles zero-filled past N and masked to NEG_INF, p
  rounded to bf16 and summed as rounded; ``fa_int8_f32``: 64-row, 64-key
  tiles in float32), the online softmax at the kernels' rounding points,
  against the JAX kernels in interpret mode with the tolerances that
  ``tests/test_torch_flash_int8.py`` states (5e-5 in float32, 2e-2 in
  bfloat16), and against the plain version;
* the design variants of ``tools/int8_sm90_variants.py``: each constant and
  text edit still applies to the source, and each build binds its C entry
  through the shared harness ``tools/variant_build.py``."""

import array
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from experiments.flash_attention_int8 import LOG2E, flash_attention_int8_qk, flash_attention_int8_qk_fused
from muggled_dpt_tpu_torch.ops.kernels import _build
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_int8 as fi8
from muggled_dpt_tpu_torch.tools import int8_sm90_variants as iv
from muggled_dpt_tpu_torch.tools import variant_build as vb

CSRC = Path(fi8.__file__).resolve().parents[2] / "csrc"
TOL = dict(rtol=5e-5, atol=5e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
D = 64
NEG_INF = np.float32(-1e30)
SM90_TILES, F32_TILES = (192, 128), (64, 64)  # (q rows, keys) per tile of the two attention kernels


def _slots() -> dict:
    """``enum Slot`` of csrc/flash_attention_int8.cu: name -> index."""
    body = re.search(r"enum Slot \{(.*?)\};", (CSRC / "flash_attention_int8.cu").read_text(), re.S).group(1)
    slots, nxt = {}, 0
    for name, value in re.findall(r"^\s*(\w+)\s*(?:=\s*(\d+))?\s*,", body, re.M):
        nxt = int(value) if value else nxt
        slots[name], nxt = nxt, nxt + 1
    return slots


def _c_text(name):
    return " ".join((CSRC / name).read_text().split())


# flash_attention_int8.cu's choice, whitespace collapsed: c_entry_route transcribes exactly this text
C_ROUTE = "bool sm90_takes(const long long* args) { return args[SLOT_DTYPE] == 1; }"


def c_entry_route(slots: dict, args: list) -> str:
    """The attention kernel mdpt_flash_attention_int8 runs for the argument array (C_ROUTE)."""
    return "flash_attention_int8_sm90" if args[slots["SLOT_DTYPE"]] == 1 else "fa_int8_f32"


def test_stub_transcribes_the_c_entrys_route():
    src = _c_text("flash_attention_int8.cu")
    assert C_ROUTE in src
    assert "const bool sm90 = sm90_takes(args); args[SLOT_ROUTE] = sm90 ? ROUTE_SM90 : ROUTE_F32;" in src
    assert "constexpr long long ROUTE_F32 = 0, ROUTE_SM90 = 1;" in src
    assert (f"constexpr long long STAGE_PROLOGUE = {fi8.STAGE_PROLOGUE}, STAGE_ATTENTION = {fi8.STAGE_ATTENTION};" in src)
    slots = _slots()
    assert fi8.SLOT_ROUTE == slots["SLOT_ROUTE"] == slots["NUM_SLOTS"] - 1 and fi8.SM90_ROUTE == 1
    assert fi8.SLOT_STAGES == slots["SLOT_STAGES"]
    assert list(slots)[-8:] == ["SLOT_DEVICE", "SLOT_Q_I8", "SLOT_K_I8", "SLOT_ALPHA", "SLOT_KMAX", "SLOT_STAGES",
                                "SLOT_ROUTE", "NUM_SLOTS"]
    # the prologue runs for every launch, before either attention kernel
    assert "if (stages & STAGE_PROLOGUE) err = int8_prologue(" in src
    kernel = _c_text("flash_attention_int8_sm90.cu")
    assert f"constexpr int PRO_ROWS = {fi8.PROLOGUE_ROWS};" in kernel
    assert f"constexpr int ALPHA_SQSK = {fi8.MODE_SQSK}, ALPHA_SCALED = {fi8.MODE_SCALED};" in kernel
    assert "i8_onepass" not in kernel  # one launch for both passes is a variant of tools/int8_sm90_variants.py
    assert "constexpr int CONSUMERS = 3;" in kernel and "constexpr int BQ = 64 * CONSUMERS;" in kernel
    assert f"constexpr int BKV = {SM90_TILES[1]};" in kernel
    assert f"constexpr int BQ = {F32_TILES[0]};" in src and f"constexpr int BK = {F32_TILES[1]};" in src
    # the bf16 mma.sync kernel is gone: no route reaches it
    assert "fa_int8<" not in src and "mma_bf16" not in src and "__nv_bfloat16" not in src


@pytest.mark.parametrize("dtype_code,want", [(1, "flash_attention_int8_sm90"), (0, "fa_int8_f32")])
def test_c_entry_route(dtype_code, want):
    s = _slots()
    args = [0] * s["NUM_SLOTS"]
    args[s["SLOT_DTYPE"]] = dtype_code
    assert c_entry_route(s, args) == want


def _bf16(a):
    """float32 numpy values rounded to the nearest bfloat16 (ties to even), kept as float32."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).view(np.float32)


def design_prologue(q, k, q_mul, mode, scale, rows=fi8.PROLOGUE_ROWS):
    """The kernel prologue's two passes in numpy on (B, N, H, D) float32 q
    and k (bf16 inputs as their exact float32 values). Pass A, chunk by
    chunk of ``rows`` rows: qf = q * q_mul, sq = max(max |qf|, 1e-12) / 127,
    q_i8 = rint(qf / sq), sq kept in alpha, each chunk's max |k| per (b, h).
    Pass B: sk from the chunks' maxima, k_i8 = rint(k / sk), alpha = sq sk
    or ((sq sk) scale) log2(e). Returns (q_i8, k_i8 (B, N, H, D) int8,
    alpha (B, H, N) float32, kmax (B, H, chunks))."""
    b, n, h, d = q.shape
    f32 = np.float32
    chunks = -(-n // rows)
    q_i8 = np.zeros(q.shape, np.int8)
    alpha = np.zeros((b, h, n), f32)
    kmax = np.zeros((b, h, chunks), f32)
    qf = q * f32(q_mul)
    for c in range(chunks):
        r = slice(c * rows, min(n, (c + 1) * rows))
        sq = np.maximum(np.abs(qf[:, r]).max(axis=3), f32(1e-12)) / f32(127.0)  # (B, rows, H)
        q_i8[:, r] = np.rint(qf[:, r] / sq[..., None])
        alpha[:, :, r] = sq.transpose(0, 2, 1)
        kmax[:, :, c] = np.abs(k[:, r]).max(axis=(1, 3))
    sk = np.maximum(kmax.max(axis=2), f32(1e-12)) / f32(127.0)  # (B, H)
    k_i8 = np.rint(k / sk[:, None, :, None]).astype(np.int8)
    alpha = alpha * sk[..., None]
    if mode == fi8.MODE_SCALED:
        alpha = alpha * f32(scale) * f32(LOG2E)
    assert qf.dtype == sq.dtype == alpha.dtype == f32
    return q_i8, k_i8, alpha, kmax


def design_attention(q_i8, k_i8, v, alpha, tiles, round_p):
    """The attention kernels' tiling in numpy on (B, N, H, D) int8 q and k,
    v as float32 values and alpha (B, N, H): per (b, h) and q tile, the key
    tiles in order, zero-filled past N; s = float32(int32 logits) * alpha
    (one rounding), keys past N set to NEG_INF; the running max m, corr =
    exp2(m_old - m), p = exp2(s - m), rounded to bf16 with ``round_p``; l =
    l corr + sum of p as rounded; O = O corr + P V in float32; out = O /
    max(l, 1e-30). Returns (B, N, H, D) float32."""
    bq, bkv = tiles
    b, n, h, d = q_i8.shape
    nq, nk = -(-n // bq) * bq, -(-n // bkv) * bkv
    qp, ap = np.zeros((b, nq, h, d), np.int64), np.zeros((b, nq, h), np.float32)
    kp, vp = np.zeros((b, nk, h, d), np.int64), np.zeros((b, nk, h, d), np.float32)
    qp[:, :n], ap[:, :n], kp[:, :n], vp[:, :n] = q_i8, alpha, k_i8, v
    out = np.zeros((b, nq, h, d), np.float32)
    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, nq, bq):
                rows = slice(q0, q0 + bq)
                m = np.full(bq, NEG_INF, np.float32)
                l = np.zeros(bq, np.float32)
                o = np.zeros((bq, d), np.float32)
                for k0 in range(0, nk, bkv):
                    keys = slice(k0, k0 + bkv)
                    s = (qp[bi, rows, hi] @ kp[bi, keys, hi].T).astype(np.float32) * ap[bi, rows, hi][:, None]
                    s[:, np.arange(k0, k0 + bkv) >= n] = NEG_INF
                    m_new = np.maximum(m, s.max(axis=1))
                    corr = np.exp2(m - m_new)
                    p = np.exp2(s - m_new[:, None])
                    if round_p:
                        p = _bf16(p)
                    l = l * corr + p.sum(axis=1, dtype=np.float32)
                    o = o * corr[:, None] + p @ vp[bi, keys, hi]
                    m = m_new
                out[bi, rows, hi] = o / np.maximum(l, np.float32(1e-30))[:, None]
    return out[:, :n]


def jax_prologue_fused(qkv, num_heads, scale):
    """experiments/flash_attention_int8.py:263-271, #7's XLA prologue, op by
    op: (q_i8, k_i8, alpha (B, H, N)). (Compiled as one jit, XLA's CPU
    backend fuses the ops and rounds alpha differently in the last bit, for
    about 40 % of the values at (2, 300, 3 heads).)"""
    b, n, c3 = qkv.shape
    hm = qkv.reshape(b, n, num_heads, 3, c3 // 3 // num_heads)
    qf = hm[..., 0, :].astype(jnp.float32) * (scale * LOG2E)
    kf = hm[..., 1, :].astype(jnp.float32)
    sq = jnp.maximum(jnp.max(jnp.abs(qf), axis=3), 1e-12) / 127.0
    sk = jnp.maximum(jnp.max(jnp.abs(kf), axis=(1, 3)), 1e-12) / 127.0
    q_i8 = jnp.round(qf / sq[..., None]).astype(jnp.int8)
    k_i8 = jnp.round(kf / sk[:, None, :, None]).astype(jnp.int8)
    return q_i8, k_i8, (sq * sk[:, None, :]).transpose(0, 2, 1)


def jax_prologue_rows(q, k, scale):
    """experiments/flash_attention_int8.py:101-107, #6's XLA prologue, op by op: (q_i8, k_i8, alpha (BH, N))."""
    qf, kf = q.astype(jnp.float32), k.astype(jnp.float32)
    sq = jnp.maximum(jnp.max(jnp.abs(qf), axis=2), 1e-12) / 127.0
    sk = jnp.maximum(jnp.max(jnp.abs(kf), axis=(1, 2)), 1e-12) / 127.0
    q_i8 = jnp.round(qf / sq[:, :, None]).astype(jnp.int8)
    k_i8 = jnp.round(kf / sk[:, None, None]).astype(jnp.int8)
    return q_i8, k_i8, (sq * sk[:, None] * scale * LOG2E).astype(jnp.float32)


def _slab(rng, b, n, h, dtype):
    """A head-major (B, N, 3C) qkv slab (torch, ``dtype``) and its q, k, v as
    (B, N, H, D) float32 numpy values (exact for bf16)."""
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * D), dtype=np.float32)).to(dtype)
    x = qkv.float().numpy().reshape(b, n, h, 3, D)
    return qkv, x[..., 0, :], x[..., 1, :], x[..., 2, :]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [300, 129, 257])  # ragged: a part-filled last chunk of 64 rows; 129, 257: one row past two, four
def test_design_prologue_matches_plain_and_jax_fused(dtype, n):
    rng = np.random.default_rng(n)
    h, scale = 3, D**-0.5
    qkv, q, k, _ = _slab(rng, 2, n, h, dtype)
    q_i8, k_i8, alpha, kmax = design_prologue(q, k, np.float32(scale * LOG2E), fi8.MODE_SQSK, scale)
    assert kmax.shape == (2, h, -(-n // fi8.PROLOGUE_ROWS))
    pq, pk, pa, _ = fi8.quantize_fused(qkv, h, scale)
    np.testing.assert_array_equal(q_i8, pq.numpy())
    np.testing.assert_array_equal(k_i8, pk.numpy())
    np.testing.assert_array_equal(alpha, pa.permute(0, 2, 1).numpy())
    jq, jk, ja = jax_prologue_fused(jnp.asarray(qkv.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
                                    h, scale)
    np.testing.assert_array_equal(q_i8, np.asarray(jq))
    np.testing.assert_array_equal(k_i8, np.asarray(jk))
    np.testing.assert_array_equal(alpha, np.asarray(ja))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,scale", [(300, None), (129, 0.2), (200, -0.3)])
def test_design_prologue_matches_plain_and_jax_rows(dtype, n, scale):
    """#6: q unscaled (q_mul = 1), alpha = ((sq sk) scale) log2(e), three roundings; a negative scale too."""
    rng = np.random.default_rng(n + 1)
    q, k = (torch.from_numpy(rng.standard_normal((3, n, D), dtype=np.float32)).to(dtype) for _ in range(2))
    s = D**-0.5 if scale is None else scale
    q_i8, k_i8, alpha, _ = design_prologue(q.float().numpy()[:, :, None], k.float().numpy()[:, :, None], 1.0,
                                           fi8.MODE_SCALED, s)
    pq, pk, pa = fi8.quantize_rows(q, k, s)
    np.testing.assert_array_equal(q_i8[:, :, 0], pq.numpy())
    np.testing.assert_array_equal(k_i8[:, :, 0], pk.numpy())
    np.testing.assert_array_equal(alpha[:, 0], pa.numpy())
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, ja = jax_prologue_rows(jnp.asarray(q.float().numpy(), jdt), jnp.asarray(k.float().numpy(), jdt), s)
    np.testing.assert_array_equal(q_i8[:, :, 0], np.asarray(jq))
    np.testing.assert_array_equal(k_i8[:, :, 0], np.asarray(jk))
    np.testing.assert_array_equal(alpha[:, 0], np.asarray(ja))


def test_plain_prologue_divides_by_127_on_every_device():
    """The plain prologue divides by 127 as a tensor, one IEEE division, as
    the kernel does: a float32 tensor divided by the Python number 127 is
    multiplied by the number's reciprocal on the card, which differs in the
    last bit for about 4 % of values."""
    x = torch.from_numpy(np.random.default_rng(3).random(1 << 16, dtype=np.float32) * 5)
    exact = torch.from_numpy(x.numpy() / np.float32(127.0))
    assert torch.equal(fi8._per_127(x), exact)
    assert not torch.equal(x * np.float32(1.0 / 127.0), exact)


@pytest.mark.parametrize("dtype,tiles", [(torch.float32, F32_TILES), (torch.bfloat16, SM90_TILES)])
@pytest.mark.parametrize("b,n,h,negative", [(2, 300, 2, False), (1, 200, 2, True), (1, 129, 2, False)])
def test_design_attention_matches_jax_fused_kernel(dtype, tiles, b, n, h, negative):
    """#7: the numpy prologue and tiling against the JAX one-pass kernel in
    interpret mode and the plain version; ragged N (past one 128-key tile by
    one key at N=129), and every logit far below zero (q = -8|x|, k = |y|),
    where the keys past N must be masked, not counted out."""
    rng = np.random.default_rng(b * n + h)
    qkv, q, k, v = _slab(rng, b, n, h, torch.float32)
    if negative:
        q, k = -8.0 * np.abs(q), np.abs(k)
        qkv = torch.from_numpy(np.stack([q, k, v], axis=3).reshape(b, n, 3 * h * D))
    qkv = qkv.to(dtype)
    x = qkv.float().numpy().reshape(b, n, h, 3, D)
    q, k, v = x[..., 0, :], x[..., 1, :], x[..., 2, :]
    scale = D**-0.5
    q_i8, k_i8, alpha, _ = design_prologue(q, k, np.float32(scale * LOG2E), fi8.MODE_SQSK, scale)
    got = design_attention(q_i8, k_i8, v, alpha.transpose(0, 2, 1), tiles, round_p=dtype == torch.bfloat16)
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = flash_attention_int8_qk_fused(jnp.asarray(qkv.float().numpy(), jdt), h, interpret=True)
    np.testing.assert_allclose(got.reshape(b, n, h * D), np.asarray(want.astype(jnp.float32)), **tol)
    plain = fi8.flash_attention_int8_qk_fused_reference(qkv, h).float().numpy()
    np.testing.assert_allclose(got.reshape(b, n, h * D), plain, **tol)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("dtype,tiles", [(torch.float32, F32_TILES), (torch.bfloat16, SM90_TILES)])
def test_design_attention_matches_jax_online_kernel(dtype, tiles):
    """#6 at a ragged N with a zero q row: sq = 1e-12 / 127, q_i8 = 0, its
    logits all 0, its output the mean of v."""
    rng = np.random.default_rng(11)
    n = 300
    q, k, v = (torch.from_numpy(rng.standard_normal((4, n, D), dtype=np.float32)).to(dtype) for _ in range(3))
    q[:, 7] = 0.0
    qn, kn, vn = (t.float().numpy()[:, :, None] for t in (q, k, v))
    q_i8, k_i8, alpha, _ = design_prologue(qn, kn, 1.0, fi8.MODE_SCALED, D**-0.5)
    got = design_attention(q_i8, k_i8, vn, alpha.transpose(0, 2, 1), tiles, round_p=dtype == torch.bfloat16)[:, :, 0]
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = flash_attention_int8_qk(*(jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v)), block_q=128, block_k=128,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(got, fi8.flash_attention_int8_qk_reference(q, k, v).float().numpy(), **tol)
    np.testing.assert_allclose(got[:, 7], vn[:, :, 0].mean(axis=1), **tol)


def _view(addr, sizes, strides, dtype):
    extent = 1 + sum((size - 1) * stride for size, stride in zip(sizes, strides))
    buf = (ctypes.c_byte * (extent * torch.empty((), dtype=dtype).element_size())).from_address(addr)
    return torch.frombuffer(buf, dtype=dtype).as_strided(sizes, strides)


class RouteStub:
    """Stands in for the kernel library: takes the route as the C entry does,
    writes it to SLOT_ROUTE and runs the design's stages through the scratch
    slots: pass A and pass B of ``design_prologue`` chunk by chunk, pass B
    reading the row chunks' maxima back from kmax, then the plain attention
    on the scratch alone (q_i8, k_i8, alpha) and v. Its float arguments are
    rounded to float32, as ctypes passes them."""

    def __init__(self):
        self.slots, self.routes, self.scratch = _slots(), [], []

    def mdpt_flash_attention_int8(self, args_ptr, q_mul, scale, stream):
        s = self.slots
        a = (ctypes.c_longlong * s["NUM_SLOTS"]).from_address(args_ptr)
        route = c_entry_route(s, list(a))
        a[s["SLOT_ROUTE"]] = 1 if route == "flash_attention_int8_sm90" else 0
        self.routes.append(route)
        b, n, h, d = (a[s[k]] for k in ("SLOT_BATCH", "SLOT_N", "SLOT_HEADS", "SLOT_HEAD_DIM"))
        dtype = [torch.float32, torch.bfloat16][a[s["SLOT_DTYPE"]]]
        q, k, v, o = (_view(a[s[k]], (b, n, h, d), [*a[s[k] + 1 : s[k] + 4], 1], dtype)
                      for k in ("SLOT_Q", "SLOT_K", "SLOT_V", "SLOT_O"))
        chunks = -(-n // fi8.PROLOGUE_ROWS)
        dense = (n * h * d, h * d, d, 1)
        q_i8, k_i8 = (_view(a[s[k]], (b, n, h, d), dense, torch.int8) for k in ("SLOT_Q_I8", "SLOT_K_I8"))
        alpha = _view(a[s["SLOT_ALPHA"]], (b, h, n), (h * n, n, 1), torch.float32)
        kmax = _view(a[s["SLOT_KMAX"]], (b, h, chunks), (h * chunks, chunks, 1), torch.float32)
        self.scratch.append(tuple(a[s[k]] for k in ("SLOT_Q_I8", "SLOT_K_I8", "SLOT_ALPHA", "SLOT_KMAX")))
        if a[s["SLOT_STAGES"]] & fi8.STAGE_PROLOGUE:
            qn, kn = q.float().numpy(), k.float().numpy()
            pq, _, pa, pkmax = design_prologue(qn, kn, np.float32(q_mul), a[s["SLOT_MODE"]], np.float32(scale))
            q_i8.copy_(torch.from_numpy(pq))  # pass A
            kmax.copy_(torch.from_numpy(pkmax))
            sq = np.maximum(np.abs(qn * np.float32(q_mul)).max(axis=3), np.float32(1e-12)) / np.float32(127.0)
            alpha.copy_(torch.from_numpy(sq.transpose(0, 2, 1)))
            # pass B: sk from the chunks' maxima as read back from the scratch
            sk = np.maximum(kmax.numpy().max(axis=2), np.float32(1e-12)) / np.float32(127.0)
            k_i8.copy_(torch.from_numpy(np.rint(kn / sk[:, None, :, None]).astype(np.int8)))
            al = alpha.numpy() * sk[..., None]
            if a[s["SLOT_MODE"]] == fi8.MODE_SCALED:
                al = al * np.float32(scale) * np.float32(LOG2E)
            np.testing.assert_array_equal(al, pa)
            alpha.copy_(torch.from_numpy(al))
        if a[s["SLOT_STAGES"]] & fi8.STAGE_ATTENTION:
            o.copy_(fi8.int8_attention_reference(q_i8, k_i8, v, alpha.permute(0, 2, 1)))
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = RouteStub()
    # a CPU tensor's device index is None: the stub has no device
    monkeypatch.setattr(fi8, "array", types.SimpleNamespace(array=lambda code, v: array.array(code, [x or 0 for x in v])))
    monkeypatch.setattr(fi8, "_device_route", lambda device, name: False)
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("entry,dtype", [(7, torch.bfloat16), (7, torch.float32), (6, torch.bfloat16), (6, torch.float32)])
def test_wrapper_counts_each_call_on_its_route(stub, entry, dtype):
    """One call counts one launch on its route; the call hands the C entry
    four scratch tensors (q_i8, k_i8, alpha, kmax), 16-byte aligned and
    apart from each other, which the stages write and read; the output,
    computed from the scratch alone, equals the plain entry bit for bit."""
    rng = np.random.default_rng(entry)
    fa.reset_launch_counts()
    if entry == 7:
        b, n, h = 2, 150, 3
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * D), dtype=np.float32)).to(dtype)
        got = fi8.flash_attention_int8_qk_fused(qkv, h)
        want = fi8.flash_attention_int8_qk_fused_reference(qkv, h)
        routes = ("int8_qk_fused_sm90", "int8_qk_fused")
    else:
        b, n, h = 3, 140, 1
        q, k, v = (torch.from_numpy(rng.standard_normal((b, n, D), dtype=np.float32)).to(dtype) for _ in range(3))
        got = fi8.flash_attention_int8_qk(q, k, v, scale=0.2)
        want = fi8.flash_attention_int8_qk_reference(q, k, v, scale=0.2)
        routes = ("int8_qk_sm90", "int8_qk")
    sm90 = dtype == torch.bfloat16
    assert stub.routes == ["flash_attention_int8_sm90" if sm90 else "fa_int8_f32"]
    counts = fa.launch_counts()
    assert (counts[routes[0]], counts[routes[1]]) == ((1, 0) if sm90 else (0, 1))
    (q8, k8, al, km), = stub.scratch
    sizes = [b * n * h * D, b * n * h * D, b * h * n * 4, b * h * -(-n // fi8.PROLOGUE_ROWS) * 4]
    spans = sorted((p, p + size) for p, size in zip((q8, k8, al, km), sizes))
    assert all(p % 16 == 0 for p in (q8, k8, al, km)) and all(x[1] <= y[0] for x, y in zip(spans, spans[1:]))
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_copies_what_the_kernels_cannot_read(stub):
    """#6's q, k or v with rows off 16-byte alignment or a strided head dim
    are copied (a visible copy, contiguous) before the launch, and the
    launch holds the copies it points the kernels at; a readable layout is
    read in place. Through the stub the result equals the plain entry's."""
    x = torch.zeros(2, 16, D + 4, dtype=torch.bfloat16)[..., :D]
    assert fi8._readable(x) is not x and fi8._readable(x).is_contiguous()
    y = torch.zeros(2, 16, 2 * D)[..., ::2]
    assert fi8._readable(y).stride(-1) == 1
    z = torch.zeros(2, 16, D)
    assert fi8._readable(z) is z
    rng = np.random.default_rng(12)
    wide = torch.from_numpy(rng.standard_normal((3, 2, 40, D + 4), dtype=np.float32)).bfloat16()
    q, k, v = wide[0, ..., :D], wide[1, ..., :D], wide[2, ..., ::1][..., 4:]  # rows 136 bytes apart; v 8 bytes off too
    launch = fi8.prepare_int8_qk(q, k, v)
    assert [t.data_ptr() for t in launch.inputs] == [launch.args[0], launch.args[4], launch.args[8]]
    assert all(t.is_contiguous() for t in launch.inputs)
    torch.testing.assert_close(fi8.flash_attention_int8_qk(q, k, v), fi8.flash_attention_int8_qk_reference(q, k, v),
                               rtol=0, atol=0)


def test_stages_run_apart_give_one_calls_output(monkeypatch):
    """Int8Launch.run with the prologue alone, then the attention alone on
    the scratch it left, gives the scratch of the plain prologue and the
    output of one whole call (the stub runs the same stages)."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((1, 70, 3 * 2 * D), dtype=np.float32)).bfloat16()
    lib = RouteStub()
    monkeypatch.setattr(fi8, "array", types.SimpleNamespace(array=lambda code, v: array.array(code, [x or 0 for x in v])))
    monkeypatch.setattr(_build, "kernel_entry", lambda name, *argtypes: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    launch = fi8.prepare_int8_qk_fused(qkv, 2)
    assert launch.run(fi8.STAGE_PROLOGUE) and launch.run(fi8.STAGE_ATTENTION)
    q8, k8, al, _ = fi8.quantize_fused(qkv, 2, D**-0.5)
    assert torch.equal(launch.q_i8, q8) and torch.equal(launch.k_i8, k8) and torch.equal(launch.alpha.permute(0, 2, 1), al)
    torch.testing.assert_close(launch.out.reshape(1, 70, 2 * D), fi8.flash_attention_int8_qk_fused_reference(qkv, 2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", list(iv.VARIANTS))
def test_int8_variant_edits_apply(name):
    """Each design variant is the committed source with its constants set
    (every constant still declared), its text edits applied (every old text
    still found) and the raw C entry appended."""
    committed = (CSRC / iv.SOURCE).read_text()
    constants, edits = iv.VARIANTS[name]
    text = iv.variant_source(constants, edits)
    assert text.endswith(iv.ENTRY)
    body = text[:-len(iv.ENTRY)]
    want = {c: f"constexpr {'bool' if isinstance(v, bool) else 'int'} {c} = {str(v).lower()};" for c, v in constants.items()}
    assert all(line in body for line in want.values())
    assert all(old in committed and old not in body for old, _ in edits)
    if not edits:  # a schedule variant changes its constants' lines and nothing else
        changed = [b for a, b in zip(committed.splitlines(), body.splitlines()) if a != b]
        assert len(committed.splitlines()) == len(body.splitlines())
        assert all(any(b.strip().startswith(w) for w in want.values()) for b in changed)


def test_int8_variants_build_binds_each_entry(monkeypatch, tmp_path):
    """The shared harness builds every variant at once, one nvcc each with
    csrc/ on the include path, binds the raw C entry, and names the kernels
    of ptxas's report."""
    cmds = []
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110fa_i8_sm90E14CUtensorMap_stS0_S0_NS_6ParamsE' "
           "for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n")
    proc = types.SimpleNamespace(returncode=0, communicate=lambda: (log, None))
    monkeypatch.setattr(vb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(vb, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(vb.subprocess, "Popen", lambda cmd, **kw: cmds.append(cmd) or proc)
    monkeypatch.setattr(vb.ctypes, "CDLL", lambda path: types.SimpleNamespace(run=types.SimpleNamespace()))
    names = ["committed", "128 rows"]
    libs = iv.build(names, str(tmp_path))
    assert list(libs) == names and len(cmds) == 2 and all(cmd[cmd.index("-I") + 1] == str(CSRC) for cmd in cmds)
    assert all(lib.run.argtypes == iv.ARGS for lib in libs.values())
    assert (tmp_path / "int8_sm90_variant_1.txt").read_text().startswith("128 rows\n")
    assert vb.ptxas_summary(log, iv.kernel_label) == ["fa_i8_sm90: spill stores 0 B, loads 0 B", "fa_i8_sm90: 128 registers"]
    assert iv.kernel_label("_ZN12_GLOBAL__N_19i8_pass_aI13__nv_bfloat16EEvNS_8PrologueE") == "i8_pass_a<bf16>"
    assert iv.kernel_label("_ZN12_GLOBAL__N_19i8_pass_bIfEEvNS_8PrologueE") == "i8_pass_b<f32>"
