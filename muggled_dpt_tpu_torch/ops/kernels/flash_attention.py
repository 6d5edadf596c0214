"""Flash attention: hand-written Hopper kernels behind one C entry
(``csrc/flash_attention.cu``) and two Python entries, each with its plain
PyTorch version beside it. The dtypes decide the kernel, nothing else:

=========================  ==================================================
bf16 q/k/v, no bias        ``csrc/flash_attention_sm90.cu`` (wgmma, TMA, a
                           warp-specialised producer), ``BIAS_NONE``
bf16 q/k/v, bf16 bias      the same source, ``BIAS_BF16``: the bias tile goes
                           through shared memory, filled by TMA or copied by
                           the producer's warps (``bias_fill``)
bf16 q/k/v, float32 bias   ``fa_bf16`` in ``csrc/flash_attention.cu`` (no
                           model sends one: ``ops/nn.py`` hands the bias over
                           in the model's dtype)
float32                    ``fa_f32`` in ``csrc/flash_attention.cu``
=========================  ==================================================

The tensor maps of the sm_90 kernel take the 16-byte aligned bases and
strides that ``_operand`` and ``_qkv_operands`` require of q, k and v; a bias
TMA cannot read is copied instead, so no bias layout is refused.

* ``flash_attention_fused_qkv(qkv, num_heads, bias, scale, bias_stack, layer)``
  replaces ``muggled_dpt_tpu/ops/pallas/flash_attention.py:flash_attention_fused_qkv``
  (TPU kernel #1, unbiased ``_onepass_qkv_kernel``, and #2, its biased path).
  The input is the fused qkv projection output, (B, N, 3C) with columns in
  head-major [head][q|k|v][dim] order (``checkpoints/convert_common.py:qkv_head_major``);
  the kernel reads q, k and v in place through strides. The output is
  (B, N, C) with head h in columns [h*D, (h+1)*D).
* ``flash_attention(q, k, v, bias, scale)`` on (B, N, H, D) tensors, which may
  be strided views, replaces the JAX package's ``flash_attention`` wrapper
  (TPU kernel #4, ``_onepass_kernel``, and #5, ``_online_kernel`` past 32768
  keys): the same kernels stream keys at every N.

Bias contract (the JAX package's ``_fit_bias``, ``flash_attention.py:574-599``):
the bias is broadcastable to (B, H, N, N); a size-1 row or column dim
broadcasts over the logical N, and trailing dims larger than N (a pre-padded
bias) are sliced to N, so pads are never read. ``bias_stack`` + ``layer`` is
BEiT's cached (L, H, Np, Np) stack: the kernel reads the layer at an element
offset, with no copy. The kernel never expands a broadcast bias: a batch,
head, row or column it broadcasts over gets stride 0.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; there is no fallback. Launches are counted per route, each in a plain
integer on its entry: ``flash_attention_fused_qkv.launches`` (unbiased),
``flash_attention_fused_qkv.biased_launches`` and ``flash_attention.launches``."""

from __future__ import annotations

import array
import math

import torch

from ._build import kernel_library

LOG2E = 1.4426950408889634
HEAD_DIM = 64  # the only head width the kernel is built for (DA and BEiT: F // 64 heads)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535  # CUDA grid y (heads) and z (batch) limit


def _bias_dims(shape, stride, b: int, h: int, n: int):
    """A bias's shape and element strides as four dims (1|B, 1|H, R, C),
    with leading size-1 dims of stride 0 added. Raises ValueError unless it
    broadcasts to (B, H, N, N): R and C are 1 or at least N (a pre-padded bias)."""
    if not 2 <= len(shape) <= 4:
        raise ValueError(f"bias must have 2 to 4 dims broadcastable to (B, H, N, N), got {tuple(shape)}")
    lead = 4 - len(shape)
    shape, stride = (1,) * lead + tuple(shape), (0,) * lead + tuple(stride)
    bb, bh, br, bc = shape
    if bb not in (1, b) or bh not in (1, h) or not (br == 1 or br >= n) or not (bc == 1 or bc >= n):
        raise ValueError(f"bias {shape[lead:]} does not broadcast to (B, H, N, N) = {(b, h, n, n)}")
    return shape, stride


def fit_bias(bias: torch.Tensor, b: int, h: int, n: int) -> torch.Tensor:
    """A view of ``bias`` as (1|B, 1|H, 1|N, 1|N): leading dims added, a
    pre-padded bias sliced to N. Raises ValueError on a bias that does not
    broadcast to (B, H, N, N)."""
    shape, _ = _bias_dims(bias.shape, bias.stride(), b, h, n)
    return bias.reshape(shape)[..., : min(shape[2], n), : min(shape[3], n)]


def _stack_layer(bias_stack: torch.Tensor, layer) -> int:
    if bias_stack.dim() != 4:
        raise ValueError(f"bias_stack must be (L, H, Np, Np), got {tuple(bias_stack.shape)}")
    if layer is None:
        raise ValueError("bias_stack needs a layer index")
    layer = int(layer)
    if not 0 <= layer < bias_stack.shape[0]:
        raise ValueError(f"layer {layer} out of range for a stack of {bias_stack.shape[0]}")
    return layer


def _layer_bias(bias, bias_stack, layer):
    """The dense bias the caller means: ``bias``, or the stack's layer slice."""
    if bias_stack is None:
        return bias
    if bias is not None:
        raise ValueError("pass either bias or bias_stack, not both")
    return bias_stack[_stack_layer(bias_stack, layer)][None]


REFERENCE_LOGITS = 1 << 28  # logits per step of a plain version: 1 GiB in float32


def reference_row_step(b: int, h: int, n_keys: int) -> int:
    """Query rows per step of a plain version, so that its (B, H, rows, N)
    float32 logits stay within ``REFERENCE_LOGITS`` elements (at N=18497 and
    16 heads the whole logit tensor would be 22 GB)."""
    return max(1, REFERENCE_LOGITS // (b * h * n_keys))


def flash_attention_reference(q, k, v, bias=None, scale=None) -> torch.Tensor:
    """Plain version on (B, N, H, D) tensors: float32 logits, bias added,
    softmax, weights cast to the input dtype for the PV product. Returns
    (B, N, H, D) in q's dtype. Query rows go in steps of
    ``reference_row_step``: every row's softmax is its own, so the steps
    change no arithmetic."""
    b, n, h, d = q.shape
    s = d**-0.5 if scale is None else scale
    kf = k.float()
    bias = None if bias is None else fit_bias(bias, b, h, n)
    step = reference_row_step(b, h, n)
    outs = []
    for i in range(0, n, step):
        rows = slice(i, i + step)
        logits = torch.einsum("bnhd,bmhd->bhnm", q[:, rows].float() * s, kf)
        if bias is not None:
            logits = logits + (bias if bias.shape[2] == 1 else bias[:, :, rows]).float()
        outs.append(torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1).to(q.dtype), v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def flash_attention_fused_qkv_reference(qkv, num_heads, bias=None, scale=None, bias_stack=None, layer=None):
    """Plain version of the fused entry: float32 attention on the split q,
    k and v of a head-major (B, N, 3C) qkv. Returns (B, N, C) in qkv's dtype."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    x = qkv.float().reshape(b, n, num_heads, 3, d)
    bias = _layer_bias(bias, bias_stack, layer)
    out = flash_attention_reference(x[..., 0, :], x[..., 1, :], x[..., 2, :], bias, scale)
    return out.reshape(b, n, num_heads * d).to(qkv.dtype)


_NO_BIAS = (-1, (0, 0, 0, 0, 0, 0))
BIAS_FILL_TMA, BIAS_FILL_COPY = 0, 1  # the argument array's SLOT_BIAS_FILL


def bias_fill(bias) -> int:
    """How the bf16 kernel fills its shared-memory bias tiles, from
    ``_bias_operand``'s result: ``BIAS_FILL_TMA`` where a tensor map can read
    the bias (bf16, column stride 1, rows not broadcast, the first element
    and every batch, head and row stride a multiple of 16 bytes: BEiT's
    cached stack and inline layer, whose rows are padded to 8 elements),
    else ``BIAS_FILL_COPY`` (the kernel's producer warps load it at any
    strides). Decided from the layout alone, before the launch; a launch
    without a bf16 bias ignores it."""
    code, (addr, offset, sb, sh, sn, sk) = bias
    es = 2  # bf16
    aligned = (addr + offset * es) % 16 == 0 and all(st * es % 16 == 0 for st in (sb, sh, sn))
    return BIAS_FILL_TMA if code == _DTYPE_CODES[torch.bfloat16] and sk == 1 and sn != 0 and aligned else BIAS_FILL_COPY


def _bias_operand(bias, bias_stack, layer, b: int, h: int, n: int, device):
    """(dtype code, (address, element offset, batch, head, row and column
    strides)) of the bias the kernel reads, stride 0 where it broadcasts.
    Shape and stride arithmetic only: no view is built, so a stack layer
    costs no more than a dense bias. ``_NO_BIAS`` without a bias."""
    if bias is None and bias_stack is None:
        return _NO_BIAS
    if bias_stack is not None:
        if bias is not None:
            raise ValueError("pass either bias or bias_stack, not both")
        t, offset = bias_stack, _stack_layer(bias_stack, layer) * bias_stack.stride(0)
        shape, stride = (1, *bias_stack.shape[1:]), (0, *bias_stack.stride()[1:])
    else:
        t, offset, shape, stride = bias, 0, bias.shape, bias.stride()
    if t.device != device or t.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention kernel: bias is {t.dtype} on {t.device}, want float32 or bfloat16 on {device}")
    shape, stride = _bias_dims(shape, stride, b, h, n)
    return _DTYPE_CODES[t.dtype], (t.data_ptr(), offset, *(st if size > 1 else 0 for size, st in zip(shape, stride)))


def _operand(name: str, t: torch.Tensor, device, dtype) -> tuple[int, ...]:
    """(address, then the element stride of every dim but the last) of a
    q, k or v input: (B, N, H, D) here, (B, nW, A, H, D) for the window
    kernel. Rows are copied as 16-byte chunks, by cp.async or a TMA tensor
    map: the head dim must be contiguous, the base and every other stride a
    multiple of 16 bytes."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"attention kernel: {name} is {t.dtype} on {t.device}, want {dtype} on {device}")
    step = 16 // t.element_size()
    *outer, sd = t.stride()
    if sd != 1 or t.data_ptr() % 16 != 0 or any(s % step for s in outer):
        raise ValueError(
            f"attention kernel: {name} needs a contiguous head dim and 16-byte aligned rows, "
            f"got strides {t.stride()} at address {t.data_ptr():#x}"
        )
    return t.data_ptr(), *outer


def _contiguous_pointer(kernel: str, name: str, t: torch.Tensor, device, dtype, align: int = 1) -> int:
    """The address of a tensor a kernel reads or writes whole: on ``device``,
    in ``dtype``, contiguous, its address a multiple of ``align`` bytes."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{kernel} kernel: {name} is {t.dtype} on {t.device}, want {dtype} on {device}")
    if not t.is_contiguous() or t.data_ptr() % align != 0:
        raise ValueError(f"{kernel} kernel: {name} must be contiguous and {align}-byte aligned, got strides {t.stride()} "
                         f"at address {t.data_ptr():#x}")
    return t.data_ptr()


def _qkv_operands(qkv: torch.Tensor, d: int) -> list[tuple[int, int, int, int]]:
    """q, k and v in place in a head-major (B, N, 3C) qkv, as ``_operand``
    gives them: head h's q at column h*3D, its k at +D and its v at +2D.
    Every base and stride is then a multiple of 16 bytes, as the tensor maps
    of the unbiased bf16 kernel require."""
    es, ptr = qkv.element_size(), qkv.data_ptr()
    sb, sn, sc = qkv.stride()
    if sc != 1 or ptr % 16 != 0 or sb % (16 // es) or sn % (16 // es) or d * es % 16:
        raise ValueError(
            f"flash attention kernel: qkv needs a contiguous last dim and 16-byte aligned rows, "
            f"got strides {qkv.stride()} at address {ptr:#x}"
        )
    return [(ptr + i * d * es, sb, sn, 3 * d) for i in range(3)]


def _launch(shape, dtype, device, q, k, v, out, bias, scale):
    """Launch the kernel over (B, N, H, D) = ``shape`` on ``device``. q, k, v
    and out are (address, batch stride, row stride, head stride) in elements;
    ``bias`` is ``_bias_operand``'s result. The arguments cross to C as one
    int64 array (slots in csrc/flash_attention.cu); the C entry launches on
    the tensors' device and leaves the caller's current device as it was."""
    b, n, h, d = shape
    if d != HEAD_DIM:
        raise ValueError(f"flash attention kernel supports head_dim {HEAD_DIM} only, got {d}")
    dtype_code = _DTYPE_CODES.get(dtype)
    if dtype_code is None:
        raise ValueError(f"flash attention kernel takes float32 or bfloat16, got {dtype}")
    if not math.isfinite(scale):
        raise ValueError(f"flash attention kernel needs a finite scale, got {scale}")
    if n < 1 or b < 1 or b > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"flash attention kernel: bad grid batch={b} heads={h} n={n}")
    bias_code, bias_args = bias
    args = array.array("q", [*q, *k, *v, *out, *bias_args, b, n, h, d, dtype_code, bias_code, device.index, bias_fill(bias)])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = kernel_library().mdpt_flash_attention(args.buffer_info()[0], scale * LOG2E, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")


def _device_route(device: torch.device, name: str) -> bool:
    """True for a CPU tensor's device (plain version), False for CUDA (kernel); raises otherwise."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return False


def _refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a kernel launch. A kernel writes
    through raw pointers into an output with no ``grad_fn``, and no kernel
    has a backward, so the gradient into its operands would be dropped
    without a word. Under ``torch.no_grad`` or ``torch.inference_mode``
    (every serving path) nothing is recorded and this passes. Never falls
    back to the plain version: training runs the plain attention itself
    (``parallel/train.py:plain_attention``)."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an operand requires grad, and there is no backward kernel; "
                           "differentiate the plain attention (use_kernel=False) or call it under torch.no_grad()")


def flash_attention_fused_qkv(qkv, num_heads, bias=None, scale=None, bias_stack=None, layer=None):
    """softmax(q k^T * scale + bias) v per head, read straight from the
    head-major qkv slab. ``scale`` defaults to D ** -0.5. ``bias`` is
    broadcastable to (B, H, N, N); or ``bias_stack`` (L, H, Np, Np) with
    ``layer`` selects one layer of a cached stack. Counts its launches in
    ``flash_attention_fused_qkv.launches`` (unbiased) and ``.biased_launches``."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads) != 0:
        raise ValueError(f"qkv must be (B, N, 3 * num_heads * D), got {tuple(qkv.shape)} for {num_heads} heads")
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    scale = d**-0.5 if scale is None else float(scale)
    device = qkv.device
    if _device_route(device, "flash_attention_fused_qkv"):
        return flash_attention_fused_qkv_reference(qkv, num_heads, bias, scale, bias_stack, layer)
    _refuse_grad("flash_attention_fused_qkv", qkv, bias, bias_stack)
    bias_arg = _bias_operand(bias, bias_stack, layer, b, num_heads, n, device)
    q, k, v = _qkv_operands(qkv, d)
    out = torch.empty((b, n, num_heads * d), dtype=qkv.dtype, device=device)
    o = (out.data_ptr(), n * num_heads * d, num_heads * d, d)
    _launch((b, n, num_heads, d), qkv.dtype, device, q, k, v, o, bias_arg, scale)
    if bias_arg is _NO_BIAS:
        flash_attention_fused_qkv.launches += 1
    else:
        flash_attention_fused_qkv.biased_launches += 1
    return out


def flash_attention(q, k, v, bias=None, scale=None):
    """Attention on (B, N, H, D) q, k and v (strided views allowed, head dim
    contiguous) with an optional bias broadcastable to (B, H, N, N); returns
    a new (B, N, H, D) tensor. Counts its launches in ``flash_attention.launches``."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, N, H, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, d = q.shape
    scale = d**-0.5 if scale is None else float(scale)
    device = q.device
    if _device_route(device, "flash_attention"):
        return flash_attention_reference(q, k, v, bias, scale)
    _refuse_grad("flash_attention", q, k, v, bias)
    bias_arg = _bias_operand(bias, None, None, b, h, n, device)
    specs = [_operand(name, t, device, q.dtype) for name, t in (("q", q), ("k", k), ("v", v))]
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=device)
    o = (out.data_ptr(), n * h * d, h * d, d)
    _launch((b, n, h, d), q.dtype, device, *specs, o, bias_arg, scale)
    flash_attention.launches += 1
    return out


flash_attention_fused_qkv.launches = 0
flash_attention_fused_qkv.biased_launches = 0
flash_attention.launches = 0


def _counted_entries() -> dict:
    """Route name -> (the entry, its attribute that counts the route's launches)."""
    from ...tools.attn_variants import flash_variant
    from .flash_attention_int8 import flash_attention_int8_qk, flash_attention_int8_qk_fused
    from .flash_attention_staged import flash_attention_fused_qkv_staged
    from .flash_attention_xl import flash_attention_fused_qkv_xl
    from .fused_mlp import fused_ln_mlp_residual
    from .head_tail import fused_head_tail
    from .window_attention import window_attention

    return {
        "fused": (flash_attention_fused_qkv, "launches"),
        "fused_biased": (flash_attention_fused_qkv, "biased_launches"),
        "bnhd": (flash_attention, "launches"),
        "window": (window_attention, "launches"),
        "window_sm90": (window_attention, "sm90_launches"),
        "fused_mlp": (fused_ln_mlp_residual, "launches"),
        "fused_mlp_sm90": (fused_ln_mlp_residual, "sm90_launches"),
        "head_tail": (fused_head_tail, "launches"),
        "head_tail_sm90": (fused_head_tail, "sm90_launches"),
        "int8_qk": (flash_attention_int8_qk, "launches"),
        "int8_qk_sm90": (flash_attention_int8_qk, "sm90_launches"),
        "int8_qk_fused": (flash_attention_int8_qk_fused, "launches"),
        "int8_qk_fused_sm90": (flash_attention_int8_qk_fused, "sm90_launches"),
        "xl": (flash_attention_fused_qkv_xl, "launches"),
        "staged": (flash_attention_fused_qkv_staged, "launches"),
        "variant": (flash_variant, "launches"),
    }


def reset_launch_counts():
    """Zero the launch count of every kernel route of the package."""
    for entry, attribute in _counted_entries().values():
        setattr(entry, attribute, 0)


def launch_counts() -> dict[str, int]:
    """The launch count of every kernel route of the package: the SwinV2
    window kernels (``ops/kernels/window_attention.py``: ``window`` and the
    sm_90 kernel's ``window_sm90``), the fused MLP (``fused_mlp.py``:
    ``fused_mlp`` and the sm_90 kernels' ``fused_mlp_sm90``), the head tail
    (``head_tail.py``: ``head_tail`` and the sm_90 kernel's
    ``head_tail_sm90``), the int8-QK^T attention's two entries
    (``flash_attention_int8.py``: ``int8_qk`` and ``int8_qk_fused``, and
    the sm_90 kernel's ``int8_qk_sm90`` and ``int8_qk_fused_sm90``) and
    the attention sweep's variants #10-#12 (``flash_attention_xl.py``,
    ``flash_attention_staged.py``, ``tools/attn_variants.py``) included."""
    return {route: getattr(entry, attribute) for route, (entry, attribute) in _counted_entries().items()}
