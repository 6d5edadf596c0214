#!/usr/bin/env python3
"""Host-cost and profile measurements of the port on one CUDA card.

    python3 muggled_dpt_tpu_torch/tools/measure.py host [--against DIR]
    python3 muggled_dpt_tpu_torch/tools/measure.py attention [--against DIR]
    python3 muggled_dpt_tpu_torch/tools/measure.py head [--against DIR]
    python3 muggled_dpt_tpu_torch/tools/measure.py mlp [--against DIR]
    python3 muggled_dpt_tpu_torch/tools/measure.py int8 [--against DIR]
    python3 muggled_dpt_tpu_torch/tools/measure.py profile [--model beit|swinv2|vitl|giant] [--dtype bf16|f16] [--out DIR]
    python3 muggled_dpt_tpu_torch/tools/measure.py profile --int8 [dense] [default] [qkv] [neck] [--out DIR]

``host``: the attention and window attention wrappers' host cost per call,
then the same calls of #1 (unbiased), #2 (a stack layer) and #3 through
their ``torch.ops.mdpt`` operators (``ops/kernels/library.py``, what an
exported program calls) against the wrappers called directly, paired round
by round under ``inference_mode`` (this checkout only),
the DA-V2 ViT-L, BEiT-L-512 and SwinV2-L-384 bf16 request times at B=1, and
BEiT-L-512's and SwinV2-L-384's ms per frame at B=8 (24 attention or window
launches per forward; the sm_90 window kernel encodes six tensor maps per
launch).
Per-call cost (``flash_tune.host_us``): each route is called 200 times
back to back, queued behind a spin of the card so that no call waits for
it, and the host clock stops at the last call's return, so it reads the
host work of a launch alone. ``--against DIR`` also loads DIR's ``muggled_dpt_tpu_torch`` (an
earlier commit unpacked with ``git archive``, say) under another module name
into the same process, and alternates the two packages round by round, so
both see the same host noise; each line then says in how many rounds this
checkout was faster.

``attention``: CUDA-event times of the bf16 attention kernel
(csrc/flash_attention_sm90.cu) at DA-V2 ViT-L's (8, 1297, 3072) and
(1, 18497, 3072) qkv slabs (#1), at (1, 32897, 2, 64) (#5), and biased at
BEiT-L-512's (8, 1025, 3072) slab with layer 23 of its padded
(24, 16, 1032, 1032) stack (#2; #4 on the slab's q, k, v views with that
layer as a (1, H, Np, Np) bias) and at the 1024x1024 request's
(1, 4097, 3072) slab with layer 23 of the (24, 16, 4104, 4104) stack (#2,
12.9 GB), on random inputs from a seed (1e6 in the stacks' pads), beside one
SDPA call (the layer as attn_mask) and the bound (4 B H N^2 D operations
over 989 TFLOP/s, or q, k, v, out and the layer's H N^2 bias read once over
3.35 TB/s); ``--against DIR`` times DIR's kernel on the same inputs in
turns (DIR, this, this, DIR). Then the attention sweep's #10 (every case
of ``flash_tune.XL_CASES``; bf16: csrc/flash_xl_sm90.cu) and #11 (panels
1, 2, 4 and 8; csrc/flash_staged_sm90.cu) beside #1 and SDPA on random
(1, N, 3072) bf16 slabs from the seed at N = 10405 and 18497 (DA-V2
ViT-L's 1428x1428 and 1904x1904 token counts, 16 heads x 64), the same
way, with the bound and #11's design floor (6 B H N^2 D over 989 TFLOP/s:
its pass 2 recomputes pass 1's QK^T), and #12 (``tools/attn_variants.py``;
bf16: csrc/flash_variant_sm90.cu) in every ``flash_tune.VARIANT_CASES``
mode at (16, 1297, 64), each both per launch (CUDA events around each
call, the host's cost per call included, as the other kernels here) and
as device time (``flash_tune.device_ms``: 20 launches queued back to back
behind a spin of the card), beside SDPA timed both ways. Then the SwinV2 window kernel (#3; bf16:
csrc/window_attention_sm90.cu) at SwinV2-L-384's four stage shapes at B=8
and stage 1 at B=1, on the inputs of ``tools/window_sm90_variants.py``, the
same way, beside one SDPA call on the summed bias, the bound (4 B
nW H A^2 D operations, or q, k, v, out, CPB and mask read once) and the exp
floor (B nW H A^2 exp2 over the SFU's 16 per clock per SM, 132 SMs at
1.83 GHz).

``head``: the fused head tail (#9; bf16: csrc/head_tail_sm90.cu) at
DA ViT-L's head, (B, 128, 504, 504) -> 32 -> 1, B = 1 and 8, ReLU and
sigmoid, on random inputs from a seed; with ``--against``, the other
checkout's kernel on the same inputs in turns (other, this, this, other),
per launch (CUDA events) and as device time (``flash_tune.device_ms``); beside them
``Head.tail``'s composite (cuDNN conv3x3 -> ReLU -> conv1x1 -> ReLU or
sigmoid) on the same weights, timed both ways, and the bound (2 B H W 32
(9 ci + 1) operations over 989 TFLOP/s, or the map read and the output
written once over 3.35 TB/s).

``mlp``: the fused LayerNorm-MLP-residual (#8; bf16: the three kernels
of csrc/fused_mlp_sm90.cu) at F = 1024, H = 4096 on (B, N) = (8, 1297)
and (1, 1297) (DA ViT-L at 504x504) and (1, 1025) (BEiT-L-512 at
512x512), on random inputs and a random ViT-L block from a seed (fc1 and
fc2 scaled by 1/sqrt(fan-in)); with ``--against``, the other checkout's
kernel on the same inputs in turns (other, this, this, other), per call
(CUDA events) and as device time (``flash_tune.device_ms``); beside them
``Block.mlp_residual``'s composite (LayerNorm, fc1, GELU, fc2, LayerScale
and residual as separate bf16 ops) timed both ways, and the bound (4 B N F
H operations over 989 TFLOP/s, or tokens, weights and output moved once
over 3.35 TB/s).

``int8``: the int8-QK^T attention, #7 on a head-major (B, N, 3072) qkv
slab (16 heads x 64) at B = 8 and 1 and #6 on (B H, N, 64) q, k and v at
B H = 128 and 16, N = 1297 (DA-V2 ViT-L at 504x504), bf16, random from a
seed: each entry per call (CUDA events) and as device time
(``flash_tune.device_ms``), and its parts, the prologue alone and the
attention kernel alone (this design: one C call with its stages chosen;
the design before it, when ``--against`` names one: its torch-op prologue
and its kernel's launch on that prologue's output); with ``--against``, the
other checkout's on the same inputs in turns (other, this, this, other).
Beside them one SDPA call on the same views and kernel #1 on the slab, timed
both ways, the bound (QK^T's 2 B H N^2 D int8 operations over 1979 TOP/s
plus PV's over 989 TFLOP/s, or q, k, v and out moved once over 3.35 TB/s),
the prologue's byte floor and the exp floor (one exp2 per (q, k) pair over
the SFU's 3.86e12 per second).

``profile``: a torch.profiler breakdown of a bf16 forward (10 forwards at
B=1, 5 at B=8): device busy share (the union of kernel intervals over the
host wall time of the profiled loop), kernels per forward, device time per
forward by kind; and the time to build the grid's aux once (``make_aux``).
``--model beit`` (the default): BEiT-L-512 at 512x512, the bias stack at
512x512 and 1024x1024. ``--model swinv2``: SwinV2-L-384 at 384x384, the CPB
stacks and shift masks at 384x384 and 512x512. ``--model vitl`` and
``--model giant``: Depth-Anything V2 ViT-L and ViT-Giant at 504x504 (no
per-grid aux). ``--out`` also writes every kernel's time per forward to
``DIR/profile_<model>[_int8]_kernels.txt``. ``--int8 TIER ...`` profiles
the model's int8 tiers (``DPTModel.quantize_encoder_int8``; ``--model``
defaults to vitl): ``default`` (qkv dense), ``qkv``, ``neck`` (qkv and the
neck) and ``dense`` (the bf16 model, for a comparison in the same run),
one after the other in one process; the int8 GEMMs (cuBLASLt's s8 kernels)
are a kind of their own. Before them it times one int8 linear's parts
with CUDA events at each encoder linear shape over the B=8 tokens: the
per-token quantize, the int8 GEMM, the dequantize (scales, bias, cast)
beside the bf16 linear, and their sums over the blocks of each tier; the
quantize and dequantize passes are generic elementwise kernels that the
profile cannot tell apart by name.

Every printed line carries the card's name and power limit (nvidia-smi).
Models have random weights from seed 0; nothing is downloaded."""

from __future__ import annotations

import argparse
import inspect
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VITL = {
    "features_per_token": 1024,
    "num_blocks": 24,
    "reassembly_features_list": [256, 512, 1024, 1024],
    "fusion_channels": 256,
    "patch_size_px": 14,
    "base_patch_grid_hw": (37, 37),
}
BEIT_L512 = {
    "features_per_token": 1024,
    "num_blocks": 24,
    "num_heads": 16,
    "reassembly_features_list": [256, 512, 1024, 1024],
    "fusion_channels": 256,
    "patch_size_px": 16,
    "base_patch_grid_hw": (32, 32),
}
VITG = dict(VITL, features_per_token=1536, num_blocks=40, reassembly_features_list=[1536] * 4, fusion_channels=384,
            is_giant=True)
SWIN_L384 = {
    "features_per_stage": [192, 384, 768, 1536],
    "heads_per_stage": [6, 12, 24, 48],
    "layers_per_stage": [2, 2, 18, 2],
    "base_patch_grid_hw": (96, 96),
    "window_size_hw": (24, 24),
    "pretrained_window_sizes_per_stage": [12, 12, 12, 6],
    "fusion_channels": 256,
    "patch_size_px": 4,
}
FRAME_HW = (720, 1280)
KINDS = [  # (kind, substrings of the kernel name), first match wins
    ("int8 GEMM (torch._int_mm)", ("gemm_s8", "i16832gemm", "imma")),
    ("attention kernel", ("fa_sm90", "fa_mma", "fa_f32")),
    ("window attention kernel", ("wa_sm90", "wa_mma", "wa_f32")),
    ("conv (cuDNN, with layout transforms)", ("cudnn", "xmma", "fprop", "dgrad", "nchwToNhwc", "nhwcToNchw")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "Gemm")),
    ("resize", ("upsample",)),
    ("LayerNorm", ("layer_norm",)),
    ("GELU", ("Gelu",)),
    ("memcpy/memset", ("Memcpy", "Memset")),
    ("cat/copy", ("copy", "Cat")),
]


def card_line() -> str:
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def spread(values) -> str:
    return f"median {statistics.median(values):.2f}, min {min(values):.2f}, max {max(values):.2f}"


def write_checkpoint(sd, path):
    import torch

    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def load_package(root: str, alias: str):
    """``root``'s muggled_dpt_tpu_torch imported under the module name
    ``alias`` (the package imports itself only relatively)."""
    import importlib.util

    pkg_dir = os.path.join(os.path.abspath(root), "muggled_dpt_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg_dir, "__init__.py"),
                                                  submodule_search_locations=[pkg_dir])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def attention_routes(pkg_name: str, heads=16, n=65, d=64) -> dict:
    """The package's attention calls at a shape too small to keep the card busy."""
    import importlib

    import torch

    fa = importlib.import_module(pkg_name + ".ops.kernels.flash_attention")
    wa = importlib.import_module(pkg_name + ".ops.kernels.window_attention")
    wq, wk, wv = torch.randn(1, 4, 16, 3, 2, 32, device="cuda", dtype=torch.bfloat16).unbind(3)
    cpb, mask = torch.zeros(2, 16, 16, device="cuda", dtype=torch.bfloat16), torch.zeros(4, 16, 16, device="cuda", dtype=torch.bfloat16)
    qkv = torch.randn(1, n, 3 * heads * d, device="cuda", dtype=torch.bfloat16)
    routes = {"fused, unbiased": lambda: fa.flash_attention_fused_qkv(qkv, heads)}
    if "bias_stack" in inspect.signature(fa.flash_attention_fused_qkv).parameters:
        stack = torch.zeros(24, heads, 72, 72, device="cuda", dtype=torch.bfloat16)
        q, k, v = qkv.unflatten(2, (heads, 3, d)).unbind(3)
        routes["fused, stack layer 23"] = lambda: fa.flash_attention_fused_qkv(qkv, heads, bias_stack=stack, layer=23)
        routes["(B, N, H, D) views, (1, H, Np, Np) bias"] = lambda: fa.flash_attention(q, k, v, bias=stack[23][None])
    routes["window, bf16 CPB and mask (B=1, nW=4, A=16, H=2)"] = lambda: wa.window_attention(wq, wk, wv, cpb, mask)
    return routes


def dispatch_routes(heads=16, n=65, d=64) -> dict:
    """The serving kernels at a shape too small to keep the card busy, each
    as (the wrapper called directly, the same call through its
    ``torch.ops.mdpt`` operator, ops/kernels/library.py)."""
    import torch

    from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
    from muggled_dpt_tpu_torch.ops.kernels import library  # noqa: F401  (registers torch.ops.mdpt.*)
    from muggled_dpt_tpu_torch.ops.kernels import window_attention as wa

    qkv = torch.randn(1, n, 3 * heads * d, device="cuda", dtype=torch.bfloat16)
    stack = torch.zeros(24, heads, 72, 72, device="cuda", dtype=torch.bfloat16)
    wq, wk, wv = torch.randn(1, 4, 16, 3, 2, 32, device="cuda", dtype=torch.bfloat16).unbind(3)
    cpb, mask = torch.zeros(2, 16, 16, device="cuda", dtype=torch.bfloat16), torch.zeros(4, 16, 16, device="cuda", dtype=torch.bfloat16)
    op = torch.ops.mdpt
    return {
        "#1 fused, unbiased (B=1, N=65, H=16)": (lambda: fa.flash_attention_fused_qkv(qkv, heads),
                                                lambda: op.flash_attention_fused_qkv(qkv, heads)),
        "#2 fused, stack layer 23 (B=1, N=65, H=16)": (
            lambda: fa.flash_attention_fused_qkv(qkv, heads, bias_stack=stack, layer=23),
            lambda: op.flash_attention_fused_qkv(qkv, heads, bias_stack=stack, layer=23)),
        "#3 window, bf16 CPB and mask (B=1, nW=4, A=16, H=2)": (lambda: wa.window_attention(wq, wk, wv, cpb, mask),
                                                                lambda: op.window_attention(wq, wk, wv, cpb, mask)),
    }


def per_call_us(fn) -> float:
    from muggled_dpt_tpu_torch.tools.flash_tune import host_us

    return host_us(fn, warmup=0)  # interleaved() warms every route up


def request_ms(fn) -> float:
    """Host-clock ms of one whole request, synchronized on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def interleaved(fns: dict, measure, rounds: int) -> dict:
    """Run each fn through ``measure`` once per round, the order reversed
    every other round; returns each name's readings."""
    readings = {name: [] for name in fns}
    for name, fn in fns.items():  # warm-up
        for _ in range(3):
            measure(fn)
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            readings[name].append(measure(fns[name]))
    return readings


def report(what: str, readings: dict, unit: str, smi: str):
    names = list(readings)
    for name in names:
        line = f"[{name}] {what}: {spread(readings[name])} {unit}"
        if len(names) == 2 and name == names[0]:
            wins = sum(a < b for a, b in zip(readings[names[0]], readings[names[1]]))
            line += f"; faster in {wins} of {len(readings[name])} rounds"
        print(f"{line} [{smi}]", flush=True)


def host(args, smi):
    import importlib

    import numpy as np
    import torch

    packages = {REPO_ROOT: "muggled_dpt_tpu_torch"}
    if args.against:
        load_package(args.against, "against_muggled_dpt_tpu_torch")
        packages[args.against] = "against_muggled_dpt_tpu_torch"
    routes = {root: attention_routes(pkg) for root, pkg in packages.items()}
    for route in routes[REPO_ROOT]:
        fns = {root: r[route] for root, r in routes.items() if route in r}
        report(f"host us per attention call, {route} (B=1, N=65, H=16)", interleaved(fns, per_call_us, 20), "us", smi)
    with torch.inference_mode():  # as the facade serves
        for route, (direct, through_op) in dispatch_routes().items():
            readings = interleaved({"wrapper": direct, "torch.ops.mdpt": through_op}, per_call_us, 20)
            report(f"host us per call, {route}", readings, "us", smi)
            extra = statistics.median(b - a for a, b in zip(readings["wrapper"], readings["torch.ops.mdpt"]))
            print(f"dispatch: the operator costs {extra:.2f} us more per call than the wrapper, {route}, median of "
                  f"{len(readings['wrapper'])} paired rounds [{smi}]", flush=True)

    frame = np.random.default_rng(1).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        sd = importlib.import_module("muggled_dpt_tpu_torch.checkpoints.random_init").random_original_depth_anything_state_dict(VITL)
        ckpt = write_checkpoint(sd, os.path.join(tmp, "depth_anything_v2_vitl_random.pth"))
        del sd
        models = {root: importlib.import_module(pkg + ".make_dpt").make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device="cuda")[1]
                  for root, pkg in packages.items()}
        fns = {root: (lambda m=m: m.inference(frame, 518)) for root, m in models.items()}
        report("DA-V2 ViT-L bf16 504x504 ms per request, B=1", interleaved(fns, request_ms, 30), "ms", smi)
        del models, fns
        beit = importlib.import_module("muggled_dpt_tpu_torch.checkpoints.beit")
        ckpt = write_checkpoint(beit.random_original_state_dict(BEIT_L512, seed=0), os.path.join(tmp, "dpt_beit_large_512_random.pt"))
        model = importlib.import_module("muggled_dpt_tpu_torch.make_dpt").make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device="cuda")[1]
        fns = {REPO_ROOT: lambda: model.inference(frame, 512)}
        report("BEiT-L-512 bf16 512x512 ms per request, B=1", interleaved(fns, request_ms, 30), "ms", smi)
        del model, fns
        models = {root: importlib.import_module(pkg + ".make_dpt").make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device="cuda")[1]
                  for root, pkg in packages.items()}
        frames = np.random.default_rng(2).integers(0, 256, (8, *FRAME_HW, 3), dtype=np.uint8)
        batch = torch.from_numpy(frames).cuda()
        hw = next(iter(models.values())).compute_scaled_hw(FRAME_HW, 512)
        fns = {root: (lambda m=m: m.inference_rgb_device(batch, hw)) for root, m in models.items()}
        report("BEiT-L-512 bf16 512x512 ms per frame, B=8", interleaved(fns, lambda fn: request_ms(fn) / 8, 20), "ms", smi)
        del models, fns
        swin = importlib.import_module("muggled_dpt_tpu_torch.checkpoints.swinv2")
        ckpt = write_checkpoint(swin.random_original_state_dict(SWIN_L384, seed=0), os.path.join(tmp, "dpt_swin2_large_384_random.pt"))
        models = {root: importlib.import_module(pkg + ".make_dpt").make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device="cuda")[1]
                  for root, pkg in packages.items()}
        fns = {root: (lambda m=m: m.inference(frame, 384)) for root, m in models.items()}
        report("SwinV2-L-384 bf16 384x384 ms per request, B=1", interleaved(fns, request_ms, 30), "ms", smi)
        hw = next(iter(models.values())).compute_scaled_hw(FRAME_HW, 384)
        fns = {root: (lambda m=m: m.inference_rgb_device(batch, hw)) for root, m in models.items()}
        report("SwinV2-L-384 bf16 384x384 ms per frame, B=8", interleaved(fns, lambda fn: request_ms(fn) / 8, 20), "ms", smi)


ATTENTION_CASES = (  # (label, batch, tokens, heads, entry, padded bias rows or None)
    ("#1 fused qkv, DA-V2 ViT-L 504x504 B=8", 8, 1297, 16, "fused", None),
    ("#1 fused qkv, DA-V2 ViT-L 1904x1904 B=1", 1, 18497, 16, "fused", None),
    ("#5 (B, N, H, D), N past 32768", 1, 32897, 2, "bnhd", None),
    ("#2 fused qkv, BEiT-L-512 512x512 B=8, stack layer 23", 8, 1025, 16, "fused", 1032),
    ("#4 (B, N, H, D) views, (1, H, Np, Np) layer 23, BEiT-L-512 B=8", 8, 1025, 16, "views", 1032),
    ("#2 fused qkv, BEiT-L-512 1024x1024 B=1, stack layer 23", 1, 4097, 16, "fused", 4104),
)
STACK_LAYERS = 24
WINDOW_CASES = (  # (label, B, windows per image, window side, heads, shift mask): SwinV2-L-384 at 384x384
    ("#3 window, SwinV2-L-384 stage 1 B=8", 8, 16, 24, 6, True),
    ("#3 window, SwinV2-L-384 stage 2 B=8", 8, 4, 24, 12, True),
    ("#3 window, SwinV2-L-384 stage 3 B=8", 8, 1, 24, 24, False),
    ("#3 window, SwinV2-L-384 stage 4 B=8", 8, 1, 12, 48, False),
    ("#3 window, SwinV2-L-384 stage 1 B=1", 1, 16, 24, 6, True),
)


def attention(args, smi):
    """bf16 CUDA-event times of the unbiased attention kernel at each of
    ``ATTENTION_CASES`` on random inputs from a seed; with ``--against``, the
    other checkout's kernel on the same inputs, in turns (other, this, this,
    other); then one SDPA call on the same views and the bound (4 B H N^2 D
    operations over 989 TFLOP/s)."""
    import importlib

    import torch
    import torch.nn.functional as F

    packages = {"this": "muggled_dpt_tpu_torch"}
    if args.against:
        load_package(args.against, "against_muggled_dpt_tpu_torch")
        packages = {"against": "against_muggled_dpt_tpu_torch", **packages}
    fas = {name: importlib.import_module(pkg + ".ops.kernels.flash_attention") for name, pkg in packages.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stacks = {}
    for label, b, n, h, entry, n_pad in ATTENTION_CASES:
        qkv = torch.randn(b, n, 3 * h * 64, device="cuda", dtype=torch.bfloat16, generator=gen)
        q, k, v = qkv.unflatten(2, (h, 3, 64)).unbind(3)
        if entry == "bnhd":  # #5 as chip_smoke.py times it: three (B, N, H, D) tensors
            q, k, v = (t.contiguous() for t in (q, k, v))
        kw, mask, bias_elements = {}, None, 0
        if n_pad is not None:
            if n_pad not in stacks:  # one stack at a time: the 1024x1024 one is 12.9 GB
                stacks.clear()
                torch.cuda.empty_cache()
                stack = torch.randn(STACK_LAYERS, h, n_pad, n_pad, device="cuda", dtype=torch.bfloat16, generator=gen)
                stack[..., n:, :] = 1e6
                stack[..., :, n:] = 1e6
                stacks[n_pad] = stack
            stack = stacks[n_pad]
            kw = {"bias_stack": stack, "layer": STACK_LAYERS - 1} if entry == "fused" else {"bias": stack[STACK_LAYERS - 1][None]}
            mask, bias_elements = stack[STACK_LAYERS - 1][None, :, :n, :n], h * n * n
        calls = {name: (lambda fa=fa: fa.flash_attention_fused_qkv(qkv, h, **kw)) if entry == "fused"
                 else (lambda fa=fa: fa.flash_attention(q, k, v, **kw)) for name, fa in fas.items()}
        iters, warmup = (30, 5) if n < 10000 else (10, 2)
        order = ["against", "this", "this", "against"] if args.against else ["this", "this"]
        times = {name: [] for name in calls}
        for name in order:
            times[name].append(event_ms(calls[name], iters, warmup))
        sdpa = [t.transpose(1, 2) for t in (q, k, v)]
        library = event_ms(lambda: F.scaled_dot_product_attention(*sdpa, attn_mask=mask), iters, warmup)
        ops_ms = 4 * b * h * n * n * 64 / 989e12 * 1e3
        bytes_ms = (4 * b * n * h * 64 + bias_elements) * 2 / 3.35e12 * 1e3
        bound = f"bound {max(ops_ms, bytes_ms):.4f} ms ({'ops' if ops_ms >= bytes_ms else 'bytes'})"
        readings = ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items())
        print(f"{label} (B={b}, N={n}, H={h}, D=64): {readings} (median of {iters} after {warmup}); SDPA {library:.4f} ms; "
              f"{bound} [{smi}]", flush=True)
        del qkv, q, k, v, sdpa, kw, mask
        torch.cuda.empty_cache()
    stacks.clear()
    sweep_variants(packages, gen, smi, args.against)
    window(packages, gen, smi, args.against)


SWEEP_NS = (10405, 18497)  # #10 and #11 at DA-V2 ViT-L's 1428x1428 and 1904x1904 token counts


def sweep_variants(packages: dict, gen, smi: str, against):
    """#10 in every ``flash_tune.XL_CASES`` case and #11 at panels 1, 2, 4
    and 8, with #1 as the anchor, at ``SWEEP_NS``, as ``attention`` times #1."""
    import importlib

    import torch
    import torch.nn.functional as F

    from muggled_dpt_tpu_torch.tools.flash_tune import XL_CASES

    h = 16
    kernels = {name: [importlib.import_module(f"{pkg}.ops.kernels.{mod}") for mod in
                      ("flash_attention", "flash_attention_xl", "flash_attention_staged")] for name, pkg in packages.items()}
    order = ["against", "this", "this", "against"] if against else ["this", "this"]
    for n in SWEEP_NS:
        qkv = torch.randn(1, n, 3 * h * 64, device="cuda", dtype=torch.bfloat16, generator=gen)
        cases = [("#1 (anchor)", lambda m: m[0].flash_attention_fused_qkv(qkv, h))]
        cases += [(f"#10 {label}", lambda m, kw=kw: m[1].flash_attention_fused_qkv_xl(qkv, h, **kw)) for label, kw in XL_CASES]
        cases += [(f"#11 panels={p}", lambda m, p=p: m[2].flash_attention_fused_qkv_staged(qkv, h, panels=p)) for p in (1, 2, 4, 8)]
        sdpa = [t.transpose(1, 2) for t in qkv.unflatten(2, (h, 3, 64)).unbind(3)]
        library = event_ms(lambda: F.scaled_dot_product_attention(*sdpa), 10, 2)
        bound_ms = 4 * h * n * n * 64 / 989e12 * 1e3  # operations bound: the bytes, 4 N H D bf16, are far below
        floor_ms = 6 * h * n * n * 64 / 989e12 * 1e3
        for label, call in cases:
            times = {name: [] for name in kernels}
            for name in order:
                times[name].append(event_ms(lambda: call(kernels[name]), 10, 2))
            readings = ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items())
            floor = f"; design floor {floor_ms:.4f} ms" if label.startswith("#11") else ""
            print(f"{label} (B=1, N={n}, H={h}, D=64, random slab): {readings} (median of 10 after 2); SDPA {library:.4f} ms; "
                  f"bound {bound_ms:.4f} ms (ops){floor} [{smi}]", flush=True)
        del qkv, sdpa
        torch.cuda.empty_cache()
    # #12 in every mode of the sweep at the JAX tool's (16, 1297, 64), per launch and as device time
    from muggled_dpt_tpu_torch.tools.flash_tune import VARIANT_CASES, device_ms

    q, k, v = (torch.randn(16, 1297, 64, device="cuda", dtype=torch.bfloat16, generator=gen) for _ in range(3))
    variant = {name: importlib.import_module(f"{pkg}.tools.attn_variants").flash_variant for name, pkg in packages.items()}
    sdpa = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=math.log(2.0))  # noqa: E731
    print(f"#12 SDPA (16, 1297, 64): {event_ms(sdpa):.4f} ms per launch, {device_ms(sdpa):.4f} ms device time [{smi}]",
          flush=True)
    for case, kw in VARIANT_CASES:
        for how, measure in (("per launch", event_ms), ("device time", device_ms)):
            times = {name: [] for name in variant}
            for name in order:
                times[name].append(measure(lambda: variant[name](q, k, v, **kw)))
            readings = ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items())
            print(f"#12 flash_variant {case} (16, 1297, 64), random, {how}: {readings} [{smi}]", flush=True)


HEAD_CASES = ((1, False), (8, False), (1, True), (8, True))  # (B, metric) at ViT-L's head tail, (B, 128, 504, 504)


def head(args, smi):
    """#9 at ``HEAD_CASES`` against the other checkout's kernel (in turns)
    and ``Head.tail``'s composite, per launch and as device time."""
    import importlib

    import torch

    from muggled_dpt_tpu_torch.models.dpt_neck import Head
    from muggled_dpt_tpu_torch.tools.flash_tune import device_ms

    packages = {"this": "muggled_dpt_tpu_torch"}
    if args.against:
        load_package(args.against, "against_muggled_dpt_tpu_torch")
        packages = {"against": "against_muggled_dpt_tpu_torch", **packages}
    hts = {name: importlib.import_module(pkg + ".ops.kernels.head_tail") for name, pkg in packages.items()}
    order = ["against", "this", "this", "against"] if args.against else ["this", "this"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    ci, hw = 128, (504, 504)
    for b, metric in HEAD_CASES:
        x = torch.randn(b, ci, *hw, device="cuda", dtype=torch.bfloat16, generator=gen)
        head_ = Head(2 * ci, 14 / 8, metric, device="cuda").to(torch.bfloat16)
        with torch.no_grad():  # the conv scaled by 1/sqrt(9 ci), the projection's bias 2: as chip_smoke.py's head inputs
            head_.conv_mid.weight.copy_(torch.randn(32, ci, 3, 3, device="cuda", generator=gen) * (9 * ci) ** -0.5)
            head_.conv_mid.bias.copy_(torch.randn(32, device="cuda", generator=gen) * 0.1)
            head_.proj.weight.copy_(torch.randn(1, 32, 1, 1, device="cuda", generator=gen) * 0.3)
            head_.proj.bias.copy_(torch.randn(1, device="cuda", generator=gen) + 2.0)
        params = (head_.conv_mid.weight, head_.conv_mid.bias, head_.proj.weight, head_.proj.bias)
        calls = {name: (lambda ht=ht: ht.fused_head_tail(x, *params, metric)) for name, ht in hts.items()}

        def composite():
            with torch.inference_mode():
                return head_.tail(x)

        ops_ms = 2 * b * hw[0] * hw[1] * 32 * (9 * ci + 1) / 989e12 * 1e3
        bytes_ms = (b * ci + b) * hw[0] * hw[1] * 2 / 3.35e12 * 1e3
        bound = f"bound {max(ops_ms, bytes_ms):.4f} ms ({'ops' if ops_ms >= bytes_ms else 'bytes'})"
        for how, measure in (("per launch", event_ms), ("device time", device_ms)):
            times = {name: [] for name in calls}
            for name in order:
                times[name].append(measure(calls[name]))
            readings = ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items())
            print(f"#9 fused_head_tail (B={b}, ci={ci}, {hw[0]}x{hw[1]}, {'sigmoid' if metric else 'relu'}), random, {how}: "
                  f"{readings}; Head.tail {measure(composite):.4f} ms; {bound} [{smi}]", flush=True)
        del x, head_, params, calls
        torch.cuda.empty_cache()


MLP_CASES = ((8, 1297), (1, 1297), (1, 1025))  # (B, N) at ViT-L's block, F = 1024, H = 4096


def mlp(args, smi):
    """#8 bf16 at ``MLP_CASES`` against the other checkout's kernel (in
    turns) and ``Block.mlp_residual``'s composite, per call and as device
    time."""
    import importlib

    import torch

    from muggled_dpt_tpu_torch.models.dinov2 import Block
    from muggled_dpt_tpu_torch.tools.flash_tune import device_ms

    packages = {"this": "muggled_dpt_tpu_torch"}
    if args.against:
        load_package(args.against, "against_muggled_dpt_tpu_torch")
        packages = {"against": "against_muggled_dpt_tpu_torch", **packages}
    fms = {name: importlib.import_module(pkg + ".ops.kernels.fused_mlp") for name, pkg in packages.items()}
    order = ["against", "this", "this", "against"] if args.against else ["this", "this"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    f = 1024
    block = Block(f, 16, device="cuda").to(torch.bfloat16)
    n2, m = block.norm2, block.mlp
    with torch.no_grad():  # chip_smoke.py's mlp_inputs: (scale, shift) per parameter
        for p, scale, shift in ((n2.weight, 0.05, 1.0), (n2.bias, 0.05, 0.0), (m.fc1.weight, f**-0.5, 0.0),
                                (m.fc1.bias, 0.05, 0.0), (m.fc2.weight, (4 * f) ** -0.5, 0.0), (m.fc2.bias, 0.05, 0.0),
                                (block.ls2, 0.05, 1.0)):
            p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * scale + shift)
    params = (n2.weight, n2.bias, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias, block.ls2)
    with torch.inference_mode():
        for b, n in MLP_CASES:
            x = torch.randn(b, n, f, device="cuda", dtype=torch.bfloat16, generator=gen)
            calls = {name: (lambda fm=fm: fm.fused_ln_mlp_residual(x, *params)) for name, fm in fms.items()}
            ops_ms = 4 * b * n * f * 4 * f / 989e12 * 1e3
            bytes_ms = (2 * b * n * f + 2 * 4 * f * f + 4 * f + 4 * f) * 2 / 3.35e12 * 1e3
            bound = f"bound {max(ops_ms, bytes_ms):.4f} ms ({'ops' if ops_ms >= bytes_ms else 'bytes'})"
            for how, measure in (("per call", event_ms), ("device time", device_ms)):
                times = {name: [] for name in calls}
                for name in order:
                    times[name].append(measure(calls[name]))
                readings = ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items())
                print(f"#8 fused_ln_mlp_residual bf16 (B={b}, N={n}, F={f}, H={4 * f}), random, {how}: {readings}; "
                      f"Block.mlp_residual {measure(lambda: block.mlp_residual(x)):.4f} ms; {bound} [{smi}]", flush=True)
            del x, calls
            torch.cuda.empty_cache()


INT8_CASES = ((7, 8), (7, 1), (6, 8), (6, 1))  # (entry, B) at N = 1297, 16 heads; #6 on (B H, N, 64)


def int8_parts(fi8, fa, entry: int, tensors) -> dict:
    """The calls one package makes for #``entry`` on ``tensors`` (the slab,
    or q, k, v): the whole entry, the prologue alone and the attention
    kernel alone, on scratch made once here."""
    scale = 64**-0.5
    if entry == 7:
        (qkv,) = tensors
        calls = {"entry": lambda: fi8.flash_attention_int8_qk_fused(qkv, 16)}
    else:
        q, k, v = tensors
        calls = {"entry": lambda: fi8.flash_attention_int8_qk(q, k, v)}
    if hasattr(fi8, "Int8Launch"):  # one C call runs the prologue, the attention or both
        launch = fi8.prepare_int8_qk_fused(qkv, 16) if entry == 7 else fi8.prepare_int8_qk(q, k, v)
        launch.run()
        calls["prologue"] = lambda: launch.run(fi8.STAGE_PROLOGUE)
        calls["kernel"] = lambda: launch.run(fi8.STAGE_ATTENTION)
        return calls
    # the torch-op prologue and a kernel launch on its output
    if entry == 7:
        b, n, _ = qkv.shape
        calls["prologue"] = lambda: fi8.quantize_fused(qkv, 16, scale)
        q_i8, k_i8, alpha, _ = calls["prologue"]()
        v_spec, shape = fa._qkv_operands(qkv, 64)[2], (b, n, 16, 64)
    else:
        calls["prologue"] = lambda: fi8.quantize_rows(q, k, scale)
        q_i8, k_i8, alpha = (t[:, :, None] for t in calls["prologue"]())
        v_spec, shape = fa._operand("v", v[:, :, None], v.device, v.dtype), (*q.shape[:2], 1, 64)
    calls["kernel"] = lambda: fi8._launch(shape, q_i8, k_i8, v_spec, alpha, tensors[-1].dtype, tensors[-1].device)
    return calls


def int8(args, smi):
    """#6 and #7 bf16 at ``INT8_CASES``: entry, prologue and kernel against
    the other checkout's (in turns), SDPA and #1, per call and as device
    time."""
    import importlib

    import torch
    import torch.nn.functional as F

    from muggled_dpt_tpu_torch.ops.kernels.flash_attention import flash_attention_fused_qkv
    from muggled_dpt_tpu_torch.ops.kernels.flash_attention_int8 import int8_bound
    from muggled_dpt_tpu_torch.tools.flash_tune import device_ms

    packages = {"this": "muggled_dpt_tpu_torch"}
    if args.against:
        load_package(args.against, "against_muggled_dpt_tpu_torch")
        packages = {"against": "against_muggled_dpt_tpu_torch", **packages}
    modules = {name: (importlib.import_module(pkg + ".ops.kernels.flash_attention_int8"),
                      importlib.import_module(pkg + ".ops.kernels.flash_attention")) for name, pkg in packages.items()}
    order = ["against", "this", "this", "against"] if args.against else ["this", "this"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, d = 1297, 16, 64
    with torch.inference_mode():
        for entry, b in INT8_CASES:
            if entry == 7:
                tensors = (torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).bfloat16(),)
                views = [t.transpose(1, 2) for t in tensors[0].view(b, n, h, 3, d).unbind(3)]
                yardsticks = {"SDPA": lambda: F.scaled_dot_product_attention(*views),
                              "#1": lambda: flash_attention_fused_qkv(tensors[0], h)}
                what = f"#7 flash_attention_int8_qk_fused bf16 (B={b}, N={n}, 3C={3 * h * d})"
            else:
                tensors = tuple(torch.randn(b * h, n, d, device="cuda", generator=gen).bfloat16() for _ in range(3))
                yardsticks = {"SDPA": lambda: F.scaled_dot_product_attention(*(t[None] for t in tensors))}
                what = f"#6 flash_attention_int8_qk bf16 (BH={b * h}, N={n}, D={d})"
            parts = {name: int8_parts(fi8, fa, entry, tensors) for name, (fi8, fa) in modules.items()}
            limit = int8_bound(b, n, h)
            floors = (f"bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}), prologue byte floor "
                      f"{limit['prologue_floor_ms']:.4f}, exp floor {limit['exp_floor_ms']:.4f}")
            for how, measure in (("per call", event_ms), ("device time", device_ms)):
                readings = []
                for part in ("entry", "prologue", "kernel"):
                    times = {name: [] for name in parts}
                    for name in order:
                        times[name].append(measure(parts[name][part]))
                    readings.append(f"{part} " + ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in ts)}"
                                                           for name, ts in times.items()))
                yard = ", ".join(f"{label} {measure(fn):.4f}" for label, fn in yardsticks.items())
                print(f"{what}, random, {how}, ms: {'; '.join(readings)}; {yard}; {floors} [{smi}]", flush=True)
            del tensors, parts, yardsticks
            torch.cuda.empty_cache()


def window(packages: dict, gen, smi: str, against):
    """#3 at ``WINDOW_CASES``, as ``attention`` times the flash kernel."""
    import importlib

    import torch
    import torch.nn.functional as F

    from muggled_dpt_tpu_torch.ops.kernels.window_attention import window_bound
    from muggled_dpt_tpu_torch.tools.window_sm90_variants import inputs, sdpa_inputs

    was = {name: importlib.import_module(pkg + ".ops.kernels.window_attention") for name, pkg in packages.items()}
    for label, b, nw, side, h, with_mask in WINDOW_CASES:
        a, d = side * side, 32
        q, k, v, cpb, mask = inputs(gen, b, nw, side, h, with_mask)
        calls = {name: (lambda wa=wa: wa.window_attention(q, k, v, cpb, mask)) for name, wa in was.items()}
        order = ["against", "this", "this", "against"] if against else ["this", "this"]
        times = {name: [] for name in calls}
        for name in order:
            times[name].append(event_ms(calls[name]))
        q4, k4, v4, bias = sdpa_inputs(q, k, v, cpb, mask)
        library = event_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias, scale=1.0))
        limit = window_bound(b, nw, a, h, with_mask)
        readings = ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items())
        print(f"{label} (nW={nw}, A={a}, H={h}, D={d}{', mask' if with_mask else ''}): {readings} (median of 30 after 5); "
              f"SDPA {library:.4f} ms; bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}); "
              f"exp floor {limit['exp_floor_ms']:.4f} ms [{smi}]", flush=True)
        del q, k, v, cpb, mask, q4, k4, v4, bias
        torch.cuda.empty_cache()


def kind_of(name: str) -> str:
    return next((kind for kind, keys in KINDS if any(key in name for key in keys)),
                "elementwise/reduce (residual, LayerScale, normalize, ...)")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


INT8_TIERS = {"dense": None, "default": {}, "qkv": {"include_qkv": True},
              "neck": {"include_qkv": True, "include_neck": True}}


def event_ms(fn, iters=30, warmup=5) -> float:
    """Median CUDA-event time of fn, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def int8_linear_breakdown(config, rows, smi):
    """CUDA-event times of one int8 linear's parts (ops/quant.py:linear_w8a8)
    at each encoder linear shape of ``config`` over ``rows`` tokens, bf16,
    beside the dense bf16 linear; then the sums over the blocks of the
    default tier (proj and the MLP) and of the qkv tier (qkv too)."""
    import torch
    import torch.nn.functional as F

    from muggled_dpt_tpu_torch.ops import quant

    f = config["features_per_token"]
    shapes = {"qkv": (f, 3 * f), "proj": (f, f), "fc1": (f, 4 * f), "fc2": (4 * f, f)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    per = {}
    for name, (k, n) in shapes.items():
        x = torch.randn(rows, k, device="cuda", dtype=torch.bfloat16, generator=gen)
        w = torch.randn(n, k, device="cuda", dtype=torch.bfloat16, generator=gen) * k**-0.5
        bias = torch.randn(n, device="cuda", dtype=torch.bfloat16, generator=gen)
        q8, w_scale = quant.quantize_weight(w)
        xq, x_scale = quant.quantize_per_token(x)
        acc = quant.int8_matmul(xq, q8)
        parts = {
            "bf16 linear": event_ms(lambda: F.linear(x, w, bias)),
            "quantize": event_ms(lambda: quant.quantize_per_token(x)),
            "int8 GEMM": event_ms(lambda: quant.int8_matmul(xq, q8)),
            "dequantize": event_ms(lambda: (acc.float() * x_scale * w_scale + bias.float()).to(torch.bfloat16)),
            "whole int8 linear": event_ms(lambda: quant.linear_w8a8(x, q8, w_scale, bias)),
        }
        per[name] = parts
        print(f"int8 linear {name} ({rows} x {k} -> {n}): " + ", ".join(f"{p} {ms:.4f} ms" for p, ms in parts.items())
              + f" [{smi}]", flush=True)
        del x, w, q8, xq, acc
    blocks = config["num_blocks"]
    for tier, names in (("default", ("proj", "fc1", "fc2")), ("qkv", tuple(shapes))):
        sums = {p: blocks * sum(per[n][p] for n in names) for p in per["qkv"]}
        print(f"int8 linears of the {tier} tier over {blocks} blocks: " + ", ".join(f"{p} {ms:.3f} ms" for p, ms in sums.items())
              + f" [{smi}]", flush=True)
    torch.cuda.empty_cache()


def profile_forward(fn, forwards, label, smi, out_lines):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(forwards):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    by_kind, by_name = {}, {}
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) / 1e3 / forwards
        by_kind[kind_of(e.name)] = by_kind.get(kind_of(e.name), 0.0) + dur
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    device_ms = sum(by_kind.values())
    print(f"{label}: {wall_ms / forwards:.3f} ms per forward under the profiler, device busy {100 * busy / wall_ms:.1f} % "
          f"(idle {100 - 100 * busy / wall_ms:.1f} %), {len(kernels) / forwards:.0f} kernels per forward, "
          f"device time {device_ms:.3f} ms per forward [{smi}]", flush=True)
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"{label}:   {kind}: {ms:.3f} ms ({100 * ms / device_ms:.1f} %)", flush=True)
    out_lines += [f"{label}\t{ms:.4f} ms\t{kind_of(name)}\t{name}" for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])]


def build_ms(model, grid, what, smi, repeats=3):
    """Host-clock ms of make_aux for a grid, first build then repeats, each synchronized."""
    import torch

    from muggled_dpt_tpu_torch.dpt import _tensor_bytes

    make_aux = model.spec["make_aux"]
    times = []
    for _ in range(1 + repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            aux = make_aux(model.net, grid, model.dtype)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        gb = _tensor_bytes(aux) / 1e9
        del aux
    print(f"{what} build, grid {grid} ({gb:.3f} GB bf16): first {times[0]:.2f} ms, "
          f"then {', '.join(f'{t:.2f}' for t in times[1:])} ms [{smi}]", flush=True)
    torch.cuda.empty_cache()


PROFILED = {  # model: (label, checkpoints module.generator, config, checkpoint name, side, aux label, aux grids)
    "beit": ("BEiT-L-512", "beit.random_original_state_dict", BEIT_L512, "dpt_beit_large_512_random.pt", 512,
             "BEiT-L-512 bias stack", ((32, 32), (64, 64))),
    "swinv2": ("SwinV2-L-384", "swinv2.random_original_state_dict", SWIN_L384, "dpt_swin2_large_384_random.pt", 384,
               "SwinV2-L-384 CPB stacks and shift masks", ((96, 96), (128, 128))),
    "vitl": ("DA-V2 ViT-L", "random_init.random_original_depth_anything_state_dict", VITL,
             "depth_anything_v2_vitl_random.pth", 518, None, ()),
    "giant": ("DA-V2 ViT-Giant", "random_init.random_original_depth_anything_state_dict", VITG,
              "depth_anything_v2_vitg_random.pth", 518, None, ()),
}


DTYPES = {"bf16": "bfloat16", "f16": "float16"}  # profile's --dtype: torch attribute names (torch is imported late)


def profile(args, smi):
    import importlib

    import numpy as np
    import torch

    from muggled_dpt_tpu_torch.make_dpt import make_dpt_from_state_dict

    label, generator, config, name, side, aux_label, grids = PROFILED[args.model]
    if args.int8 and grids:
        raise SystemExit("--int8 profiles a model without a per-grid aux: --model vitl or giant")
    module, function = generator.split(".")
    random_state_dict = getattr(importlib.import_module(f"muggled_dpt_tpu_torch.checkpoints.{module}"), function)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_checkpoint(random_state_dict(config, seed=0), os.path.join(tmp, name))
        _, model = make_dpt_from_state_dict(ckpt, dtype=getattr(torch, DTYPES[args.dtype]), device="cuda")
    for grid in grids:
        build_ms(model, grid, aux_label, smi)
    frames = np.random.default_rng(1).integers(0, 256, (8, *FRAME_HW, 3), dtype=np.uint8)
    batch = torch.from_numpy(frames).cuda()
    hw = model.compute_scaled_hw(FRAME_HW, side)
    lines = []
    size = f"{hw[0]}x{hw[1]}"
    if args.int8:
        tokens = 1 + (hw[0] // config["patch_size_px"]) * (hw[1] // config["patch_size_px"])
        int8_linear_breakdown(config, 8 * tokens, smi)
    tiers = {tier: INT8_TIERS[tier] for tier in args.int8} if args.int8 else {"": None}
    for tier, opts in tiers.items():
        served = model if opts is None else model.quantize_encoder_int8(**opts)
        what = f"{label}{' int8 ' + tier if opts is not None else ''} {args.dtype} {size}"
        for b, forwards, fn in ((1, 10, lambda: served.inference(frames[0], side)),
                                (8, 5, lambda: served.inference_rgb_device(batch, hw))):
            profile_forward(fn, forwards, f"{what} B={b}", smi, lines)
        del served
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = f"profile_{args.model}{'_int8' if args.int8 else ''}{'_f16' if args.dtype == 'f16' else ''}_kernels.txt"
        with open(os.path.join(args.out, name), "w") as f:
            f.write(f"# ms per forward per kernel [{smi}]\n" + "\n".join(lines) + "\n")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", choices=["host", "attention", "head", "mlp", "int8", "profile"])
    parser.add_argument("--against", default=None, help="another checkout whose package host, attention, head, mlp or int8 also "
                        "measures, interleaved")
    parser.add_argument("--model", choices=sorted(PROFILED), default=None, help="the model profile measures (default beit; "
                        "vitl with --int8)")
    parser.add_argument("--int8", nargs="+", choices=list(INT8_TIERS), default=None,
                        help="profile these int8 tiers of the model (dense: the bf16 model) instead of the bf16 model")
    parser.add_argument("--dtype", choices=["bf16", "f16"], default="bf16", help="the model's dtype for profile (f16: the "
                        "apps' -u)")
    parser.add_argument("--out", default=None, help="directory for the per-kernel profile table")
    args = parser.parse_args()
    args.model = args.model or ("vitl" if args.int8 else "beit")
    sys.path.insert(0, REPO_ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a GPU", file=sys.stderr)
        return 1
    smi = card_line()
    {"host": host, "attention": attention, "head": head, "mlp": mlp, "int8": int8, "profile": profile}[args.what](args, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
