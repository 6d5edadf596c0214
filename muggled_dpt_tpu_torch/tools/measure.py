#!/usr/bin/env python3
"""Host-cost and profile measurements of the port on one CUDA card.

    python3 muggled_dpt_tpu_torch/tools/measure.py host [--against DIR]
    python3 muggled_dpt_tpu_torch/tools/measure.py attention [--against DIR]
    python3 muggled_dpt_tpu_torch/tools/measure.py profile [--model beit|swinv2|vitl|giant] [--out DIR]
    python3 muggled_dpt_tpu_torch/tools/measure.py profile --int8 [dense] [default] [qkv] [neck] [--out DIR]

``host``: the attention and window attention wrappers' host cost per call,
the DA-V2 ViT-L, BEiT-L-512 and SwinV2-L-384 bf16 request times at B=1, and
BEiT-L-512's and SwinV2-L-384's ms per frame at B=8 (24 attention or window
launches per forward; the sm_90 window kernel encodes six tensor maps per
launch).
Per-call cost: each route is called 200 times back to back at a shape
whose device time (a few us) is far below the host's, and the host clock
stops at the last call's return, so it reads the host work of a launch
alone. ``--against DIR`` also loads DIR's ``muggled_dpt_tpu_torch`` (an
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
turns (DIR, this, this, DIR). Then the SwinV2 window kernel (#3; bf16:
csrc/window_attention_sm90.cu) at SwinV2-L-384's four stage shapes at B=8
and stage 1 at B=1, on the inputs of ``tools/window_sm90_variants.py``, the
same way, beside one SDPA call on the summed bias, the bound (4 B
nW H A^2 D operations, or q, k, v, out, CPB and mask read once) and the exp
floor (B nW H A^2 exp2 over the SFU's 16 per clock per SM, 132 SMs at
1.83 GHz).

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
    ("attention kernel", ("fa_sm90_bf16", "fa_bf16", "fa_f32")),
    ("window attention kernel", ("wa_bf16", "wa_f32")),
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


def per_call_us(fn, calls=200) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


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
    window(packages, gen, smi, args.against)


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
        _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device="cuda")
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
        what = f"{label}{' int8 ' + tier if opts is not None else ''} bf16 {size}"
        for b, forwards, fn in ((1, 10, lambda: served.inference(frames[0], side)),
                                (8, 5, lambda: served.inference_rgb_device(batch, hw))):
            profile_forward(fn, forwards, f"{what} B={b}", smi, lines)
        del served
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"profile_{args.model}{'_int8' if args.int8 else ''}_kernels.txt"), "w") as f:
            f.write(f"# ms per forward per kernel [{smi}]\n" + "\n".join(lines) + "\n")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", choices=["host", "attention", "profile"])
    parser.add_argument("--against", default=None, help="another checkout whose package host or attention also measures, "
                        "interleaved")
    parser.add_argument("--model", choices=sorted(PROFILED), default=None, help="the model profile measures (default beit; "
                        "vitl with --int8)")
    parser.add_argument("--int8", nargs="+", choices=list(INT8_TIERS), default=None,
                        help="profile these int8 tiers of the model (dense: the bf16 model) instead of the bf16 model")
    parser.add_argument("--out", default=None, help="directory for the per-kernel profile table")
    args = parser.parse_args()
    args.model = args.model or ("vitl" if args.int8 else "beit")
    sys.path.insert(0, REPO_ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a GPU", file=sys.stderr)
        return 1
    smi = card_line()
    {"host": host, "attention": attention, "profile": profile}[args.what](args, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
