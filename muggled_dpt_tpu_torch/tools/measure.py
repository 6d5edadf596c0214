#!/usr/bin/env python3
"""Host-cost and profile measurements of the port on one CUDA card.

    python3 muggled_dpt_tpu_torch/tools/measure.py host [--against DIR]
    python3 muggled_dpt_tpu_torch/tools/measure.py profile [--model beit|swinv2|vitl|giant] [--out DIR]

``host``: the attention wrapper's host cost per call, and the DA-V2 ViT-L
and BEiT-L-512 bf16 request times at B=1.
Per-call cost: each route is called 200 times back to back at a shape
whose device time (a few us) is far below the host's, and the host clock
stops at the last call's return, so it reads the host work of a launch
alone. ``--against DIR`` also loads DIR's ``muggled_dpt_tpu_torch`` (an
earlier commit unpacked with ``git archive``, say) under another module name
into the same process, and alternates the two packages round by round, so
both see the same host noise; each line then says in how many rounds this
checkout was faster.

``profile``: a torch.profiler breakdown of a bf16 forward (10 forwards at
B=1, 5 at B=8): device busy share (the union of kernel intervals over the
host wall time of the profiled loop), kernels per forward, device time per
forward by kind; and the time to build the grid's aux once (``make_aux``).
``--model beit`` (the default): BEiT-L-512 at 512x512, the bias stack at
512x512 and 1024x1024. ``--model swinv2``: SwinV2-L-384 at 384x384, the CPB
stacks and shift masks at 384x384 and 512x512. ``--model vitl`` and
``--model giant``: Depth-Anything V2 ViT-L and ViT-Giant at 504x504 (no
per-grid aux). ``--out`` also writes every kernel's time per forward to
``DIR/profile_<model>_kernels.txt``.

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
    ("attention kernel", ("fa_bf16", "fa_f32")),
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
    qkv = torch.randn(1, n, 3 * heads * d, device="cuda", dtype=torch.bfloat16)
    routes = {"fused, unbiased": lambda: fa.flash_attention_fused_qkv(qkv, heads)}
    if "bias_stack" in inspect.signature(fa.flash_attention_fused_qkv).parameters:
        stack = torch.zeros(24, heads, 72, 72, device="cuda", dtype=torch.bfloat16)
        q, k, v = qkv.unflatten(2, (heads, 3, d)).unbind(3)
        routes["fused, stack layer 23"] = lambda: fa.flash_attention_fused_qkv(qkv, heads, bias_stack=stack, layer=23)
        routes["(B, N, H, D) views, (1, H, Np, Np) bias"] = lambda: fa.flash_attention(q, k, v, bias=stack[23][None])
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
    profile_forward(lambda: model.inference(frames[0], side), 10, f"{label} bf16 {size} B=1", smi, lines)
    profile_forward(lambda: model.inference_rgb_device(batch, hw), 5, f"{label} bf16 {size} B=8", smi, lines)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"profile_{args.model}_kernels.txt"), "w") as f:
            f.write(f"# ms per forward per kernel [{smi}]\n" + "\n".join(lines) + "\n")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", choices=["host", "profile"])
    parser.add_argument("--against", default=None, help="another checkout whose package host also measures, interleaved")
    parser.add_argument("--model", choices=sorted(PROFILED), default="beit", help="the model profile measures")
    parser.add_argument("--out", default=None, help="directory for the per-kernel profile table")
    args = parser.parse_args()
    sys.path.insert(0, REPO_ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a GPU", file=sys.stderr)
        return 1
    smi = card_line()
    (host if args.what == "host" else profile)(args, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
