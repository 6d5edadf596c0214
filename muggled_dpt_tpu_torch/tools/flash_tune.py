"""The attention sweep on the card: flash attention #1, SDPA and the
measurement variants #10 (XL), #11 (staged) and #12 (the variant shootout)
on Depth-Anything V2 ViT-L's own qkv slabs across the long-N serving ladder.

    python3 muggled_dpt_tpu_torch/tools/flash_tune.py [N ...]

The port of ``tools/flash_tune.py --xl`` and ``--staged`` and of
``tools/attn_variants.py:main``. DA-V2 ViT-L is built at full width
(random weights from a seed, written as an original checkpoint) and serves
one bf16 request from a 720x1280 frame at each ladder size; block 11's
(1, N, 3072) head-major qkv slab is taken on the way (``capture_slab``). For each
N (default: the ladder; an N off the ladder gets a random slab from the
seed) it prints one table of CUDA-event times: #1 (the anchor), SDPA on the
same views, every #10 case of ``tools/flash_tune.py:76-86``, every #11
panel count of ``:192``, every #12 mode of
``tools/attn_variants.py:192-222`` on the slab's heads, then the plain
versions of #1, #11 and #12. ``flash_tune.py 1297`` gives the JAX tool's
(16, 1297, 64) rows on a random slab. ``hpp`` and ``block_q`` are TPU tactics
with no counterpart in the port, so the JAX cases that differ only in them
are one case here. Times: median per launch after warm-up, the kernels in two turns
(forward, then backward) and the faster of the two kept; 30 launches after
5 up to N=10405, 5 after 1 past it and for every plain version.

In bf16 #10, #11 and #12 run their wgmma/TMA kernels on #1's Hopper
pipeline (``csrc/flash_xl_sm90.cu``: qp consumer warpgroups per CTA,
pipelined = the next tile's QK^T in flight under this tile's softmax;
``csrc/flash_staged_sm90.cu``: pass 1 the row max, pass 2 exp2 and PV with
no rescale; ``csrc/flash_variant_sm90.cu``: each mode's own arithmetic), so
the sweep's questions (two passes against the online softmax, more q blocks
per CTA, QK^T under the softmax, the shoot-out's modes and ablations) are
asked of the serving kernel's machinery. At the JAX tool's (16, 1297, 64)
a #12 call costs the host more than the card (``host_us``), so its
per-launch times there carry the wrapper's cost; ``device_ms`` times the
card alone.

``chip_smoke.py`` drives the same cases, timing and capture through this
module. Runs only on a CUDA card."""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

if __name__ == "__main__":  # run as a script: the package of this checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from muggled_dpt_tpu_torch.ops.kernels.flash_attention_staged import (  # noqa: E402
    flash_attention_fused_qkv_staged,
    flash_attention_fused_qkv_staged_reference,
)
from muggled_dpt_tpu_torch.ops.kernels.flash_attention_xl import flash_attention_fused_qkv_xl  # noqa: E402
from muggled_dpt_tpu_torch.ops.nn import layer_norm  # noqa: E402
from muggled_dpt_tpu_torch.ops.quant import linear_p  # noqa: E402
from muggled_dpt_tpu_torch.tools.attn_variants import flash_variant, flash_variant_reference  # noqa: E402

LADDER = {756: 2917, 1036: 5477, 1428: 10405, 1904: 18497}  # DA-V2 ViT-L max side -> tokens N (square, 14 px patches)
VITL = {
    "features_per_token": 1024,
    "num_blocks": 24,
    "reassembly_features_list": [256, 512, 1024, 1024],
    "fusion_channels": 256,
    "patch_size_px": 14,
    "base_patch_grid_hw": (37, 37),
}
HEADS, HEAD_DIM = 16, 64
SLAB_BLOCK = 11
FRAME_HW = (720, 1280)
LONG_N = 10405  # past it, 5 timed launches after 1
SEED = 0

XL_CASES = (  # tools/flash_tune.py:76-86
    ("xl qp=1 seq (anchor-equiv)", {"qp": 1, "pipelined": False}),
    ("xl qp=1 pipelined", {"qp": 1, "pipelined": True}),
    ("xl qp=2 pipelined", {"qp": 2, "pipelined": True}),
    ("xl qp=2 seq", {"qp": 2, "pipelined": False}),
    ("xl qp=4 pipelined", {"qp": 4, "pipelined": True}),
    ("xl ABLATION no-softmax", {"ablate_softmax": True}),
    ("xl ABLATION no-sm qp=2 pl", {"qp": 2, "pipelined": True, "ablate_softmax": True}),
)
STAGED_CASES = (1, 2, 4, 8)  # the panel counts of :192
VARIANT_CASES = (  # tools/attn_variants.py:192-222, one per distinct launch
    ("v1 mask+exp", {"mode": "mask_exp"}),
    ("v2 mask+exp2", {"mode": "mask_exp2"}),
    ("v3 padfix", {"mode": "padfix"}),
    ("v5 inner-loop chunk=704", {"chunk": 704}),
    ("v5 inner-loop chunk=352", {"chunk": 352}),
    ("abl: 2 matmuls + cast only", {"mode": "nosm"}),
    ("abl: + max-reduce/sub", {"mode": "maxonly"}),
    ("abl: + exp2 (no reductions)", {"mode": "exponly"}),
)
ANCHOR, SDPA = "#1 anchor (fused-qkv)", "SDPA"
XL_DEFAULT, STAGED_DEFAULT = "xl qp=1 pipelined", "staged panels=2"  # the JAX defaults


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def qkv_views(slab):
    """q, k and v of a head-major (B, N, 3C) slab as (B, N, H, D) strided views."""
    x = slab.unflatten(2, (HEADS, 3, HEAD_DIM))
    return x[..., 0, :], x[..., 1, :], x[..., 2, :]


def variant_inputs(slab) -> dict:
    """#12's operands from a slab: (B H, N, D) copies of its heads, q
    pre-scaled by D^-0.5 (``q_s``, for mask_exp) and by D^-0.5 log2(e)
    (``q_s2``, for the exp2 modes), as the JAX tool's main scales them."""
    q, k, v = (t.transpose(1, 2).reshape(-1, t.shape[1], HEAD_DIM).contiguous() for t in qkv_views(slab))
    scale = HEAD_DIM**-0.5
    return {"q_s": (q.float() * scale).to(q.dtype), "q_s2": (q.float() * (scale * fa.LOG2E)).to(q.dtype), "k": k, "v": v}


def variant_q(inputs: dict, kw: dict):
    return inputs["q_s"] if kw.get("mode") == "mask_exp" else inputs["q_s2"]


def kernel_calls(slab, inputs=None) -> list:
    """(label, call) for every case of the sweep on a slab, in table order:
    #1, SDPA, #10, #11, #12."""
    inputs = variant_inputs(slab) if inputs is None else inputs
    sdpa = [t.transpose(1, 2) for t in qkv_views(slab)]
    calls = [(ANCHOR, lambda: fa.flash_attention_fused_qkv(slab, HEADS)),
             (SDPA, lambda: F.scaled_dot_product_attention(*sdpa))]
    calls += [(label, lambda kw=kw: flash_attention_fused_qkv_xl(slab, HEADS, **kw)) for label, kw in XL_CASES]
    calls += [(f"staged panels={n}", lambda n=n: flash_attention_fused_qkv_staged(slab, HEADS, panels=n))
              for n in STAGED_CASES]
    k, v = inputs["k"], inputs["v"]
    calls += [(label, lambda kw=kw: flash_variant(variant_q(inputs, kw), k, v, **kw)) for label, kw in VARIANT_CASES]
    return calls


def plain_calls(slab, inputs=None) -> list:
    """(label, call) of the plain versions the sweep times: #1's (also
    #10's), #11's at the default 2 panels, #12's padfix."""
    inputs = variant_inputs(slab) if inputs is None else inputs
    return [("#1 / #10 plain version", lambda: fa.flash_attention_fused_qkv_reference(slab, HEADS)),
            ("#11 plain version (panels=2)", lambda: flash_attention_fused_qkv_staged_reference(slab, HEADS, panels=2)),
            ("#12 plain version (padfix)", lambda: flash_variant_reference(inputs["q_s2"], inputs["k"], inputs["v"], "padfix"))]


def time_ms(fn, iters=30, warmup=5) -> float:
    """Median of per-launch CUDA-event times, after warm-up."""
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


def device_ms(fn, iters=20, warmup=3) -> float:
    """Device time per launch: ``iters`` launches queued behind a spin of
    the card (``torch.cuda._sleep``), so that they run back to back whatever
    the host's cost per call; CUDA events around them, divided by ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # about 50 ms at the H100's clock: the host queues every launch before it ends
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls=200, warmup=3) -> float:
    """Host microseconds per call: ``calls`` calls back to back, queued
    behind a spin of the card so that none waits for it; the host clock
    around them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def timing_plan(n: int) -> tuple[int, int]:
    """(timed launches, warm-up launches) of a kernel at N tokens."""
    return (30, 5) if n <= LONG_N else (5, 1)


def time_calls(calls, n: int) -> dict:
    """CUDA-event times of each call, in two turns (forward, then backward),
    the faster median kept: {label: ms}."""
    iters, warmup = timing_plan(n)
    first = {label: time_ms(fn, iters, warmup) for label, fn in calls}
    second = {label: time_ms(fn, iters, warmup) for label, fn in reversed(calls)}
    return {label: min(first[label], second[label]) for label in first}


def sweep(slab, smi: str, with_plain: bool = True) -> dict:
    """Time every case on one slab and print the table; returns {label: ms}
    (the plain versions' labels included with ``with_plain``)."""
    n = slab.shape[1]
    inputs = variant_inputs(slab)
    times = time_calls(kernel_calls(slab, inputs), n)
    if with_plain:
        times.update({label: time_ms(fn, 5, 1) for label, fn in plain_calls(slab, inputs)})
    iters, warmup = timing_plan(n)
    print(f"N={n} (B={slab.shape[0]}, H={HEADS}, D={HEAD_DIM}, {str(slab.dtype)[6:]}; kernels: median of {iters} "
          f"launches after {warmup}, in two turns; plain versions: 5 after 1) [{smi}]", flush=True)
    anchor = times[ANCHOR]
    for label, ms in times.items():
        print(f"  {label:34s} {ms:10.4f} ms  {ms / anchor:6.2f}x #1", flush=True)
    return times


def run_once(slab) -> None:
    """Every kernel case of the sweep once on a slab (the path whose
    launches a caller counts)."""
    for _, fn in kernel_calls(slab):
        fn()
    torch.cuda.synchronize()


def capture_slab(model, frame, side: int):
    """Serve one request of ``frame`` at max side ``side``; return the
    (B, N, 3C) qkv slab of block ``SLAB_BLOCK`` and the depth.
    A forward pre-hook takes the block's input tokens, and the block's own
    norm1 and qkv layer give the slab, the ops ``Block.attention_residual``
    runs (the dense qkv layer is applied as ``F.linear`` inside the block,
    so a hook on the layer itself would not fire)."""
    blk = model.net.encoder.blocks[SLAB_BLOCK]
    got = {}
    hook = blk.register_forward_pre_hook(lambda m, args: got.setdefault("tokens", args[0]))
    try:
        depth = model.inference(frame, side)
    finally:
        hook.remove()
    with torch.inference_mode():
        slab = linear_p(layer_norm(got["tokens"], blk.norm1.weight, blk.norm1.bias), blk.attn.qkv)
    torch.cuda.synchronize()
    return slab, depth


def build_model():
    """DA-V2 ViT-L in bf16 at full width, random weights from the seed,
    written as an original checkpoint and loaded through ``make_dpt_from_state_dict``."""
    from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
    from muggled_dpt_tpu_torch.make_dpt import make_dpt_from_state_dict

    sd = random_original_depth_anything_state_dict(VITL, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "depth_anything_v2_vitl_random.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        return make_dpt_from_state_dict(path, dtype=torch.bfloat16, device="cuda")[1]


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("flash_tune.py runs on a CUDA card")
    ns = [int(a) for a in args] or list(LADDER.values())
    smi = card_line()
    print(smi, flush=True)
    sides = {n: side for side, n in LADDER.items()}
    model = build_model() if any(n in sides for n in ns) else None
    rng = np.random.default_rng(SEED)
    frame = rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    for n in ns:
        if n in sides:
            slab, _ = capture_slab(model, frame, sides[n])
            what = f"DA-V2 ViT-L block {SLAB_BLOCK} qkv slab at {sides[n]}x{sides[n]}"
        else:
            slab = torch.from_numpy(rng.standard_normal((1, n, 3 * HEADS * HEAD_DIM), dtype=np.float32)).to("cuda", torch.bfloat16)
            what = "random slab from the seed"
        print(f"\n{what}: {tuple(slab.shape)}", flush=True)
        sweep(slab, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
