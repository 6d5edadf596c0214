"""The int8 serving tiers on trained (not random) weights: the counterpart
of the JAX package's ``tools/int8_trained_weights.py``.

Every int8 error of a random-weight model is dominated by random logits and
necks amplifying rounding. This tool overfits a mid-size DA-V2 (F=256, 12
blocks, 4 heads, base grid 37) on the synthetic scene of
``tools/finetune_demo.py`` with the SSI objective (``parallel/train.py``),
then quantizes that model with each tier (default, include_qkv, calibrated
include_qkv, include_neck) and prints each tier's depth abs-rel against the
same model's own bfloat16 forward on held-out frames, with bfloat16 against
float32 for context, and last one JSON line of the numbers.

    python -m muggled_dpt_tpu_torch.tools.int8_trained_weights [--steps 240] [-d cpu]

Runs on the CUDA card unless ``-d cpu`` is given."""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def parse_args(argv=None):
    from ..demo_helpers.misc import DEVICE_HELP

    ap = argparse.ArgumentParser(description="int8 tiers on trained weights")
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--train_size", type=int, default=112, help="square training input (multiple of 28)")
    ap.add_argument("--eval_size", type=int, default=224, help="held-out eval input")
    ap.add_argument("--batch", type=int, default=1, help="training batch")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-d", "--device", default=None, help=DEVICE_HELP)
    return ap.parse_args(argv)


def absrel(preds, refs) -> float:
    """Mean over frames of mean |p - r| / mean |r|."""
    return float(np.mean([np.abs(p - r).mean() / (np.abs(r).mean() + 1e-12) for p, r in zip(preds, refs)]))


def main(argv=None) -> dict:
    """Returns the JSON line's numbers."""
    from ..dpt import resolve_device
    from ..demo_helpers.misc import depth_to_numpy
    from ..make_depthanythingv2_dpt import make_depthanythingv2_dpt
    from ..parallel.train import adamw, make_train_step
    from .finetune_demo import synthetic_scene

    args = parse_args(argv)
    device = resolve_device(args.device)
    model = make_depthanythingv2_dpt(256, 4, 12, (32, 64, 128, 256), (37, 37), 64, dtype=torch.float32, device=device,
                                     seed=args.seed)
    hw = (args.train_size, args.train_size)
    images, targets = synthetic_scene(np.random.default_rng(args.seed), args.batch, hw)
    print(f"batch={args.batch}  train_input={hw}  on {device}")

    step = make_train_step(model, adamw(model.net.parameters(), args.lr))
    images, targets = torch.from_numpy(images), torch.from_numpy(targets)
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = float(step(images, targets))
        if i == 0:
            first = loss
        if i % max(1, args.steps // 8) == 0 or i == args.steps - 1:
            print(f"step {i:3d}  ssi_loss {loss:.5f}")
    drop = first / max(loss, 1e-12)
    print(f"trained {args.steps} steps in {time.perf_counter() - t0:.1f}s: loss {first:.5f} -> {loss:.5f} ({drop:.1f}x)")
    if drop < 10.0:
        print("WARNING: <10x loss drop — weights may not be 'trained enough' for this measurement")

    m32 = model
    m16 = m32.to(torch.bfloat16)
    # held-out frames (another seed than training): uint8 BGR like a real
    # caller, through the whole inference() preprocessing path
    ev_images, _ = synthetic_scene(np.random.default_rng(args.seed + 1), 3, (args.eval_size, args.eval_size))
    frames = [(np.clip(im, 0, 1) * 255).astype(np.uint8)[:, :, ::-1] for im in ev_images]

    def depth(m, frame):
        return depth_to_numpy(m.inference(frame, max_side_length=args.eval_size))

    d16 = [depth(m16, f) for f in frames]
    d32 = [depth(m32, f) for f in frames]
    variants = {
        "int8 default": lambda: m16.quantize_encoder_int8(),
        "int8 include_qkv": lambda: m16.quantize_encoder_int8(include_qkv=True),
        "int8 calibrated include_qkv": lambda: m16.quantize_encoder_int8(
            include_qkv=True, calibration_images=frames[:2], max_side_length=args.eval_size),
        "int8 include_neck": lambda: m16.quantize_encoder_int8(include_neck=True),
    }
    tiers = {"bf16 vs f32 (context)": absrel(d16, d32)}
    for name, make in variants.items():
        quantized = make()
        tiers[name] = absrel([depth(quantized, f) for f in frames], d16)
        del quantized

    print(f"\nDepth abs-rel vs the model's own bf16, {len(frames)} held-out frames @ {args.eval_size}²:")
    for name, v in tiers.items():
        print(f"  {name:34s} {v:.3e}")
    result = {"metric": "trained_weights_int8_absrel_vs_bf16", "loss_drop": drop, "tiers": tiers}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
