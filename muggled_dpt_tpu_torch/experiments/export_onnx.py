"""Export a DPT model to a runnable .onnx artifact, the counterpart of the
JAX package's ``experiments/export_onnx.py``: the graph is emitted directly
from the port's modules (``onnx_export/``), with no onnx package and no torch
exporter, and its parity is checked by running it with the numpy evaluator
against the live float32 model.

    python -m muggled_dpt_tpu_torch.experiments.export_onnx -m CKPT [-b SIDE] [-o DIR] [--dynamic] [--skip_check] [--timing_iters N] [-d cpu]

By default the artifact is shape-specialized: export one file per input size
you serve. Input is the normalized (1, 3, H, W) float32 tensor; output is
depth (1, H', W'). With --dynamic (Depth-Anything and BEiT) the export
declares dynamic batch/height/width axes: one artifact serves any
tiling-aligned size; for BEiT the relpos LUT resize and relative-index
gather move in-graph. SwinV2 stays fixed-shape, because its window plan,
shift masks and CPB tables depend on the grid. The live model the parity
check runs is the float32 kernel model on ``-d`` (TF32 off, as the facade's
float32 mode)."""

from __future__ import annotations

import argparse
import os.path as osp
import time

import numpy as np
import torch

from ..demo_helpers.saving import get_save_folder
from ..onnx_export import emitter_for, evaluate_model
from .common import load_model

PARITY_BUDGET = 1e-3  # mean abs-rel of the evaluator's depth against the live float32 model


def main(argv=None) -> dict:
    """Emit, write, check and (optionally) time the evaluator; returns the
    artifact's path and bytes, the evaluator's abs-rel against the live
    float32 model (None with --skip_check) and its seconds."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-m", "--model_path", default=None, help="Original checkpoint (default: a tiny random DA-V2)")
    parser.add_argument("-b", "--base_size_px", default=None, type=int, help="Max side the input is sized to")
    parser.add_argument("-o", "--output_folder", default=None)
    parser.add_argument("--skip_check", action="store_true", help="skip the numpy-evaluator parity check")
    parser.add_argument("--dynamic", action="store_true",
                        help="export with dynamic batch/height/width axes (Depth-Anything and BEiT)")
    parser.add_argument("--timing_iters", default=0, type=int, help="time the numpy evaluator (oracle, not a runtime)")
    parser.add_argument("-d", "--device", default=None,
                        help="Device of the live model (default: the CUDA card, which must exist; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    model = load_model(args)
    name = osp.splitext(osp.basename(args.model_path))[0] if args.model_path else "tiny_dav2"
    emit, supports_dynamic = emitter_for(model)

    side = args.base_size_px or model.default_size_px
    h, w = model.compute_scaled_hw((side, side), side, True)
    if args.dynamic:
        if not supports_dynamic:
            raise SystemExit("--dynamic is not supported for SwinV2 (its window plan, shift masks and CPB tables "
                             "depend on the grid)")
        print(f"Emitting ONNX with dynamic batch/height/width axes (opset 17); parity-checked at {h}x{w}")
        onnx_bytes = emit(model, dynamic=True)
    else:
        print(f"Emitting ONNX at fixed input size {h}x{w} (opset 17)")
        onnx_bytes = emit(model, (h, w))

    out_dir = get_save_folder(args.output_folder or osp.join("saved_results", "exports"))
    out_path = osp.join(out_dir, f"{name}_dynamic.onnx" if args.dynamic else f"{name}_{h}x{w}.onnx")
    with open(out_path, "wb") as f:
        f.write(onnx_bytes)
    print(f"Wrote {out_path} ({len(onnx_bytes) / 1e6:.1f} MB)")

    result = {"path": out_path, "bytes": len(onnx_bytes), "abs_rel": None, "evaluator_s": None}
    if not args.skip_check:
        x = np.random.default_rng(0).standard_normal((1, 3, h, w)).astype(np.float32) * 0.5
        want = model.forward(torch.from_numpy(x)).float().cpu().numpy()
        t0 = time.perf_counter()
        (got,) = evaluate_model(onnx_bytes, {"image": x}).values()
        result["evaluator_s"] = time.perf_counter() - t0
        err = float(np.abs(got - want).mean() / (np.abs(want).mean() + 1e-12))
        result["abs_rel"] = err
        print(f"ONNX parity (numpy evaluator, {result['evaluator_s']:.1f} s) abs-rel vs live f32 model: {err:.2e}")
        if not err < PARITY_BUDGET:
            raise RuntimeError(f"the exported graph does not match the live model: abs-rel {err:.3e}")

    for i in range(args.timing_iters):
        x = np.random.default_rng(i).standard_normal((1, 3, h, w)).astype(np.float32)
        t0 = time.perf_counter()
        evaluate_model(onnx_bytes, {"image": x})
        print(f"evaluator iter {i}: {1e3 * (time.perf_counter() - t0):.1f} ms")
    return result


if __name__ == "__main__":
    main()
