"""Model export, the counterpart of the JAX package's
``experiments/export_model.py`` (jax.export to StableHLO): ``torch.export``
of the forward at one fixed input size, serialized with
``torch.export.save``, reloaded with ``torch.export.load``, held against the
live model and timed.

    python -m muggled_dpt_tpu_torch.experiments.export_model -m CKPT [-b SIDE] [-o DIR] [--timing_iters N] [-d cpu]

The exported program holds the serving kernels as operator nodes,
``mdpt::flash_attention_fused_qkv`` (TPU kernels #1 and #2) and
``mdpt::window_attention`` (#3), one per attention block
(``ops/kernels/library.py``): on the card each node launches the hand-written
kernel when the program runs. Loading the artifact elsewhere needs those ops
registered first: ``import muggled_dpt_tpu_torch.ops.kernels.library``, then
``torch.export.load(path).module()(image)``.

The program is shape-specialized, as the JAX export is: one artifact per
input size. Its input is the normalized (1, 3, h, w) image in the model's
dtype, its output the (1, h', w') depth, and it runs under ``no_grad``.
The per-grid aux (BEiT's bias stack; SwinV2's CPB stacks and shift masks)
follows the model's ``enable_cache``: cached (the default), the aux is built
once at export and lifted into the artifact as constants, so the program's
kernels read it in place, as the facade's cache does; with caching off the
program builds it in-graph on every call, as the facade does then. A
float32 model's parity runs with TF32 off, as the facade's float32 mode
(the program does not carry that setting)."""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import numpy as np
import torch
from torch import nn

from ..demo_helpers.saving import get_save_folder
from ..ops.kernels import library  # noqa: F401  (registers the mdpt ops the program holds)
from .common import load_model

PARITY_BUDGET = 1e-3  # mean abs-rel of the reloaded program against the live model


class ExportedForward(nn.Module):
    """The net's forward on a normalized (B, 3, h, w) image with one grid's
    aux bound, under ``no_grad``: the module ``torch.export`` traces."""

    def __init__(self, net: nn.Module, aux):
        super().__init__()
        self.net = net
        self.aux = aux

    def forward(self, image_nchw):
        with torch.no_grad():
            return self.net(image_nchw, self.aux)


def export_forward(model, hw) -> torch.export.ExportedProgram:
    """``torch.export`` of ``model``'s forward at the fixed input size ``hw``
    (batch 1). ``hw`` must satisfy ``model.verify_input``. The aux, where
    the family has one and the model caches it, is built here outside
    ``inference_mode`` (export refuses inference tensors) and becomes the
    program's constants; otherwise the program builds it in-graph."""
    h, w = (int(s) for s in hw)
    example = torch.zeros((1, 3, h, w), dtype=model.dtype, device=model.device)
    model.verify_input(example)
    make_aux = model.spec.get("make_aux")
    aux = None
    p = model.patch_size_px
    with model._precision():
        if make_aux is not None and model.config.get("enable_cache", True):
            with torch.no_grad():
                aux = make_aux(model.net, (h // p, w // p), model.dtype)
        return torch.export.export(ExportedForward(model.net, aux), (example,))


def kernel_nodes(program: torch.export.ExportedProgram) -> dict[str, int]:
    """The ``mdpt`` operator nodes of an exported program, by op name (the
    ``no_grad`` region is a submodule, so every graph of the program is read)."""
    counts: dict[str, int] = {}
    for module in program.graph_module.modules():
        if not isinstance(module, torch.fx.GraphModule):
            continue
        for node in module.graph.nodes:
            if node.op == "call_function" and str(node.target).startswith("mdpt."):
                name = str(node.target).split(".")[1]
                counts[name] = counts.get(name, 0) + 1
    return counts


def abs_rel(ours: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return float((ours.float() - ref).abs().mean() / (ref.abs().mean() + 1e-12))


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Export, save, reload, check and time; returns the artifact's path and
    bytes, the reloaded program's kernel nodes, its abs-rel against the live
    model and its ms per frame."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-m", "--model_path", default=None, help="Original checkpoint (default: a tiny random DA-V2)")
    parser.add_argument("-b", "--base_size_px", default=None, type=int, help="Max side the input is sized to")
    parser.add_argument("-o", "--output_folder", default=None)
    parser.add_argument("--timing_iters", default=20, type=int)
    parser.add_argument("-d", "--device", default=None,
                        help="Device to run on (default: the CUDA card, which must exist; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    model = load_model(args)
    name = osp.splitext(osp.basename(args.model_path))[0] if args.model_path else "tiny_dav2"
    side = args.base_size_px or model.default_size_px
    h, w = model.compute_scaled_hw((side, side), side, True)
    print(f"Exporting at fixed input size {h}x{w}")

    program = export_forward(model, (h, w))
    out_dir = get_save_folder(args.output_folder or osp.join("saved_results", "exports"))
    out_path = osp.join(out_dir, f"{name}_{h}x{w}.pt2")
    torch.export.save(program, out_path)
    nbytes = os.path.getsize(out_path)
    print(f"Serialized program: {out_path} ({nbytes / 1e6:.1f} MB)")
    del program

    # reload + parity against the live model (the reference's ONNX-vs-torch parity display)
    reloaded = torch.export.load(out_path)
    nodes = kernel_nodes(reloaded)
    print(f"Kernel nodes of the reloaded program: {nodes}")
    call = reloaded.module()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, h, w)).astype(np.float32))
    x = x.to(model.device, model.dtype)
    with model._precision():
        ref = model.forward(x)
        got = call(x)
    err = abs_rel(got, ref)
    print(f"Export parity abs-rel vs live model: {err:.2e}")
    if not err < PARITY_BUDGET:
        raise RuntimeError(f"the reloaded program does not match the live model: abs-rel {err:.3e}")

    ms = None
    if args.timing_iters > 0:  # host clock around work that ends in a synchronize
        with model._precision():
            call(x)
            _synchronize(model.device)
            t0 = time.perf_counter()
            for _ in range(args.timing_iters):
                call(x)
            _synchronize(model.device)
        ms = (time.perf_counter() - t0) / args.timing_iters * 1e3
        print(f"Exported-model timing: {ms:.2f} ms/frame ({1e3 / ms:.1f} fps)")
    return {"path": out_path, "bytes": nbytes, "nodes": nodes, "abs_rel": err, "ms": ms}


if __name__ == "__main__":
    main()
