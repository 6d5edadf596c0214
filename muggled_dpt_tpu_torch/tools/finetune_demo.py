"""Multi-step fine-tuning demo: overfit a DPT model to synthetic depth
targets with the scale-shift-invariant objective, data parallel over ranks.
The counterpart of the JAX package's ``tools/finetune_demo.py`` and the
runnable proof of the port's training path (``parallel/train.py``): the SSI
loss must fall below half its start within a few dozen steps when
overfitting a fixed batch, with gradients through the full patch embed ->
encoder -> reassembly -> fusion -> head stack.

    python -m muggled_dpt_tpu_torch.tools.finetune_demo --steps 30 [-d cpu] [-dp 2] [-tp 2]
    python -m muggled_dpt_tpu_torch.tools.finetune_demo --ckpt_dir CKPTS --save_every 10 --steps 30
    python -m muggled_dpt_tpu_torch.tools.finetune_demo --ckpt_dir CKPTS --resume --steps 40

Runs on the CUDA card unless ``-d cpu`` is given, and exits with an error
where there is no card. ``-dp D -tp T`` trains over D x T ranks (one per
card over NCCL; gloo processes on the CPU) on the mesh data D x model T, as
``run_batch``'s pair sets it: the batch cut along its leading axis over the
data axis, the blocks split Megatron-style over the model axis
(``parallel/tensor.py``). The JAX demo trains on ``make_mesh()`` of every
device (a model axis up to 4): its mesh of 8 is ``-dp 2 -tp 4`` here.
Loading a real checkpoint instead of the random tiny model:
``-m depth_anything_v2_vits.pth --size 238``. Prints CONVERGED (or, after
``--resume``, RESUMED OK) and exits 0 when the gate holds."""

from __future__ import annotations

import argparse

import numpy as np
import torch


def synthetic_scene(rng, batch, hw):
    """(images, inverse-depth targets): a slanted 'floor' plane plus a few
    raised rectangles whose image brightness correlates with their depth —
    a learnable image->depth mapping, not pure noise."""
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    images = np.zeros((batch, h, w, 3), np.float32)
    targets = np.zeros((batch, h, w), np.float32)
    for b in range(batch):
        depth = 0.2 + 0.5 * yy  # floor ramp (near at the bottom)
        img = np.stack([0.3 + 0.4 * yy] * 3, axis=-1)
        for _ in range(3):  # raised boxes
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            bh, bw = rng.integers(h // 6, h // 3), rng.integers(w // 6, w // 3)
            lift = rng.uniform(0.2, 0.4)
            depth[y0 : y0 + bh, x0 : x0 + bw] += lift
            img[y0 : y0 + bh, x0 : x0 + bw] = 0.25 + lift + rng.uniform(-0.05, 0.05, 3)
        images[b] = img + rng.normal(0, 0.01, (h, w, 3))
        targets[b] = depth
    return images, targets


def parse_args(argv=None):
    from ..demo_helpers.misc import DEVICE_HELP

    ap = argparse.ArgumentParser(description="Overfit a DPT model to synthetic depth (training-path demo)")
    ap.add_argument("-m", "--model_path", default=None, help="Optional real checkpoint (default: tiny random DA-V2)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=None, help="Default: one per rank")
    ap.add_argument("--size", type=int, default=56, help="Square input side (multiple of the model tile)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt_dir", default=None, help="Save/resume the train state here (parallel/checkpoint.py)")
    ap.add_argument("--save_every", type=int, default=10, help="Checkpoint cadence in steps (with --ckpt_dir)")
    ap.add_argument("--resume", action="store_true", help="Resume from the latest step in --ckpt_dir")
    ap.add_argument("-d", "--device", default=None, help=DEVICE_HELP)
    ap.add_argument("-dp", "--data-parallel", dest="data_parallel", type=int, default=1,
                    help="Width of the mesh's data axis (ranks: one per card; gloo processes on the CPU)")
    ap.add_argument("-tp", "--tensor-parallel", dest="tensor_parallel", type=int, default=1,
                    help="Width of the mesh's model axis: the blocks split Megatron-style over it")
    return ap.parse_args(argv)


def build_model(model_path, seed: int, device):
    """The float32 model to train: a checkpoint's, or the tiny random DA-V2."""
    if model_path:
        from ..make_dpt import make_dpt_from_state_dict

        return make_dpt_from_state_dict(model_path, dtype=torch.float32, device=device)[1]
    from ..make_depthanythingv2_dpt import make_depthanythingv2_dpt

    return make_depthanythingv2_dpt(
        features_per_token=64, num_heads=2, num_blocks=4,
        reassembly_features_list=[8, 16, 32, 64], base_patch_grid_hw=(8, 8),
        fusion_channels=16, patch_size_px=14, dtype=torch.float32, device=device, seed=seed,
    )


def demo_mesh(args) -> dict:
    """The (data, model) mesh of -dp and -tp."""
    from ..parallel.mesh import make_mesh

    if min(args.data_parallel, args.tensor_parallel) < 1:
        raise ValueError(f"-dp {args.data_parallel} -tp {args.tensor_parallel}: each must be at least 1")
    return make_mesh(args.data_parallel * args.tensor_parallel, data_parallel=args.data_parallel)


def train(args, device, rank: int = 0) -> int:
    """The demo on this rank; returns the exit code (0 when the gate holds)."""
    from ..parallel.mesh import mesh_coords, shard_batch
    from ..parallel.tensor import shard_model
    from ..parallel.train import adamw, make_train_step, plain_attention
    from ..utils.metrics import depth_metrics

    say = print if rank == 0 else (lambda *a, **k: None)
    full = build_model(args.model_path, args.seed, device)
    mesh = demo_mesh(args)
    model = shard_model(full, mesh, rank, share=False) if mesh["model"] > 1 else full
    dp = mesh["data"]
    batch = args.batch or dp
    if batch % dp:
        raise ValueError(f"batch {batch} must divide over data={dp}")
    hw = (args.size, args.size)
    if args.size % model.tiling_size:
        raise ValueError(f"--size must be a multiple of {model.tiling_size}")

    rng = np.random.default_rng(args.seed)
    images, targets = (torch.from_numpy(a) for a in synthetic_scene(rng, batch, hw))
    say(f"mesh={mesh}  batch={batch}  input={hw}  params=f32 on {model.device}")

    optimizer = adamw(model.net.parameters(), args.lr)
    start = 0
    if args.ckpt_dir:
        from ..parallel.checkpoint import restore_train_state, save_train_state
    if args.ckpt_dir and args.resume:
        _, _, start = restore_train_state(args.ckpt_dir, model.net, optimizer)
        say(f"resumed from {args.ckpt_dir} step {start}")
        if start >= args.steps:
            say(f"nothing to do: checkpoint step {start} >= --steps {args.steps}")
            return 0

    step = make_train_step(model, optimizer)
    my_images, my_targets = shard_batch((images, targets), mesh_coords(rank, mesh)[0], dp)
    losses = []
    for i in range(start, args.steps):
        losses.append(float(step(my_images, my_targets)))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            say(f"step {i:3d}  ssi_loss {losses[-1]:.5f}")
        if args.ckpt_dir and (i + 1) % args.save_every == 0:
            save_train_state(args.ckpt_dir, i + 1, model.net, optimizer)
            say(f"saved step {i + 1} -> {args.ckpt_dir}")

    # final validation readout: the standard monocular-depth eval protocol
    # (SSI-aligned, matching the relative-depth output convention), on the
    # plain attention as the training forward: the tiny model's 32-wide heads
    # are narrower than the attention kernel's 64; every rank of a model group
    # runs it, since the split blocks meet in their collectives
    with plain_attention(model.net):
        pred = model.forward(images.permute(0, 3, 1, 2))
    m = {k: float(v) for k, v in depth_metrics(pred, targets.to(pred.device)).items()}
    say("eval:", "  ".join(f"{k}={v:.4f}" for k, v in m.items()))

    drop = losses[-1] / max(losses[0], 1e-12)
    say(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}  ({drop:.3f}x of start)")
    if start:
        # resumed segment: the big early-loss drop happened before the
        # checkpoint, so gate only on continued improvement
        ok = losses[-1] <= losses[0]
        say("RESUMED OK" if ok else "LOSS REGRESSED AFTER RESUME")
    else:
        ok = losses[-1] < 0.5 * losses[0]
        say("CONVERGED" if ok else "DID NOT CONVERGE")
    return 0 if ok else 1


def _rank_main(rank, world_size, args, device_type, results):
    from ..parallel.mesh import rank_device

    code = train(args, rank_device(device_type, rank), rank)
    if rank == 0:
        results.put(code)


def main(argv=None) -> int:
    from ..dpt import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    mesh = demo_mesh(args)
    n = mesh["data"] * mesh["model"]
    if n == 1:
        return train(args, device)
    import torch.multiprocessing as mp

    from ..parallel.mesh import spawn

    results = mp.get_context("spawn").SimpleQueue()
    spawn(_rank_main, n, args, device.type, results, device_type=device.type)
    return results.get()


if __name__ == "__main__":
    raise SystemExit(main())
