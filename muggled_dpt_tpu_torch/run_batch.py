"""Offline batch depth extraction, the counterpart of the JAX package's
``run_batch.py``: a folder of images, a single image or a video file
through ``parallel.BatchParallelRunner``, in batches of ``-dp`` ranks times
``--per-chip-batch`` frames, writing per-frame uint16 PNG, ``.npy`` and
colormapped PNG results, with an optional ground-truth evaluation.

    python -m muggled_dpt_tpu_torch.run_batch -i FRAMES_OR_VIDEO -m CKPT [-dp N] [-tp M] [--per-chip-batch B] [-d cpu]

Runs on the CUDA card in bfloat16 unless ``-d cpu`` (float32) is given, and
exits with an error where there is no card. ``-dp N -tp M`` starts N x M
ranks on a (data N, model M) mesh: on the card one process per GPU over
NCCL (N x M must not exceed the visible cards), on the CPU gloo processes.
The M ranks of a model group hold one Megatron split of the model
(``parallel/tensor.py``) and take one data slot of each batch: its frames
of a folder are decoded by the group's first rank and broadcast to the
others (a video's are decoded by rank 0 and scattered), run through the
kernel forward, and written, with their eval sums, by the group's first
rank. The last batch is padded by repeating its last frame, and the padded
outputs are dropped."""

import argparse
import itertools
import os.path as osp
import time

import cv2
import numpy as np
import torch
import torch.distributed as dist

from .demo_helpers.history_keeper import HistoryKeeper
from .demo_helpers.loading import PathCarousel, ask_for_model_path, ask_for_path
from .demo_helpers.misc import DEVICE_HELP, depth_to_numpy, make_device_config, maybe_quantize_int8, reduce_overthreading
from .demo_helpers.postprocess import normalize_01, remove_infinities
from .demo_helpers.saving import get_save_folder
from .demo_helpers.ui import ColormapsBar
from .demo_helpers.video import create_video_capture
from .make_dpt import make_dpt_from_state_dict

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v")
UNROLL_NOTE = "--unroll is a TPU compile switch (lax.scan unrolling); the port runs its blocks eagerly and ignores it"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Batch depth extraction for folders of images or video files")
    parser.add_argument("-i", "--input_path", default=None, help="Image, folder of images, or video file")
    parser.add_argument("-m", "--model_path", default=None, help="Path to DPT model weights")
    parser.add_argument("-o", "--output_folder", default=None, help="Output folder (default: saved_results/batch_<input>)")
    parser.add_argument("-b", "--base_size_px", default=None, type=int, help="Override model base size")
    parser.add_argument("-ar", "--use_aspect_ratio", action="store_true", help="Process at the input's aspect ratio")
    parser.add_argument("-d", "--device", default=None, help=DEVICE_HELP)
    parser.add_argument("-f32", "--use_float32", action="store_true")
    parser.add_argument("--int8", action="store_true", help="int8 encoder serving tier")
    parser.add_argument("--int8-full", dest="int8_full", action="store_true",
                        help="int8 tier incl. the full neck: reassembly GEMMs + fusion/head convs (implies --int8)")
    parser.add_argument("-dp", "--data-parallel", dest="data_parallel", default=None, type=int,
                        help="Width of the mesh's data axis: frames per step = this x --per-chip-batch "
                             "(default: the visible cards / -tp; 1 on the CPU)")
    parser.add_argument("--per-chip-batch", default=1, type=int, help="Frames per data slot per step")
    parser.add_argument("-tp", "--tensor-parallel", dest="tensor_parallel", default=1, type=int,
                        help="Also shard the weights Megatron-style over a model axis of this width "
                             "(needs data_parallel x tensor_parallel cards; gloo processes on the CPU)")
    parser.add_argument("--unroll", default=None, const="6", nargs="?", metavar="K",
                        help="The JAX package's encoder unrolling switch: accepted and ignored")
    parser.add_argument("--save", default="u16", help="Comma list of outputs: u16, npy, color (default: u16)")
    parser.add_argument("--max_frames", default=None, type=int, help="Stop after N frames")
    parser.add_argument("--eval_gt", default=None, metavar="FOLDER",
                        help="Ground-truth inverse-depth folder (<name>.npy float or <name>.png u16): "
                             "aggregate AbsRel/RMSE/delta metrics over the run (utils/metrics.py; "
                             "pixels with gt<=0 are masked out, the standard validity convention)")
    parser.add_argument("--eval_no_align", action="store_true",
                        help="Skip the per-image SSI (scale, shift) alignment before measuring "
                             "(for metric models, whose absolute scale is under test)")
    return parser.parse_args(argv)


def load_gt(folder: str, name: str, hw: tuple[int, int]) -> np.ndarray | None:
    """Ground truth for frame `name`: <name>.npy (float inverse depth) or
    <name>.png (u16/u8, normalized). Resized nearest to the prediction's HW
    so zero-invalid pixels never bleed into valid ones."""
    npy = osp.join(folder, f"{name}.npy")
    png = osp.join(folder, f"{name}.png")
    if osp.isfile(npy):
        gt = np.load(npy).astype(np.float32)
    elif osp.isfile(png):
        raw = cv2.imread(png, cv2.IMREAD_UNCHANGED)
        if raw is None:
            return None
        if raw.ndim == 3:
            raw = raw[..., 0]
        gt = raw.astype(np.float32) / float(np.iinfo(raw.dtype).max if raw.dtype.kind == "u" else 1)
    else:
        return None
    if gt.shape != hw:
        gt = cv2.resize(gt, (hw[1], hw[0]), interpolation=cv2.INTER_NEAREST)
    return gt


def iter_frames(input_path: str):
    """Yield (name, bgr_frame) for a video file, in order."""
    cap = create_video_capture(input_path)
    idx = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield f"frame_{idx:06d}", frame
            idx += 1
    finally:
        cap.release()


def folder_steps(paths: list[str], first: np.ndarray, rank: int, world_size: int, per_rank: int):
    """Data slot ``rank``'s slice of an image list (of ``world_size``
    slots), one per step: ``per_rank`` (name, bgr_frame) pairs, decoded here
    and on no other slot. Slots past the end repeat the last image with name
    None (padding: no output). A file that does not decode keeps its slot,
    runs ``first`` and has no output."""
    n = len(paths)
    last = (None, None)  # (index, frame) decoded last: a padded slot reuses it
    for start in range(0, n, world_size * per_rank):
        mine = []
        for i in range(start + rank * per_rank, start + (rank + 1) * per_rank):
            j = min(i, n - 1)
            if last[0] != j:
                last = (j, cv2.imread(paths[j]))
                if last[1] is None:
                    print(f"Skipping {paths[j]}: not a readable image", flush=True)
            name = osp.splitext(osp.basename(paths[j]))[0] if i < n and last[1] is not None else None
            mine.append((name, first if last[1] is None else last[1]))
        yield mine


def video_steps(input_path: str, rank: int, world_size: int, per_rank: int, max_frames: int | None,
                tensor_parallel: int = 1):
    """This rank's slice of a video, one per step: rank 0 decodes each step's
    frames and scatters the slices, every rank of a model group (of
    ``tensor_parallel`` consecutive ranks) getting its data slot's; the last
    step is padded by repeating its last frame with name None (no output)."""
    batch = world_size // tensor_parallel * per_rank
    frames = iter_frames(input_path) if rank == 0 else None
    n_read = 0
    while True:
        slices = None
        if rank == 0:
            take = batch if max_frames is None else max(0, min(batch, max_frames - n_read))
            step = list(itertools.islice(frames, take))
            n_read += len(step)
            if step:
                step += [(None, step[-1][1])] * (batch - len(step))
            slices = [step[r // tensor_parallel * per_rank:(r // tensor_parallel + 1) * per_rank] for r in range(world_size)]
        if world_size > 1:
            received = [None]
            dist.scatter_object_list(received, slices, src=0)
            mine = received[0]
        else:
            mine = slices[0]
        if not mine:
            return
        yield mine


def extract(args, input_path: str, model_path: str, device_config: dict, rank: int = 0, world_size: int = 1) -> dict:
    """The extraction on this rank: the first rank of each model group
    decodes the frames of its data slot of every step and broadcasts them to
    the group (a video's are decoded by rank 0 and scattered), the group
    runs them, and its first rank writes their outputs; the ranks' counts
    and eval sums meet once, at the end. Returns the run's numbers (rank
    0's are the run's)."""
    from .parallel.inference import BatchParallelRunner
    from .parallel.mesh import make_mesh
    from .utils.metrics import depth_metrics

    lead = rank == 0
    tp = max(1, args.tensor_parallel)
    say = print if lead else (lambda *a, **k: None)
    say("", "Loading model weights...", f"  @ {model_path}", sep="\n", flush=True)
    _, model = make_dpt_from_state_dict(model_path, dtype=device_config["dtype"], device=device_config["device"])
    model = maybe_quantize_int8(model, args.int8, args.int8_full)

    mesh = make_mesh(world_size, data_parallel=world_size // tp)
    runner = BatchParallelRunner(model, mesh=mesh)
    slot, slots, writer = runner.data_index, runner.data_parallelism, runner.model_index == 0
    per_rank = max(1, args.per_chip_batch)
    batch = runner.data_parallelism * per_rank
    say(f"Mesh: {mesh} | batch per step: {batch}", flush=True)

    base_size = args.base_size_px or model.default_size_px
    use_square = not args.use_aspect_ratio
    save_kinds = {s.strip() for s in args.save.split(",") if s.strip()}
    unknown = save_kinds - {"u16", "npy", "color"}
    if unknown:
        raise ValueError(f"Unknown --save kinds: {sorted(unknown)}")
    cmap = ColormapsBar() if "color" in save_kinds else None

    out_dir = args.output_folder or osp.join("saved_results", f"batch_{osp.splitext(osp.basename(str(input_path)))[0]}")
    get_save_folder(out_dir)

    if str(input_path).lower().endswith(VIDEO_EXTS):
        target_hw = None  # a video's frames share one size: its first frame's
        steps = video_steps(str(input_path), rank, world_size, per_rank, args.max_frames, tp)
    else:
        paths = PathCarousel(input_path).paths[: args.max_frames]
        # every rank decodes the first readable image: -ar's target size, and the filler of an unreadable slot
        first = next((f for f in map(cv2.imread, paths) if f is not None), None)
        if first is None:
            raise FileNotFoundError(f"No image files at: {input_path}")
        target_hw = model.compute_scaled_hw(first.shape[:2], base_size, use_square)
        steps = folder_steps(paths, first, slot, slots, per_rank) if writer else itertools.repeat(None)
        if tp > 1:
            steps = _broadcast_steps(steps, runner.model_group, rank - runner.model_index)

    n_done = n_at_start = 0
    t_start = None
    eval_sums: dict[str, float] = {}
    eval_n = 0

    def save_one(name: str, depth: np.ndarray):
        d = normalize_01(remove_infinities(depth.astype(np.float32)))
        if "u16" in save_kinds:
            cv2.imwrite(osp.join(out_dir, f"{name}.png"), np.round(d * 65535).astype(np.uint16))
        if "npy" in save_kinds:
            np.save(osp.join(out_dir, f"{name}.npy"), depth.astype(np.float32))
        if cmap is not None:
            cv2.imwrite(osp.join(out_dir, f"{name}_color.png"), cmap.apply(np.round(d * 255).astype(np.uint8)))

    for mine in steps:
        if target_hw is None:
            target_hw = model.compute_scaled_hw(mine[0][1].shape[:2], base_size, use_square)
        if t_start is None:
            say(f"Processing at {target_hw[1]}x{target_hw[0]} -> {out_dir}", flush=True)
        for _, frame in mine:
            this_hw = model.compute_scaled_hw(frame.shape[:2], base_size, use_square)
            if this_hw != target_hw:
                raise ValueError(f"Mixed input sizes in aspect-ratio mode ({this_hw} vs {target_hw}); "
                                 "batching needs one shape — drop -ar or split the inputs")
        # device-resident NHWC prep of this rank's slice: no per-frame host sync
        x = torch.cat([model.prepare_image_bgr_nhwc(f, base_size, use_square) for _, f in mine])
        for (name, _), depth in zip(mine, depth_to_numpy(runner.run_shard(x))):
            if name is None or not writer:
                continue
            save_one(name, depth)
            n_done += 1
            if args.eval_gt:
                gt = load_gt(args.eval_gt, name, depth.shape)
                if gt is not None:
                    frame_metrics = depth_metrics(torch.from_numpy(depth[None]), torch.from_numpy(gt[None]),
                                                  torch.from_numpy((gt > 0).astype(np.float32)[None]),
                                                  align=not args.eval_no_align)
                    for k, v in frame_metrics.items():
                        eval_sums[k] = eval_sums.get(k, 0.0) + float(v)
                    eval_n += 1
        if t_start is None:
            if world_size > 1:
                dist.barrier()
            t_start = time.perf_counter()  # exclude the first step: kernel loads, aux build
            n_at_start = n_done

    counts = [(n_done, n_at_start, eval_n, eval_sums)]
    if world_size > 1:
        counts = [None] * world_size
        dist.all_gather_object(counts, (n_done, n_at_start, eval_n, eval_sums))
    t_end = time.perf_counter()
    n_done, n_at_start, eval_n = (sum(c[i] for c in counts) for i in range(3))
    eval_sums = {k: sum(c[3].get(k, 0.0) for c in counts) for k in set().union(*(c[3] for c in counts))}
    if n_done == 0:
        raise RuntimeError("No frames processed")

    stats = {"frames": n_done, "out_dir": out_dir, "batch": batch, "fps": None, "eval": None}
    if t_start is not None and n_done > n_at_start:
        stats["fps"] = (n_done - n_at_start) / (t_end - t_start)
        say(f"Done: {n_done} frames -> {out_dir} ({stats['fps']:.1f} frames/s steady-state)")
    else:
        say(f"Done: {n_done} frames -> {out_dir}")

    if args.eval_gt and lead:
        if eval_n:
            stats["eval"] = {k: eval_sums[k] / eval_n for k in sorted(eval_sums)}
            summary = "  ".join(f"{k}={v:.4f}" for k, v in stats["eval"].items())
            align_note = "no-align" if args.eval_no_align else "SSI-aligned"
            print(f"Eval vs {args.eval_gt} ({eval_n}/{n_done} frames, {align_note}): {summary}")
        else:
            print(f"Eval: no ground-truth files matched under {args.eval_gt}")
    return stats


def _broadcast_steps(steps, group, src: int):
    """The steps of a model group's first rank (global rank ``src``), each
    broadcast to the group's other ranks, whose own ``steps`` are ignored."""
    for mine in steps:
        box = [mine]
        dist.broadcast_object_list(box, src=src, group=group)
        if box[0] is None:
            return
        yield box[0]
    box = [None]
    dist.broadcast_object_list(box, src=src, group=group)


def _rank_main(rank, world_size, args, input_path, model_path, device_type, dtype, results):
    from .parallel.mesh import rank_device

    device_config = {"device": rank_device(device_type, rank), "dtype": dtype}
    stats = extract(args, input_path, model_path, device_config, rank, world_size)
    if rank == 0:
        results.put(stats)


def main(argv=None):
    """Returns the run's numbers: frames, out_dir, batch, steady-state fps
    (None for a single step) and the eval means (None without --eval_gt)."""
    args = parse_args(argv)
    if args.unroll is not None:
        print(UNROLL_NOTE)
    reduce_overthreading()
    device_config = make_device_config(args.device, args.use_float32)
    device_type = device_config["device"].type
    tp = max(1, args.tensor_parallel)
    cards = torch.cuda.device_count() if device_type == "cuda" else None
    dp = args.data_parallel or (max(1, cards // tp) if cards else 1)
    if cards is not None and dp * tp > cards:
        raise ValueError(f"-dp {dp} x -tp {tp} needs {dp * tp} CUDA cards, have {cards} (on the CPU: -d cpu)")

    history = HistoryKeeper()
    _, hist_input = history.read("batch_input_path")
    _, hist_model = history.read("model_path")
    input_path = args.input_path or ask_for_path("Enter path to image/folder/video", hist_input)
    model_path = args.model_path or ask_for_model_path(default_path=hist_model)
    history.store(batch_input_path=str(input_path), model_path=model_path)

    if dp * tp == 1:
        return extract(args, input_path, model_path, device_config)
    import torch.multiprocessing as mp

    from .parallel.mesh import spawn

    results = mp.get_context("spawn").SimpleQueue()
    spawn(_rank_main, dp * tp, args, input_path, model_path, device_type, device_config["dtype"], results,
          device_type=device_type)  # raises, before any rank loads, where the card count is short
    return results.get()


if __name__ == "__main__":
    main()
