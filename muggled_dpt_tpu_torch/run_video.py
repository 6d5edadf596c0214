"""Streaming video/webcam depth demo, the counterpart of the JAX package's
``run_video.py``. Dispatch-ahead as the reference's async CUDA gating
(run_video.py:336,349): each inference is queued on a CUDA stream of its own
(``demo_helpers/misc.py:AsyncResult``), and a result is collected only once
the event after it has completed, so the displayed depth lags by up to one
in-flight frame but playback never waits on the card. ``-sync`` waits for
every frame instead, for honest per-frame times.

    python -m muggled_dpt_tpu_torch.run_video -m CKPT -i VIDEO [--headless --max_frames N] [-sync] [-d cpu]

Runs on the CUDA card in bfloat16 unless ``-d cpu`` (float32) is given, and
exits with an error where there is no card. With ``--headless -r`` every
shown frame is recorded (there is no window in which to toggle recording).

Keys: space = pause, c = colormap, r = reverse, e = equalize, o = record
      frames, q/esc = quit."""

import argparse
import os.path as osp
import time

import cv2
import numpy as np

from .demo_helpers import ui
from .demo_helpers.history_keeper import HistoryKeeper
from .demo_helpers.loading import ask_for_model_path, ask_for_video_path
from .demo_helpers.misc import (
    DEVICE_HELP,
    AsyncResult,
    make_device_config,
    maybe_quantize_int8,
    print_config_feedback,
    reduce_overthreading,
)
from .demo_helpers.postprocess import convert_to_uint8, histogram_equalization, normalize_01, remove_infinities
from .demo_helpers.saving import get_save_folder, make_save_name
from .demo_helpers.video import LoopingVideoReader
from .make_dpt import make_dpt_from_state_dict


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run depth estimation on video/webcam")
    parser.add_argument("-i", "--video_path", default=None, help="Path to video file or webcam number")
    parser.add_argument("-m", "--model_path", default=None, help="Path to DPT model weights")
    parser.add_argument("-cam", "--use_webcam", action="store_true", help="Use webcam 0")
    parser.add_argument("-s", "--display_size", default=800, type=int)
    parser.add_argument(
        "-t", "--display_ms", default=1, type=int,
        help="Time to display each frame; 0 = pace by the video's own FPS (reference run_video.py:56-62)",
    )
    parser.add_argument("-d", "--device", default=None, help=DEVICE_HELP)
    parser.add_argument("-b", "--base_size_px", default=None, type=int, help="Override model base size")
    parser.add_argument("-nc", "--no_cache", action="store_true",
                        help="Disable per-grid aux caching to reduce device memory use")
    parser.add_argument("-f32", "--use_float32", action="store_true")
    parser.add_argument("-u", "--prefer_unstable_f16", action="store_true")
    parser.add_argument("-z", "--no_optimization", action="store_true")
    parser.add_argument("--int8", action="store_true", help="int8 encoder serving tier (DA/BEiT; see docs/performance.md)")
    parser.add_argument("--int8-full", dest="int8_full", action="store_true",
                        help="int8 tier incl. the full neck: reassembly GEMMs + fusion/head convs (implies --int8; docs/performance.md)")
    parser.add_argument("-ar", "--use_aspect_ratio", action="store_true")
    parser.add_argument("-sync", "--use_sync", action="store_true", help="Block on every frame (accurate timing)")
    parser.add_argument(
        "-r", "--allow_recording", action="store_true",
        help="Enable the toggle-able per-frame depth recording UI (reference run_video.py:122-128); "
             "with --headless, record every shown frame",
    )
    parser.add_argument("--crop", action="store_true", help="Interactively crop frames before inference (persisted)")
    parser.add_argument("--max_frames", default=None, type=int, help="Stop after N frames (headless testing)")
    parser.add_argument("--headless", action="store_true", help="No display window")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the loop's counts and times: frames read, results shown,
    frames recorded, the loop's wall seconds and frames per second, and per
    dispatch the host ms inside it and the inference ms (-sync: dispatch to
    the result on the host)."""
    args = parse_args(argv)
    reduce_overthreading()
    device_config = make_device_config(args.device, args.use_float32, prefer_bfloat16=not args.prefer_unstable_f16)

    history = HistoryKeeper()
    _, hist_video = history.read("video_path")
    _, hist_model = history.read("model_path")
    video_source = "0" if args.use_webcam else (args.video_path or ask_for_video_path(hist_video))
    model_path = args.model_path or ask_for_model_path(default_path=hist_model)
    history.store(video_path=str(video_source), model_path=model_path)

    print("", "Loading model weights...", f"  @ {model_path}", sep="\n", flush=True)
    model_config, dpt_model = make_dpt_from_state_dict(
        model_path, enable_cache=not args.no_cache, enable_optimizations=not args.no_optimization,
        dtype=device_config["dtype"], device=device_config["device"],
    )
    dpt_model = maybe_quantize_int8(dpt_model, args.int8, args.int8_full)
    print_config_feedback(model_path, device_config, use_cache=not args.no_cache)

    reader = LoopingVideoReader(video_source)
    base_size = args.base_size_px or dpt_model.default_size_px
    use_square = not args.use_aspect_ratio

    # Optional interactive crop of the video frames, persisted via history
    # (reference run_video.py:130-134,207-215)
    crop_slices = None
    if args.crop:
        ok_first, first_frame = reader.peek_frame()
        assert ok_first, "No frame available to crop"
        _, prev_crop = history.read("crop_xy1xy2_norm")
        if args.headless:
            # no display: reuse the persisted crop instead of the blocking UI
            if prev_crop:
                from .demo_helpers.crop_ui import norm_crop_to_slices

                crop_slices = norm_crop_to_slices(first_frame.shape[:2], prev_crop)
                print(f"  --crop (headless): using persisted crop {prev_crop}")
            else:
                print("  --crop ignored: headless mode and no persisted crop in history")
        else:
            from .demo_helpers.crop_ui import run_crop_ui

            crop_slices, crop_norm = run_crop_ui(first_frame, prev_crop)
            history.store(crop_xy1xy2_norm=crop_norm)

    cmap_bar = ui.ColormapsBar()
    reverse_toggle = ui.ToggleButton("Reverse colors", False)
    histeq_toggle = ui.ToggleButton("Equalize", False)
    # headless: no window to toggle recording in, so -r records from the start
    record_toggle = ui.ToggleButton("Record", args.headless) if args.allow_recording else None
    display = ui.ImageDisplay()
    playback = ui.PlaybackBar(reader.total_frames) if not reader.is_webcam else None
    layout = ui.VStack(display, cmap_bar, playback, reverse_toggle, histeq_toggle, record_toggle)

    window = None
    if not args.headless:
        window = ui.DisplayWindow(f"Depth video - {osp.basename(str(video_source))}")
        window.attach(layout)
        window.attach_keypress_callback("c", cmap_bar.next)
        window.attach_keypress_callback("r", reverse_toggle.toggle)
        window.attach_keypress_callback("e", histeq_toggle.toggle)
        if record_toggle is not None:
            window.attach_keypress_callback("o", record_toggle.toggle)
        window.attach_keypress_callback(" ", playback.toggle_pause if playback is not None else reader.toggle_pause)
        rec_help = "  o=record" if record_toggle is not None else ""
        print(f"\nKeys: space=pause  c=colormap  r=reverse  e=equalize{rec_help}  q=quit")

    gate = AsyncResult(device_config["device"])
    depth_u8 = None
    infer_ms = 0.0
    record_folder = None
    frames_seen = results_shown = recorded = 0
    host_times, infer_times = [], []

    # frame pacing (reference run_video.py:192): 0 = use the video's own fps
    frame_delay_ms = max(1, int(1000 / max(reader.fps, 1))) if args.display_ms == 0 else max(1, int(args.display_ms))

    t_start = time.perf_counter()
    for is_paused, frame_idx, frame in reader:
        frames_seen += 1
        if crop_slices is not None:
            frame = frame[crop_slices]
        if playback is not None and not is_paused:
            playback.set_frame(frame_idx)

        # Dispatch-ahead: queue a new inference only when the previous result is
        # on the host (never blocks playback); -sync waits for every result.
        if gate.is_ready():
            prev = gate.collect()
            if prev is not None:
                depth = normalize_01(remove_infinities(prev.squeeze()))
                depth_u8 = convert_to_uint8(depth)
                results_shown += 1
            t0 = time.perf_counter()
            gate.dispatch(dpt_model, frame, base_size, use_square)
            host_ms = (time.perf_counter() - t0) * 1000.0
            host_times.append(host_ms)
            if args.use_sync:
                gate.wait()
                infer_ms = (time.perf_counter() - t0) * 1000.0
                infer_times.append(infer_ms)
            else:
                infer_ms = 0.9 * infer_ms + 0.1 * host_ms

        if depth_u8 is not None:
            shown = histogram_equalization(depth_u8) if histeq_toggle.is_on else depth_u8
            if reverse_toggle.is_on:
                shown = 255 - shown
            colored = cmap_bar.apply(shown)
            h, w = frame.shape[:2]
            colored = cv2.resize(colored, (w, h))
            label = f"{infer_ms:.1f} ms" + ("" if args.use_sync else " (dispatch)")
            ui.TextDrawer(0.6, 2, (255, 255, 255)).draw(colored, label, (10, 8))
            combined = np.hstack([frame, colored])
            display.set_image(combined)

            if record_toggle is not None and record_toggle.is_on:
                if record_folder is None:
                    record_folder = get_save_folder(osp.join("saved_results", make_save_name(str(video_source), "rec")))
                cv2.imwrite(osp.join(record_folder, f"frame_{frame_idx:06d}.png"), colored)
                recorded += 1

        if playback is not None:
            seek_changed, seek_val = playback.read_seek()
            if seek_changed:
                reader.seek(seek_val)
            pause_changed, paused = playback.read_pause()
            if pause_changed:
                reader.pause(paused)

        if window is not None:
            request_close, _ = window.show(args.display_size, frame_delay_ms)
            if request_close:
                break
        if args.max_frames is not None and frames_seen >= args.max_frames:
            break

    seconds = time.perf_counter() - t_start
    reader.release()
    if window is not None:
        window.close()
    stats = {"frames": frames_seen, "shown": results_shown, "recorded": recorded, "record_folder": record_folder,
             "seconds": seconds, "fps": frames_seen / seconds if seconds > 0 else 0.0,
             "host_ms": host_times, "infer_ms": infer_times}
    print(f"{frames_seen} frames in {seconds:.2f} s ({stats['fps']:.1f} frames/s), {results_shown} depth results shown, "
          f"{len(host_times)} dispatched ({'-sync' if args.use_sync else 'dispatch-ahead'}), {recorded} recorded",
          flush=True)
    return stats


if __name__ == "__main__":
    main()
