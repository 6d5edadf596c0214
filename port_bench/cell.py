"""One run of one cell: set-up, the measured window, the traced steps, the
check against the reference, and the result line.

Set-up makes the weights on the device from the seed, builds the port from
them, makes the frame pool and runs the cell's own step ``warmup_steps``
times. The window then runs the closed loop for ``--seconds``: each step
copies the next ``batch`` frames from pinned host memory to the card, calls
``DPTModel.inference_rgb_device`` and reads the depth back into pinned host
memory; a step ends when its read-back has completed. ``check_steps`` steps
of the window, drawn from the seed by reservoir sampling, keep their depth.
With ``--trace 1`` the window is followed by ``trace_steps`` steps under the
profiler (and one before them that the reading skips). Once that is done and
the peak memory read, the port is freed and the reference runs on the kept
steps' frames."""

from __future__ import annotations

import gc
import random
import sys
import time
from dataclasses import dataclass

import torch

from . import check, frames, program, spec, trace
from .weights import checksum

FORBIDDEN = ("jax", "jaxlib", "flax", "muggled_dpt_tpu")  # top-level module names, compared whole


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Window:
    frames: int
    steps: int
    seconds: float
    request_s: list  # each step's start to its read-back
    enqueue_s: list  # each step's start to the return of the facade call
    peak_bytes: int  # max_memory_allocated over the window
    begin: float  # the first step's start, on the time.perf_counter clock


@dataclass
class Record:
    """What a metric reader reads."""

    cell: spec.Cell
    counts: dict
    setup_s: float
    window: Window
    trace: trace.TraceRecord | None


class Client:
    """The single client of the closed loop, with its pinned read-back buffers."""

    def __init__(self, model, pool, traffic: dict, size, device):
        self.model, self.pool, self.traffic, self.size, self.device = model, pool, traffic, size, device
        shape = (traffic["batch"], *size)
        pin = device.type == "cuda"
        self.buffers = [torch.empty(shape, dtype=model.dtype, pin_memory=pin) for _ in range(traffic["check_steps"] + 1)]
        self.scratch = torch.empty(shape, dtype=model.dtype, pin_memory=pin)  # warm-up and traced steps: never kept

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def step(self, index: int, out: torch.Tensor, traced: bool = False) -> tuple:
        """One request: upload, the facade call, read-back; (start, enqueued, done) host times."""
        with trace.span("step", traced):
            t0 = time.perf_counter()
            with trace.span("upload", traced):
                x = self.pool[frames.step_frames(self.traffic, index)].to(self.device, non_blocking=True)
            with trace.span("entry", traced):
                depth = self.model.inference_rgb_device(x, self.size)
            t_enq = time.perf_counter()
            with trace.span("readback", traced):
                out.copy_(depth, non_blocking=True)
            with trace.span("sync", traced):
                self.sync()
            return t0, t_enq, time.perf_counter()

    def window(self, seconds: float, first: int, rng: random.Random) -> tuple:
        """Steps from ``first`` until ``seconds`` have passed; (Window, kept),
        kept holding (step, depth) of ``check_steps`` steps drawn uniformly from
        all the window's steps."""
        k = self.traffic["check_steps"]
        kept, spare = [], self.buffers[k]
        request, enqueue = [], []
        i = 0
        begin = time.perf_counter()
        deadline = begin + seconds
        while True:
            slot = i if i < k else rng.randrange(i + 1)
            target = self.buffers[i] if i < k else spare
            t0, t_enq, t1 = self.step(first + i, target)
            if i < k:
                kept.append((first + i, target))
            elif slot < k:
                kept[slot], spare = (first + i, target), kept[slot][1]
            request.append(t1 - t0)
            enqueue.append(t_enq - t0)
            i += 1
            if t1 >= deadline:
                break
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        return Window(i * self.traffic["batch"], i, t1 - begin, request, enqueue, peak, begin), kept


def traced_steps(client: Client, first: int) -> trace.TraceRecord:
    """``trace_steps`` steps (after one more that is not counted) under the profiler, read in memory."""
    from torch.profiler import ProfilerActivity, profile

    n = client.traffic["trace_steps"]
    with trace.layer_spans(client.model.net), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n + 1):
            client.step(first + i, client.scratch, traced=True)
    record = trace.read(prof.profiler.kineto_results.events(), client.traffic["batch"], skip_steps=1)
    if not record.ops:
        raise RuntimeError("the profiler recorded no device events in the traced steps")
    return record


def metric_values(entries: list, record: Record) -> dict:
    """{name: {"value", "unit"}} of the metrics whose readers find something to read."""
    out = {}
    for m in entries:
        reader = spec.metric_reader(m["name"])
        if reader.UNIT != m["unit"]:
            raise ValueError(f"metric {m['name']}: reader unit {reader.UNIT!r}, BENCHMARK.json {m['unit']!r}")
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float, log=print) -> dict:
    """One run of ``cell``; returns the result line's object. ``t_start`` is
    the process's start on the ``time.perf_counter`` clock; ``log`` takes
    the run's diagnostic lines."""
    device = torch.device(device)
    config, traffic = cell.config, cell.traffic
    frames.check_traffic(traffic)
    weights = spec.family_module("weights", config["family"])
    counts = spec.family_module("counts", config["family"]).counts
    reference = spec.family_module("reference", config["family"])
    size = frames.scaled_hw(config, traffic)
    marks = [("", t_start), ("start-up", time.perf_counter())]

    state_dict = weights.generate(config, seed, device, program.DTYPES[config["dtype"]])
    weights_sum = checksum(state_dict)
    marks.append(("weights", time.perf_counter()))
    model = program.build(config, state_dict, device)
    del state_dict
    marks.append(("build", time.perf_counter()))
    mismatch = program.port_config_matches(model, config)
    if mismatch:
        raise ValueError(f"the port read other widths than {cell.workload['config']}: {mismatch}")
    port_size = model.compute_scaled_hw(traffic["frame_hw"], traffic["max_side"], traffic["square"])
    if tuple(port_size) != size:
        raise ValueError(f"the port sizes a frame to {port_size}, the traffic to {size}")
    pool = frames.make_pool(traffic, seed, device)
    marks.append(("frames", time.perf_counter()))
    client = Client(model, pool, traffic, size, device)
    for i in range(traffic["warmup_steps"]):
        client.step(i, client.scratch)
    marks.append(("warm-up", time.perf_counter()))
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    from muggled_dpt_tpu_torch.ops.kernels.flash_attention import launch_counts

    launches = launch_counts()

    window, kept = client.window(seconds, traffic["warmup_steps"], random.Random(seed))
    setup_s = window.begin - t_start
    forbidden = forbidden_modules()
    if forbidden:
        raise RuntimeError(f"modules loaded in the run's process: {forbidden}")
    launched = {k: v - launches[k] for k, v in launch_counts().items() if v != launches[k]}
    log(f"set-up {setup_s:.3f} s: " + ", ".join(f"{name} {t1 - t0:.3f}" for (_, t0), (name, t1) in zip(marks, marks[1:])))
    log(f"window: {window.steps} steps, {window.frames} frames in {window.seconds:.3f} s; launches by route {launched}")

    record = Record(cell, counts(config, size, traffic["batch"]), setup_s, window, None)
    if traced:
        record.trace = traced_steps(client, traffic["warmup_steps"] + window.steps)
        log(f"trace: {record.trace.steps} steps, {len(record.trace.ops)} device operations, "
            f"{record.trace.unmatched} with no runtime call, busy {record.trace.busy_s:.6f} of {record.trace.window_s:.6f} s")
    memory_peak = max(setup_peak, window.peak_bytes, torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)

    del client, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    state_dict = weights.generate(config, seed, device, program.DTYPES[config["dtype"]])
    if checksum(state_dict) != weights_sum:
        raise RuntimeError("the reference's weights are not the program's")
    state_dict = {k: v.float() for k, v in state_dict.items()}
    t_ref = time.perf_counter()
    refs, yard = check.yardstick(cell, reference, state_dict, pool, [s for s, _ in kept], device)
    values, errors = check.compare(kept, refs, yard, device)
    correct, table = check.judge(values, cell.limits)
    log(f"reference: {len(errors)} frames of {len(kept)} steps in {time.perf_counter() - t_ref:.3f} s; frame errors "
        f"{[float(f'{e:.4g}') for e in errors]}, bfloat16-rounded reference's {[float(f'{e:.4g}') for e in yard]}")

    result = {
        "correct": correct,
        "attempted": window.frames,
        "failed": 0,
        "metrics": metric_values(cell.per_layer if traced else cell.end_to_end, record),
        "device": device_info(device, cell.workload["chips"], memory_peak, record.trace),
    }
    if traced:
        result["breakdown"] = trace.breakdown(record.trace)
    result["checks"] = table
    return result


def device_info(device, chips: int, memory_peak: int, traced) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": memory_peak}
    if traced is not None:
        info["busy_s"] = traced.busy_s
        info["window_s"] = traced.window_s
    return info
