"""The traced run: spans from the benchmark's own hooks, the profiler's device
events, and each device operation attributed to the spans that held its launch.

Spans are ``record_function`` ranges named ``pb:<name>``, so they share the
profiler's clock with the CUDA runtime calls. Around each step the harness
opens ``step``, ``upload``, ``entry`` (the facade call), ``readback`` and
``sync``; hooks on the net open ``net``, ``encoder``, ``neck`` (from the
first reassembly stage's entry to the head's exit), ``reassemble.<i>``,
``fusion.<i>`` and ``head``. A device operation's launch is the runtime
call with its correlation id; it belongs to every span whose interval holds
that call. ``busy_us`` is ``muggled_dpt_tpu_torch/tools/measure.py``'s."""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

PREFIX = "pb:"
HOST_PHASES = (("upload", "upload"), ("entry", "enqueue"), ("readback", "read-back"), ("sync", "sync"))
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160  # device operation names are cut to this many characters in the breakdown


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def span(name: str, on: bool):
    """A ``pb:<name>`` range while ``on``; nothing otherwise."""
    return torch.autograd.profiler.record_function(PREFIX + name) if on else contextlib.nullcontext()


def span_modules(net) -> list:
    """(span name, module) of each layer the per-layer metrics read."""
    mods = [("net", net), ("encoder", net.encoder)]
    mods += [(f"reassemble.{i}", m) for i, m in enumerate(net.reassemble)]
    mods += [(f"fusion.{i}", m) for i, m in enumerate(net.fusion)]
    return mods + [("head", net.head)]


@contextlib.contextmanager
def layer_spans(net):
    """Forward hooks that open a span as each layer module is entered and close it as it returns."""
    handles, open_ranges = [], []

    def opener(name):
        def pre(module, args):
            rf = torch.autograd.profiler.record_function(PREFIX + name)
            rf.__enter__()
            open_ranges.append(rf)
        return pre

    def closer(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    neck_first, neck_last = net.reassemble[0], net.head
    for name, module in span_modules(net):
        if module is neck_first:
            handles.append(module.register_forward_pre_hook(opener("neck")))
        handles.append(module.register_forward_pre_hook(opener(name)))
        handles.append(module.register_forward_hook(closer))
        if module is neck_last:
            handles.append(module.register_forward_hook(closer))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        while open_ranges:
            open_ranges.pop().__exit__(None, None, None)


@dataclass
class DeviceOp:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    launch: int | None  # ns of the runtime call that launched it; None where no call matched
    spans: frozenset = field(default_factory=frozenset)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


@dataclass
class TraceRecord:
    ops: list  # DeviceOp of the counted steps
    stretch: tuple  # (start, end) ns: the counted steps, first start to last end
    steps: int
    frames: int
    busy_s: float
    gaps: list  # (label, seconds) of each idle stretch of the device, longest first
    unmatched: int  # device operations with no runtime call found

    @property
    def window_s(self) -> float:
        return (self.stretch[1] - self.stretch[0]) * 1e-9


def _end_ns(e) -> int:
    end = getattr(e, "end_ns", None)
    return int(end()) if end is not None else int(e.start_ns() + e.duration_ns())


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def read(events, frames_per_step: int, skip_steps: int = 1) -> TraceRecord:
    """A ``TraceRecord`` from the profiler's raw events
    (``prof.profiler.kineto_results.events()``): the steps after the first
    ``skip_steps`` are counted."""
    spans: dict[str, list] = {}
    launches: dict[int, int] = {}
    device = []
    for e in events:
        name = e.name()
        if name.startswith(PREFIX):  # a span; the profiler also copies each onto the device's timeline
            if not _is_device(e):
                spans.setdefault(name[len(PREFIX):], []).append((int(e.start_ns()), _end_ns(e)))
        elif _is_device(e):
            device.append(e)
        elif name.startswith("cu"):  # a CUDA runtime or driver call
            launches[int(e.correlation_id())] = int(e.start_ns())
    for v in spans.values():
        v.sort()
    steps = spans.get("step", [])[skip_steps:]
    if not steps:
        raise RuntimeError("the trace holds no counted step")
    stretch = (steps[0][0], steps[-1][1])
    starts = {name: [s for s, _ in v] for name, v in spans.items()}

    def holding(t):
        out = []
        for name, v in spans.items():
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and v[i][1] >= t:
                out.append(name)
        return frozenset(out)

    ops, unmatched = [], 0
    for e in device:
        start, end = int(e.start_ns()), _end_ns(e)
        launch = launches.get(int(e.correlation_id()))
        unmatched += launch is None
        when = start if launch is None else launch
        if not stretch[0] <= when <= stretch[1]:
            continue
        ops.append(DeviceOp(e.name(), start, end, launch, holding(launch) if launch is not None else frozenset()))
    clipped = [(max(o.start, stretch[0]), min(o.end, stretch[1])) for o in ops if o.end > stretch[0] and o.start < stretch[1]]
    busy = merged(clipped)
    edges = [stretch[0]] + [t for iv in busy for t in iv] + [stretch[1]]
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = []
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            gaps.append((host_phase(spans, g0, g1), (g1 - g0) * 1e-9))
    gaps.sort(key=lambda g: -g[1])
    return TraceRecord(ops, stretch, len(steps), len(steps) * frames_per_step, busy_s, gaps, unmatched)


def host_phase(spans: dict, g0: int, g1: int) -> str:
    """What the host was doing over most of [g0, g1]: a step phase, or between steps."""
    best, label = 0, "between steps"
    for name, phase in HOST_PHASES:
        for s, e in spans.get(name, []):
            overlap = min(e, g1) - max(s, g0)
            if overlap > best:
                best, label = overlap, phase
    return label


def breakdown(record: TraceRecord) -> dict:
    """The device operations that took most time and the longest idle gaps, as [name, seconds] pairs."""
    by_name: dict[str, float] = {}
    for o in record.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + o.seconds
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
            "idle_gaps": [[label, s] for label, s in record.gaps[:BREAKDOWN_ENTRIES]]}
