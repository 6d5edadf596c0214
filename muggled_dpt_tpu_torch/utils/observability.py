"""The port's spans, and two helpers beside them: a memory report and a
NaN/inf guard.

* ``trace_span`` / ``tracing``: the program's spans. The serving path opens
  one at each layer boundary: ``facade`` (each ``DPTModel`` entry call, which
  starts a new request id), ``facade.prep``, ``facade.aux`` and, on a cache
  miss, ``facade.aux_build``, ``encoder``, ``attention`` and ``mlp`` (once
  per block), ``neck``; ViT-Giant's SwiGLU MLP adds ``gate`` (once a block,
  inside ``mlp``: silu(a) * b between the two products); SwinV2's encoder
  adds ``window`` (twice a block: the roll and partition before qkv, the
  merge and roll back after proj), ``cosine`` (once a block: the float32
  normalize of q and k, the logit-scale fold and the casts) and ``merge``
  (each patch merge); Video Depth Anything's neck adds ``temporal`` (each of
  its four temporal motion modules, inside ``neck``: GroupNorm to the map's
  residual) and ``temporal.attention`` (each of a module's two attention
  cores over the frames, the ``F.scaled_dot_product_attention`` call).
  Spans are off by default: ``trace_span`` then
  returns one shared null context after a single flag check. Inside ``with
  tracing() as spans:`` each span appends a ``Span`` record to ``spans`` on
  the host's ``time.perf_counter_ns`` clock, and, while a ``torch.profiler``
  session is active, also opens a ``record_function`` range
  ``mdpt:<name>``, on the profiler's clock with the CUDA runtime calls and
  the device's operations. While ``torch.export`` traces, spans are skipped,
  so an exported graph is the same with tracing on or off.
* ``device_memory_report``: the caching allocator's bytes per visible card;
* ``assert_finite``: a NaN/inf guard over tensors, arrays and nested
  dicts, lists and tuples."""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _profiler

RANGE_PREFIX = "mdpt:"  # the profiler ranges' names: RANGE_PREFIX + the span's name

_NULL = contextlib.nullcontext()  # what every span is while tracing is off
_recorder = None  # the innermost ``tracing()`` context's recorder; None: tracing is off


class Span(NamedTuple):
    """One span: ``parent`` is the index in the same list of the span that
    held it (None at the top), ``request`` the id of the facade call it
    belongs to (None outside any). Written when the span closes: until then
    its place in the list holds None."""

    name: str
    parent: int | None
    request: int | None
    t0_ns: int
    t1_ns: int


class _Recorder:
    """The span list of one ``tracing()`` context, its request counter, the
    lock that keeps a span's index its place in the list, and, per thread,
    the stack of its open spans."""

    def __init__(self):
        self.spans: list[Span | None] = []
        self.requests = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()


class _OpenSpan:
    __slots__ = ("recorder", "name", "new_request", "index", "parent", "request", "range", "t0")

    def __init__(self, recorder: _Recorder, name: str, new_request: bool):
        self.recorder, self.name, self.new_request = recorder, name, new_request

    def __enter__(self):
        recorder = self.recorder
        stack = getattr(recorder.local, "stack", None)
        if stack is None:
            stack = recorder.local.stack = []
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.index
        if self.new_request:
            self.request = next(recorder.requests)
        else:
            self.request = None if outer is None else outer.request
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        with recorder.lock:
            self.index = len(recorder.spans)
            recorder.spans.append(None)
        stack.append(self)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        recorder = self.recorder
        # tuple.__new__ skips the NamedTuple's Python-level constructor
        recorder.spans[self.index] = tuple.__new__(Span, (self.name, self.parent, self.request, self.t0, t1))
        recorder.local.stack.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


def trace_span(name: str, request: bool = False):
    """A span named ``name`` around a ``with`` block. ``request=True`` (the
    facade's entry calls) gives it and every span inside it a new request
    id. Off (outside ``tracing()``) or while ``torch.export`` traces: the
    shared null context."""
    if _recorder is None or torch.compiler.is_exporting():
        return _NULL
    return _OpenSpan(_recorder, name, request)


@contextlib.contextmanager
def tracing():
    """Turn spans on for the ``with`` block; yields the list that every span
    opened inside it, on any thread, appends its ``Span`` to, in the order
    they open. A nested ``tracing()`` records into its own list until it
    ends."""
    global _recorder
    outer, _recorder = _recorder, _Recorder()
    try:
        yield _recorder.spans
    finally:
        _recorder = outer


def device_memory_report() -> dict:
    """Bytes per visible card: the caching allocator's ``bytes_in_use`` now
    and ``peak_bytes_in_use`` since the last ``reset_peak_memory_stats``,
    and the card's total as ``bytes_limit``. {} without a card."""
    if not torch.cuda.is_available():
        return {}
    report = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        report[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return report


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, str(i)))
    else:
        yield path, tree


def assert_finite(tree, name: str = "output"):
    """Raise FloatingPointError naming the first leaf of ``tree`` (a tensor,
    an array, or nested dicts, lists and tuples of them) that holds a NaN or
    an inf. Returns ``tree``."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            bad = int((~torch.isfinite(leaf.detach())).sum())
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            bad = int((~np.isfinite(arr)).sum())
        if bad:
            pathstr = "/".join(path)
            raise FloatingPointError(f"{name}{'/' + pathstr if pathstr else ''}: {bad} non-finite values")
    return tree
