"""Tracing, profiling, memory and logging helpers: the counterpart of JAX
``utils/observability.py`` on torch.

* ``trace_span``: a wall-clock span that is also a ``torch.profiler``
  ``record_function`` range and, once CUDA is initialized, an NVTX range,
  so the region shows up in a captured trace;
* ``start_profiler_trace`` / ``stop_profiler_trace``: a ``torch.profiler``
  session over the CPU and, where there is one, the card, exported as a
  Chrome trace. A process that has traced once and then loads a kernel
  library may see no device events in a later trace: name kernels from
  CUPTI's callback API instead (``chip_smoke.py:device_kernels``);
* ``device_memory_report``: the caching allocator's bytes per visible card;
* ``assert_finite``: a NaN/inf guard over tensors, arrays and nested
  dicts, lists and tuples;
* ``StepTimer``: an EMA step-time / fps counter."""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

LOGGER = logging.getLogger("muggled_dpt_tpu_torch")
_PROFILER = {}  # the running torch.profiler session and its trace folder


def setup_logging(level=logging.INFO):
    if not LOGGER.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        LOGGER.addHandler(handler)
    LOGGER.setLevel(level)
    return LOGGER


@contextlib.contextmanager
def trace_span(name: str, log: bool = False):
    """Wall-clock span that is also a profiler range (and an NVTX range
    once CUDA is initialized), so the region shows up in captured traces."""
    t0 = time.perf_counter()
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
    dt = time.perf_counter() - t0
    if log:
        LOGGER.info("%s: %.2f ms", name, dt * 1000)


def start_profiler_trace(log_dir: str = "torch_trace") -> str:
    """Start a ``torch.profiler`` session (CPU, plus CUDA where a card is
    visible); ``stop_profiler_trace`` writes it into ``log_dir``."""
    if _PROFILER:
        raise RuntimeError(f"a profiler trace is already running into {_PROFILER['dir']}")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _PROFILER.update(prof=prof, dir=log_dir)
    return log_dir


def stop_profiler_trace() -> str:
    """Stop the running session and export it as a Chrome trace
    (``<log_dir>/trace.json``); returns the file's path."""
    if not _PROFILER:
        raise RuntimeError("no profiler trace is running")
    prof, log_dir = _PROFILER.pop("prof"), _PROFILER.pop("dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


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


class StepTimer:
    """EMA step-time / fps counter for streaming loops (the reference's
    on-frame ms overlay, run_video.py:383-384)."""

    def __init__(self, smoothing: float = 0.9):
        self._smoothing = smoothing
        self._ema = None
        self._last = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._ema = dt if self._ema is None else self._smoothing * self._ema + (1 - self._smoothing) * dt
        self._last = now
        return self.ms

    @property
    def ms(self) -> float:
        return 0.0 if self._ema is None else self._ema * 1000.0

    @property
    def fps(self) -> float:
        return 0.0 if not self._ema else 1.0 / self._ema
