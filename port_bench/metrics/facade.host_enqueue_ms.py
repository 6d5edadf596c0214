"""Host ms from a step's start to the return of ``inference_rgb_device``,
mean over the steps of the untraced window that precedes the traced steps
(the profiler's own cost would inflate it): the host's launch path."""

import statistics

UNIT = "ms"
LAYER = "facade"
MOVES = "frames_per_s"


def read(record):
    return statistics.fmean(record.window.enqueue_s) * 1e3
