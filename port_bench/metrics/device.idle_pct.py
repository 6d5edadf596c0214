"""100 minus the union of the device operations' intervals over the wall time
of the traced steps, in %."""

UNIT = "%"
LAYER = "device"
MOVES = "frames_per_s"


def read(record):
    t = record.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
