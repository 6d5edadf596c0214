"""Frames completed in the window over the window's seconds (the first
step's start to the last step's read-back)."""

UNIT = "frames/s"
LAYER = "end to end"
MOVES = "frames_per_s"


def read(record):
    return record.window.frames / record.window.seconds
