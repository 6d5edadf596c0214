"""Device ms per frame of the operations launched inside the facade call but
outside the net: the uint8-to-float conversion, the antialiased resize and
the normalization."""

UNIT = "ms"
LAYER = "facade"
MOVES = "frames_per_s"


def read(record):
    t = record.trace
    ops = [o for o in t.ops if "entry" in o.spans and "net" not in o.spans]
    if not ops:
        return None
    return sum(o.seconds for o in ops) * 1e3 / t.frames
