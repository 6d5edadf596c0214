"""Device ms per frame of the operations launched inside the reassembly
stages, the fusion blocks and the head."""

UNIT = "ms"
LAYER = "neck"
MOVES = "frames_per_s"

SPANS = ("reassemble.", "fusion.", "head")


def read(record):
    t = record.trace
    ops = [o for o in t.ops if any(s.startswith(SPANS) for s in o.spans)]
    if not ops:
        return None
    return sum(o.seconds for o in ops) * 1e3 / t.frames
