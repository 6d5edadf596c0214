"""Device ms per frame of the operations launched from the net's entry to the
first reassembly stage's entry: the patch embed and the blocks, attention
included."""

UNIT = "ms"
LAYER = "encoder"
MOVES = "frames_per_s"


def read(record):
    t = record.trace
    ops = [o for o in t.ops if "net" in o.spans and "neck" not in o.spans]
    if not ops:
        return None
    return sum(o.seconds for o in ops) * 1e3 / t.frames
