"""Device ms per frame of the operations launched inside the ``neck`` span but
in no reassembly stage, fusion block or head: in Video Depth Anything the four
temporal motion modules, which its net runs between those modules. None where
the neck launches nothing outside them."""

UNIT = "ms"
LAYER = "neck"
MOVES = "frames_per_s"

SPANS = ("reassemble.", "fusion.", "head")


def ops(record) -> list:
    """The device operations of the traced steps launched in ``neck`` and outside every hooked neck module."""
    return [o for o in record.trace.ops if "neck" in o.spans and not any(s.startswith(SPANS) for s in o.spans)]


def read(record):
    found = ops(record)
    if not found:
        return None
    return sum(o.seconds for o in found) * 1e3 / record.trace.frames
