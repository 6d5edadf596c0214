"""The temporal modules' share of their roofline, in %: the least time the card
could take for the traced steps' temporal modules (``counts``' ``temporal``:
each product at the dense peak or with its weight, input and output moved
once at HBM's rate, whichever is longer, and each temporal attention block's
4 T C operations a token or its q, k, v and output moved once) over the device
time of the operations that ``neck.temporal_device_ms`` reads. The
denominator holds the GroupNorms, LayerNorms, rearranges, position-encoding
adds, GEGLU gates and residuals too, which the bound does not count, so a
pass folded into a product moves the share. None where the counts have no
``temporal`` or the neck launches nothing outside its hooked modules."""

UNIT = "%"
LAYER = "neck"
MOVES = "frames_per_s"


def read(record):
    from port_bench import spec

    temporal = record.counts.get("temporal")
    if temporal is None:
        return None
    seconds = sum(o.seconds for o in spec.metric_reader("neck.temporal_device_ms").ops(record))
    if seconds <= 0:
        return None
    return 100.0 * record.trace.steps * temporal["bound_s"] / seconds
