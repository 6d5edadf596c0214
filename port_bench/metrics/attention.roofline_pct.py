"""The attention's share of its roofline, in %: the least time the card could
take for the traced steps' attention (``counts``: 4 B H N^2 D operations at
the dense peak, or q, k, v, out and any bias read once at HBM's rate,
whichever is longer) over the device time of the operations whose names
match ``PATTERNS``: every attention kernel of the port (the global
attention routes, the long-sequence and staged ones, the variants, the int8
ones and SwinV2's window attention) and PyTorch's own SDPA kernels, so
attention that another route or family runs is still read."""

UNIT = "%"
LAYER = "attention kernels"
MOVES = "frames_per_s"

PATTERNS = ("fa_sm90", "fa_mma", "fa_f32", "fa_i8", "fa_int8", "fxl_sm90", "fst_sm90", "fv_sm90", "fv_f32", "wa_sm90",
            "wa_mma", "wa_f32", "flash_fwd", "fmha", "attention_kernel", "efficient_attention")


def read(record):
    t = record.trace
    seconds = sum(o.seconds for o in t.ops if "entry" in o.spans and any(p in o.name for p in PATTERNS))
    if seconds <= 0:
        return None
    return 100.0 * t.steps * record.counts["attention"]["bound_s"] / seconds
