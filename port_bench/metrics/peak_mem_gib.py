"""``torch.cuda.max_memory_allocated()`` over the window, after a reset at its
start, in GiB: the resident weights and per-grid aux with the activations."""

UNIT = "GiB"
LAYER = "end to end"
MOVES = "peak_mem_gib"


def read(record):
    peak = record.window.peak_bytes
    return peak / 2**30 if peak > 0 else None
