"""The whole step's share of the card's peak, in %: the model's operations
per frame (``counts``: GEMMs, attention, convolutions, from the widths and
the cell's shapes) times the frames of the untraced window over its
seconds, over the dense peak of the configuration's type."""

UNIT = "%"
LAYER = "device"
MOVES = "frames_per_s"


def read(record):
    from port_bench.peaks import FLOPS_PER_S

    w = record.window
    rate = record.counts["model_flops_per_frame"] * w.frames / w.seconds
    return 100.0 * rate / FLOPS_PER_S[record.cell.config["dtype"]]
