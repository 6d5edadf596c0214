"""The encoder's products' share of their roofline, in %: the least time the
card could take for every product of the encoder outside attention
(``counts``' ``encoder_dense``: the patch embed, qkv, proj and the MLP's
products, each at the dense peak or with its weight, input and output moved
once at HBM's rate, whichever is longer) over the device time of every
operation that ``encoder.device_ms`` counts except the attention kernels
(``attention.roofline_pct``'s ``PATTERNS``). The denominator holds the
encoder's LayerNorms, residuals, LayerScales and MLP activations too,
whatever kernel runs them, so folding one into a product's epilogue moves
the share and leaves the numerator as it is. None where the counts have no
``encoder_dense``."""

UNIT = "%"
LAYER = "encoder"
MOVES = "frames_per_s"


def read(record):
    from port_bench import spec

    dense = record.counts.get("encoder_dense")
    if dense is None:
        return None
    attention = spec.metric_reader("attention.roofline_pct").PATTERNS
    t = record.trace
    seconds = sum(o.seconds for o in t.ops
                  if "net" in o.spans and "neck" not in o.spans and not any(p in o.name for p in attention))
    if seconds <= 0:
        return None
    return 100.0 * t.steps * dense["bound_s"] / seconds
