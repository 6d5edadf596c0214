"""Device ms per frame of the encoder's glue: the operations that
``encoder.device_ms`` counts (launched from the net's entry to the first
reassembly stage's entry) that are neither a matrix product or convolution
(cuBLAS, cuDNN and CUTLASS kernels, named in ``PRODUCTS``) nor an attention
kernel (``attention.roofline_pct``'s ``PATTERNS``). In a SwinV2 cell that is
the float32 cosine normalization of q and k, the rolls, the window
partition and merge copies, the casts, the post-norm LayerNorms, GELU and
the residual adds.

It reads kernel names, not the program's ``window`` and ``cosine`` spans:
the trace attributes device operations to the harness's ``pb:`` ranges
only."""

UNIT = "ms"
LAYER = "encoder"
MOVES = "frames_per_s"

PRODUCTS = ("nvjet", "gemm", "xmma", "cutlass", "cublas", "cudnn", "splitKreduce")


def read(record):
    from port_bench import spec

    attention = spec.metric_reader("attention.roofline_pct").PATTERNS
    t = record.trace
    ops = [o for o in t.ops if "net" in o.spans and "neck" not in o.spans]
    if not ops:
        return None
    glue = [o for o in ops if not any(p in o.name for p in PRODUCTS + attention)]
    return sum(o.seconds for o in glue) * 1e3 / t.frames
