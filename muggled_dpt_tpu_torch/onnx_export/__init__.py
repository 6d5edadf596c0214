"""ONNX export of the port's DPT models without an `onnx` dependency.

* proto.py    — protobuf wire codec for the ONNX schema subset
* builder.py  — GraphProto builder + numpy<->TensorProto helpers
* emit_dpt.py — DPT forwards (Depth-Anything, BEiT, SwinV2) -> ONNX graphs
* evaluate.py — numpy reference evaluator (the correctness oracle)

The port's own copies of the JAX package's ``onnx_export`` modules, reading
the port's modules and state. User surface:
``python -m muggled_dpt_tpu_torch.experiments.export_onnx`` (CLI) or:

    from muggled_dpt_tpu_torch.onnx_export import emit_depth_anything_onnx
    onnx_bytes = emit_depth_anything_onnx(model, model.compute_scaled_hw(img.shape[:2]))
"""

from .emit_dpt import emit_beit_onnx, emit_depth_anything_onnx, emit_swinv2_onnx, emitter_for
from .evaluate import evaluate_model
from .proto import decode_message, encode_message

__all__ = [
    "emit_beit_onnx",
    "emit_depth_anything_onnx",
    "emit_swinv2_onnx",
    "emitter_for",
    "evaluate_model",
    "decode_message",
    "encode_message",
]
