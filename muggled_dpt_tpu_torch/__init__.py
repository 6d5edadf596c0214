"""muggled_dpt_tpu_torch -- the PyTorch + CUDA port of muggled_dpt_tpu for
NVIDIA Hopper (H100).

Depth-Anything V2 runs end to end: original ``.pth`` checkpoints load
unchanged, plain torch ops carry the GEMMs, norms, convolutions and resizes,
and attention goes through a hand-written CUDA kernel
(``csrc/flash_attention_fused_qkv.cu``) built by nvcc at first use. The
package imports neither jax nor ``muggled_dpt_tpu``."""

from .dpt import DPTModel
from .make_depthanythingv2_dpt import make_depthanythingv2_dpt, make_depthanythingv2_dpt_from_original_state_dict
from .make_dpt import make_dpt_from_state_dict

__all__ = [
    "DPTModel",
    "make_dpt_from_state_dict",
    "make_depthanythingv2_dpt",
    "make_depthanythingv2_dpt_from_original_state_dict",
]

__version__ = "0.1.0"
