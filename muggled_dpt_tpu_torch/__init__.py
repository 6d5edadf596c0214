"""muggled_dpt_tpu_torch -- the PyTorch + CUDA port of muggled_dpt_tpu for
NVIDIA Hopper (H100).

Depth-Anything V1 and V2 (ViT-S/B/L/Giant, metric head), MiDaS v3.1 BEiT,
MiDaS v3.1 SwinV2 and Video Depth Anything (DA-V2 with four temporal modules
in its neck; a call's frames are one clip of up to 32) run end to end:
original checkpoints load unchanged, plain
torch ops carry the GEMMs, norms, convolutions and resizes, and attention goes
through hand-written CUDA kernels built by nvcc at first use:
``csrc/flash_attention.cu`` (DA, and BEiT with its relative-position bias) and
``csrc/window_attention.cu`` (SwinV2's window attention with its CPB bias and
shift mask). More kernels stand beside the models' own layers:
``csrc/fused_mlp.cu`` (LayerNorm -> MLP -> LayerScale residual, the second half
of a GELU block), ``csrc/head_tail.cu`` (the depth head's last 3x3 conv,
ReLU, 1x1 projection and activation), ``csrc/upsample_bilinear_ac.cu`` (the
neck's align-corners upsample), ``csrc/cosine_qk.cu`` (SwinV2's cosine
normalization of q and k) and ``csrc/postnorm_residual.cu`` (SwinV2's
post-norm residual, x + LayerNorm(h), with the window merge and the roll
back folded into its read of h) and ``csrc/swiglu_gate.cu`` (ViT-Giant's
SwiGLU gate, silu(a) * b over w12's output in one pass). Entry points build on the CUDA card
unless given ``device="cpu"``. The apps run as modules of the package
(``python -m muggled_dpt_tpu_torch.run_image``, ``run_video``,
``run_3dviewer``), as do the examples and analysis experiments. The package
imports neither jax nor ``muggled_dpt_tpu``."""

from .dpt import DPTModel
from .make_beit_dpt import make_beit_dpt, make_beit_dpt_from_midas_v31_state_dict
from .make_depthanythingv1_dpt import make_depthanythingv1_dpt, make_depthanythingv1_dpt_from_original_state_dict
from .make_depthanythingv2_dpt import make_depthanythingv2_dpt, make_depthanythingv2_dpt_from_original_state_dict
from .make_dpt import make_dpt_from_state_dict
from .make_swinv2_dpt import make_swinv2_dpt, make_swinv2_dpt_from_midas_v31_state_dict

__all__ = [
    "DPTModel",
    "make_dpt_from_state_dict",
    "make_depthanythingv1_dpt",
    "make_depthanythingv1_dpt_from_original_state_dict",
    "make_depthanythingv2_dpt",
    "make_depthanythingv2_dpt_from_original_state_dict",
    "make_beit_dpt",
    "make_beit_dpt_from_midas_v31_state_dict",
    "make_swinv2_dpt",
    "make_swinv2_dpt_from_midas_v31_state_dict",
]

__version__ = "0.1.0"
