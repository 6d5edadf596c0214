"""Generic DPT model facade.

The same public surface as the JAX package's ``DPTModel``
(``muggled_dpt_tpu/dpt.py``): ``forward`` takes a normalized BCHW tensor and
returns (B, H, W) depth; ``inference`` takes a BGR uint8 (H, W, 3) numpy
frame and returns (1, H, W); ``inference_rgb_device`` takes an RGB uint8
(H, W, 3) or (B, H, W, 3) tensor, ideally already on the model's device.
Preprocessing (antialiased bilinear resize to the model's tiling, then
ImageNet normalization) runs on the device in float32.

float32 is the parity mode: while the model runs, TF32 is switched off for
both cuBLAS matmuls and cuDNN convolutions (cuDNN uses TF32 by default), and
both settings are restored afterwards."""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from .ops.resize import resize_2d


@contextlib.contextmanager
def _no_tf32():
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


class DPTModel:
    """Holds the family's ``nn.Module`` (``net``) with its dtype and device,
    plus the sizing and normalization the family needs.

    family_spec: dict with keys mean_rgb, std_rgb (floats 0..1),
    patch_size_px, tiling_size, default_size_px."""

    def __init__(self, net: torch.nn.Module, config_dict: dict, family_spec: dict, dtype=torch.float32):
        self.config = dict(config_dict)
        self.spec = family_spec
        self.net = net.eval()
        self.dtype = dtype
        self.device = next(net.parameters()).device
        self._mean = torch.tensor(family_spec["mean_rgb"], dtype=torch.float32, device=self.device).view(1, 3, 1, 1)
        self._std = torch.tensor(family_spec["std_rgb"], dtype=torch.float32, device=self.device).view(1, 3, 1, 1)
        self.patch_size_px = family_spec["patch_size_px"]
        self.tiling_size = family_spec["tiling_size"]
        self.default_size_px = family_spec["default_size_px"]

    def _precision(self):
        return _no_tf32() if self.dtype == torch.float32 else contextlib.nullcontext()

    def _prep(self, image_f32_nchw, scaled_hw):
        # resize (bilinear antialias, on 0..255 floats) then normalize
        x = resize_2d(image_f32_nchw, scaled_hw, antialias=True)
        return ((x / 255.0 - self._mean) / self._std).to(self.dtype)

    def _to_device_nchw(self, image_rgb_u8):
        """uint8 (H, W, 3) or (B, H, W, 3) -> float32 (B, 3, H, W) on the
        device; the antialiased resize needs a float input."""
        x = image_rgb_u8 if image_rgb_u8.dim() == 4 else image_rgb_u8[None]
        return x.to(self.device).permute(0, 3, 1, 2).float()

    def _infer(self, image_rgb_u8, scaled_hw):
        with torch.inference_mode(), self._precision():
            return self.net(self._prep(self._to_device_nchw(image_rgb_u8), scaled_hw))

    # -- public API -----------------------------------------------------------

    def forward(self, image_rgb_normalized_bchw):
        """Depth prediction on a preprocessed BCHW tensor -> (B, H, W)."""
        self.verify_input(image_rgb_normalized_bchw)
        x = torch.as_tensor(image_rgb_normalized_bchw).to(self.device, self.dtype)
        with torch.inference_mode(), self._precision():
            return self.net(x)

    __call__ = forward

    def inference(self, image_bgr: np.ndarray, max_side_length: int | None = None, use_square_sizing: bool = True):
        """Full preprocessing + forward on a BGR uint8 (H, W, 3) image -> (1, H, W)."""
        scaled_hw = self.compute_scaled_hw(image_bgr.shape[:2], max_side_length, use_square_sizing)
        image_rgb = torch.from_numpy(np.ascontiguousarray(image_bgr[..., ::-1]))
        return self._infer(image_rgb, scaled_hw)

    def inference_rgb_device(self, image_rgb_hw3: torch.Tensor, scaled_hw: tuple[int, int]):
        """Prep + forward on an RGB uint8 (H, W, 3) frame or (B, H, W, 3)
        batch, at a size from ``compute_scaled_hw`` -> (B, h, w). The same as
        ``inference`` minus the BGR flip and the sizing arithmetic."""
        return self._infer(image_rgb_hw3, tuple(scaled_hw))

    def prepare_image_bgr(self, image_bgr: np.ndarray, max_side_length: int | None = None, use_square_sizing: bool = True):
        """Preprocess a BGR uint8 image -> normalized (1, 3, h, w) tensor in the model's dtype."""
        scaled_hw = self.compute_scaled_hw(image_bgr.shape[:2], max_side_length, use_square_sizing)
        image_rgb = torch.from_numpy(np.ascontiguousarray(image_bgr[..., ::-1]))
        with torch.inference_mode():
            return self._prep(self._to_device_nchw(image_rgb), scaled_hw)

    def compute_scaled_hw(self, img_hw, max_side_length=None, use_square_sizing=True):
        """Round the target size to the model's tiling (twice the patch size)."""
        if max_side_length is None:
            max_side_length = self.default_size_px
        h, w = int(img_hw[0]), int(img_hw[1])
        largest = max(h, w)
        scale = max_side_length / largest
        targ = (largest, largest) if use_square_sizing else (h, w)
        tile = self.tiling_size
        return tuple(max(1, round(s * scale / tile)) * tile for s in targ)

    def verify_input(self, image_rgb_normalized_bchw) -> bool:
        shape = tuple(image_rgb_normalized_bchw.shape)
        if len(shape) != 4:
            raise ValueError(f"Bad image shape! {shape} should be BxCxHxW")
        b, c, h, w = shape
        p = self.patch_size_px
        if c != 3:
            raise ValueError(f"Bad channel count! Expected 3 got {c}")
        if h % p != 0 or w % p != 0:
            raise ValueError(f"Bad image size! Height ({h}) and width ({w}) must be divisible by {p}")
        return True

    def to(self, dtype):
        """Return a copy of this model with another compute dtype.

        Upcasting (e.g. bf16 -> f32) starts from THIS model's already-rounded
        weights: the result runs f32 arithmetic over bf16-rounded values. For
        the checkpoint-exact parity mode, reload with dtype=torch.float32."""
        if torch.finfo(dtype).bits > torch.finfo(self.dtype).bits:
            print(
                f"Note: .to({dtype}) upcasts {self.dtype}-rounded weights; "
                "for checkpoint-exact parity mode reload with dtype=torch.float32."
            )
        return DPTModel(copy.deepcopy(self.net).to(dtype), self.config, self.spec, dtype=dtype)
