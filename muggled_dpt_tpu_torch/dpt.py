"""Generic DPT model facade.

The same public surface as the JAX package's ``DPTModel``
(``muggled_dpt_tpu/dpt.py``): ``forward`` takes a normalized BCHW tensor and
returns (B, H, W) depth; ``inference`` takes a BGR uint8 (H, W, 3) numpy
frame and returns (1, H, W); ``inference_rgb_device`` takes an RGB uint8
(H, W, 3) or (B, H, W, 3) tensor, ideally already on the model's device.
Preprocessing (antialiased bilinear resize to the model's tiling, then
normalization) runs on the device in float32.

Per-grid aux cache (a port of JAX ``dpt.py:102-166``): a family may define
``make_aux`` (BEiT: the grid's whole relative-position bias stack; SwinV2:
every block's CPB bias and every stage's shift mask). The
facade builds it once per patch grid, keeps the grids in least-recently-used
order within a device-memory budget, remembers a grid that never fits, and
passes the aux to the net's forward; with ``enable_cache=False`` it passes
None and the net builds what it needs inline.

float32 is the parity mode: while the model runs, TF32 is switched off for
both cuBLAS matmuls and cuDNN convolutions (cuDNN uses TF32 by default), and
both settings are restored afterwards.

``quantize_encoder_int8`` returns the opt-in int8 serving tier of a model
(``ops/quant.py``), a port of JAX ``dpt.py:288-367``."""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from .ops import quant
from .ops.resize import resize_2d

FALLBACK_BUDGET_BYTES = 8 * 1024**3  # where the device reports no memory stats (the CPU)
CUDA_BUDGET_FRACTION = 0.5  # share of the card's free bytes an aux may take: headroom for activations


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


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: ``device`` as given, or the
    current CUDA card when it is None. Without a card, None raises: a model
    runs on the CPU only when the caller asks for ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port builds on the card by default; pass device="cpu" to run on the CPU')
    return torch.device("cuda", torch.cuda.current_device())


def assemble_model(net_cls, config_dict: dict, state_dict: dict, family_spec: dict, dtype=torch.float32, device=None):
    """A DPTModel from an already-converted state dict: the modules are made
    on the meta device and take the given tensors, cast to ``dtype`` on
    ``device`` (None: the CUDA card, see ``resolve_device``), without a
    throwaway random init."""
    device = resolve_device(device)
    with torch.device("meta"):
        net = net_cls(config_dict)
    sd = {k: v.to(device=device, dtype=dtype) for k, v in state_dict.items()}
    net.load_state_dict(sd, strict=True, assign=True)
    return DPTModel(net, config_dict, family_spec, dtype=dtype)


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor in a tensor, or a nested list, tuple, dict or
    other iterable of them (a SwinV2 aux: per stage a CPB stack and a mask);
    None counts 0."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_tensor_bytes(t) for t in (tree.values() if isinstance(tree, dict) else tree))


def fits_device_budget(needed_bytes: int, device, resident_bytes: int = 0, reclaimable_bytes: int = 0) -> bool:
    """True if ``needed_bytes`` fits in ``CUDA_BUDGET_FRACTION`` of the device's free memory.

    On CUDA the free bytes are ``mem_get_info``'s plus what the caching
    allocator holds reserved but unallocated (``mem_get_info`` counts that as
    used), plus ``reclaimable_bytes``: the cached grids the caller is willing
    to evict, which are allocated and so not yet free. Where the device
    reports no memory stats (the CPU) the budget is a flat 8 GB for
    ``resident_bytes`` (weights plus cached grids) minus ``reclaimable_bytes``
    plus the request."""
    device = torch.device(device)
    if device.type != "cuda":
        return resident_bytes - reclaimable_bytes + needed_bytes < FALLBACK_BUDGET_BYTES
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return needed_bytes < (free + reclaimable_bytes) * CUDA_BUDGET_FRACTION


class DPTModel:
    """Holds the family's ``nn.Module`` (``net``) with its dtype and device,
    plus the sizing and normalization the family needs.

    family_spec: dict with keys mean_rgb, std_rgb (floats 0..1),
    patch_size_px, tiling_size, default_size_px; optionally make_aux(net,
    grid_hw, dtype), aux_bytes_estimate(config, grid_hw, dtype),
    forward_capture(net, image_nchw, aux) -> (depth, internals) and
    head_upsample (the head's upsample factor)."""

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
        self._aux_cache: dict = {}  # grid -> aux, least recently used first; None = never fits

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

    def _run(self, x):
        """The net on a preprocessed (B, 3, h, w) tensor, with its grid's aux."""
        p = self.patch_size_px
        aux = self._get_aux((x.shape[-2] // p, x.shape[-1] // p))
        return self.net(x, aux)

    def _infer(self, image_rgb_u8, scaled_hw):
        with torch.inference_mode(), self._precision():
            return self._run(self._prep(self._to_device_nchw(image_rgb_u8), scaled_hw))

    # -- per-grid aux cache ----------------------------------------------------

    def _get_aux(self, grid_hw):
        """The grid's aux from the cache, built on a miss; None when the
        family has none, caching is off or the grid never fits the budget."""
        make_aux = self.spec.get("make_aux")
        if make_aux is None or not self.config.get("enable_cache", True):
            return None
        grid_hw = tuple(int(g) for g in grid_hw)
        if grid_hw in self._aux_cache:
            self._aux_cache[grid_hw] = self._aux_cache.pop(grid_hw)  # most recently used last
            return self._aux_cache[grid_hw]
        estimate = self.spec.get("aux_bytes_estimate")
        if estimate is not None:
            needed = estimate(self.config, grid_hw, self.dtype)
            params_bytes = _tensor_bytes([*self.net.parameters(), *self.net.buffers()])
            cache_bytes = _tensor_bytes(self._aux_cache.values())
            if not fits_device_budget(needed, self.device, resident_bytes=params_bytes + cache_bytes,
                                      reclaimable_bytes=cache_bytes):
                # does not fit even with an empty cache: remember that, and
                # keep the cached grids, which evicting would not help
                print("*** WARNING ***\nNot enough device memory for relpos caching! Caching disabled for this grid...")
                self._aux_cache[grid_hw] = None
                return None
            while not fits_device_budget(needed, self.device,
                                         resident_bytes=params_bytes + _tensor_bytes(self._aux_cache.values())):
                lru = next((k for k, v in self._aux_cache.items() if v is not None), None)
                if lru is None:  # drained: go on with the empty-cache verdict
                    break
                del self._aux_cache[lru]
        with torch.inference_mode():
            aux = make_aux(self.net, grid_hw, self.dtype)
        self._aux_cache[grid_hw] = aux
        return aux

    def clear_cache(self):
        """Drop every cached per-grid aux."""
        self._aux_cache.clear()

    def prewarm(self, max_side_lengths, use_square_sizing=True, image_hw=(720, 1280)):
        """Run one request per distinct scaled size of ``max_side_lengths``
        (for a frame of ``image_hw``), so the first real request at each size
        finds its aux built and the card's kernels loaded. Returns the scaled
        sizes, each once, in order."""
        warmed = []
        dummy = np.zeros((*image_hw, 3), dtype=np.uint8)
        for side in max_side_lengths:
            scaled = self.compute_scaled_hw(image_hw, side, use_square_sizing)
            if scaled in warmed:
                continue
            self.inference(dummy, side, use_square_sizing)
            warmed.append(scaled)
        return warmed

    # -- public API -----------------------------------------------------------

    def forward(self, image_rgb_normalized_bchw):
        """Depth prediction on a preprocessed BCHW tensor -> (B, H, W)."""
        self.verify_input(image_rgb_normalized_bchw)
        x = torch.as_tensor(image_rgb_normalized_bchw).to(self.device, self.dtype)
        with torch.inference_mode(), self._precision():
            return self._run(x)

    __call__ = forward

    def forward_with_internals(self, image_rgb_normalized_bchw):
        """Introspection: ``forward`` on the plain attention path (a flash
        kernel never holds the softmax weights), keeping what the net made
        on the way. Returns (depth (B, H, W), internals): "block_tokens",
        one per block ((B, 1+N, F) for the ViTs, (B, gh*gw, C) for SwinV2);
        "attention", one per block, float32 softmax weights ((B, H, N, N);
        SwinV2 (B, nW, H, A, A) in the rolled window frame); the 4
        "reassembly_maps" and the "fused_map", NCHW (the JAX package's are
        NHWC). Raises NotImplementedError for a family without capture."""
        capture = self.spec.get("forward_capture")
        if capture is None:
            raise NotImplementedError("no capture mode for this model family")
        self.verify_input(image_rgb_normalized_bchw)
        x = torch.as_tensor(image_rgb_normalized_bchw).to(self.device, self.dtype)
        p = self.patch_size_px
        with torch.inference_mode(), self._precision():
            return capture(self.net, x, self._get_aux((x.shape[-2] // p, x.shape[-1] // p)))

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

    def prepare_image_bgr(
        self,
        image_bgr: np.ndarray,
        max_side_length: int | None = None,
        use_square_sizing: bool = True,
        interpolation_mode: str = "bilinear",
    ):
        """Preprocess a BGR uint8 image -> normalized (1, 3, h, w) tensor in
        the model's dtype. Only bilinear preprocessing exists."""
        if interpolation_mode != "bilinear":
            raise ValueError(f"only bilinear preprocessing is supported, got interpolation_mode={interpolation_mode!r}")
        scaled_hw = self.compute_scaled_hw(image_bgr.shape[:2], max_side_length, use_square_sizing)
        image_rgb = torch.from_numpy(np.ascontiguousarray(image_bgr[..., ::-1]))
        with torch.inference_mode():
            return self._prep(self._to_device_nchw(image_rgb), scaled_hw)

    def prepare_image_bgr_nhwc(self, image_bgr: np.ndarray, max_side_length=None, use_square_sizing=True):
        """``prepare_image_bgr`` as a (1, h, w, 3) tensor on the model's
        device, in its dtype, with no host sync: the batching entry of
        ``parallel.BatchParallelRunner`` callers, the JAX package's NHWC
        contract. A channels-last view of the BCHW preprocessing, which the
        runner turns back into BCHW as a permuted view."""
        return self.prepare_image_bgr(image_bgr, max_side_length, use_square_sizing).permute(0, 2, 3, 1)

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
        net = copy.deepcopy(self.net)
        # int8 scales and act_smooth stay float32 (ops/quant.py:is_scale_key)
        kept = {name: t for name, t in net.named_buffers() if quant.is_scale_key(name)}
        net.to(dtype)
        for name, t in kept.items():
            parent, _, leaf = name.rpartition(".")
            setattr(net.get_submodule(parent), leaf, t)
        return DPTModel(net, self.config, self.spec, dtype=dtype)

    def quantize_encoder_int8(self, include_qkv: bool = False, calibration_images=None, max_side_length=None,
                              include_neck: bool = False):
        """Opt-in int8 (w8a8) serving tier: a copy of this model whose encoder
        linears are symmetric per-channel int8 with per-token int8
        activations (``ops/quant.py``). include_qkv=False (the default) keeps
        the attention's qkv projection dense: softmax amplifies qkv
        quantization noise. DINOv2 (Depth-Anything V1/V2, ViT-Giant's SwiGLU
        included) and BEiT quantize every block linear of the subset; SwinV2
        only its MLP (its window qkv and proj stay dense).

        calibration_images: optional BGR uint8 frames for SmoothQuant
        calibration: this model runs on each (at ``max_side_length``) while
        the encoder's per-channel input maxima are recorded, and the outlier
        magnitude they show is moved from the activations into the int8
        weights (``ops/quant.py:compute_smoothing``). DINOv2 and BEiT only.
        include_neck: the reassembly and readout projections, the fusion
        blocks' convolutions and 1x1 outputs and the head's conv_in and
        conv_mid go int8 too (``ops/quant.py:quantize_neck``)."""
        blocks = getattr(self.net.encoder, "blocks", None)
        subset = quant.QUANTIZABLE if include_qkv else tuple(n for n in quant.QUANTIZABLE if n != "qkv")
        smoothing = None
        if calibration_images is not None:
            if blocks is None:
                raise NotImplementedError("int8 calibration: only the stacked-blocks encoders (DINOv2/BEiT)")
            with quant.collect_activation_stats() as stats:
                for img in calibration_images:
                    quant.reset_collection_pass()
                    self.forward(self.prepare_image_bgr(img, max_side_length))
            if not stats:
                # the tier would silently degrade to dynamic quantization,
                # which the calibration images were passed to avoid
                raise RuntimeError("int8 calibration recorded no activation stats; refusing to quantize "
                                   "without the smoothing the calibration images were for")
            weights = quant.stacked_weights(blocks, subset)
            smoothing = quant.compute_smoothing(weights, stats, subset)
            missing = [n for n in subset if n in weights and n not in smoothing]
            if missing:
                print(f"int8 calibration: no activation stats for {missing}; those stay dynamic-only")
        net = copy.deepcopy(self.net)
        if blocks is not None:
            quant.quantize_blocks(net.encoder.blocks, subset, smoothing)
        elif hasattr(net.encoder, "stages"):
            quant.quantize_blocks([b for stage in net.encoder.stages for b in stage], [n for n in subset if n in ("fc1", "fc2")])
        else:
            raise NotImplementedError("int8 tier: unrecognized encoder layout")
        if include_neck:
            quant.quantize_neck(net)
        return DPTModel(net, self.config, self.spec, dtype=self.dtype)
