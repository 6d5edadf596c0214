"""Intermediate-output capture, the counterpart of JAX
``demo_helpers/model_capture.py``.

The original registers forward hooks on modules of a chosen type. The port,
like the JAX package, gets the intermediates from one introspection forward
(``DPTModel.forward_with_internals``); this class gives them the original's
capture-object ergonomics for the analysis experiments."""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a CPU numpy array; bfloat16, which numpy
    has no type for, becomes float32."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class ModelOutputCapture:
    """Capture intermediates of one forward pass.

    target: 'attention' (per-block softmax maps), 'block_tokens' (per-block
    token outputs), 'reassembly_maps' or 'fused_map' (NCHW). After ``run``,
    the captured results are CPU numpy arrays, read by indexing this object
    (list-like, as the original's capture results)."""

    def __init__(self, dpt_model, target: str = "attention"):
        self._model = dpt_model
        self._target = target
        self.results: list = []
        self.depth = None

    def run(self, image_rgb_normalized_bchw):
        depth, internals = self._model.forward_with_internals(image_rgb_normalized_bchw)
        captured = internals[self._target]
        if not isinstance(captured, (list, tuple)):
            captured = [captured]
        self.results = [to_numpy(c) for c in captured]
        self.depth = to_numpy(depth)
        return self.depth

    def __len__(self):
        return len(self.results)

    def __getitem__(self, idx):
        return self.results[idx]

    def __iter__(self):
        return iter(self.results)
