"""Monocular-depth evaluation metrics: the counterpart of JAX
``utils/metrics.py`` on torch tensors.

Predictions are relative inverse depth, so by default each image is first
least-squares aligned (scale, shift) to its target, the alignment inside
``parallel/train.py:ssi_loss``; then AbsRel, RMSE, RMSE-log and the delta
thresholds, means over valid pixels per image and then over the batch.
Everything is computed in float32 on the inputs' device, mask-aware and
differentiable."""

from __future__ import annotations

import torch


def _flat(x, b):
    return torch.as_tensor(x).reshape(b, -1).float()


def align_scale_shift(pred_bhw, target_bhw, mask_bhw=None, eps: float = 1e-6):
    """Per-image least-squares (scale, shift) aligning pred to target.
    Returns the aligned predictions, float32, in the inputs' shape."""
    b = pred_bhw.shape[0]
    p, t = _flat(pred_bhw, b), _flat(target_bhw, b)
    m = torch.ones_like(p) if mask_bhw is None else _flat(mask_bhw, b)

    n = m.sum(dim=1) + eps
    sp = (m * p).sum(dim=1)
    st = (m * t).sum(dim=1)
    spp = (m * p * p).sum(dim=1)
    spt = (m * p * t).sum(dim=1)
    det = n * spp - sp * sp + eps
    scale = (n * spt - sp * st) / det
    shift = (spp * st - sp * spt) / det
    return (scale[:, None] * p + shift[:, None]).reshape(pred_bhw.shape)


def depth_metrics(pred_bhw, target_bhw, mask_bhw=None, align: bool = True, eps: float = 1e-6) -> dict:
    """Standard monocular-depth eval over a batch of (B, H, W) inverse-depth
    maps. mask: optional (B, H, W) validity weights. align=True applies the
    per-image SSI alignment first (relative-depth models); False for metric
    models, whose absolute scale is under test.

    Returns a dict of float32 scalar tensors (batch means over valid pixels):
      abs_rel   mean |p - t| / t          (over pixels with t > eps)
      rmse      sqrt(mean (p - t)^2)
      rmse_log  sqrt(mean (log p - log t)^2)   (positive p and t only)
      delta1/2/3  fraction with max(p/t, t/p) < 1.25 / 1.25^2 / 1.25^3
    """
    b = pred_bhw.shape[0]
    if align:
        pred_bhw = align_scale_shift(pred_bhw, target_bhw, mask_bhw, eps)
    p, t = _flat(pred_bhw, b), _flat(target_bhw, b)
    m = torch.ones_like(p) if mask_bhw is None else _flat(mask_bhw, b)

    def masked_mean(x, w):
        return (w * x).sum(dim=1) / (w.sum(dim=1) + eps)

    valid = m * (t > eps)
    # ratio metrics need positive predictions too (alignment can cross zero)
    both_pos = valid * (p > eps)
    pc = p.clamp_min(eps)
    tc = t.clamp_min(eps)

    abs_rel = masked_mean((p - t).abs() / tc, valid)
    rmse = masked_mean((p - t) ** 2, m).sqrt()
    rmse_log = masked_mean((pc.log() - tc.log()) ** 2, both_pos).sqrt()
    ratio = torch.maximum(pc / tc, tc / pc)
    out = {"abs_rel": abs_rel.mean(), "rmse": rmse.mean(), "rmse_log": rmse_log.mean()}
    for i, name in enumerate(("delta1", "delta2", "delta3")):
        out[name] = masked_mean((ratio < 1.25 ** (i + 1)).float(), both_pos).mean()
    return out
