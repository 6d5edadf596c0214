"""``muggled_dpt_tpu_torch.utils.metrics`` against the JAX package's
``utils/metrics.py``: every case of tests/test_metrics.py on the port, and
on each the port's numbers equal to the JAX functions' on the same inputs
(made from a seed with numpy) within 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muggled_dpt_tpu.utils import metrics as jm
from muggled_dpt_tpu_torch.utils.metrics import align_scale_shift, depth_metrics

TOL = 1e-6
KEYS = {"abs_rel", "rmse", "rmse_log", "delta1", "delta2", "delta3"}


def _rand(shape, seed=0, lo=0.2, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _both(p, t, mask=None, align=True):
    """(port's metrics, JAX's) as floats; every key equal within TOL."""
    ours = {k: float(v) for k, v in depth_metrics(_t(p), _t(t), _t(mask), align=align).items()}
    theirs = {k: float(v) for k, v in
              jm.depth_metrics(jnp.asarray(p), jnp.asarray(t), None if mask is None else jnp.asarray(mask), align=align).items()}
    assert set(ours) == set(theirs) == KEYS
    for k in KEYS:
        assert abs(ours[k] - theirs[k]) <= TOL * max(1.0, abs(theirs[k])), (k, ours[k], theirs[k])
    return ours


def test_perfect_up_to_scale_shift():
    t = _rand((2, 16, 16))
    m = _both(4.0 * t - 0.3, t)  # alignment must recover this exactly
    assert m["abs_rel"] < 1e-5 and m["rmse"] < 1e-5 and m["delta1"] == 1.0


def test_unaligned_metrics_match_numpy():
    rng = np.random.default_rng(3)
    t = _rand((3, 8, 8), seed=1)
    p = np.clip(t * (1 + 0.1 * rng.standard_normal(t.shape).astype(np.float32)), 1e-3, None)
    m = _both(p, t, align=False)
    pf, tf = p.reshape(3, -1), t.reshape(3, -1)
    ratio = np.maximum(pf / tf, tf / pf)
    np.testing.assert_allclose(m["abs_rel"], (np.abs(pf - tf) / tf).mean(axis=1).mean(), rtol=1e-4)
    np.testing.assert_allclose(m["rmse"], np.sqrt(((pf - tf) ** 2).mean(axis=1)).mean(), rtol=1e-4)
    np.testing.assert_allclose(m["delta1"], (ratio < 1.25).mean(axis=1).mean(), rtol=1e-4)


def test_mask_excludes_corrupted_region():
    t = _rand((1, 12, 12))
    p = t.copy()
    p[:, :4, :] = 50.0  # corrupt a band
    mask = np.ones_like(t)
    mask[:, :4, :] = 0.0
    m = _both(p, t, mask, align=False)
    assert m["abs_rel"] < 1e-6 and m["delta1"] == 1.0
    assert _both(p, t, align=False)["abs_rel"] > 1.0


def test_align_flag_matters_for_metric_models():
    t = _rand((2, 8, 8))
    assert _both(2.0 * t, t, align=True)["abs_rel"] < 1e-5
    assert _both(2.0 * t, t, align=False)["abs_rel"] > 0.5  # 2x off everywhere


def test_align_scale_shift_recovers_parameters():
    t = _rand((2, 10, 10), seed=7)
    p = 0.5 * t + 0.2
    ours = align_scale_shift(_t(p), _t(t)).numpy()
    np.testing.assert_allclose(ours, t, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(jm.align_scale_shift(jnp.asarray(p), jnp.asarray(t))), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_batches_with_masks_and_sign_crossings(seed):
    """Noisy predictions crossing zero after alignment, weighted masks,
    targets with invalid (zero) pixels: both packages, aligned and not."""
    rng = np.random.default_rng(seed)
    t = _rand((3, 9, 11), seed=seed + 10, lo=0.0, hi=1.0)
    t[:, :2] = 0.0
    p = (t + 0.3 * rng.standard_normal(t.shape)).astype(np.float32)
    mask = (rng.uniform(size=t.shape) > 0.2).astype(np.float32)
    for align in (True, False):
        _both(p, t, mask, align=align)


def test_batched_and_differentiable():
    t = torch.from_numpy(_rand((4, 8, 8), seed=9))
    p = (t * 1.5).requires_grad_()
    m = depth_metrics(p, t)
    assert set(m) == KEYS and all(v.dtype == torch.float32 and torch.isfinite(v) for v in m.values())
    m["rmse"].backward()
    assert p.grad is not None and torch.isfinite(p.grad).all()
    # bfloat16 inputs are measured in float32
    m16 = depth_metrics(p.detach().bfloat16(), t.bfloat16())
    assert all(v.dtype == torch.float32 for v in m16.values())
