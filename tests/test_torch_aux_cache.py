"""The facade's per-grid aux cache (BEiT's relative-position bias stack):
the JAX package's cache tests (tests/test_helpers_and_cache.py,
tests/test_ui_toolkit.py) ported to the PyTorch facade, with the budget
monkeypatched where the test needs a device it does not have."""

import gc

import numpy as np
import pytest
import torch

from muggled_dpt_tpu_torch import dpt as dpt_mod
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv2_dpt
from muggled_dpt_tpu_torch.models.beit import bias_build_bytes, calculate_bias_bytes, padded_tokens
from muggled_dpt_tpu_torch.models.beit_family import aux_bytes_estimate

GB = 1024**3


@pytest.fixture()
def beit():
    return make_beit_dpt(128, 2, 4, (16, 24, 32, 40), (6, 6), 16)


def test_beit_bias_budget_math():
    # BEiT-L-512 at 512^2: 24 layers x 16 heads x 1032^2 x 4 B (N = 1025 padded to a multiple of 8)
    per_layer = calculate_bias_bytes(1, 16, (32, 32))
    assert per_layer == 16 * 1032 * 1032 * 4
    assert calculate_bias_bytes(24, 16, (32, 32)) == 24 * per_layer
    # the estimate is the build's peak, in the model's dtype: the stack, one
    # layer's gather and the (N, N) int32 index
    cfg = {"num_blocks": 24, "num_heads": 16}
    index = 1025 * 1025 * 4
    assert aux_bytes_estimate(cfg, (32, 32), torch.bfloat16) == 25 * 16 * 1032 * 1032 * 2 + index
    assert aux_bytes_estimate(cfg, (32, 32), torch.float32) == 25 * 16 * 1032 * 1032 * 4 + index
    assert bias_build_bytes(24, 16, (32, 32), 2) == aux_bytes_estimate(cfg, (32, 32), torch.bfloat16)


def test_aux_is_the_padded_stack_in_the_model_dtype(beit):
    stack = beit._get_aux((6, 6))
    n = 37
    assert stack.shape == (4, 2, 40, 40) and stack.dtype == torch.float32
    assert not stack[..., n:, :].any() and not stack[..., :, n:].any()  # zero pads
    assert beit._get_aux((6, 6)) is stack  # served from the cache
    assert stack.numel() * stack.element_size() == calculate_bias_bytes(4, 2, (6, 6))
    assert aux_bytes_estimate(beit.config, (6, 6), torch.float32) > calculate_bias_bytes(4, 2, (6, 6))


def test_aux_budget_negative_cached_and_cumulative(beit, capsys):
    """An over-budget grid prints the cache-disabled warning once (the
    decision is negative-cached), and the CPU budget counts resident weights
    and cached grids against the flat 8 GB."""
    beit.spec = {**beit.spec, "aux_bytes_estimate": lambda cfg, grid, dtype: 1 << 62}
    assert beit._get_aux((8, 8)) is None
    assert "Caching disabled" in capsys.readouterr().out
    assert beit._get_aux((8, 8)) is None  # served from the negative cache
    assert "Caching disabled" not in capsys.readouterr().out
    assert dpt_mod.fits_device_budget(1 * GB, "cpu", resident_bytes=0)
    assert not dpt_mod.fits_device_budget(1 * GB, "cpu", resident_bytes=8 * GB)
    assert dpt_mod.fits_device_budget(1 * GB, "cpu", resident_bytes=8 * GB, reclaimable_bytes=4 * GB)


def test_aux_cache_lru_eviction(beit, monkeypatch):
    """A grid that does not fit evicts the least recently used grid; a grid
    that cannot fit even with an empty cache is negative-cached without
    evicting anything; a drained cache goes on with the precheck's verdict."""

    def positives():
        return [k for k, v in beit._aux_cache.items() if v is not None]

    # 1 byte per cached grid, 0 for the weights: "fits" means fewer than two grids
    cache_values = type({}.values())
    monkeypatch.setattr(
        dpt_mod, "_tensor_bytes", lambda ts: sum(t is not None for t in ts) if isinstance(ts, cache_values) else 0
    )
    monkeypatch.setattr(
        dpt_mod, "fits_device_budget", lambda needed, device, resident_bytes=0, reclaimable_bytes=0: resident_bytes - reclaimable_bytes < 2
    )
    a, b, c = (6, 6), (7, 7), (8, 8)
    aux_a = beit._get_aux(a)
    assert aux_a is not None and beit._get_aux(b) is not None
    assert positives() == [a, b]
    assert beit._get_aux(a) is aux_a  # recency bump: b is now the LRU
    assert beit._get_aux(c) is not None
    assert positives() == [a, c] and len(beit._aux_cache) == 2

    monkeypatch.setattr(dpt_mod, "fits_device_budget", lambda needed, device, resident_bytes=0, reclaimable_bytes=0: False)
    assert beit._get_aux((9, 9)) is None
    assert positives() == [a, c] and beit._aux_cache[(9, 9)] is None

    monkeypatch.setattr(
        dpt_mod, "fits_device_budget", lambda needed, device, resident_bytes=0, reclaimable_bytes=0: reclaimable_bytes > 0
    )
    assert beit._get_aux((10, 10)) is not None
    assert positives() == [(10, 10)]


def test_fits_device_budget_cuda_path_credits_reserved_and_reclaimable(monkeypatch):
    """On CUDA the free bytes are mem_get_info's plus the allocator's
    reserved-but-unallocated bytes; the empty-cache precheck also credits the
    evictable cached grids."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1 * GB, 80 * GB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 6 * GB)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 4 * GB)
    cuda = torch.device("cuda", 0)
    # free 1 GB + 2 GB reserved-unallocated = 3 GB, half of it usable
    assert dpt_mod.fits_device_budget(1 * GB, cuda)
    assert not dpt_mod.fits_device_budget(2 * GB, cuda)
    # crediting 4 GB of evictable grids: (3 + 4) / 2 = 3.5 GB
    assert dpt_mod.fits_device_budget(3 * GB, cuda, reclaimable_bytes=4 * GB)
    # resident bytes are already inside the device's own accounting
    assert dpt_mod.fits_device_budget(1 * GB, cuda, resident_bytes=100 * GB)


def test_clear_cache_and_disabled_cache(beit):
    beit._get_aux((6, 6))
    beit._aux_cache[(7, 7)] = None
    beit.clear_cache()
    assert beit._aux_cache == {}
    beit.config["enable_cache"] = False
    frame = np.random.default_rng(0).integers(0, 256, (60, 80, 3), np.uint8)
    depth = beit.inference(frame, 96)
    assert beit._get_aux((6, 6)) is None and beit._aux_cache == {}  # inline mode: nothing cached
    assert depth.shape == (1, 96, 96) and bool(torch.isfinite(depth).all())


def _live_tensors():
    gc.collect()
    return [o for o in gc.get_objects() if issubclass(type(o), torch.Tensor)]


def test_clear_cache_leaves_no_bias_or_index_behind(beit):
    """After clear_cache no bias stack and no (N, N) relative-position index
    of any grid the model served is alive: nothing outside the aux cache
    keeps them."""
    frame = np.random.default_rng(0).integers(0, 256, (60, 80, 3), np.uint8)
    for side in (96, 128, 160):
        beit.inference(frame, side)
    beit.clear_cache()
    sizes = {g * g + 1 for g in (6, 8, 10)} | {padded_tokens((g, g)) for g in (6, 8, 10)}
    left = [t for t in _live_tensors() if t.dim() >= 2 and t.shape[-1] in sizes and t.shape[-2] in sizes]
    assert left == []


def test_prewarm_returns_unique_sizes(beit):
    """As tests/test_ui_toolkit.py:66 for the JAX facade; prewarm also
    leaves each size's bias stack cached."""
    m = make_depthanythingv2_dpt(64, 1, 4, (8, 16, 32, 64), (8, 8), 16)
    assert m.prewarm([56, 56, 84], image_hw=(120, 160)) == [(56, 56), (84, 84)]
    assert beit.prewarm([96, 96, 128], image_hw=(120, 160)) == [(96, 96), (128, 128)]
    assert set(beit._aux_cache) == {(6, 6), (8, 8)}
