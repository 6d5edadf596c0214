"""The facade's per-grid aux cache (BEiT's relative-position bias stack,
SwinV2's per-stage CPB stacks and shift masks):
the JAX package's cache tests (tests/test_helpers_and_cache.py,
tests/test_ui_toolkit.py) ported to the PyTorch facade, with the budget
monkeypatched where the test needs a device it does not have."""

import gc

import numpy as np
import pytest
import torch

from muggled_dpt_tpu_torch import dpt as dpt_mod
from muggled_dpt_tpu_torch import make_beit_dpt, make_depthanythingv2_dpt, make_swinv2_dpt
from muggled_dpt_tpu_torch.models import swinv2_family
from muggled_dpt_tpu_torch.models.beit import bias_build_bytes, calculate_bias_bytes, padded_tokens
from muggled_dpt_tpu_torch.models.beit_family import aux_bytes_estimate
from muggled_dpt_tpu_torch.models.swinv2 import aux_bytes

GB = 1024**3
DEVICE = "cpu"  # the entry points build on the CUDA card unless told otherwise


@pytest.fixture()
def beit():
    return make_beit_dpt(128, 2, 4, (16, 24, 32, 40), (6, 6), 16, device=DEVICE)


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
    m = make_depthanythingv2_dpt(64, 1, 4, (8, 16, 32, 64), (8, 8), 16, device=DEVICE)
    assert m.prewarm([56, 56, 84], image_hw=(120, 160)) == [(56, 56), (84, 84)]
    assert beit.prewarm([96, 96, 128], image_hw=(120, 160)) == [(96, 96), (128, 128)]
    assert set(beit._aux_cache) == {(6, 6), (8, 8)}


SWIN_L384 = {"features_per_stage": [192, 384, 768, 1536], "heads_per_stage": [6, 12, 24, 48],
             "layers_per_stage": [2, 2, 18, 2], "window_size_hw": (24, 24)}


@pytest.fixture()
def swin():
    return make_swinv2_dpt((16, 32, 64, 128), (2, 4, 4, 8), (2, 2, 2, 2), (16, 16), (4, 4), (None,) * 4, 16, device=DEVICE)


def test_nested_aux_bytes():
    """_tensor_bytes walks nested lists, tuples and dicts; None counts 0."""
    t = torch.zeros(3, 5)
    assert dpt_mod._tensor_bytes(None) == 0
    assert dpt_mod._tensor_bytes(t) == 60
    assert dpt_mod._tensor_bytes([{"cpb": t, "mask": None}, ({"cpb": t.bfloat16(), "mask": t}, [t])]) == 60 + 30 + 60 + 60
    assert dpt_mod._tensor_bytes({(6, 6): [{"cpb": t}], (7, 7): None}.values()) == 60


def test_swinv2_aux_bytes_math():
    """SwinV2-L-384 at 384x384 (grid 96): stages see grids 96/48/24/12 with
    windows 24/24/24/12; stages 1-2 shift (16 and 4 windows), 3-4 do not."""
    per_stage = [2 * 6 * 576**2, 2 * 12 * 576**2, 18 * 24 * 576**2, 2 * 48 * 144**2]
    masks = [16 * 576**2, 4 * 576**2]
    assert aux_bytes(SWIN_L384, (96, 96), 2) == 2 * (sum(per_stage) + sum(masks))
    # 512x512 (grid 128): the divisor search picks windows of 32 (A=1024) at stages 1-3 and 16 at stage 4
    per_stage = [2 * 6 * 1024**2, 2 * 12 * 1024**2, 18 * 24 * 1024**2, 2 * 48 * 256**2]
    assert aux_bytes(SWIN_L384, (128, 128), 4) == 4 * (sum(per_stage) + 16 * 1024**2 + 4 * 1024**2)
    est = swinv2_family.aux_bytes_estimate(SWIN_L384, (96, 96), torch.bfloat16)
    assert aux_bytes(SWIN_L384, (96, 96), 2) < est < aux_bytes(SWIN_L384, (96, 96), 2) + 64 * 1024**2


def test_swinv2_aux_is_counted_by_its_estimate_and_budget(swin):
    """The cached aux (per stage a CPB stack and a mask) has exactly the
    bytes ``aux_bytes`` counts, and the facade's budget sums it."""
    aux = swin._get_aux((16, 16))
    assert [tuple(a["cpb"].shape) for a in aux] == [(2, 2, 16, 16), (2, 4, 16, 16), (2, 4, 16, 16), (2, 8, 4, 4)]
    assert [None if a["mask"] is None else tuple(a["mask"].shape) for a in aux] == [(16, 16, 16), (4, 16, 16), None, None]
    assert swin._get_aux((16, 16)) is aux  # served from the cache
    assert dpt_mod._tensor_bytes(swin._aux_cache.values()) == aux_bytes(swin.config, (16, 16), 4)
    assert swinv2_family.aux_bytes_estimate(swin.config, (16, 16), torch.float32) > aux_bytes(swin.config, (16, 16), 4)


def test_swinv2_aux_lru_eviction(swin, monkeypatch):
    """A grid whose nested aux does not fit evicts the least recently used
    grid, as for BEiT's stacks: the budget sees every stage's tensors."""
    one_grid = aux_bytes(swin.config, (16, 16), 4)
    monkeypatch.setattr(dpt_mod, "fits_device_budget",
                        lambda needed, device, resident_bytes=0, reclaimable_bytes=0:
                        resident_bytes - reclaimable_bytes - dpt_mod._tensor_bytes(swin.net.parameters()) < 2 * one_grid)
    a, b, c = (16, 16), (16, 24), (24, 16)
    assert swin._get_aux(a) is not None and swin._get_aux(b) is not None
    assert swin._get_aux(a) is not None  # recency bump: b is now the LRU
    assert swin._get_aux(c) is not None
    assert list(swin._aux_cache) == [a, c]
    swin.clear_cache()
    assert swin._aux_cache == {}
