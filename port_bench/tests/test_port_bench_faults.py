"""A run of a tiny cell on the CPU, the card's look skipped, with the timed
path sound and then broken underneath: ``correct`` comes out true, then
false for each fault a depth cell can have (an answer altered where it is
produced; half the batch left out, the rest's answers in its place; a step
that returns the previous step's answer unchanged)."""

import time

import pytest
import torch

from muggled_dpt_tpu_torch.dpt import DPTModel
from port_bench import cell as cell_run

SOUND = DPTModel.inference_rgb_device


def altered(self, frames, size):
    depth = SOUND(self, frames, size).clone()
    depth[0] = depth[0].flip(-1)
    return depth


def half_batch(self, frames, size):
    b = frames.shape[0]
    depth = SOUND(self, frames[: (b + 1) // 2], size)
    return torch.cat([depth, depth], dim=0)[:b]


def stale(self, frames, size):
    last = getattr(self, "_last_depth", None)
    depth = SOUND(self, frames, size)
    self._last_depth = depth
    return depth if last is None else last


def run(cell):
    return cell_run.run(cell, 2**31 + 77, 0.5, False, "cpu", time.perf_counter(), log=lambda line: None)


@pytest.mark.parametrize("name", ["tiny_dav2.tiny_b2", "tiny_beit.tiny_b2_beit"])
def test_sound_run_is_correct(name, tiny_cell):
    result = run(tiny_cell(name))
    assert result["correct"], result["checks"]
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert {"frames_per_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", [altered, half_batch, stale], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", ["tiny_dav2.tiny_b2", "tiny_beit.tiny_b2_beit"])
def test_broken_path_is_not_correct(name, fault, tiny_cell, monkeypatch):
    monkeypatch.setattr(DPTModel, "inference_rgb_device", fault)
    result = run(tiny_cell(name))
    assert not result["correct"], result["checks"]
    assert result["checks"]["depth_err_vs_bf16"]["value"] > result["checks"]["depth_err_vs_bf16"]["limit"]
