"""The comparison that decides ``correct``: the depth maps that timed steps
produced, against the plain float32 reference on the same frames and the
same original weights.

Per frame, the error is the mean absolute difference from the float32
reference over the reference's spread, its mean absolute deviation from its
own mean: random weights give depth maps that sit on an offset, and the
error is of the structure on top. How far rounding moves the depth differs
from seed to seed (the random weights of one seed amplify it several times
more than another's), so the number compared divides it out: the same
reference run with every product's operands rounded to bfloat16 (the
rounding a bfloat16 model cannot avoid) gives the yardstick on the same
frames. The number compared, against its limit from ``limits/<workload>.json``:

* ``depth_err_vs_bf16``: the compared frames' mean error over the mean error
  of the bfloat16-rounded reference on the same frames."""

from __future__ import annotations

import sys

import torch

NUMBERS = ("depth_err_vs_bf16",)


def frame_errors(got: torch.Tensor, ref: torch.Tensor) -> list:
    """(B, h, w) depth from the program and the reference -> B errors, each the
    mean absolute difference over the reference frame's mean absolute
    deviation. A shape mismatch or a value that is not finite reads infinite."""
    if got.shape != ref.shape:
        return [float("inf")] * ref.shape[0]
    got, ref = got.float().flatten(1), ref.flatten(1)
    spread = (ref - ref.mean(1, keepdim=True)).abs().mean(1)
    err = (got - ref).abs().mean(1) / spread.clamp_min(1e-30)
    err = torch.where(torch.isfinite(got).all(1), err, torch.full_like(err, float("inf")))
    return [float(e) for e in err]


def mean(values: list) -> float:
    return sum(values) / len(values) if values else float("inf")


def readings(errors: list, yardstick: list) -> dict:
    """Each number compared, from the compared frames' errors and the
    bfloat16-rounded reference's on the same frames."""
    ratio = mean(errors) / max(mean(yardstick), 1e-30)
    return {"depth_err_vs_bf16": min(ratio, sys.float_info.max)}  # JSON has no infinity


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct where every number is at or under its limit."""
    table = {name: {"value": values[name], "limit": limits["numbers"][name]["limit"]} for name in NUMBERS}
    return all(v["value"] <= v["limit"] for v in table.values()), table


def lines(table: dict) -> list:
    """One line per number compared, with its limit."""
    return [f"check {name}: {v['value']!r} limit {v['limit']!r}" for name, v in table.items()]


def reference_depths(cell, reference, state_dict32: dict, pool: torch.Tensor, steps: list, device, q=None) -> dict:
    """{step: (B, h, w) float32 reference depth} for the steps given, in full
    float32 with TF32 off; ``q`` rounds the products' operands (the control)."""
    from .frames import scaled_hw, step_frames
    from .reference import exact, no_tf32

    size = scaled_hw(cell.config, cell.traffic)
    out = {}
    with no_tf32():
        for step in steps:
            frames = pool[step_frames(cell.traffic, step)].to(device)
            out[step] = reference.forward(state_dict32, cell.config, frames, size, q or exact)
    return out


def yardstick(cell, reference, state_dict32: dict, pool: torch.Tensor, steps: list, device) -> tuple:
    """(the float32 reference's depth by step, the bfloat16-rounded reference's
    frame errors in step order)."""
    from .reference import bf16

    refs = reference_depths(cell, reference, state_dict32, pool, steps, device)
    rounded = reference_depths(cell, reference, state_dict32, pool, steps, device, bf16)
    errors = []
    for step in steps:
        errors += frame_errors(rounded.pop(step), refs[step])
    return refs, errors


def compare(kept: list, refs: dict, yard: list, device) -> tuple:
    """(numbers, frame errors) of the (step, depth) pairs against the reference."""
    errors = []
    for step, depth in kept:
        errors += frame_errors(depth.to(device), refs[step])
    return readings(errors, yard), errors
