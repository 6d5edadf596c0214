"""Readings that a cell's limits are set from, on the card.

    python3 port_bench/calibrate.py --workload <name> --seeds 1 2 ... [--control-seeds 1 2 3]

For each seed: the weights and frames the run would make, the port built from
them, ``check_steps`` of the cell's steps through ``inference_rgb_device``,
and the numbers of ``check.py`` against the plain reference on the same
frames (the program's sound readings: the lower reading of each limit). For
each control seed, the control in the program's place on the same frames:
the reference with every product's operands in float8 e4m3 (the precision
below the configuration's bfloat16), which gives the upper reading. Prints
one line per seed and a JSON summary."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import check, frames, program, spec  # noqa: E402
from port_bench.cell import Client  # noqa: E402
from port_bench.reference import fp8_e4m3  # noqa: E402

def depths(model, cell, pool, steps: list, device) -> dict:
    """{step: the depth the timed path returns} for the steps given."""
    size = frames.scaled_hw(cell.config, cell.traffic)
    client = Client(model, pool, cell.traffic, size, torch.device(device))
    out = {}
    client.step(steps[0], client.scratch)  # warm-up
    for s in steps:
        buf = torch.empty_like(client.buffers[-1])
        client.step(s, buf)
        out[s] = buf
    return out


def readings(cell, seed: int, control: bool, device="cuda") -> dict:
    """{"program", "control": numbers (the control None without
    ``control``), "reference_s": seconds} for one seed."""
    config, traffic = cell.config, cell.traffic
    weights = spec.family_module("weights", config["family"])
    reference = spec.family_module("reference", config["family"])
    steps = list(range(traffic["check_steps"]))
    state_dict = weights.generate(config, seed, device, program.DTYPES[config["dtype"]])
    model = program.build(config, state_dict, device)
    pool = frames.make_pool(traffic, seed, device)
    got = {"program": depths(model, cell, pool, steps, device)}
    del model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    state_dict = {k: v.float() for k, v in state_dict.items()}
    t0 = time.perf_counter()
    refs, yard = check.yardstick(cell, reference, state_dict, pool, steps, device)
    ref_s = time.perf_counter() - t0
    if control:
        got["control"] = check.reference_depths(cell, reference, state_dict, pool, steps, device, fp8_e4m3)
    out = {"reference_s": ref_s, "control": None, "yardstick_frames": yard}
    for side, by_step in got.items():
        out[side], out[side + "_frames"] = check.compare([(s, by_step[s]) for s in steps], refs, yard, device)
    del state_dict, refs
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    summary = {"workload": args.workload, "program": {}, "control": {}}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        r = readings(cell, seed, seed in args.control_seeds)
        frames_of = {k[:-7]: [float(f"{e:.4g}") for e in v] for k, v in r.items() if k.endswith("_frames")}
        print(f"{args.workload} seed {seed}: program {r['program']} control {r['control']} "
              f"reference and yardstick {r['reference_s']:.3f} s; frame errors {frames_of}", flush=True)
        if seed in args.seeds:
            summary["program"][seed] = r["program"]
        if r["control"] is not None:
            summary["control"][seed] = r["control"]
    for side in ("program", "control"):
        for name in r["program"]:
            values = [v[name] for v in summary[side].values() if name in v]
            if values:
                summary[f"{side}_{name}_range"] = [min(values), max(values)]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
