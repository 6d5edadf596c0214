"""Train-state checkpoint and resume: the counterpart of JAX
``parallel/checkpoint.py`` (orbax) on ``torch.save``.

Layout: ``<ckpt_dir>/step_<N>/state.pt`` holding the model's and the
optimizer's ``state_dict`` and the step; the step number in the folder name
is what ``latest_step`` reads back. Rank 0 writes into a temporary folder
and renames it into place only after a complete write, so a crash mid-save
never leaves a partial ``step_<N>``; every rank then waits at a barrier.

The file always holds the whole, unsharded state. A net split over a model
axis (``parallel/tensor.py``) gathers each split parameter and its AdamW
moments to their full shape over its model group before rank 0 writes, and
a restore slices them again for the mesh it is restored on. So a
checkpoint restores at any mesh shape and world size, a single process
included, and a single process's checkpoint restores onto any mesh."""

from __future__ import annotations

import os
import os.path as osp
import re
import shutil

import torch
import torch.distributed as dist

from .mesh import world
from .tensor import gather_full

_STEP_RE = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return osp.join(osp.abspath(ckpt_dir), f"step_{step}")


def _barrier():
    if world()[1] > 1:
        dist.barrier()


def list_steps(ckpt_dir: str) -> list[int]:
    """Saved step numbers in ascending order ([] if the folder does not exist)."""
    if not osp.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and osp.isfile(osp.join(ckpt_dir, name, STATE_FILE)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _resplit(net, params: dict, opt_state: dict, optimizer, piece) -> tuple[dict, dict]:
    """``params`` and ``opt_state`` with every tensor of a split parameter
    of ``net`` (the parameter, and each AdamW moment of its shape) replaced
    by ``piece(tensor, split)``; unchanged for a net that is not split. The
    optimizer's state indices run over its parameter groups in order, as
    ``state_dict`` numbers them."""
    tp = getattr(net, "tensor_parallel", None)
    if tp is None or not tp.splits:
        return params, opt_state
    params = {k: piece(v, tp.splits[k]) if k in tp.splits else v for k, v in params.items()}
    names = {id(p): n for n, p in net.named_parameters()}
    splits = [tp.splits.get(names.get(id(p))) for group in optimizer.param_groups for p in group["params"]]
    state = {i: {k: piece(v, splits[i]) if splits[i] is not None and v.dim() else v for k, v in moments.items()}
             for i, moments in opt_state["state"].items()}
    return params, {**opt_state, "state": state}


def save_train_state(ckpt_dir: str, step: int, params, opt_state, keep: int | None = 3) -> str:
    """Write ``<ckpt_dir>/step_<step>`` from the module ``params`` and the
    optimizer ``opt_state``. Prunes to the newest ``keep`` steps. Returns
    the path; every rank returns after the write. A split net's tensors are
    gathered whole first: a collective over each model group, so every rank
    calls it."""
    path = _step_dir(ckpt_dir, step)
    tp = getattr(params, "tensor_parallel", None)
    state, opt = _resplit(params, params.state_dict(), opt_state.state_dict(), opt_state,
                          lambda t, split: gather_full(t, split, tp))
    if world()[0] == 0:
        os.makedirs(osp.abspath(ckpt_dir), exist_ok=True)
        tmp = path + f".tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"params": state, "opt_state": opt, "step": int(step)}, osp.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        if keep is not None:
            for old in list_steps(ckpt_dir)[:-keep]:
                shutil.rmtree(_step_dir(ckpt_dir, old), ignore_errors=True)
    _barrier()
    return path


def restore_train_state(ckpt_dir: str, params, opt_state, step: int | None = None):
    """Load a saved step (None: the latest) into the module ``params`` and
    the optimizer ``opt_state``, on the devices they live on; a split net
    takes its rank's slices. Returns (params, opt_state, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    # read onto the CPU: load_state_dict copies onto each parameter's device, and the
    # optimizer keeps its step counts on the CPU, as a fresh one does
    saved = torch.load(osp.join(_step_dir(ckpt_dir, step), STATE_FILE), map_location="cpu", weights_only=True)
    tp = getattr(params, "tensor_parallel", None)
    state, opt = _resplit(params, saved["params"], saved["opt_state"], opt_state,
                          lambda t, split: split.take(t, tp.model_index, tp.mesh["model"]))
    params.load_state_dict(state)
    opt_state.load_state_dict(opt)
    return params, opt_state, int(saved["step"])
