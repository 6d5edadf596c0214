"""Fine-tuning: the scale-and-shift-invariant depth loss and a dp x tp
AdamW train step, the counterpart of JAX ``parallel/train.py``.

The differentiated forward runs the plain attention (``plain_attention``):
the hand-written kernels have no backward, and a kernel launch under
autograd raises (``ops/kernels/flash_attention.py:_refuse_grad``). The JAX
package has no backward kernel either: its ``value_and_grad`` never reaches
a Pallas kernel. Under data parallelism each rank differentiates its slice
of the batch and the gradients are averaged over the data axis, which for
equal slices is the gradient of the full batch's mean loss. A net sharded
over a model axis (``parallel/tensor.py``) gets its split parameters' own
gradients and every replicated parameter's whole gradient from the
Megatron pair in its blocks, so only the data group averages."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ..utils.metrics import align_scale_shift
from .mesh import check_world, grouped, make_mesh, mesh_coords, shard_batch, world
from .tensor import shard_model

# optax.adamw's defaults; torch's AdamW decays by 1e-2 unless told otherwise
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def ssi_loss(pred_bhw, target_bhw, mask_bhw=None, eps=1e-6):
    """Scale-shift-invariant MSE in float32: per-image least-squares align
    (scale, shift) of the prediction to the target, then the mean squared
    residual over valid pixels, averaged over the batch."""
    b = pred_bhw.shape[0]
    aligned = align_scale_shift(pred_bhw, target_bhw, mask_bhw, eps).reshape(b, -1)
    t = torch.as_tensor(target_bhw).reshape(b, -1).float()
    m = torch.ones_like(t) if mask_bhw is None else torch.as_tensor(mask_bhw).reshape(b, -1).float()
    n = m.sum(dim=1) + eps
    return ((m * (aligned - t) ** 2).sum(dim=1) / n).mean()


def adamw(params, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` in torch: betas (0.9, 0.999), eps 1e-8, decoupled weight decay 1e-4."""
    return torch.optim.AdamW(params, lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)


@contextlib.contextmanager
def plain_attention(net: torch.nn.Module):
    """Every block of ``net`` (DINOv2, BEiT and SwinV2 alike) on the plain,
    differentiable attention for the duration; the kernels after."""
    blocks = [m for m in net.modules() if hasattr(m, "use_kernel")]
    saved = [m.use_kernel for m in blocks]
    for m in blocks:
        m.use_kernel = False
    try:
        yield
    finally:
        for m, use in zip(blocks, saved):
            m.use_kernel = use


def fixed_zero_grads(net: torch.nn.Module) -> list:
    """(parameter, boolean mask) pairs whose gradients the train step
    zeroes: entries the original model does not have, each declared by the
    module that lays them out (``fixed_zero_grads()``, as BEiT's and
    SwinV2's absent key biases are)."""
    return [pair for m in net.modules() if hasattr(m, "fixed_zero_grads") for pair in m.fixed_zero_grads()]


def _constant(aux):
    """A copy of a cached aux that autograd may hold: the facade builds it
    under ``inference_mode``, and an inference tensor cannot be saved for
    backward. Not differentiated: a cached aux is data, as in JAX."""
    if aux is None:
        return None
    if isinstance(aux, torch.Tensor):
        return aux.detach().clone()
    if isinstance(aux, dict):
        return {k: _constant(v) for k, v in aux.items()}
    return type(aux)(_constant(a) for a in aux)


def make_train_step(model, optimizer):
    """Build ``step(images_nhwc, targets_bhw, aux=None) -> loss`` for a
    facade ``model`` and an optimizer over ``model.net``'s parameters.

    images_nhwc: this rank's (b, H, W, 3) normalized images; targets_bhw
    (b, H, W). ``aux``: the grid's cached aux (``model._get_aux``), threaded
    outside autograd as in JAX ``make_train_step``: with it, BEiT's
    relative-position tables and SwinV2's CPB MLP get no gradient; None
    builds them inside the differentiated forward. In a process group the
    gradients and the returned loss are averaged across ranks: across the
    data group for a model sharded by ``parallel/tensor.py:shard_model``
    (whose fixed-zero masks are its own slices), else across the world.
    float32 models are differentiated with TF32 off, as the parity mode runs."""
    net = model.net
    zeros = fixed_zero_grads(net)
    params = [p for p in net.parameters() if p.requires_grad]
    sharded = getattr(net, "tensor_parallel", None)
    group = None if sharded is None else sharded.data_group

    def step(images_nhwc, targets_bhw, aux=None):
        size = world()[1] if sharded is None else sharded.mesh["data"]
        x = torch.as_tensor(images_nhwc).to(model.device, model.dtype).permute(0, 3, 1, 2)
        t = torch.as_tensor(targets_bhw).to(model.device)
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad(), plain_attention(net), model._precision():
            loss = ssi_loss(net(x, _constant(aux)), t)
            loss.backward()
        with torch.no_grad():
            for p, mask in zeros:
                if p.grad is not None:
                    p.grad[mask] = 0
            if grouped() and (sharded is None or size > 1):
                for p in params:
                    if p.grad is not None:
                        dist.all_reduce(p.grad, group=group)
                        p.grad /= size
                loss = loss.detach().clone()
                dist.all_reduce(loss, group=group)
                loss /= size
        optimizer.step()
        return loss.detach()

    return step


def sharded_train_demo(model, mesh=None, batch: int = 2, image_hw=(56, 56), lr: float = 1e-4) -> float:
    """One dp x tp training step on random images at tiny shapes over the
    mesh (default: ``make_mesh()`` of the world), the model split over its
    model axis, the grid's cached aux threaded in. Returns the loss (every
    rank the same). A float32 model trains in place at a model axis of 1;
    another dtype trains a float32 copy, and a model axis above 1 a split
    copy of its own (``shard_model(share=False)``), so ``model`` keeps its
    state. Every rank of the world calls it."""
    mesh = make_mesh() if mesh is None else mesh
    rank, size = world()
    check_world(mesh, size)
    if model.dtype != torch.float32:
        model = model.to(torch.float32)
    if mesh["model"] > 1:
        model = shard_model(model, mesh, rank, share=False)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((batch, image_hw[0], image_hw[1], 3)).astype(np.float32)
    targets = rng.uniform(0.1, 1.0, (batch, image_hw[0], image_hw[1])).astype(np.float32)
    images, targets = shard_batch((torch.from_numpy(images), torch.from_numpy(targets)), mesh_coords(rank, mesh)[0],
                                  mesh["data"])
    p = model.patch_size_px
    aux = model._get_aux((image_hw[0] // p, image_hw[1] // p))
    step = make_train_step(model, adamw(model.net.parameters(), lr))
    return float(step(images, targets, aux))
