"""Batch inference over the (data, model) mesh: the counterpart of JAX
``parallel/inference.py`` on ``torch.distributed``.

A batch (B, H, W, 3) of preprocessed frames, the same on every rank, is cut
along B over the data axis: the ranks of one model group take the same
slice, and with ``shard_model`` (the default, as in JAX) run it through
their Megatron split of the model (``parallel/tensor.py``), the attention
through the kernels at the rank's head count. Each rank runs its slice
under ``inference_mode`` and the depths are all-gathered over the data
group back into batch order, so every rank returns the whole (B, H', W').
A data axis of 1 (outside a process group, or a world that is all model
axis) gathers nothing."""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

from . import tensor
from .mesh import check_world, make_mesh, mesh_coords, mesh_groups, shard_batch, world


class BatchParallelRunner:
    """Runs frame batches sharded over the data axis of the mesh, the model
    split over its model axis when ``shard_model`` (else whole on every rank).

    Every rank builds the same weights (from one checkpoint, or one seed):
    nothing is broadcast. Every rank of the world must build the runner (it
    makes the mesh's groups). The per-grid aux (BEiT's bias stack, SwinV2's
    CPB stacks and masks) comes from the rank's model (``local``), built
    once per grid on each rank from its own heads, as JAX ``place_aux``
    splits the stacks by head. Calls are serialized by a lock: the aux cache
    and the kernels' launch counters are read-modify-write."""

    def __init__(self, model, mesh=None, shard_model: bool = True):
        self.model = model
        self.mesh = make_mesh() if mesh is None else mesh
        self.rank, self.world_size = world()
        check_world(self.mesh, self.world_size)
        self.model_group, self.data_group = mesh_groups(self.mesh)
        self.data_index, self.model_index = mesh_coords(self.rank, self.mesh)
        sharded = shard_model and self.mesh["model"] > 1
        self.local = tensor.shard_model(model, self.mesh, self.rank) if sharded else model
        self._lock = threading.Lock()

    @property
    def data_parallelism(self) -> int:
        return self.mesh["data"]

    def run_shard(self, shard_nhwc: torch.Tensor) -> torch.Tensor:
        """The rank's model's kernel forward on this rank's (b, H, W, 3)
        slice -> (b, H', W'). The ranks of a model group call it together."""
        model = self.local
        x = shard_nhwc.to(model.device, model.dtype).permute(0, 3, 1, 2)  # the port's BCHW, as a view
        p = model.patch_size_px
        with self._lock, torch.inference_mode(), model._precision():
            return model.net(x, model._get_aux((x.shape[-2] // p, x.shape[-1] // p)))

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every data index's equal-shaped slice, concatenated in batch order."""
        if self.data_parallelism == 1:
            return local
        parts = [torch.empty_like(local) for _ in range(self.data_parallelism)]
        dist.all_gather(parts, local.contiguous(), group=self.data_group)
        return torch.cat(parts)

    def __call__(self, images_nhwc) -> torch.Tensor:
        """images_nhwc: (B, H, W, 3) normalized frames, B divisible by the
        data axis. Returns (B, H', W') inverse depth on every rank."""
        x = torch.as_tensor(images_nhwc)
        if x.shape[0] % self.data_parallelism:
            raise ValueError(f"batch {x.shape[0]} must be divisible by data parallelism {self.data_parallelism}")
        return self.gather(self.run_shard(shard_batch(x, self.data_index, self.data_parallelism)))

    def clear_cache(self):
        self.local.clear_cache()
        self.model.clear_cache()
