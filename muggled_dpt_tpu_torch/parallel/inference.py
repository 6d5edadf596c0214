"""Data-parallel batch inference: the counterpart of JAX
``parallel/inference.py`` on ``torch.distributed``.

Every rank holds the whole model. A batch (B, H, W, 3) of preprocessed
frames, the same on every rank, is cut along B: each rank runs its slice
through the model's kernel forward under ``inference_mode``, and the depths
are all-gathered back into batch order, so every rank returns the whole
(B, H', W'). Outside a process group (world size 1) nothing is gathered."""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

from .mesh import grouped, make_mesh, shard_batch, world


class BatchParallelRunner:
    """Runs frame batches sharded over the data axis of the world.

    Every rank builds the same weights (from one checkpoint, or one seed):
    nothing is broadcast. The facade's per-grid aux (BEiT's bias stack,
    SwinV2's CPB stacks and masks) comes from ``model._get_aux``, built once
    per grid on each rank. Calls are serialized by a lock: the aux cache and
    the kernels' launch counters are read-modify-write."""

    def __init__(self, model, mesh=None):
        self.model = model
        self.mesh = make_mesh() if mesh is None else mesh
        self.rank, self.world_size = world()
        if self.mesh["data"] != self.world_size:
            raise ValueError(f"mesh data axis {self.mesh['data']} != world size {self.world_size}")
        self._lock = threading.Lock()

    @property
    def data_parallelism(self) -> int:
        return self.mesh["data"]

    def run_shard(self, shard_nhwc: torch.Tensor) -> torch.Tensor:
        """The model's kernel forward on this rank's (b, H, W, 3) slice -> (b, H', W')."""
        model = self.model
        x = shard_nhwc.to(model.device, model.dtype).permute(0, 3, 1, 2)  # the port's BCHW, as a view
        p = model.patch_size_px
        with self._lock, torch.inference_mode(), model._precision():
            return model.net(x, model._get_aux((x.shape[-2] // p, x.shape[-1] // p)))

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's equal-shaped slice, concatenated in rank (batch) order."""
        if not grouped():
            return local
        parts = [torch.empty_like(local) for _ in range(self.world_size)]
        dist.all_gather(parts, local.contiguous())
        return torch.cat(parts)

    def __call__(self, images_nhwc) -> torch.Tensor:
        """images_nhwc: (B, H, W, 3) normalized frames, B divisible by the
        data axis. Returns (B, H', W') inverse depth on every rank."""
        x = torch.as_tensor(images_nhwc)
        if x.shape[0] % self.data_parallelism:
            raise ValueError(f"batch {x.shape[0]} must be divisible by data parallelism {self.data_parallelism}")
        return self.gather(self.run_shard(shard_batch(x, self.rank, self.world_size)))
