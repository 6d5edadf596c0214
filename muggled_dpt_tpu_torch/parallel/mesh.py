"""Process groups and the (data, model) mesh shape: the counterpart of JAX
``parallel/mesh.py`` on ``torch.distributed``.

The JAX package runs one program over a ``jax.sharding.Mesh``; here every
rank is a process of its own, holding the whole model, and a batch is cut
along its leading axis, rank r taking the r-th slice (``shard_batch``). On
the card a rank owns one GPU (``cuda:<rank>``) and talks over NCCL; on the
CPU the ranks are gloo processes. Both meet at a ``file://`` rendezvous in a
fresh temporary folder. ``spawn`` starts the ranks with
``torch.multiprocessing``, which needs the rank function importable from a
file (not a script on stdin).

Tensor parallelism (the model axis, JAX ``_spec_for_param``'s Megatron
column/row split) is not ported yet: the model axis is 1, and asking for
more raises."""

from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist

TP_REFUSAL = "tensor parallel is not ported yet: the model axis must be 1 (ROADMAP A13 item 7)"


def grouped() -> bool:
    """True inside a process group, whose collectives then run at every
    world size, 1 included."""
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a process group."""
    if grouped():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_devices: int | None = None, data_parallel: int | None = None) -> dict:
    """The (data, model) mesh shape over ``n_devices`` (default: the world
    size inside a process group, else the visible cards, else 1). The model
    axis is n_devices / data_parallel and must be 1: the JAX default of a
    model axis up to 4 waits for tensor parallelism."""
    if n_devices is None:
        _, size = world()
        n_devices = size if size > 1 else max(1, torch.cuda.device_count() if torch.cuda.is_available() else 1)
    data = n_devices if data_parallel is None else data_parallel
    if data < 1 or n_devices % data:
        raise ValueError(f"data_parallel={data} does not divide {n_devices} devices")
    model = n_devices // data
    if model > 1:
        raise NotImplementedError(TP_REFUSAL)
    return {"data": data, "model": model}


def shard_batch(batch, rank: int | None = None, world_size: int | None = None):
    """This rank's slice of the leading axis of a tensor, an array, or a
    tuple/list of them; the leading axis must divide by the world size."""
    if rank is None or world_size is None:
        rank, world_size = world()
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, rank, world_size) for b in batch)
    n = batch.shape[0]
    if n % world_size:
        raise ValueError(f"batch {n} must be divisible by data parallelism {world_size}")
    per = n // world_size
    return batch[rank * per:(rank + 1) * per]


def rank_device(device_type: str, rank: int) -> torch.device:
    """A rank's device: ``cuda:<rank>`` on the card, the CPU otherwise."""
    return torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")


def init_process_group(rank: int, world_size: int, init_method: str, device_type: str = "cuda") -> torch.device:
    """Join the group as ``rank`` of ``world_size`` and return this rank's
    device: NCCL on ``cuda:<rank>``, gloo on the CPU."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    backend = "nccl" if device_type == "cuda" else "gloo"
    kwargs = {"device_id": torch.device("cuda", rank)} if device_type == "cuda" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, **kwargs)
    return rank_device(device_type, rank)


def _rank_entry(rank, fn, world_size, init_method, device_type, args):
    if device_type != "cuda":  # the CPU's cores shared among the ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    init_process_group(rank, world_size, init_method, device_type)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def spawn(fn, world_size: int, *args, device_type: str = "cuda"):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes, each
    in the process group (``init_process_group``); returns once every rank
    has ended, raising if one failed. On the card the world needs that many
    visible cards."""
    if device_type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks need {world_size} CUDA cards, {torch.cuda.device_count()} visible")
    import torch.multiprocessing as mp

    folder = tempfile.mkdtemp(prefix="mdpt_rendezvous_")
    try:
        init_method = "file://" + os.path.join(folder, "store")
        mp.spawn(_rank_entry, args=(fn, world_size, init_method, device_type, args), nprocs=world_size, join=True)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
