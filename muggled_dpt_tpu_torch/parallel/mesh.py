"""Process groups and the (data, model) mesh: the counterpart of JAX
``parallel/mesh.py`` on ``torch.distributed``.

The JAX package runs one program over a ``jax.sharding.Mesh``; here every
rank is a process of its own. Rank r sits at (data r // model, model r %
model) of the mesh, as JAX's ``np.array(devices).reshape(data, model)``
lays the devices out. A batch is cut along its leading axis over the data
axis (``shard_batch``); the ranks of one model group hold one replica of the
model, its transformer blocks split Megatron-style over the group
(``parallel/tensor.py``). ``mesh_groups`` makes the model and data process
groups. On the card a rank owns one GPU (``cuda:<rank>``) and talks over
NCCL; on the CPU the ranks are gloo processes. They meet at a ``file://``
rendezvous in a fresh temporary folder. ``spawn`` starts the ranks with
``torch.multiprocessing``, which needs the rank function importable from a
file (not a script on stdin)."""

from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist

MAX_MODEL_AXIS = 4  # make_mesh's default model axis: the largest power of two up to this


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
    size inside a process group, else the visible cards, else 1). Without
    ``data_parallel`` the model axis is the largest power of two up to 4
    that divides ``n_devices``, as in JAX: ``make_mesh(8)`` is 2 x 4."""
    if n_devices is None:
        _, size = world()
        n_devices = size if size > 1 else max(1, torch.cuda.device_count() if torch.cuda.is_available() else 1)
    if data_parallel is None:
        model = 1
        while model * 2 <= min(MAX_MODEL_AXIS, n_devices) and n_devices % (model * 2) == 0:
            model *= 2
        data_parallel = n_devices // model
    if data_parallel < 1 or n_devices % data_parallel:
        raise ValueError(f"data_parallel={data_parallel} does not divide {n_devices} devices")
    return {"data": data_parallel, "model": n_devices // data_parallel}


def mesh_coords(rank: int, mesh: dict) -> tuple[int, int]:
    """(data index, model index) of a rank on the mesh."""
    return divmod(rank, mesh["model"])


def check_world(mesh: dict, world_size: int) -> None:
    """Raise unless the mesh covers exactly ``world_size`` ranks."""
    if mesh["data"] * mesh["model"] != world_size:
        raise ValueError(f"mesh data axis {mesh['data']} != world size {world_size} over model axis {mesh['model']}")


_GROUPS = {"world": None, "meshes": {}}  # the default group, and per (data, model) this rank's two groups in it


def mesh_groups(mesh: dict):
    """This rank's (model group, data group) of the mesh: the ranks that
    share its data index, and those that share its model index. Every rank
    of the world makes every group, in one order (``dist.new_group`` is
    collective); the pair is made once per process group and mesh. Outside
    a process group both are None."""
    if not grouped():
        check_world(mesh, 1)
        return None, None
    rank, size = world()
    check_world(mesh, size)
    default = dist.distributed_c10d._get_default_group()
    if _GROUPS["world"] is not default:  # a new world: the old groups went with the old one
        _GROUPS.update(world=default, meshes={})
    key = (mesh["data"], mesh["model"])
    if key not in _GROUPS["meshes"]:
        data, model = key
        model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
        data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
        d, m = mesh_coords(rank, mesh)
        _GROUPS["meshes"][key] = (model_groups[d], data_groups[m])
    return _GROUPS["meshes"][key]


def shard_batch(batch, rank: int | None = None, world_size: int | None = None):
    """This rank's slice of the leading axis of a tensor, an array, or a
    tuple/list of them; the leading axis must divide by the world size.
    Under tensor parallelism pass the data index and the data axis."""
    if rank is None or world_size is None:
        rank, world_size = world()
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, rank, world_size) for b in batch)
    n = batch.shape[0]
    if n % world_size:
        raise ValueError(f"batch {n} must be divisible by data parallelism {world_size}")
    per = n // world_size
    return batch[rank * per:(rank + 1) * per]


def rank_device(device_type: str, rank: int, share_card: bool = False) -> torch.device:
    """A rank's device: ``cuda:<rank>`` on the card (``cuda:0`` for every
    rank of a ``share_card`` world), the CPU otherwise."""
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", 0 if share_card else rank)


def init_process_group(rank: int, world_size: int, init_method: str, device_type: str = "cuda",
                       share_card: bool = False) -> torch.device:
    """Join the group as ``rank`` of ``world_size`` and return this rank's
    device: NCCL on ``cuda:<rank>``, gloo on the CPU and on a shared card."""
    device = rank_device(device_type, rank, share_card)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    nccl = device.type == "cuda" and not share_card
    kwargs = {"device_id": device} if nccl else {}
    dist.init_process_group("nccl" if nccl else "gloo", init_method=init_method, rank=rank, world_size=world_size,
                            **kwargs)
    return device


def _rank_entry(rank, fn, world_size, init_method, device_type, share_card, args):
    if device_type != "cuda":  # the CPU's cores shared among the ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    init_process_group(rank, world_size, init_method, device_type, share_card)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def spawn(fn, world_size: int, *args, device_type: str = "cuda", share_card: bool = False):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes, each
    in the process group (``init_process_group``); returns once every rank
    has ended, raising if one failed. On the card the world needs that many
    visible cards, unless ``share_card``: then every rank runs on ``cuda:0``
    and the group is gloo (NCCL refuses two ranks on one device), whose
    all-reduce and broadcast take CUDA tensors through the host and whose
    all-gather does not take them. It is for validating the
    collectives' placement on one card, not for speed."""
    if device_type == "cuda" and not share_card and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks need {world_size} CUDA cards, {torch.cuda.device_count()} visible")
    import torch.multiprocessing as mp

    folder = tempfile.mkdtemp(prefix="mdpt_rendezvous_")
    try:
        init_method = "file://" + os.path.join(folder, "store")
        mp.spawn(_rank_entry, args=(fn, world_size, init_method, device_type, share_card, args), nprocs=world_size,
                 join=True)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
