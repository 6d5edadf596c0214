"""Tensor parallelism: the Megatron column/row split of the transformer
blocks over a model process group, the counterpart of JAX
``parallel/mesh.py:_spec_for_param``, ``shard_params`` and ``place_aux``.

The JAX package marks the weights with shardings and XLA inserts the
collectives; here each rank holds its slice of every split weight and the
blocks call the Megatron pair themselves (``ops/collectives.py``:
``copy_to_model`` at the input of a column-split linear, ``reduce_from_model``
at the output of a row-split one, whose bias is added once after the sum).

Everything else (norms, embeddings, LayerScale, the neck) is replicated, so
each replicated parameter gets its whole gradient on every rank. A pair
(qkv and proj with the heads, fc1 and fc2 with the hidden width) splits
only where its heads or its hidden width divide by the model axis and
neither of its linears is int8 (``ops/quant.py:QuantLinear``): otherwise it
runs whole on every rank, as ``place_aux`` replicates a stack whose heads
do not divide and GSPMD replicates the int8 weights, whose dense kernels
``quantize_weight`` drops. The case that occurs is SwinV2-L's first stage (6
heads) at a model axis of 4. With heads split, the per-head tables follow
them: BEiT's relative-position LUT, so each rank's cached bias stack holds
its heads only; SwinV2's logit scale and CPB output rows, so its CPB stack
does."""

from __future__ import annotations

import copy
import itertools
import re
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from ..ops.quant import QuantLinear
from .mesh import mesh_coords, mesh_groups, world


@dataclass(frozen=True)
class Split:
    """How a split tensor is cut: along ``dim``, which holds ``parts``
    equal parts (SwinV2's qkv rows [q|k|v]: 3; SwiGLU's [a|b]: 2), each
    cut into one contiguous piece per rank of the model group."""

    dim: int
    parts: int = 1

    def take(self, t: torch.Tensor, index: int, tp: int) -> torch.Tensor:
        """Rank ``index``'s piece of a whole tensor, as a new contiguous tensor."""
        return t.unflatten(self.dim, (self.parts, tp, -1)).select(self.dim + 1, index).flatten(self.dim, self.dim + 1).contiguous()

    def join(self, pieces) -> torch.Tensor:
        """The whole tensor from every rank's piece, in model-index order."""
        stacked = torch.stack([p.unflatten(self.dim, (self.parts, -1)) for p in pieces], self.dim + 1)
        return stacked.flatten(self.dim, self.dim + 2)


# JAX _spec_for_param's table in the port's parameter names and layouts:
# column-split linears by output rows, row-split ones by input columns (their
# bias stays whole), the per-head tables by head
SPECS = (
    (r"\.attn\.qkv\.(weight|bias)$", Split(0)),  # DINOv2 and BEiT rows: [head][q|k|v][dim]
    (r"\.attn\.proj\.weight$", Split(1)),
    (r"\.mlp\.fc1\.(weight|bias)$", Split(0)),
    (r"\.mlp\.fc2\.weight$", Split(1)),
    (r"\.mlp\.w12\.(weight|bias)$", Split(0, 2)),  # ViT-Giant's SwiGLU: [a|b], each half cut
    (r"\.mlp\.w3\.weight$", Split(1)),
    (r"stages\.\d+\.\d+\.qkv\.(weight|bias)$", Split(0, 3)),  # SwinV2 rows: [q|k|v][head][dim]
    (r"stages\.\d+\.\d+\.proj\.weight$", Split(1)),
    (r"stages\.\d+\.\d+\.fc1\.(weight|bias)$", Split(0)),
    (r"stages\.\d+\.\d+\.fc2\.weight$", Split(1)),
    (r"stages\.\d+\.\d+\.logit_scale$", Split(0)),  # (H,)
    (r"stages\.\d+\.\d+\.cpb1\.weight$", Split(0)),  # the CPB MLP's (H, 512) output rows
    (r"relpos_lut$", Split(2)),  # BEiT's (L, rows, H)
)


def spec_for_param(name: str) -> Split | None:
    """How ``name`` splits when its pair does (None: replicated)."""
    return next((split for pattern, split in SPECS if re.search(pattern, name)), None)


@dataclass
class TensorParallel:
    """What a sharded net knows of its mesh: the shape, this rank's model
    index and groups, and the split parameters (name -> ``Split``)."""

    mesh: dict
    model_index: int
    model_group: object
    data_group: object
    splits: dict


def shard_net(net: nn.Module, mesh: dict, rank: int, model_group, data_group=None, share: bool = True) -> nn.Module:
    """The rank's net of ``net`` on the mesh: every pair that splits (see the
    module's docstring) sliced to this rank's heads or hidden columns as new
    parameters, everything else shared with ``net``, the blocks' local head
    counts and groups set. ``net`` itself is left whole, so it still
    computes the unsharded forward. An optimizer stepping the rank's net
    would step the shared tensors too and leave ``net`` half updated, so a
    net to be trained is made with ``share=False``: every tensor copied. The
    result carries ``tensor_parallel`` (a ``TensorParallel``)."""
    from ..models.beit import BEiTEncoder
    from ..models.dinov2 import Block, SwiGLUMlp
    from ..models.swinv2 import SwinBlock

    tp = mesh["model"]
    index = mesh_coords(rank, mesh)[1]
    memo = {id(t): t for t in itertools.chain(net.parameters(), net.buffers())} if share else {}
    local = copy.deepcopy(net, memo)
    splits = {}
    names = {id(m): n for n, m in local.named_modules()}

    def cut(owner: nn.Module, attr: str):
        name = f"{names[id(owner)]}.{attr}".lstrip(".")
        split = spec_for_param(name)
        old = getattr(owner, attr)
        setattr(owner, attr, nn.Parameter(split.take(old.detach(), index, tp), requires_grad=old.requires_grad))
        splits[name] = split

    def column(layer: nn.Linear, with_bias: bool = True):
        cut(layer, "weight")
        if with_bias and layer.bias is not None:
            cut(layer, "bias")
        layer.out_features = layer.weight.shape[0]

    def row(layer: nn.Linear):
        cut(layer, "weight")
        layer.in_features = layer.weight.shape[1]

    def splits_pair(first, second, width) -> bool:
        """True if the pair is dense and ``width()`` (heads or hidden) divides by the model axis."""
        return tp > 1 and not isinstance(first, QuantLinear) and not isinstance(second, QuantLinear) and width() % tp == 0

    for module in local.modules():
        if isinstance(module, Block):
            a, mlp = module.attn, module.mlp
            if splits_pair(a.qkv, a.proj, lambda: module.num_heads):
                column(a.qkv)
                row(a.proj)
                module.num_heads //= tp
                a.model_group = model_group
            first, second = (mlp.w12, mlp.w3) if isinstance(mlp, SwiGLUMlp) else (mlp.fc1, mlp.fc2)
            if splits_pair(first, second, lambda: second.in_features):
                column(first)
                row(second)
                mlp.model_group = model_group
        elif isinstance(module, SwinBlock):
            if splits_pair(module.qkv, module.proj, lambda: module.num_heads):
                column(module.qkv)
                row(module.proj)
                cut(module, "logit_scale")
                column(module.cpb1)
                module.num_heads //= tp
                module.attn_group = model_group
            if splits_pair(module.fc1, module.fc2, lambda: module.fc2.in_features):
                column(module.fc1)
                row(module.fc2)
                module.mlp_group = model_group
    for module in local.modules():
        if isinstance(module, BEiTEncoder):
            split = [b.attn.model_group is not None for b in module.blocks]
            if any(split):
                if not all(split):
                    raise ValueError("BEiT's blocks split their heads unevenly: the stacked relpos LUT cannot follow")
                cut(module, "relpos_lut")
    local.tensor_parallel = TensorParallel(dict(mesh), index, model_group, data_group, splits)
    return local


def shard_model(model, mesh: dict, rank: int | None = None, share: bool = True):
    """A facade over this rank's ``shard_net`` of ``model.net``, with an
    aux cache of its own (its per-grid stacks built from its local heads)
    and a config whose head counts are the rank's, so the aux estimates are
    per-rank bytes. ``share=False`` for a model to be trained (see
    ``shard_net``). Every rank of the world must call it (it makes the
    mesh's groups on first use)."""
    from ..dpt import DPTModel

    rank = world()[0] if rank is None else rank
    model_group, data_group = mesh_groups(mesh)
    net = shard_net(model.net, mesh, rank, model_group, data_group, share)
    config = dict(model.config)
    tp = mesh["model"]
    if "num_heads" in config and any(n.endswith("attn.qkv.weight") for n in net.tensor_parallel.splits):
        config["num_heads"] //= tp
    if "heads_per_stage" in config:
        config["heads_per_stage"] = [stage[0].num_heads for stage in net.encoder.stages]
    return DPTModel(net, config, model.spec, dtype=model.dtype)


def gather_full(t: torch.Tensor, split: Split, tp: TensorParallel) -> torch.Tensor:
    """The whole tensor of a split one, from every rank of the model group
    (collective over it). A gloo group gathers through host copies (its
    all-gather takes no CUDA tensor)."""
    group = tp.model_group
    if t.is_cuda and dist.get_backend(group) == "gloo":
        t = t.cpu()
    pieces = [torch.empty_like(t) for _ in range(tp.mesh["model"])]
    dist.all_gather(pieces, t.contiguous(), group=group)
    return split.join(pieces)
