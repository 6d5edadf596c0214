"""The Megatron pair of collectives that a tensor-parallel block calls
(``parallel/tensor.py`` splits the weights and sets the groups):

* ``copy_to_model`` at the input of a column-split linear (qkv, fc1, w12):
  identity forward, the gradient all-reduced over the model group backward;
* ``reduce_from_model`` at the output of a row-split linear (proj, fc2,
  w3): the partial products all-reduced forward, identity backward. The
  row-split linear runs without its bias, which is added once after the
  sum, on every rank (``row_linear``)."""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, group):
    """The input of a column-split linear: x itself; under autograd the
    gradient into x is all-reduced over ``group`` (each rank holds the part
    that flowed through its columns)."""
    return _CopyToModel.apply(x, group) if torch.is_grad_enabled() and x.requires_grad else x


def reduce_from_model(x, group):
    """The output of a row-split linear: the ranks' partial products summed
    over ``group``. Its gradient passes through unchanged, so an upstream
    gradient is not scaled by the group's size (``torch.distributed.nn``'s
    all-reduce would all-reduce it again). Outside autograd the fresh,
    contiguous ``x`` is summed in place."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, group)
    dist.all_reduce(x, group=group)
    return x


def row_linear(x, layer, group):
    """A row-split linear: this rank's columns' product, summed over the
    model group, then the whole bias once."""
    y = reduce_from_model(F.linear(x, layer.weight), group)
    return y if layer.bias is None else y + layer.bias
