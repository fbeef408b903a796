"""Tensor parallelism of the DiT's training route over the ``model`` axis
(the port's counterpart of the JAX ``dit_param_pspecs`` under GSPMD,
``lemas_tts_tpu/parallel/mesh.py``).

The blocks compute their products with ``models/modules.py:dense``, which
reads ``lin.weight`` directly, so the module hooks of
``torch.distributed.tensor.parallel`` would never run. The split is made by
hand instead, Megatron-style, on the plan of ``mesh.tp_param_dims``: each
process holds its slice of the split weights as the module's own
parameters (``shard_``), and the modules with a ``tp`` record compute on it:

- column-parallel q/k/v and FF-in take the replicated input through
  ``copy_in`` (identity forward, gradient summed over ``model``) and give
  this process's heads or hidden columns;
- row-parallel ``to_out``, FF-out and the AdaLN modulations multiply their
  part of the input by their part of the weight, sum the products over
  ``model`` with ``reduce_out`` (sum forward, identity backward) and add
  the bias once;
- attention runs this process's ``heads / model`` heads, the rope on the
  global heads below ``pe_attn_head`` (v0's rope lands on global head 0
  only).

Every process of a ``model`` group then holds the same activations and the
same loss, and the gradient of every replicated parameter is whole on each.
Only the training route takes a split module (the kernels need the whole
heads): the serving route raises on one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiably: the backward sums the
    gradient over the group too (``torch.distributed.nn.functional.
    all_reduce``'s rule). Where every process of the group differentiates
    the same global scalar, each gets its own input's part of the gradient
    times the group's size."""
    return _SumOver.apply(x, group)


class TensorParallel:
    """This process's place in a ``model`` group: ``size`` processes, this
    one ``rank``; ``copy_in`` and ``reduce_out`` are the two collectives of
    a split layer."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def __deepcopy__(self, memo):  # a module copy shares the process group
        return self

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, y: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(y, self.group)

    def take(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """This process's ``width`` columns of the last axis of ``x``."""
        return x[..., self.rank * width:(self.rank + 1) * width]


def shard_(model: nn.Module, mesh) -> nn.Module:
    """Split ``model`` (a DiT) over the mesh's ``model`` axis in place: the
    parameters of ``tp_param_dims`` become this process's slices and the
    split modules get the ``tp`` record. A ``model`` axis of one splits
    nothing and leaves the module as it was."""
    from lemas_tts_tpu_torch.models.modules import (AdaLayerNorm, AdaLayerNormFinal,
                                                    Attention, FeedForward)
    from lemas_tts_tpu_torch.parallel.mesh import axis_size, tp_param_dims

    m = axis_size(mesh, "model")
    if m == 1:
        return model
    arch = model.arch
    if arch.heads % m or arch.dim % m or (arch.dim * arch.ff_mult) % m:
        raise ValueError(f"heads {arch.heads}, dim {arch.dim} and FF width "
                         f"{arch.dim * arch.ff_mult} must divide by the model axis {m}")
    tp = TensorParallel(mesh.get_group("model"))
    for name, dim in tp_param_dims(model).items():
        p = model.get_parameter(name)
        k = p.shape[dim] // m
        p.data = p.data.narrow(dim, tp.rank * k, k).contiguous().clone()
    for mod in model.modules():
        if isinstance(mod, (Attention, FeedForward, AdaLayerNorm, AdaLayerNormFinal)):
            mod.tp = tp
    return model
