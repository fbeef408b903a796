"""Random weights from a seed, drawn on the device in one call.

The benchmark makes the weights and hands the same values to the program
and to the reference: every parameter that ``shapes`` names is a slice of
one ``torch.randn`` draw from a generator on the device, scaled by a rule on
its name and shape, and rounded to bfloat16 (the type the program serves
them in). The program loads them as a checkpoint; the reference reads their
float32 values.

Scales: a family's own rule first (``weight_rule`` of
``portbench/backbones/`` and ``vocoders/``: the DiT's text embedding table
``N(0, 1)``, Vocos' layer scales ``1/8 + N(0, 0.01^2)``), then the common
rule: matrices and convolution kernels ``N(0, 1/fan_in)``; LayerNorm
weights ``1 + N(0, 0.02^2)``; every other vector (biases, the response-norm
gamma and beta) ``N(0, 0.02^2)``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

Rule = Callable[[str, tuple], Optional[tuple]]


def rule(name: str, shape: tuple, own: Optional[Rule] = None) -> tuple:
    """(mean, std) of a parameter: ``own`` (a family's ``weight_rule``)
    where it gives one, else the common rule."""
    got = own(name, shape) if own is not None else None
    if got is not None:
        return got
    if name.endswith(("norm.weight", "final_layer_norm.weight")) and len(shape) == 1:
        return 1.0, 0.02
    if name.endswith("weight") and len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    return 0.0, 0.02


def make(shapes: Dict[str, tuple], seed: int, device,
         own: Optional[Rule] = None) -> Dict[str, torch.Tensor]:
    """``{name: bfloat16 tensor}`` of ``shapes``, views of one flat buffer
    (``own``: the family's rule)."""
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    off = 0
    for (name, shape), n in zip(shapes.items(), sizes):
        mean, std = rule(name, shape, own)
        flat[off:off + n].mul_(std).add_(mean)
        off += n
    flat16 = flat.to(torch.bfloat16)
    del flat
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = flat16[off:off + n].view(shape)
        off += n
    return out

