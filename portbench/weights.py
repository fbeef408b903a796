"""Random weights from a seed, drawn on the device in one call.

The benchmark makes the weights and hands the same values to the program
and to the reference: every parameter that ``shapes`` names is a slice of
one ``torch.randn`` draw from a generator on the device, scaled by a rule on
its name and shape, and rounded to bfloat16 (the type the program serves
them in). The program loads them as a checkpoint; the reference reads their
float32 values.

Scales (a fixed rule, the same for every configuration): matrices and
convolution kernels ``N(0, 1/fan_in)``; the text embedding table
``N(0, 1)``; LayerNorm weights ``1 + N(0, 0.02^2)``; Vocos layer scales
``1/8 + N(0, 0.01^2)``; every other vector (biases, the response-norm
gamma and beta) ``N(0, 0.02^2)``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _rule(name: str, shape: tuple) -> tuple:
    """(mean, std) of a parameter."""
    if name.endswith("text_embed.text_embed.weight"):
        return 0.0, 1.0
    if name.endswith(("norm.weight", "final_layer_norm.weight")) and len(shape) == 1:
        return 1.0, 0.02
    if name.endswith(".gamma") and len(shape) == 1:
        return 0.125, 0.01
    if name.endswith("weight") and len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    return 0.0, 0.02


def make(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: bfloat16 tensor}`` of ``shapes``, views of one flat buffer."""
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    off = 0
    for (name, shape), n in zip(shapes.items(), sizes):
        mean, std = _rule(name, shape)
        flat[off:off + n].mul_(std).add_(mean)
        off += n
    flat16 = flat.to(torch.bfloat16)
    del flat
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = flat16[off:off + n].view(shape)
        off += n
    return out

