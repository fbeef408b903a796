"""Misc model utilities (counterpart of ``lemas_tts_tpu/utils/misc.py``;
reference ``model/utils.py:18-25,182-190``). The JAX module's
``enable_compile_cache`` has no counterpart: the kernels' nvcc build
directory (``ops/_cuda.py``) persists on its own."""

from __future__ import annotations

import random
from collections import defaultdict

import numpy as np
import torch


def seed_everything(seed: int = 0) -> torch.Generator:
    """Seed python's, numpy's and torch's global RNGs, and return a CPU
    ``torch.Generator`` seeded the same."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def repetition_found(text: str, length: int = 2, tolerance: int = 10) -> bool:
    """True when any character or any ``length``-gram repeats more than
    ``tolerance`` times — the reference uses this to reject degenerate ASR
    transcripts (``model/utils.py:182-190``)."""
    pattern_count: dict = defaultdict(int)
    for i in range(len(text) - length + 1):
        pattern_count[text[i : i + length]] += 1
    for pattern, count in pattern_count.items():
        if count > tolerance:
            return True
    return False


@torch.no_grad()
def fast_random_params(module: torch.nn.Module, generator: torch.Generator,
                       scale: float = 0.02, dtype=None) -> torch.nn.Module:
    """Fill every parameter of ``module`` in place with ``normal * scale``,
    drawn from ``generator`` on the module's own device (where the generator
    must be), one pass over the parameters; ``dtype`` also casts them.
    Random weights for speed and kernel checks, where the values do not
    matter but a flagship-size init on the host would. Returns ``module``."""
    for p in module.parameters():
        w = torch.randn(p.shape, generator=generator, device=p.device) * scale
        if dtype is not None:
            p.data = w.to(dtype)
        else:
            p.copy_(w)
    return module
