"""Int8 W8A8 products for serving (counterpart of
``lemas_tts_tpu/ops/quant.py``):

- ``quantize_weight``: symmetric per-output-channel absmax -> int8 + f32
  scale;
- ``quantize_activation``: dynamic symmetric per-token quantization;
- ``int8_dense``: quantize ``x`` per token, int8 × int8 product with int32
  accumulation, rescale by ``act_scale ⊗ weight_scale``, + bias in f32, then
  the output dtype;
- ``QuantLinear``: a ``Linear`` with int8 weights (buffers ``weight_q`` and
  ``scale``, f32 bias); a float ``weight`` in a state dict is quantized as it
  loads, so float checkpoints load into a quantized model;
- ``quantize_dense_tree``: swaps the DiT blocks' ``Linear``s for
  ``QuantLinear``s (``"int8"``: q/k/v, out, both FF products; ``"int8_ff"``:
  the FF products only).

The JAX package leaves the int8 product to XLA; it is no Pallas kernel. Here
it is ``torch._int_mm`` (cuBLASLt, int32 accumulation) on CUDA and exact
int32 integer math on the CPU: both give the same int32 sums. Weights are in
torch ``Linear`` layout ``[out, in]``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# Layer names of the JAX package (``lemas_tts_tpu/ops/quant.py``) and, beside
# each, where the port's DiTBlock keeps that Linear.
QUANT_DENSE_NAMES = frozenset({"to_q", "to_k", "to_v", "to_out", "in_proj", "out_proj"})
FF_QUANT_NAMES = frozenset({"in_proj", "out_proj"})
_BLOCK_PATHS = {"to_q": ("attn", "to_q"), "to_k": ("attn", "to_k"), "to_v": ("attn", "to_v"),
                "to_out": ("attn", "to_out", "0"), "in_proj": ("ff", "ff", "0", "0"),
                "out_proj": ("ff", "ff", "2")}
MODES = {"int8": QUANT_DENSE_NAMES, "int8_ff": FF_QUANT_NAMES}


def quantize_weight(w: torch.Tensor):
    """``w [out, in]`` -> ``(w_q int8 [out, in], scale f32 [out])`` with
    ``w ≈ w_q * scale[:, None]``."""
    wf = w.float()
    scale = wf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    w_q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_activation(x: torch.Tensor):
    """``x [..., in]`` -> ``(x_q int8, scale f32 [...])``, one scale a row."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    x_q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return x_q, scale


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``x_q [M, K] @ w_q[N, K]ᵀ`` as int32: ``torch._int_mm`` on CUDA (the
    weight goes column-major, as cuBLASLt's int8 product takes it), int32
    integer math on the CPU."""
    if x_q.device.type == "cuda":
        return torch._int_mm(x_q, w_q.t())
    return torch.matmul(x_q.to(torch.int32), w_q.to(torch.int32).t())


def _rescale(x_q, x_scale, weight_q, scale, bias, lead, out_dtype):
    out = int8_matmul(x_q, weight_q).float() * x_scale[:, None] * scale[None, :]
    if bias is not None:
        out = out + bias.float()[None, :]
    return out.reshape(*lead, weight_q.shape[0]).to(out_dtype)


def int8_dense(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """W8A8 dense: ``x [..., in]``, ``weight_q`` int8 ``[out, in]``, ``scale``
    f32 ``[out]``, ``bias [out]``."""
    x_q, x_scale = quantize_activation(x.reshape(-1, x.shape[-1]))
    return _rescale(x_q, x_scale, weight_q, scale, bias, x.shape[:-1], out_dtype)


def int8_dense_shared(x: torch.Tensor, layers) -> list:
    """``[layer(x) for layer in layers]`` for ``QuantLinear``s that share
    their input, with ``x`` quantized once (q/k/v; XLA merges the three
    quantizations of the JAX package's int8 attention). Equal to the
    layers' own calls."""
    x_q, x_scale = quantize_activation(x.reshape(-1, x.shape[-1]))
    return [_rescale(x_q, x_scale, lin.weight_q, lin.scale, lin.bias, x.shape[:-1], x.dtype)
            for lin in layers]


class QuantLinear(nn.Module):
    """``nn.Linear`` with int8 weights; the output takes the input's dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QuantLinear":
        q = cls(lin.in_features, lin.out_features, lin.bias is not None)
        with torch.no_grad():
            w_q, scale = quantize_weight(lin.weight)
            q.weight_q.copy_(w_q)
            q.scale.copy_(scale)
            if lin.bias is not None:
                q.bias.copy_(lin.bias.float())
        return q.to(lin.weight.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense(x, self.weight_q, self.scale, self.bias, out_dtype=x.dtype)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a float checkpoint's weight is quantized as it loads
        w = state_dict.pop(prefix + "weight", None)
        if w is not None:
            state_dict[prefix + "weight_q"], state_dict[prefix + "scale"] = quantize_weight(w)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def quantize_dense_tree(model: nn.Module, names=None) -> nn.Module:
    """Swap the ``Linear``s named in ``names`` (default
    :data:`QUANT_DENSE_NAMES`; :data:`FF_QUANT_NAMES` for ``"int8_ff"``) in
    every block of a DiT for :class:`QuantLinear`s quantized from their
    current (float) weights, in place. Returns ``model``."""
    names = QUANT_DENSE_NAMES if names is None else names
    for blk in model.transformer_blocks:
        for name in sorted(names):
            *parents, leaf = _BLOCK_PATHS[name]
            parent = blk
            for p in parents:
                parent = parent[int(p)] if p.isdigit() else getattr(parent, p)
            lin = parent[int(leaf)] if leaf.isdigit() else getattr(parent, leaf)
            q = QuantLinear.from_linear(lin)
            if leaf.isdigit():
                parent[int(leaf)] = q
            else:
                setattr(parent, leaf, q)
    return model
