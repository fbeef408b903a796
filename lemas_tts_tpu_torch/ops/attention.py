"""Self-attention for the DiT blocks.

Counterpart of ``lemas_tts_tpu/ops/attention.py``:

- ``sdpa``: plain split-head attention ``[B, H, N, D]`` with an f32 softmax
  and a key-padding mask (the JAX ``sdpa``);
- ``vmem_attention_nhd`` (K3): flat-layout ``[B, N, H*D]`` attention with the
  interleaved-pair rope applied to q and k inside the kernel and ``1/sqrt(D)``
  folded into q. CPU tensors take ``vmem_attention_nhd_plain``; CUDA tensors
  launch ``csrc/attention_nhd.cu`` or raise. ``.launches`` counts the
  launches.

Known difference from the JAX one-shot path (N <= 2048): a query row whose
keys are *all* masked gets the mean of v there, 0 here (as in the JAX chunked
path). Callers zero padded query rows after the output projection, so the
value never reaches the model's output.
"""

from __future__ import annotations

import math

import torch

from lemas_tts_tpu_torch.ops import _cuda

NEG_INF = -1e30  # score of a padded key
M_FLOOR = -1e29  # online-softmax running-max floor
Q_TILE = 64  # query rows per kernel block (csrc/attention_nhd.cu BQ = BKV)


def sdpa(q, k, v, mask=None):
    """q, k, v [B, H, N, D]; mask [B, N] (True = keep). f32 softmax."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(dtype).float(), v.float()).to(dtype)


def nhd_supported(heads: int, dim_head: int, n: int, qk_norm=None, pe_attn_head=None,
                  has_rope: bool = True) -> bool:
    """Geometries the flat-layout kernel takes: d64 heads in pairs (the
    flagship) or d128 heads, rope on every head, no qk norm, N % 64."""
    return (qk_norm is None and pe_attn_head is None and has_rope
            and ((dim_head == 64 and heads % 2 == 0) or dim_head == 128)
            and n % Q_TILE == 0)


def _rope(x, cos, sin, scale=None):
    # x [B, N, H, D] in the compute dtype; (x0, x1) -> x * cos + (-x1, x0) * sin
    # in f32, optionally * scale, rounded to the compute dtype
    xf = x.float()
    rot = torch.stack([-xf[..., 1::2], xf[..., 0::2]], dim=-1).flatten(-2)
    out = xf * cos + rot * sin
    if scale is not None:
        out = out * scale
    return out.to(x.dtype)


def vmem_attention_nhd_plain(q, k, v, mask, angles, heads):
    B, N, inner = q.shape
    D = inner // heads
    cdt = q.dtype
    cos = torch.cos(angles).repeat_interleave(2, dim=-1)[None, :, None, :]  # [1, N, 1, D]
    sin = torch.sin(angles).repeat_interleave(2, dim=-1)[None, :, None, :]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qr = _rope(q.view(B, N, heads, D), cos, sin, scale).transpose(1, 2)  # [B, H, N, D]
    kr = _rope(k.view(B, N, heads, D), cos, sin).transpose(1, 2)
    vh = v.view(B, N, heads, D).transpose(1, 2)
    outs = []
    for b in range(B):  # one batch row at a time bounds the [H, N, N] f32 scores
        s = torch.matmul(qr[b].float(), kr[b].float().transpose(-1, -2))
        if mask is not None:
            s = s.masked_fill(~mask[b, None, None, :], NEG_INF)
        m = s.amax(-1, keepdim=True).clamp_min(M_FLOOR)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(cdt).float(), vh[b].float()) / l.clamp_min(1e-30)
        outs.append(o.to(cdt).transpose(0, 1).reshape(N, inner))
    return torch.stack(outs)


def vmem_attention_nhd(q, k, v, mask, angles, heads: int):
    """q, k, v [B, N, H*D] (heads not split); mask [B, N] bool or None;
    angles [N, D/2] f32 rope angles. Returns [B, N, H*D]."""
    if q.device.type == "cpu":
        return vmem_attention_nhd_plain(q, k, v, mask, angles, heads)
    _cuda.require(q.device.type == "cuda", f"no kernel for device {q.device}")
    B, N, inner = q.shape
    D = inner // heads
    _cuda.require(inner == heads * D and nhd_supported(heads, D, N),
                  f"attention kernel does not take heads={heads}, D={D}, N={N}")
    for t in (q, k, v):
        _cuda.require(t.device == q.device and t.dtype == q.dtype and t.is_contiguous()
                      and t.shape == q.shape, "q, k, v must match in shape, dtype, device")
    _cuda.require(angles.dtype == torch.float32 and angles.is_contiguous()
                  and tuple(angles.shape) == (N, D // 2) and angles.device == q.device,
                  "angles must be contiguous f32 [N, D/2] on q's device")
    if mask is not None:
        _cuda.require(mask.dtype == torch.bool and mask.is_contiguous()
                      and tuple(mask.shape) == (B, N) and mask.device == q.device,
                      "mask must be contiguous bool [B, N] on q's device")
    out = torch.empty_like(q)
    err = _cuda.library("attention_nhd")(
        q.device.index, _cuda.dtype_code(q), D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), angles.data_ptr(), out.data_ptr(),
        B, N, heads, float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, "attention_nhd")
    vmem_attention_nhd.launches += 1
    return out


vmem_attention_nhd.launches = 0
