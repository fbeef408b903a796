"""The DiT velocity of F5-TTS and LEMAS-TTS in plain float32 torch.

``param_shapes`` declares the parameters by name (the published checkpoint
layout) and shape; the functions below evaluate the network from a dict of
float32 tensors with those names, ``velocity`` one sampler step's whole
forward under the block-range cache. ``quantize_blocks`` (int8 or int4)
emulates symmetric W-A quantization of the block products (q, k, v, out and
both feed-forward products): weights per output channel, activations per
token, both scaled by absmax (to 127 or 7), the product of the quantized
values exact, then the scales and the bias. ``quantize_all`` (fp8, e4m3
scaled to 448) does the same to every matrix product of the network, the
attention's scores and values included.

Published equations, with the conventions both model families use: AdaLN-zero
chunks (shift, scale, gate for attention, then for the MLP), LayerNorm
without affine (eps 1e-6) under the modulation, rotary embedding on
interleaved pairs of the first ``pe_attn_head`` heads (all by default),
softmax over unmasked keys, outputs of padded frames zeroed after the
attention projection, tanh-GELU feed-forward, a ConvNeXt-V2 text encoder
(erf-GELU, global response norm over the sequence) and a grouped k=31
convolutional position embedding with Mish.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def param_shapes(arch: dict, mel_dim: int, vocab_size: int) -> Dict[str, tuple]:
    """Name -> shape of every parameter, in declaration order."""
    d, td = arch["dim"], arch["text_dim"]
    inner = arch["heads"] * arch["dim_head"]
    ff = d * arch["ff_mult"]
    hidden = td * arch.get("conv_mult", 2)
    s: Dict[str, tuple] = {
        "time_embed.time_mlp.0.weight": (d, 256), "time_embed.time_mlp.0.bias": (d,),
        "time_embed.time_mlp.2.weight": (d, d), "time_embed.time_mlp.2.bias": (d,),
        "text_embed.text_embed.weight": (vocab_size + 1, td),
    }
    for i in range(arch["conv_layers"]):
        p = f"text_embed.text_blocks.{i}."
        s.update({p + "dwconv.weight": (td, 1, 7), p + "dwconv.bias": (td,),
                  p + "norm.weight": (td,), p + "norm.bias": (td,),
                  p + "pwconv1.weight": (hidden, td), p + "pwconv1.bias": (hidden,),
                  p + "grn.gamma": (1, 1, hidden), p + "grn.beta": (1, 1, hidden),
                  p + "pwconv2.weight": (td, hidden), p + "pwconv2.bias": (td,)})
    s.update({"input_embed.proj.weight": (d, 2 * mel_dim + td), "input_embed.proj.bias": (d,),
              "input_embed.conv_pos_embed.conv1d.0.weight": (d, d // 16, 31),
              "input_embed.conv_pos_embed.conv1d.0.bias": (d,),
              "input_embed.conv_pos_embed.conv1d.2.weight": (d, d // 16, 31),
              "input_embed.conv_pos_embed.conv1d.2.bias": (d,)})
    for i in range(arch["depth"]):
        p = f"transformer_blocks.{i}."
        s.update({p + "attn_norm.linear.weight": (6 * d, d), p + "attn_norm.linear.bias": (6 * d,)})
        for n in ("to_q", "to_k", "to_v"):
            s.update({p + f"attn.{n}.weight": (inner, d), p + f"attn.{n}.bias": (inner,)})
        s.update({p + "attn.to_out.0.weight": (d, inner), p + "attn.to_out.0.bias": (d,),
                  p + "ff.ff.0.0.weight": (ff, d), p + "ff.ff.0.0.bias": (ff,),
                  p + "ff.ff.2.weight": (d, ff), p + "ff.ff.2.bias": (d,)})
    s.update({"norm_out.linear.weight": (2 * d, d), "norm_out.linear.bias": (2 * d,),
              "proj_out.weight": (mel_dim, d), "proj_out.bias": (mel_dim,)})
    return s


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def _quant(x: torch.Tensor, fmt) -> tuple:
    """Symmetric absmax quantization along the last axis to ``fmt`` (8 or 4
    bits of integer, or ``"fp8"``, float8 e4m3): the quantized values (as
    float32) and one scale per row."""
    top = 448.0 if fmt == "fp8" else float(2 ** (fmt - 1) - 1)
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / top
    if fmt == "fp8":
        return (x / scale).to(torch.float8_e4m3fn).float(), scale
    return torch.clamp(torch.round(x / scale), -top, top), scale


QUANT_PRODUCTS = ("attn.to_q", "attn.to_k", "attn.to_v", "attn.to_out.0", "ff.ff.0.0",
                  "ff.ff.2")


def quantize_blocks(W: Weights, depth: int, fmt) -> Weights:
    """``W`` with each block product's weight replaced by ``(quantized
    values, per-channel scale, fmt)``; ``linear`` then quantizes its input per
    token."""
    out = dict(W)
    for i in range(depth):
        for n in QUANT_PRODUCTS:
            key = f"transformer_blocks.{i}.{n}.weight"
            wq, ws = _quant(W[key], fmt)
            out[key] = (wq, ws[:, 0], fmt)
    return out


def quantize_all(W: Weights, fmt) -> Weights:
    """``W`` with every matrix of the network (all the linear layers, not
    the embedding table) quantized as ``quantize_blocks`` does, and the
    attention's two products (scores and values) quantized too."""
    out = dict(W)
    for key, w in W.items():
        if key.endswith(".weight") and w.dim() == 2 and key != "text_embed.text_embed.weight":
            wq, ws = _quant(w, fmt)
            out[key] = (wq, ws[:, 0], fmt)
    out["attention_format"] = fmt
    return out


def _qmatmul(a: torch.Tensor, b: torch.Tensor, fmt) -> torch.Tensor:
    """``a @ b`` with ``a`` quantized per row and ``b`` per column."""
    if fmt is None:
        return a @ b
    aq, as_ = _quant(a, fmt)
    bq, bs = _quant(b.transpose(-1, -2), fmt)
    return (aq @ bq.transpose(-1, -2)) * as_ * bs.transpose(-1, -2)


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x wᵀ + b``; ``w`` may be a quantized triple (``quantize_blocks``)."""
    if isinstance(w, tuple):
        wq, ws, fmt = w
        xq, xs = _quant(x, fmt)
        y = (xq @ wq.t()) * xs * ws[None, :]
    else:
        y = x @ w.t()
    return y if b is None else y + b


def time_embedding(W: Weights, t: torch.Tensor) -> torch.Tensor:
    """[B] times -> [B, dim]: 256 sinusoidal features (scale 1000), MLP."""
    half = 128
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = 1000.0 * t.float()[:, None] * freqs[None, :]
    h = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    h = F.silu(linear(h, W["time_embed.time_mlp.0.weight"], W["time_embed.time_mlp.0.bias"]))
    return linear(h, W["time_embed.time_mlp.2.weight"], W["time_embed.time_mlp.2.bias"])


def _abs_pos(n: int, dim: int, device) -> torch.Tensor:
    freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float64)[: dim // 2] / dim))
    f = torch.outer(torch.arange(n, dtype=torch.float64), freqs)
    return torch.cat([torch.cos(f), torch.sin(f)], dim=-1).float().to(device)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, left: int, right: int,
          groups: int) -> torch.Tensor:
    """Channel-last ``[B, N, C]`` convolution with zero padding."""
    h = F.pad(x.transpose(1, 2), (left, right))
    return F.conv1d(h, w, b, groups=groups).transpose(1, 2)


def text_embedding(W: Weights, arch: dict, ids: torch.Tensor, n: int,
                   drop_text: bool) -> torch.Tensor:
    """``ids [B, L]`` (byte ids, -1 padded) -> ``[B, n, text_dim]``. Id 0 is
    the filler of every frame past the text; the uncond branch replaces every
    id by the filler, and a masked encoder zeroes the frames past the text."""
    ids = ids.long() + 1
    ids = F.pad(ids, (0, n - ids.shape[1]))[:, :n] if ids.shape[1] < n else ids[:, :n]
    pad = (ids == 0)[..., None]
    if drop_text:
        ids = torch.zeros_like(ids)
    table = W["text_embed.text_embed.weight"]
    emb = table[ids]
    if arch["conv_layers"] == 0:
        return emb
    mask_pad = arch.get("text_mask_padding", True)
    emb = emb + _abs_pos(n, table.shape[1], emb.device)[None]
    for i in range(arch["conv_layers"]):
        p = f"text_embed.text_blocks.{i}."
        if mask_pad:
            emb = emb.masked_fill(pad, 0.0)
        td = emb.shape[-1]
        h = _conv(emb, W[p + "dwconv.weight"], W[p + "dwconv.bias"], 3, 3, td)
        h = F.layer_norm(h, (td,), W[p + "norm.weight"], W[p + "norm.bias"], eps=1e-6)
        h = F.gelu(linear(h, W[p + "pwconv1.weight"], W[p + "pwconv1.bias"]))
        gx = torch.sqrt((h * h).sum(dim=1, keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        h = W[p + "grn.gamma"] * (h * nx) + W[p + "grn.beta"] + h
        emb = emb + linear(h, W[p + "pwconv2.weight"], W[p + "pwconv2.bias"])
    if mask_pad:
        emb = emb.masked_fill(pad, 0.0)
    return emb


def input_embedding(W: Weights, x, cond, text_emb) -> torch.Tensor:
    h = linear(torch.cat([x, cond, text_emb], dim=-1), W["input_embed.proj.weight"],
               W["input_embed.proj.bias"])
    p = "input_embed.conv_pos_embed.conv1d."
    c = F.mish(_conv(h, W[p + "0.weight"], W[p + "0.bias"], 15, 15, 16))
    c = F.mish(_conv(c, W[p + "2.weight"], W[p + "2.bias"], 15, 15, 16))
    return h + c


def rope(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Rotate interleaved pairs of the first ``n_heads`` heads of ``x [B, H,
    N, D]`` by position times ``10000^(-2i/D)``."""
    B, H, N, D = x.shape
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = torch.outer(torch.arange(N, dtype=torch.float32, device=x.device), inv)
    cos, sin = torch.cos(ang), torch.sin(ang)
    r = x[:, :n_heads]
    even, odd = r[..., 0::2], r[..., 1::2]
    rot = torch.stack([even * cos - odd * sin, odd * cos + even * sin], dim=-1).reshape(r.shape)
    return torch.cat([rot, x[:, n_heads:]], dim=1)


def block(W: Weights, arch: dict, i: int, x, t_emb, mask) -> torch.Tensor:
    p = f"transformer_blocks.{i}."
    B, N, _ = x.shape
    heads, dh = arch["heads"], arch["dim_head"]
    mod = linear(F.silu(t_emb), W[p + "attn_norm.linear.weight"], W[p + "attn_norm.linear.bias"])
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = (c[:, None] for c in mod.chunk(6, dim=-1))
    h = _ln(x) * (1 + sc_a) + sh_a
    q, k, v = (linear(h, W[p + f"attn.{n}.weight"], W[p + f"attn.{n}.bias"])
               .view(B, N, heads, dh).transpose(1, 2) for n in ("to_q", "to_k", "to_v"))
    pe = arch.get("pe_attn_head") or heads
    q, k = rope(q, pe), rope(k, pe)
    fmt = W.get("attention_format")
    s = _qmatmul(q, k.transpose(-1, -2), fmt) / math.sqrt(dh)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    a = _qmatmul(torch.softmax(s, dim=-1), v, fmt).transpose(1, 2).reshape(B, N, heads * dh)
    a = linear(a, W[p + "attn.to_out.0.weight"], W[p + "attn.to_out.0.bias"])
    x = x + g_a * a.masked_fill(~mask[..., None], 0.0)
    h = _ln(x) * (1 + sc_m) + sh_m
    h = F.gelu(linear(h, W[p + "ff.ff.0.0.weight"], W[p + "ff.ff.0.0.bias"]),
               approximate="tanh")
    return x + g_m * linear(h, W[p + "ff.ff.2.weight"], W[p + "ff.ff.2.bias"])


def head(W: Weights, h, t_emb) -> torch.Tensor:
    mod = linear(F.silu(t_emb), W["norm_out.linear.weight"], W["norm_out.linear.bias"])
    scale, shift = (c[:, None] for c in mod.chunk(2, dim=-1))
    return linear(_ln(h) * (1 + scale) + shift, W["proj_out.weight"], W["proj_out.bias"])


def velocity(W: Weights, arch: dict, x, cond, text_emb, t, mask, lo_hi, refresh: bool, cache):
    """``(velocity [B, N, mel], cache)`` of one sampler step. With a block
    range ``lo_hi``, a ``refresh`` step stores the range's residual in the
    cache and the other steps add it in place of the range's blocks."""
    depth = arch["depth"]
    t_emb = time_embedding(W, t.expand(x.shape[0]))
    h0 = input_embedding(W, x, cond, text_emb)
    lo, hi = lo_hi if lo_hi is not None else (0, depth)
    h = h0
    for i in range(lo):
        h = block(W, arch, i, h, t_emb, mask)
    if lo_hi is None or refresh:
        h_mid = h
        for i in range(lo, hi):
            h_mid = block(W, arch, i, h_mid, t_emb, mask)
        cache = h_mid - h
        h = h_mid
    else:
        h = h + cache
    for i in range(hi, depth):
        h = block(W, arch, i, h, t_emb, mask)
    return head(W, h, t_emb), cache
