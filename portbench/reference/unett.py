"""The UNetT velocity of E2 TTS (F5-TTS ``src/f5_tts/model/backbones/
unett.py``) in plain float32 torch.

``param_shapes`` declares the parameters by name (the port's layout:
``layers.{i}.0`` the skip projection of the second half, ``.1`` the
attention's RMSNorm, ``.2`` the attention, ``.3`` the feed-forward's
RMSNorm, ``.4`` the feed-forward) and shape; ``velocity`` evaluates one
sampler step's whole forward from a dict of float32 tensors with those
names. Where the equations are the DiT's, the helpers are
``reference/dit.py``'s: the text embedding, the input embedding with its
grouped k=31 convolutional position embedding and Mish, the time MLP, the
rotary embedding on interleaved pairs and the (optionally fp8) linear
layers.

The forward, as F5-TTS writes it:

- text ids shifted by 1, cut or padded with 0 to N, every id 0 under
  ``drop_text``, looked up in the table (``conv_layers`` 0: no position
  embedding, no ConvNeXt, nothing masked);
- ``InputEmbedding``: the projection of ``[x, cond, text]``, plus the conv
  position embedding;
- the time embedding (256 sinusoidal features, MLP) as token 0, the mask
  padded with True there, rope at N + 1 on the first ``pe_attn_head`` heads;
- each of ``depth`` blocks: in the first half the input is pushed on a
  stack; in the second half one is popped and joined (``concat``: concat and
  a bias-free projection back to ``dim``; ``add``; ``none``); then
  ``x + Attn(RMSNorm(x))`` (softmax over unmasked keys, outputs of padded
  frames zeroed after the output projection) and ``x + FF(RMSNorm(x))``
  with tanh-GELU;
- ``norm_out``, token 0 dropped, ``proj_out``.

Departures from F5-TTS, each below the port's bf16 gap by orders:

- RMSNorm: F5-TTS takes x_transformers' ``RMSNorm``, ``F.normalize(x) *
  sqrt(dim) * g``, whose eps (1e-12) clamps the L2 norm; the port divides by
  ``sqrt(mean(x^2) + 1e-6)``. The reference follows F5-TTS: on rows whose
  mean square is m the two differ by a factor ``(1 + 1e-6 / m)^(-1/2)``, a
  relative 5e-7 at m = 1.
- Dropout (0.1 in training) is off, as at inference; the gains are named
  ``weight`` (F5-TTS: ``g``).
- No block cache: UNetT has none, so ``velocity`` refuses a block range.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import dit as d

Weights = Dict[str, torch.Tensor]
SKIP_TYPES = ("concat", "add", "none")


def skip_type(arch: dict) -> str:
    s = arch.get("skip_connect_type", "concat")
    if s not in SKIP_TYPES:
        raise ValueError(f"unknown skip_connect_type: {s!r}")
    return s


def param_shapes(arch: dict, mel_dim: int, vocab_size: int) -> Dict[str, tuple]:
    """Name -> shape of every parameter, in the port's declaration order."""
    dim = arch["dim"]
    td = arch["text_dim"] if arch.get("text_dim") is not None else mel_dim
    inner = arch["heads"] * arch["dim_head"]
    ff = dim * arch["ff_mult"]
    # the DiT's time MLP, text table and stack, input embedding: its own names
    dit = d.param_shapes(dict(arch, text_dim=td, depth=0), mel_dim, vocab_size)
    s = {k: v for k, v in dit.items() if not k.startswith(("norm_out.", "proj_out."))}
    for i in range(arch["depth"]):
        p = f"layers.{i}."
        if skip_type(arch) == "concat" and i >= arch["depth"] // 2:
            s[p + "0.weight"] = (dim, 2 * dim)
        s[p + "1.weight"] = (dim,)
        for n in ("to_q", "to_k", "to_v"):
            s.update({p + f"2.{n}.weight": (inner, dim), p + f"2.{n}.bias": (inner,)})
        s.update({p + "2.to_out.0.weight": (dim, inner), p + "2.to_out.0.bias": (dim,),
                  p + "3.weight": (dim,),
                  p + "4.ff.0.0.weight": (ff, dim), p + "4.ff.0.0.bias": (ff,),
                  p + "4.ff.2.weight": (dim, ff), p + "4.ff.2.bias": (dim,)})
    s.update({"norm_out.weight": (dim,), "proj_out.weight": (mel_dim, dim),
              "proj_out.bias": (mel_dim,)})
    return s


def rms_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x_transformers' ``RMSNorm``: ``F.normalize(x) * sqrt(dim) * g``."""
    return F.normalize(x, dim=-1) * math.sqrt(x.shape[-1]) * g


def attention(W: Weights, arch: dict, p: str, x: torch.Tensor, mask: torch.Tensor):
    B, N, _ = x.shape
    heads, dh = arch["heads"], arch["dim_head"]
    q, k, v = (d.linear(x, W[p + f"{n}.weight"], W[p + f"{n}.bias"])
               .view(B, N, heads, dh).transpose(1, 2) for n in ("to_q", "to_k", "to_v"))
    pe = arch.get("pe_attn_head") or heads
    q, k = d.rope(q, pe), d.rope(k, pe)
    fmt = W.get("attention_format")
    s = d._qmatmul(q, k.transpose(-1, -2), fmt) / math.sqrt(dh)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    a = d._qmatmul(torch.softmax(s, dim=-1), v, fmt).transpose(1, 2).reshape(B, N, heads * dh)
    a = d.linear(a, W[p + "to_out.0.weight"], W[p + "to_out.0.bias"])
    return a.masked_fill(~mask[..., None], 0.0)


def feed_forward(W: Weights, p: str, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(d.linear(x, W[p + "ff.0.0.weight"], W[p + "ff.0.0.bias"]), approximate="tanh")
    return d.linear(h, W[p + "ff.2.weight"], W[p + "ff.2.bias"])


def velocity(W: Weights, arch: dict, x, cond, text_emb, t, mask, lo_hi, refresh: bool, cache):
    """``(velocity [B, N, mel], None)`` of one sampler step; ``lo_hi`` and
    ``cache`` must be None (UNetT has no block cache)."""
    if lo_hi is not None or cache is not None:
        raise ValueError("UNetT has no block cache")
    depth, skip = arch["depth"], skip_type(arch)
    t_emb = d.time_embedding(W, t.expand(x.shape[0]))
    h = torch.cat([t_emb[:, None], d.input_embedding(W, x, cond, text_emb)], dim=1)
    mask = F.pad(mask, (1, 0), value=True)
    skips = []
    for i in range(depth):
        p = f"layers.{i}."
        if i < depth // 2:
            skips.append(h)
        else:
            s = skips.pop()
            if skip == "concat":
                h = d.linear(torch.cat([h, s], dim=-1), W[p + "0.weight"], None)
            elif skip == "add":
                h = h + s
        h = h + attention(W, arch, p + "2.", rms_norm(h, W[p + "1.weight"]), mask)
        h = h + feed_forward(W, p + "4.", rms_norm(h, W[p + "3.weight"]))
    h = rms_norm(h, W["norm_out.weight"])[:, 1:]
    return d.linear(h, W["proj_out.weight"], W["proj_out.bias"]), None
