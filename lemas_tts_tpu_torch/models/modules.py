"""Building blocks of the DiT backbone (counterpart of
``lemas_tts_tpu/models/modules.py``).

Numerics follow the JAX modules: erf-GELU in ConvNeXtV2, tanh-GELU in
FeedForward, AdaLN chunks in the reference order, GRN over the sequence axis,
the interleaved-pair rope. Parameters keep the reference torch key names
(``tests/torch_ref/dit_torch.py``), so reference checkpoints load directly.
Layers run in the dtype of their input (the compute dtype): weights are cast
to it at use, as flax's ``dtype=`` does; LayerNorms compute in f32.

Under ``attn_backend="vmem"`` (the port's default) ``DiTBlock`` chooses its
kernels by shape alone, as the JAX block does on its TPU path, on either
device (the CPU runs each kernel's plain version):

- attention side: ``qkv_block`` (K1) and the flat ``vmem_attention_nhd`` (K3;
  K4 under ``LEMAS_ATTN_PACK=1``) when both take the geometry; otherwise
  AdaLN in PyTorch and ``Attention``: K3 when the flat kernel takes the heads,
  else split heads, qk RMSNorm, rope on the first ``pe_attn_head`` heads and
  the split-head ``attention`` (K5);
- FF side: ``ffn_block`` (K2) whenever it takes the widths, else the
  unfused chain.

Under ``"splash"`` or ``"xla"`` (the JAX names, ``models/modules.py:369``,
``:519``, ``:554``) K1, K2 and K3 stay off: the block runs AdaLN in
PyTorch, the split-head chain with ``attention(..., backend=)`` (K6, or
plain ``sdpa``) and the unfused FF.

The training route (``DiTBlock.forward(..., train=...)``, the JAX XLA
route that ``cfm/loss.py`` and ``cfm/distill.py`` differentiate through)
takes the unfused chain on either device: AdaLN in PyTorch, attention by
``sdpa_train`` and the dropouts of ``arch.dropout`` where the JAX modules
apply them (after the FF GELU and after ``to_out``). The kernels define no
backward, so it runs none of them.

Under tensor parallelism (``parallel/tensor.py``) the split modules carry
a ``tp`` record and hold their slice of the split weights: column-parallel
q/k/v and FF-in, row-parallel ``to_out``, FF-out and AdaLN modulations
(``row_dense``), this process's heads in attention. Only the training route
takes them.

Under sequence parallelism (``seq_group``, ``parallel/sequence.py``) the
block takes the unfused attention side with ``ring_attention`` and keeps
K2, as the JAX block does under ``seq_axis``; the conv position embedding
exchanges a halo with its neighbours.

Under W8A8 int8 (``ops/quant.py``, the JAX ``int8``/``int8_ff`` split of
``models/modules.py:488-495``) the quantized products are ``QuantLinear``s:
``int8`` quantizes q/k/v, the output projection and both FF products, so the
block leaves K1 and K2 and K3 still runs on the int8 q/k/v; ``int8_ff``
quantizes the FF products only, so only K2 is left.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from lemas_tts_tpu_torch.ops.attention import (attention, check_backend, nhd_supported,
                                                vmem_attention_nhd)
from lemas_tts_tpu_torch.ops.conv import conv_taps, conv_taps_mish
from lemas_tts_tpu_torch.ops.ffn import (ffn_block, ffn_block_supported, qkv_block,
                                         qkv_block_supported)
from lemas_tts_tpu_torch.ops.quant import QuantLinear, int8_dense_shared
from lemas_tts_tpu_torch.ops.ring_attention import halo_exchange, ring_attention
from lemas_tts_tpu_torch.ops.rope import apply_rope


def fold_seed(seed: int, k: int) -> int:
    """A seed of its own for stream ``k`` of ``seed`` (``k`` 0: ``seed``)."""
    return (seed + k * 0x9E3779B97F4A7C15) % 2 ** 62


class TrainRoute:
    """How a block runs on the training route: the dropout rate (0 when
    deterministic) and the seed of the block's own dropout generator, so a
    recomputed block (activation checkpointing) draws the same masks.
    ``drop(x, stream)`` draws from stream 0 (the block's generator) or from
    a stream of its own (a ``model`` split's part of a split activation)."""

    def __init__(self, dropout: float = 0.0, seed: Optional[int] = None):
        self.dropout = dropout
        self.seed = seed
        self.generator: Optional[torch.Generator] = None
        self.streams: dict = {}

    def start(self, device: torch.device) -> "TrainRoute":
        """A fresh generator from the seed, for one (re)run of the block."""
        if self.dropout > 0:
            self.generator = torch.Generator(device=device).manual_seed(self.seed)
            self.streams = {}
        return self

    def drop(self, x: torch.Tensor, stream: int = 0) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability 1 - p, scale by 1 / (1 - p)."""
        if self.dropout <= 0:
            return x
        gen = self.generator
        if stream:
            gen = self.streams.get(stream)
            if gen is None:
                gen = self.streams[stream] = torch.Generator(device=x.device).manual_seed(
                    fold_seed(self.seed, stream))
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


def sdpa_train(q, k, v, mask=None):
    """Differentiable attention of the training route (the JAX XLA ``sdpa``,
    ``lemas_tts_tpu/ops/attention.py:28-47``): q, k, v [B, H, N, D]; mask
    [B, N] keys (True = keep). ``F.scaled_dot_product_attention`` keeps the
    scores out of memory. A query row whose keys are all masked gives NaN
    here where the JAX ``sdpa`` gives the mean of v; training never has one
    while every length is >= 1 (``cfm/loss.py`` checks it)."""
    m = None if mask is None else mask[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=m)


def dense(x: torch.Tensor, lin: nn.Module) -> torch.Tensor:
    """flax ``nn.Dense(dtype=x.dtype)``: product in x's dtype, then + bias;
    a ``QuantLinear`` runs the W8A8 product (``ops/quant.py:int8_dense``)."""
    if isinstance(lin, QuantLinear):
        return lin(x)
    y = torch.matmul(x, lin.weight.to(x.dtype).t())
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def row_dense(x: torch.Tensor, lin: nn.Linear, tp) -> torch.Tensor:
    """A row-parallel ``dense``: this process's part of x times its part of
    the weight, summed over the ``model`` group, then the bias once."""
    y = tp.reduce_out(torch.matmul(x, lin.weight.to(x.dtype).t()))
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def conv1d(x: torch.Tensor, conv: nn.Conv1d, padding) -> torch.Tensor:
    """Channel-last ``[B, N, C]`` 1-D convolution in x's dtype; ``padding``
    is ``(left, right)``."""
    h = F.pad(x.transpose(1, 2), padding)
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv1d(h, w, b, dilation=conv.dilation, groups=conv.groups).transpose(1, 2)


def layer_norm_f32(x: torch.Tensor, norm: Optional[nn.LayerNorm] = None,
                   eps: float = 1e-6) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)``: fast variance clipped at 0,
    optional affine; returns f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if norm is not None and norm.weight is not None:
        y = y * norm.weight.float() + norm.bias.float()
    return y


def adaln_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``T(LN(x)) * (1 + scale) + shift`` (LN without affine, f32 stats);
    x [B, N, D], scale/shift [B, D]."""
    return layer_norm_f32(x).to(x.dtype) * (1 + scale[:, None]) + shift[:, None]


def sinus_position_embedding(x: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """[B] scalar positions -> [B, dim] sin/cos features."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = scale * x.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Sinusoidal(256) -> Linear -> SiLU -> Linear."""

    def __init__(self, dim: int, freq_embed_dim: int = 256):
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        self.time_mlp = nn.Sequential(nn.Linear(freq_embed_dim, dim), nn.SiLU(),
                                      nn.Linear(dim, dim))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = sinus_position_embedding(t, self.freq_embed_dim).to(dtype)
        return dense(F.silu(dense(h, self.time_mlp[0])), self.time_mlp[2])


class ConvPositionEmbedding(nn.Module):
    """Two grouped k=31 convs with Mish, padded ``(K-1)//2`` on the left and
    ``K//2`` on the right (flax SAME). Inference runs each conv with its bias
    and Mish as one ``conv_taps_mish`` (``ops/conv.py``: the JAX package's
    shifted-tap form; on CUDA one kernel launch), on taps made from the
    weight at each call. The training route (``train=True``) runs the
    differentiable chain, a grouped ``conv1d`` then ``F.mish``: the kernel
    defines no backward.

    With a ``seq_group`` (sequence-parallel sampling, ``parallel/sequence.py``)
    x is this process's shard of the sequence: one halo of ``2·(K//2)``
    frames a side from the neighbours (``ops/ring_attention.halo_exchange``),
    then both convs unpadded, the first conv's rows outside the global
    sequence zeroed in between, as the global chain's zero padding of the
    second conv does (JAX ``modules.py:141-170``)."""

    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16):
        super().__init__()
        self.conv1d = nn.Sequential(
            nn.Conv1d(dim, dim, kernel_size, groups=groups), nn.Mish(),
            nn.Conv1d(dim, dim, kernel_size, groups=groups), nn.Mish())

    def _kernel(self, x: torch.Tensor, i: int, padding) -> torch.Tensor:
        c = self.conv1d[i]
        return conv_taps_mish(x, conv_taps(c.weight, c.groups, x.dtype), c.bias.to(x.dtype),
                              padding)

    def _chain(self, x: torch.Tensor, i: int, padding) -> torch.Tensor:
        return F.mish(conv1d(x, self.conv1d[i], padding))

    def forward(self, x: torch.Tensor, seq_group=None, train: bool = False) -> torch.Tensor:
        conv_mish = self._chain if train else self._kernel
        k = self.conv1d[0].kernel_size[0]
        if seq_group is None:
            pad = ((k - 1) // 2, k // 2)
            return conv_mish(conv_mish(x, 0, pad), 2, pad)
        if k % 2 != 1:
            raise ValueError(f"the sequence-parallel halo needs an odd kernel, not {k}")
        half, nl = k // 2, x.shape[1]
        h = conv_mish(halo_exchange(x, 2 * half, seq_group), 0, (0, 0))
        # rows of conv1's output whose centre lies outside the global sequence:
        # the global chain's zero padding of conv2 has 0 there, not mish(bias)
        centers = (torch.arange(h.shape[1], device=x.device) - half
                   + dist.get_rank(seq_group) * nl)
        inside = (centers >= 0) & (centers < nl * dist.get_world_size(seq_group))
        h = torch.where(inside[None, :, None], h, 0.0)
        return conv_mish(h, 2, (0, 0))


class GRN(nn.Module):
    """Global response norm over the sequence axis."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gx = torch.sqrt(torch.sum(x.float() ** 2, dim=1, keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma * (x * nx.to(x.dtype)) + self.beta + x).to(x.dtype)


class ConvNeXtV2Block(nn.Module):
    """Depthwise k=7 conv -> LN -> pw expand -> GELU(erf) -> GRN -> pw back,
    residual."""

    def __init__(self, dim: int, intermediate_dim: int, dilation: int = 1):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, groups=dim, dilation=dilation)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.dwconv.dilation[0] * 3
        h = conv1d(x, self.dwconv, (pad, pad))
        h = layer_norm_f32(h, self.norm).to(x.dtype)
        h = F.gelu(dense(h, self.pwconv1))
        h = self.grn(h)
        return x + dense(h, self.pwconv2)


class RMSNorm(nn.Module):
    """Per-head qk RMSNorm option."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight).to(x.dtype)


class FeedForward(nn.Module):
    """Linear -> GELU(tanh) -> Linear (reference keys ``ff.0.0``, ``ff.2``)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.ff = nn.Sequential(nn.Sequential(nn.Linear(dim, inner), nn.GELU(approximate="tanh")),
                                nn.Dropout(0.0), nn.Linear(inner, dim))
        self.tp = None  # parallel/tensor.py: column-parallel in, row-parallel out

    def forward(self, x: torch.Tensor, train: Optional[TrainRoute] = None) -> torch.Tensor:
        tp = self.tp
        if tp is not None:
            x = tp.copy_in(x)
        h = F.gelu(dense(x, self.ff[0][0]), approximate="tanh")
        if train is not None:  # a split hidden draws its columns' masks from a stream of its own
            h = train.drop(h, 0 if tp is None else 1 + tp.rank)
        return dense(h, self.ff[2]) if tp is None else row_dense(h, self.ff[2], tp)


class Attention(nn.Module):
    """Multi-head self-attention with rope (reference projection layout);
    ``attn_backend`` is the split-head ``attention`` backend, and only
    ``"vmem"`` takes the flat kernel K3."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 qk_norm: Optional[str] = None, pe_attn_head: Optional[int] = None,
                 attn_backend: str = "vmem"):
        super().__init__()
        if qk_norm not in (None, "rms_norm"):
            raise ValueError(f"unknown qk_norm: {qk_norm!r}")
        self.attn_backend = check_backend(attn_backend)
        self.heads, self.dim_head = heads, dim_head
        self.qk_norm, self.pe_attn_head = qk_norm, pe_attn_head
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(0.0)])
        if qk_norm is not None:
            self.q_norm = RMSNorm(dim_head)
            self.k_norm = RMSNorm(dim_head)
        else:
            self.q_norm = self.k_norm = None
        self.tp = None  # parallel/tensor.py: this process's heads

    def forward(self, x, mask=None, angles=None, train: Optional[TrainRoute] = None,
                seq_group=None):
        """Unfused chain: x is the modulated, normalised residual stream.
        ``train``: the training route (``sdpa_train``, dropout after
        ``to_out``). ``seq_group``: x is this process's shard of the
        sequence, and attention is ``ring_attention`` over the group."""
        B, N, _ = x.shape
        if train is not None:
            return self.forward_train(x, mask, angles, train)
        if isinstance(self.to_q, QuantLinear):  # int8: x quantized once for q, k, v
            q, k, v = int8_dense_shared(x, (self.to_q, self.to_k, self.to_v))
        else:
            q, k, v = (dense(x, lin) for lin in (self.to_q, self.to_k, self.to_v))
        if seq_group is not None:
            q, k, v = self.split_rope(q, k, v, angles)
            out = ring_attention(q, k, v, mask, seq_group)
            return self.project_out(out.transpose(1, 2).reshape(B, N, -1), mask)
        if (self.attn_backend == "vmem" and angles is not None
                and nhd_supported(self.heads, self.dim_head, N, self.qk_norm, self.pe_attn_head)):
            return self.project_out(vmem_attention_nhd(q, k, v, mask, angles, self.heads), mask)

        q, k, v = self.split_rope(q, k, v, angles)
        out = attention(q, k, v, mask, self.attn_backend).transpose(1, 2).reshape(B, N, -1)
        return self.project_out(out, mask)

    def split_rope(self, q, k, v, angles):
        """q, k, v [B, N, H*D] -> [B, H, N, D], with the qk norm and the rope
        on the first ``pe_attn_head`` heads (all by default). Under tensor
        parallelism H is this process's heads, the global heads from
        ``rank * H`` on."""
        B, N, _ = q.shape
        heads = q.shape[-1] // self.dim_head
        first = 0 if self.tp is None else self.tp.rank * heads

        def split(t):
            return t.view(B, N, heads, self.dim_head).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if angles is not None:
            pn = self.heads if self.pe_attn_head is None else self.pe_attn_head
            pn = min(max(pn - first, 0), heads)  # this process's heads that take the rope
            q = torch.cat([apply_rope(q[:, :pn], angles), q[:, pn:]], dim=1)
            k = torch.cat([apply_rope(k[:, :pn], angles), k[:, pn:]], dim=1)
        return q, k, v

    def forward_train(self, x, mask, angles, train: TrainRoute):
        B, N, _ = x.shape
        tp = self.tp
        if tp is not None:
            x = tp.copy_in(x)
        q, k, v = self.split_rope(*(dense(x, lin) for lin in (self.to_q, self.to_k, self.to_v)),
                                  angles)
        out = sdpa_train(q, k, v, mask).transpose(1, 2).reshape(B, N, -1)
        out = dense(out, self.to_out[0]) if tp is None else row_dense(out, self.to_out[0], tp)
        out = train.drop(out)
        if mask is not None:
            out = torch.where(mask[..., None], out, 0.0)  # zero padded queries
        return out

    def project_out(self, out, mask):
        out = dense(out, self.to_out[0])
        if mask is not None:
            out = torch.where(mask[..., None], out, 0.0)  # zero padded queries
        return out


def modulation(e: torch.Tensor, lin: nn.Linear, tp) -> torch.Tensor:
    """The AdaLN modulation ``dense(e, lin)``; under tensor parallelism
    row-parallel over its input (the JAX plan's ``mod``), ``lin`` holding
    this process's input columns."""
    if tp is None:
        return dense(e, lin)
    return row_dense(tp.take(tp.copy_in(e), lin.weight.shape[1]), lin, tp)


class AdaLayerNorm(nn.Module):
    """AdaLN-zero: 6 modulation chunks, shift/scale/gate (msa) then
    shift/scale/gate (mlp)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, dim * 6)
        self.tp = None  # parallel/tensor.py: row-parallel over the input

    def forward(self, emb: torch.Tensor):
        return modulation(F.silu(emb), self.linear, self.tp).chunk(6, dim=-1)


class AdaLayerNormFinal(nn.Module):
    """Final AdaLN: 2 chunks in scale-then-shift order."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, dim * 2)
        self.tp = None  # parallel/tensor.py: row-parallel over the input

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        scale, shift = modulation(F.silu(emb), self.linear, self.tp).chunk(2, dim=-1)
        return adaln_modulate(x, scale, shift)


class DiTBlock(nn.Module):
    """AdaLN -> attention -> gate, LN-modulate -> FF -> gate."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int = 4,
                 qk_norm: Optional[str] = None, pe_attn_head: Optional[int] = None,
                 attn_backend: str = "vmem"):
        super().__init__()
        self.attn_norm = AdaLayerNorm(dim)
        self.attn = Attention(dim, heads, dim_head, qk_norm, pe_attn_head, attn_backend)
        self.ff = FeedForward(dim, ff_mult)

    def fused_attn_ok(self, n: int) -> bool:
        """Whether K1 + K3 take the attention side at sequence length ``n``
        (only under ``"vmem"``; not under int8: quantized q/k/v leave K1,
        and K3 still runs)."""
        a = self.attn
        return (a.attn_backend == "vmem" and not isinstance(a.to_q, QuantLinear)
                and nhd_supported(a.heads, a.dim_head, n, a.qk_norm, a.pe_attn_head)
                and qkv_block_supported(n, a.to_q.in_features, a.heads * a.dim_head))

    def fused_ff_ok(self, n: int) -> bool:
        """Whether K2 takes the FF side at sequence length ``n`` (only under
        ``"vmem"``; not under ``int8`` or ``int8_ff``: the quantized FF
        products leave K2)."""
        down = self.ff.ff[2]
        return (self.attn.attn_backend == "vmem" and not isinstance(down, QuantLinear)
                and ffn_block_supported(n, down.out_features, down.in_features))

    def forward(self, x, t_emb, mask=None, angles=None, train: Optional[TrainRoute] = None,
                seq_group=None):
        """``train``: the training route (unfused, differentiable, with
        dropout), else the kernels as the shapes allow. ``seq_group``: x is
        this process's shard of the sequence; the attention side takes the
        unfused chain with ring attention (no K1, K3), the FF side keeps K2
        (JAX ``modules.py:517-563``)."""
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = self.attn_norm(t_emb)
        if train is not None:
            train.start(x.device)
            x = x + g_a[:, None] * self.attn(adaln_modulate(x, sc_a, sh_a), mask=mask,
                                             angles=angles, train=train)
            return x + g_m[:, None] * self.ff(adaln_modulate(x, sc_m, sh_m), train)
        if self.attn.tp is not None:
            raise ValueError("a tensor-parallel block runs only the training route")
        n, cdt = x.shape[1], x.dtype
        x = x.contiguous()  # the kernels read x through its pointer
        if angles is not None and seq_group is None and self.fused_attn_ok(n):
            a = self.attn
            q, k, v = qkv_block(
                x, sc_a.contiguous(), sh_a.contiguous(),
                *(t for lin in (a.to_q, a.to_k, a.to_v)
                  for t in (lin.weight.to(cdt), lin.bias.to(cdt))))
            # the JAX package's probe switch for the head-pair kernel (K4); never a default
            out = vmem_attention_nhd(q, k, v, mask, angles, a.heads,
                                     pack_pair=os.environ.get("LEMAS_ATTN_PACK", "") == "1")
            attn_out = a.project_out(out, mask)
        else:
            attn_out = self.attn(adaln_modulate(x, sc_a, sh_a), mask=mask, angles=angles,
                                 seq_group=seq_group)
        x = x + g_a[:, None] * attn_out
        if self.fused_ff_ok(n):
            ff = self.ff.ff
            return ffn_block(x, sc_m.contiguous(), sh_m.contiguous(), g_m.contiguous(),
                             ff[0][0].weight.to(cdt), ff[0][0].bias.to(cdt),
                             ff[2].weight.to(cdt), ff[2].bias.to(cdt))
        return x + g_m[:, None] * self.ff(adaln_modulate(x, sc_m, sh_m))
