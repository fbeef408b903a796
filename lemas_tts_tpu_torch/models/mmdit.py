"""MMDiT backbone, the dual-stream alternative to the DiT (counterpart of
``lemas_tts_tpu/models/mmdit.py``).

Text and audio each get their own q/k/v projections and AdaLN modulation,
attend jointly over the concatenation ``[audio ; text]`` (each stream roped
from position 0) and split again; the last block is context-pre-only (no
text output, no text FF). The joint attention is the split-head
``attention`` of the model's ``attn_backend`` (K5 under ``"vmem"``, K6 under
``"splash"``, with the text positions never masked); the FFs and
projections are plain products, as in the JAX MMDiT. The
hoistable ``embed_text`` keeps the DiT's sampler contract, so the sampler
drives either backbone. Parameters keep the reference F5-TTS ``mmdit.py``
key names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lemas_tts_tpu_torch.config import DiTArch
from lemas_tts_tpu_torch.models.modules import (
    AdaLayerNorm,
    AdaLayerNormFinal,
    ConvPositionEmbedding,
    FeedForward,
    RMSNorm,
    TimestepEmbedding,
    adaln_modulate,
    dense,
)
from lemas_tts_tpu_torch.ops.attention import attention, check_backend
from lemas_tts_tpu_torch.ops.rope import abs_pos_embedding, apply_rope, rope_angles


class MMTextEmbedding(nn.Module):
    """Token embed + absolute sinus pos (positions clamped at 1024), padding
    zeroed. ids are -1-padded; the +1 shift maps padding to the filler 0."""

    def __init__(self, out_dim: int, text_num_embeds: int, mask_padding: bool = True,
                 precompute_max_pos: int = 1024):
        super().__init__()
        self.mask_padding = mask_padding
        self.max_pos = precompute_max_pos
        self.text_embed = nn.Embedding(text_num_embeds + 1, out_dim)
        self.register_buffer(
            "freqs_cis", torch.from_numpy(abs_pos_embedding(out_dim, precompute_max_pos)),
            persistent=False)

    def forward(self, text_ids: torch.Tensor, drop_text: bool = False,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        ids = text_ids.long() + 1
        pad_mask = (ids == 0)[..., None]
        if drop_text:
            ids = torch.zeros_like(ids)
        emb = self.text_embed.weight.to(dtype)[ids]
        pos = torch.clamp(torch.arange(ids.shape[1], device=ids.device), max=self.max_pos - 1)
        emb = emb + self.freqs_cis[pos][None].to(emb.dtype)
        if self.mask_padding:
            emb = torch.where(pad_mask, 0.0, emb)
        return emb


class AudioEmbedding(nn.Module):
    """concat(noised x, cond mel) -> Linear -> + conv position embedding."""

    def __init__(self, mel_dim: int, out_dim: int):
        super().__init__()
        self.linear = nn.Linear(2 * mel_dim, out_dim)
        self.conv_pos_embed = ConvPositionEmbedding(out_dim)

    def forward(self, x, cond):
        h = dense(torch.cat([x, cond], dim=-1), self.linear)
        return self.conv_pos_embed(h) + h


class JointAttention(nn.Module):
    """Dual-stream joint attention (reference ``JointAttnProcessor``).
    Returns ``(x_out, c_out)``; ``c_out`` is None when context_pre_only."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_pre_only: bool = False,
                 qk_norm: Optional[str] = None, attn_backend: str = "vmem"):
        super().__init__()
        if qk_norm not in (None, "rms_norm"):
            raise ValueError(f"unknown qk_norm: {qk_norm!r}")
        self.attn_backend = check_backend(attn_backend)
        self.heads, self.dim_head, self.context_pre_only = heads, dim_head, context_pre_only
        inner = heads * dim_head
        for name in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c"):
            setattr(self, name, nn.Linear(dim, inner))
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(0.0)])
        if not context_pre_only:
            self.to_out_c = nn.Linear(inner, dim)
        self.qk_norm = qk_norm
        if qk_norm is not None:
            self.q_norm, self.k_norm = RMSNorm(dim_head), RMSNorm(dim_head)
            self.c_q_norm, self.c_k_norm = RMSNorm(dim_head), RMSNorm(dim_head)

    def forward(self, x, c, mask=None, angles_x=None, angles_c=None):
        B, N, _ = x.shape
        nt = c.shape[1]

        def heads_first(h, lin):
            return dense(h, lin).view(B, -1, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = (heads_first(x, lin) for lin in (self.to_q, self.to_k, self.to_v))
        cq, ck, cv = (heads_first(c, lin) for lin in (self.to_q_c, self.to_k_c, self.to_v_c))
        if self.qk_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
            cq, ck = self.c_q_norm(cq), self.c_k_norm(ck)
        if angles_x is not None:
            q, k = apply_rope(q, angles_x), apply_rope(k, angles_x)
        if angles_c is not None:
            cq, ck = apply_rope(cq, angles_c), apply_rope(ck, angles_c)
        joint_mask = None
        if mask is not None:  # text positions are never masked
            joint_mask = torch.cat([mask, mask.new_ones(B, nt)], dim=1)
        out = attention(torch.cat([q, cq], dim=2), torch.cat([k, ck], dim=2),
                        torch.cat([v, cv], dim=2), joint_mask, self.attn_backend)
        out = out.transpose(1, 2).reshape(B, N + nt, -1)
        x_out = dense(out[:, :N], self.to_out[0])
        if mask is not None:
            x_out = torch.where(mask[..., None], x_out, 0.0)  # zero padded queries
        if self.context_pre_only:
            return x_out, None
        return x_out, dense(out[:, N:], self.to_out_c)


class MMDiTBlock(nn.Module):
    """Dual-stream AdaLN-zero block: joint attention, then an FF per stream."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int = 4,
                 context_pre_only: bool = False, qk_norm: Optional[str] = None,
                 attn_backend: str = "vmem"):
        super().__init__()
        self.context_pre_only = context_pre_only
        self.attn_norm_c = AdaLayerNormFinal(dim) if context_pre_only else AdaLayerNorm(dim)
        self.attn_norm_x = AdaLayerNorm(dim)
        self.attn = JointAttention(dim, heads, dim_head, context_pre_only, qk_norm, attn_backend)
        if not context_pre_only:
            self.ff_c = FeedForward(dim, ff_mult)
        self.ff_x = FeedForward(dim, ff_mult)

    def forward(self, x, c, t_emb, mask=None, angles_x=None, angles_c=None):
        if self.context_pre_only:
            norm_c = self.attn_norm_c(c, t_emb)
        else:
            c_shift, c_scale, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.attn_norm_c(t_emb)
            norm_c = adaln_modulate(c, c_scale, c_shift)
        x_shift, x_scale, x_gate, x_shift_mlp, x_scale_mlp, x_gate_mlp = self.attn_norm_x(t_emb)
        x_attn, c_attn = self.attn(adaln_modulate(x, x_scale, x_shift), norm_c, mask,
                                   angles_x, angles_c)
        if self.context_pre_only:
            c = None
        else:
            c = c + c_gate[:, None] * c_attn
            c = c + c_gate_mlp[:, None] * self.ff_c(adaln_modulate(c, c_scale_mlp, c_shift_mlp))
        x = x + x_gate[:, None] * x_attn
        x = x + x_gate_mlp[:, None] * self.ff_x(adaln_modulate(x, x_scale_mlp, x_shift_mlp))
        return c, x


class MMDiT(nn.Module):
    """CFM velocity transformer: v = MMDiT(x_t, cond, text, t). Of ``arch``
    it reads dim, depth, heads, dim_head, ff_mult, qk_norm and
    text_mask_padding."""

    def __init__(self, arch: DiTArch, mel_dim: int = 100, text_num_embeds: int = 256,
                 compute_dtype: torch.dtype = torch.float32, attn_backend: str = "vmem"):
        super().__init__()
        self.dim_head = arch.dim_head
        self.compute_dtype = compute_dtype
        self.time_embed = TimestepEmbedding(arch.dim)
        self.text_embed = MMTextEmbedding(arch.dim, text_num_embeds,
                                          mask_padding=arch.text_mask_padding)
        self.audio_embed = AudioEmbedding(mel_dim, arch.dim)
        self.transformer_blocks = nn.ModuleList([
            MMDiTBlock(arch.dim, arch.heads, arch.dim_head, arch.ff_mult,
                       context_pre_only=i == arch.depth - 1, qk_norm=arch.qk_norm,
                       attn_backend=attn_backend)
            for i in range(arch.depth)])
        self.norm_out = AdaLayerNormFinal(arch.dim)
        self.proj_out = nn.Linear(arch.dim, mel_dim)

    def embed_text(self, text_ids: torch.Tensor, seq_len: int = 0, drop_text: bool = False):
        """Text embedding [B, nt, dim], computed once per utterance. The text
        keeps its own length: ``seq_len`` is unused (the DiT's contract)."""
        return self.text_embed(text_ids, drop_text=drop_text, dtype=self.compute_dtype)

    def forward(self, x, cond, text_ids, time, mask=None, drop_text: bool = False,
                text_embed=None, prosody_text=None):
        """Velocity [B, N, mel_dim] (f32); ``mask`` [B, N] marks the valid
        frames."""
        if prosody_text is not None:
            raise NotImplementedError("MMDiT does not take prosody_text conditioning; the "
                                      "prosody models use the DiT backbone")
        B, N, _ = x.shape
        if time.ndim == 0:
            time = time.expand(B)
        t_emb = self.time_embed(time, self.compute_dtype)
        c = text_embed if text_embed is not None else self.embed_text(text_ids,
                                                                      drop_text=drop_text)
        h = self.audio_embed(x.to(self.compute_dtype), cond.to(self.compute_dtype))
        angles_x = rope_angles(N, self.dim_head, device=x.device)
        angles_c = rope_angles(c.shape[1], self.dim_head, device=x.device)
        for blk in self.transformer_blocks:
            c, h = blk(h, c, t_emb, mask, angles_x, angles_c)
        return dense(self.norm_out(h, t_emb), self.proj_out).float()
