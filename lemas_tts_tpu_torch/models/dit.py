"""DiT backbone, the flagship CFM transformer (counterpart of
``lemas_tts_tpu/models/dit.py``).

The blocks are an ``nn.ModuleList`` run in a Python loop. Text embedding is
a separate method so the sampler computes it once per utterance;
``embed_inputs``, ``run_blocks`` and ``head`` split the forward around the
block stack (the sampler's block-range cache runs it in three ranges).

- ``use_prosody_encoder``: ``prosody_text_proj`` (Linear 512 -> text_dim)
  projects the prosody text ``[B, T_text, 512]``, which is zero-padded or cut
  to N and added to the text embedding (``embed_inputs``);
- ``arch.long_skip_connection``: ``long_skip_connection`` (Linear 2 dim -> dim,
  no bias) joins the blocks' output with their input before the head.

The training route (``forward(..., deterministic=False)`` or
``autograd=True``) is the JAX DiT on its XLA route: every block takes the
unfused, differentiable chain (``DiTBlock.forward(train=...)``), the
dropouts of ``arch.dropout`` are live when not ``deterministic``, and under
grad ``arch.checkpoint_activations`` recomputes each block in the backward
pass (``torch.utils.checkpoint``, as ``nn.remat`` does). ``drop_audio_cond``
zeroes the cond mel (the CFG audio drop). ``attn_backend`` (``"vmem"``,
``"splash"``, ``"xla"``) is every block's, as in JAX (``models/modules.py``).

Sequence parallelism (``parallel/sequence.py``): ``seq_sharded(group)`` is
the model seen by one process of a ``seq`` group, the JAX
``DiT(seq_axis=...)``: x, cond and the text embedding are this process's
shard of the sequence, the rope rows are the shard's global positions, the
conv position embedding exchanges a halo and attention runs the ring. The
text embedding (with the prosody projection folded in) must come
precomputed on the whole sequence.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from lemas_tts_tpu_torch.config import DiTArch
from lemas_tts_tpu_torch.models.modules import (
    AdaLayerNormFinal,
    ConvNeXtV2Block,
    ConvPositionEmbedding,
    DiTBlock,
    TimestepEmbedding,
    TrainRoute,
    dense,
    fold_seed,
)
from lemas_tts_tpu_torch.ops.rope import abs_pos_embedding, rope_angles

PROSODY_DIM = 512  # the prosody encoder's embedding width


class TextEmbedding(nn.Module):
    """Token embed + absolute sinus pos + masked ConvNeXtV2 stack. ids are
    -1-padded; the +1 shift maps padding to the filler token 0."""

    def __init__(self, text_num_embeds: int, text_dim: int, mask_padding: bool = True,
                 conv_layers: int = 4, conv_mult: int = 2, precompute_max_pos: int = 4096):
        super().__init__()
        self.mask_padding = mask_padding
        self.max_pos = precompute_max_pos
        self.text_embed = nn.Embedding(text_num_embeds + 1, text_dim)
        self.text_blocks = nn.Sequential(
            *[ConvNeXtV2Block(text_dim, text_dim * conv_mult) for _ in range(conv_layers)])
        self.register_buffer(
            "freqs_cis", torch.from_numpy(abs_pos_embedding(text_dim, precompute_max_pos)),
            persistent=False)

    def forward(self, text_ids: torch.Tensor, seq_len: int, drop_text: bool = False,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        ids = (text_ids.long() + 1)[:, :seq_len]
        if ids.shape[1] < seq_len:
            ids = nn.functional.pad(ids, (0, seq_len - ids.shape[1]))
        pad_mask = (ids == 0)[..., None]  # filler / batch-pad positions
        if drop_text:
            ids = torch.zeros_like(ids)
        emb = self.text_embed.weight.to(dtype)[ids]
        if len(self.text_blocks):
            pos = torch.clamp(torch.arange(seq_len, device=ids.device), max=self.max_pos - 1)
            emb = emb + self.freqs_cis[pos][None].to(emb.dtype)
            for blk in self.text_blocks:
                if self.mask_padding:
                    emb = torch.where(pad_mask, 0.0, emb)
                emb = blk(emb)
            if self.mask_padding:
                emb = torch.where(pad_mask, 0.0, emb)
        return emb


class InputEmbedding(nn.Module):
    """concat(noised x, cond mel, text emb) -> proj -> + conv pos embed."""

    def __init__(self, mel_dim: int, text_dim: int, out_dim: int):
        super().__init__()
        self.proj = nn.Linear(mel_dim * 2 + text_dim, out_dim)
        self.conv_pos_embed = ConvPositionEmbedding(out_dim)

    def forward(self, x, cond, text_embed, seq_group=None, train: bool = False):
        h = dense(torch.cat([x, cond, text_embed], dim=-1), self.proj)
        return self.conv_pos_embed(h, seq_group, train) + h


class DiT(nn.Module):
    """CFM velocity transformer: v = DiT(x_t, cond, text, t)."""

    def __init__(self, arch: DiTArch, mel_dim: int = 100, text_num_embeds: int = 256,
                 compute_dtype: torch.dtype = torch.float32, use_prosody_encoder: bool = False,
                 attn_backend: str = "vmem"):
        super().__init__()
        self.arch = arch
        self.mel_dim = mel_dim
        self.compute_dtype = compute_dtype
        text_dim = arch.text_dim if arch.text_dim is not None else mel_dim
        self.time_embed = TimestepEmbedding(arch.dim)
        self.text_embed = TextEmbedding(text_num_embeds, text_dim,
                                        mask_padding=arch.text_mask_padding,
                                        conv_layers=arch.conv_layers,
                                        conv_mult=arch.conv_mult)
        self.prosody_text_proj = (nn.Linear(PROSODY_DIM, text_dim) if use_prosody_encoder
                                  else None)
        self.input_embed = InputEmbedding(mel_dim, text_dim, arch.dim)
        self.transformer_blocks = nn.ModuleList([
            DiTBlock(arch.dim, arch.heads, arch.dim_head, arch.ff_mult, arch.qk_norm,
                     arch.pe_attn_head, attn_backend) for _ in range(arch.depth)])
        self.long_skip_connection = (nn.Linear(arch.dim * 2, arch.dim, bias=False)
                                     if arch.long_skip_connection else None)
        self.norm_out = AdaLayerNormFinal(arch.dim)
        self.proj_out = nn.Linear(arch.dim, mel_dim)
        # the data shard this process trains (cfm/train.py): its dropout
        # masks come from streams of their own, as JAX folds the key per shard
        self.dropout_fold = 0

    def embed_text(self, text_ids: torch.Tensor, seq_len: int, drop_text: bool = False):
        """Text embedding [B, seq_len, text_dim], computed once per utterance."""
        return self.text_embed(text_ids, seq_len, drop_text=drop_text, dtype=self.compute_dtype)

    def embed_prosody(self, prosody_text: torch.Tensor, seq_len: int) -> torch.Tensor:
        """``prosody_text_proj`` of ``[B, T_text, 512]``, zero-padded or cut
        to ``seq_len``: what the prosody text adds to the text embedding."""
        if self.prosody_text_proj is None:
            raise ValueError("prosody_text given to a DiT built without use_prosody_encoder")
        pt = dense(prosody_text.to(self.compute_dtype), self.prosody_text_proj)
        return (nn.functional.pad(pt, (0, 0, 0, seq_len - pt.shape[1]))
                if pt.shape[1] < seq_len else pt[:, :seq_len])

    def embed_inputs(self, x, cond, text_ids, time, drop_text: bool = False, text_embed=None,
                     prosody_text=None, drop_audio_cond: bool = False, seq_group=None,
                     train: bool = False):
        """Everything before the block stack: returns ``(h, t_emb, angles)``;
        ``h`` is also the long skip's residual. ``seq_group``: the inputs
        are this process's shard of the sequence (``seq_sharded``).
        ``train``: the training route's differentiable conv position
        embedding in place of its kernel."""
        B, N, _ = x.shape
        if time.ndim == 0:
            time = time.expand(B)
        t_emb = self.time_embed(time, self.compute_dtype)
        if seq_group is not None and (text_embed is None or prosody_text is not None):
            raise ValueError("under a seq group the text embedding (with the prosody projection "
                             "folded in) must be precomputed on the whole sequence")
        if text_embed is None:
            text_embed = self.embed_text(text_ids, N, drop_text=drop_text)
        if prosody_text is not None:
            text_embed = text_embed + self.embed_prosody(prosody_text, N)
        if drop_audio_cond:
            cond = torch.zeros_like(cond)
        h = self.input_embed(x.to(self.compute_dtype), cond.to(self.compute_dtype), text_embed,
                             seq_group, train)
        if seq_group is None:
            return h, t_emb, rope_angles(N, self.arch.dim_head, device=x.device)
        # the rope rows of this shard's global positions
        s, i = dist.get_world_size(seq_group), dist.get_rank(seq_group)
        return h, t_emb, rope_angles(N * s, self.arch.dim_head, device=x.device)[i * N:(i + 1) * N]

    def run_blocks(self, h, t_emb, mask, angles, start: int, stop: int,
                   train: Optional[list] = None, seq_group=None,
                   remat: Optional[bool] = None) -> torch.Tensor:
        """Blocks ``[start, stop)`` of the stack over ``h`` (the block-range
        cache runs the stack in three such ranges). ``train``: one
        ``TrainRoute`` a block, for the training route; ``remat`` (default
        ``arch.checkpoint_activations``) recomputes each block in the
        backward pass."""
        remat = self.arch.checkpoint_activations if remat is None else remat
        for i, blk in enumerate(self.transformer_blocks[start:stop]):
            if train is None:
                h = blk(h, t_emb, mask=mask, angles=angles, seq_group=seq_group)
            elif remat and torch.is_grad_enabled():
                h = checkpoint(blk, h, t_emb, mask, angles, train[start + i],
                               use_reentrant=False)
            else:
                h = blk(h, t_emb, mask, angles, train[start + i])
        return h

    def train_routes(self, deterministic: bool,
                     generator: Optional[torch.Generator]) -> list:
        """One ``TrainRoute`` a block: dropout ``arch.dropout`` unless
        ``deterministic``, each block's dropout seed drawn from ``generator``
        (a CPU generator; the global one when None) and folded with
        ``dropout_fold``."""
        depth = len(self.transformer_blocks)
        p = 0.0 if deterministic else float(self.arch.dropout)
        if p <= 0:
            return [TrainRoute() for _ in range(depth)]
        seeds = torch.randint(0, 2 ** 62, (depth,), generator=generator).tolist()
        return [TrainRoute(p, fold_seed(s, self.dropout_fold)) for s in seeds]

    def head(self, h: torch.Tensor, t_emb: torch.Tensor, residual=None) -> torch.Tensor:
        """The long skip (with ``residual``, the blocks' input), final AdaLN
        and mel projection; returns f32 [B, N, mel_dim]."""
        if self.long_skip_connection is not None:
            h = dense(torch.cat([h, residual], dim=-1), self.long_skip_connection)
        return dense(self.norm_out(h, t_emb), self.proj_out).float()

    def forward(self, x, cond, text_ids, time, mask=None, drop_text: bool = False,
                text_embed=None, prosody_text=None, drop_audio_cond: bool = False,
                deterministic: bool = True, autograd: bool = False,
                generator: Optional[torch.Generator] = None):
        """Velocity [B, N, mel_dim] (f32); ``mask`` [B, N] marks the valid
        frames (keys); ``prosody_text`` [B, T_text, 512] or None.
        ``deterministic=False`` (dropout live, its draws from ``generator``)
        or ``autograd=True`` (no dropout) take the training route; the
        default is the kernels."""
        routed = autograd or not deterministic
        h, t_emb, angles = self.embed_inputs(x, cond, text_ids, time, drop_text=drop_text,
                                             text_embed=text_embed, prosody_text=prosody_text,
                                             drop_audio_cond=drop_audio_cond, train=routed)
        train = self.train_routes(deterministic, generator) if routed else None
        out = self.run_blocks(h, t_emb, mask, angles, 0, len(self.transformer_blocks), train)
        return self.head(out, t_emb, residual=h)

    def seq_sharded(self, group) -> "SeqShardedDiT":
        """This model as one process of the ``seq`` group sees it."""
        return SeqShardedDiT(self, group)


class SeqShardedDiT:
    """A DiT on one process's shard of the sequence (the JAX
    ``DiT(seq_axis=...)``; same weights): the forward, ``embed_inputs``,
    ``run_blocks`` and ``head`` that ``cfm/sampler.py`` calls, each with the
    group. Inference only; the text embedding comes precomputed."""

    def __init__(self, dit: DiT, group):
        self.dit, self.group = dit, group
        self.transformer_blocks = dit.transformer_blocks

    def embed_text(self, *args, **kwargs):
        raise ValueError("under a seq group the text embedding must be precomputed on the "
                         "whole sequence (DiT.embed_text) and passed in sharded")

    def embed_inputs(self, x, cond, text_ids, time, **kwargs):
        return self.dit.embed_inputs(x, cond, text_ids, time, seq_group=self.group, **kwargs)

    def run_blocks(self, h, t_emb, mask, angles, start: int, stop: int) -> torch.Tensor:
        return self.dit.run_blocks(h, t_emb, mask, angles, start, stop, seq_group=self.group)

    def head(self, h, t_emb, residual=None) -> torch.Tensor:
        return self.dit.head(h, t_emb, residual=residual)

    def __call__(self, x, cond, text_ids, time, mask=None, text_embed=None,
                 prosody_text=None) -> torch.Tensor:
        h, t_emb, angles = self.embed_inputs(x, cond, text_ids, time, text_embed=text_embed,
                                             prosody_text=prosody_text)
        out = self.run_blocks(h, t_emb, mask, angles, 0, len(self.transformer_blocks))
        return self.head(out, t_emb, residual=h)


def cast_matrices(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store the Linear, Conv1d, ConvTranspose1d and Embedding parameters of
    ``module`` in ``dtype`` (the compute dtype), once, instead of casting them
    at every use. LayerNorm, GRN, layer-scale and snake parameters keep f32,
    as the JAX package's do, and so does a layer marked ``keep_f32`` (one
    that the JAX module runs in f32). Numerically the same as casting at use."""
    for m in module.modules():
        if (isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d, nn.Embedding))
                and not getattr(m, "keep_f32", False)):
            m.to(dtype)
    return module
