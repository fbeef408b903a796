"""Pipeline parallelism: GPipe over the DiT's blocks (counterpart of
``lemas_tts_tpu/parallel/pipeline.py``).

A ``("data", "pipe")`` mesh (``make_pipe_mesh``): each stage of ``pipe``
holds a contiguous range of ``depth / pipe`` blocks; the embeddings and the
head are whole on every stage. Each step, every stage computes the
embeddings of its data shard (the replicated compute of the JAX design),
the local batch is cut into ``M`` microbatches, and they flow through the
stages: stage 0 takes the input embedding's rows, every other stage
receives the previous stage's activation, runs its blocks and sends the
result on. The last stage joins the ``M`` outputs, runs the head, and the
loss is the global batch's there (``cfm/loss.py``, ``group``).

The schedule is written by hand with blocking point-to-point sends and
receives on the ``pipe`` group's global ranks (as ``ops/ring_attention.py``
does), rather than ``torch.distributed.pipelining``: the loss's global
denominators, clamps and the CTC gate are computed once on the whole batch,
so the step equals the plain trainer's (the JAX pipeline, which runs its
``M + P - 1`` ticks under one ``scan`` and then the head on the whole
batch, does the same). Forward: stage ``s`` works on microbatch ``m`` while
stage ``s + 1`` works on ``m - 1``. Backward: the last stage's one backward
(head, loss and its blocks for every microbatch) gives the gradient of each
received activation, sent back in microbatch order; every other stage
runs its blocks' backward for each microbatch as the gradient arrives and
passes the gradient of its input on. The embeddings' gradient (of the time
embedding that feeds every block's AdaLN, and on stage 0 of the input) is
then one backward per stage, and the gradients of every parameter held by
all stages are summed over ``pipe`` (JAX's ``psum('pipe')``,
``ParamPlacement.reduce_grads``).

``PipelinedTrainer`` composes with ``data`` (the gradient's mean) and with
``fsdp`` (the stage's leaves split once more over ``data``, gathered for
the step), and refuses a ``model`` axis, as JAX does. As in JAX its AdamW
runs without the optax chain's clip (the clip is the pipelined one, on the
norm summed over the stages) and without gradient accumulation (raise the
microbatches instead).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from lemas_tts_tpu_torch.cfm.train import Trainer, TrainState
from lemas_tts_tpu_torch.config import TrainConfig
from lemas_tts_tpu_torch.models.modules import TrainRoute, fold_seed
from lemas_tts_tpu_torch.parallel.mesh import (axis_rank, axis_size, device_mesh,
                                               fsdp_param_dims, gather_output)


def make_pipe_mesh(n_devices: Optional[int] = None, pipe_parallel: int = 2,
                   device_type: Optional[str] = None):
    """``("data", "pipe")`` mesh over the job's processes: the batch over
    ``data``, the DiT's block stages over ``pipe``."""
    return device_mesh(n_devices, pipe_parallel, ("data", "pipe"), device_type)


def stage_blocks(depth: int, pipe: int, stage: int) -> tuple:
    """The ``[start, stop)`` block range of ``stage``."""
    if depth % pipe:
        raise ValueError(f"depth {depth} does not split into {pipe} pipeline stages")
    k = depth // pipe
    return stage * k, (stage + 1) * k


def pipe_param_stages(dit: nn.Module, pipe: int, prefix: str = "") -> Dict[str, int]:
    """The JAX ``pipe_param_pspecs`` under the port's names: ``{name:
    stage}`` for every block parameter (the stage that holds its block);
    every other parameter is on every stage (absent)."""
    depth = len(dit.transformer_blocks)
    out = {}
    for i, blk in enumerate(dit.transformer_blocks):
        stage = next(s for s in range(pipe) if i < stage_blocks(depth, pipe, s)[1])
        for n, _ in blk.named_parameters():
            out[f"{prefix}transformer_blocks.{i}.{n}"] = stage
    return out


class _Pipe:
    """One stage's view of the ``pipe`` group: the neighbours' global ranks."""

    def __init__(self, mesh):
        self.size = axis_size(mesh, "pipe")
        self.stage = axis_rank(mesh, "pipe")
        self.group = mesh.get_group("pipe")
        self.first, self.last = self.stage == 0, self.stage == self.size - 1

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def send(self, t: torch.Tensor, to: int) -> None:
        dist.send(t.contiguous(), self.peer(to), group=self.group)

    def recv(self, like: torch.Tensor, frm: int) -> torch.Tensor:
        t = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        dist.recv(t, self.peer(frm), group=self.group)
        return t


def pipeline_blocks(dit: nn.Module, pipe: _Pipe, h: torch.Tensor, t_emb: torch.Tensor, mask,
                    angles, M: int, routes: Optional[List[list]] = None,
                    remat: Optional[bool] = None) -> tuple:
    """The forward half of the schedule on this stage: ``(inputs,
    outputs)`` per microbatch. ``h`` is the stage's input embedding (used
    on stage 0), ``routes`` one list of ``TrainRoute``s a microbatch (the
    training route), else the serving route."""
    B = h.shape[0]
    if B % M:
        raise ValueError(f"the local batch {B} does not split into {M} microbatches")
    b = B // M
    lo, hi = stage_blocks(len(dit.transformer_blocks), pipe.size, pipe.stage)
    ins, outs = [], []
    for m in range(M):
        rows = slice(m * b, (m + 1) * b)
        if pipe.first:
            x = h[rows]
        else:
            x = pipe.recv(h[rows], pipe.stage - 1)
            if routes is not None and torch.is_grad_enabled():
                x.requires_grad_(True)
        out = dit.run_blocks(x, t_emb[rows], None if mask is None else mask[rows], angles, lo,
                             hi, None if routes is None else routes[m], remat=remat)
        if not pipe.last:
            pipe.send(out.detach(), pipe.stage + 1)
        ins.append(x)
        outs.append(out)
    return ins, outs


def pipeline_forward(dit: nn.Module, mesh, num_microbatches: Optional[int] = None):
    """The pipelined DiT forward over a ``("data", "pipe")`` mesh (the JAX
    ``pipeline_dit_forward``): ``fn(x, cond, text_ids, time, mask)`` of the
    whole batch, on every process, equal to ``dit(x, cond, text_ids, time,
    mask)`` (the serving route, no grad). Each data shard runs its rows
    through the stages; the last stage's result is broadcast over ``pipe``
    and joined over ``data``."""
    pipe = _Pipe(mesh)
    M = num_microbatches or pipe.size
    d, r = axis_size(mesh, "data"), axis_rank(mesh, "data")

    @torch.no_grad()
    def fn(x, cond, text_ids, time, mask=None):
        B = x.shape[0]
        if B % d:
            raise ValueError(f"batch {B} does not split over the {d} processes of 'data'")
        rows = slice(r * (B // d), (r + 1) * (B // d))
        x, cond, text_ids, time = x[rows], cond[rows], text_ids[rows], time[rows]
        mask = None if mask is None else mask[rows]
        h, t_emb, angles = dit.embed_inputs(x, cond, text_ids, time)
        _, outs = pipeline_blocks(dit, pipe, h, t_emb, mask, angles, M)
        if pipe.last:
            pred = dit.head(torch.cat(outs), t_emb, residual=h)
        else:
            pred = torch.empty(*x.shape[:2], dit.mel_dim, device=x.device)
        dist.broadcast(pred, pipe.peer(pipe.size - 1), group=pipe.group)
        return gather_output(pred, mesh.get_group("data"), 0)

    return fn


class PipelineRun:
    """One training step's pipelined DiT, called by ``cfm_training_loss``
    in place of the DiT: ``__call__`` runs the forward half (the prediction
    on the last stage, zeros elsewhere, which no stage differentiates) and
    ``backward(loss)`` the backward half."""

    def __init__(self, dit: nn.Module, pipe: _Pipe, M: int, remat: bool):
        self.dit, self.pipe, self.M, self.remat = dit, pipe, M, remat
        self.prosody_text_proj = dit.prosody_text_proj

    def __call__(self, x, cond, text_ids, time, mask=None, drop_text=False, prosody_text=None,
                 drop_audio_cond=False, deterministic=True, generator=None):
        dit, pipe = self.dit, self.pipe
        h, t_emb, angles = dit.embed_inputs(x, cond, text_ids, time, drop_text=drop_text,
                                            prosody_text=prosody_text,
                                            drop_audio_cond=drop_audio_cond, train=True)
        # every stage but the last cuts the embeddings off its blocks' graph:
        # their gradient is complete only after every microbatch's backward
        self.h, self.t_emb = h, t_emb
        self.h_in = h if pipe.last else h.detach().requires_grad_(pipe.first)
        self.t_in = t_emb if pipe.last else t_emb.detach().requires_grad_(True)
        base = dit.train_routes(deterministic, generator)
        routes = [[TrainRoute(r.dropout, None if r.seed is None else fold_seed(r.seed, m))
                   for r in base] for m in range(self.M)]
        self.ins, self.outs = pipeline_blocks(dit, pipe, self.h_in, self.t_in, mask, angles,
                                              self.M, routes, self.remat)
        if pipe.last:
            return dit.head(torch.cat(self.outs), self.t_in, residual=self.h_in)
        return torch.zeros(*x.shape[:2], dit.mel_dim, device=x.device)

    def backward(self, loss: torch.Tensor) -> None:
        pipe = self.pipe
        if pipe.last:
            loss.backward()  # head, loss and this stage's blocks for every microbatch
            if not pipe.first:
                for x in self.ins:
                    pipe.send(x.grad, pipe.stage - 1)
            return
        for x, out in zip(self.ins, self.outs):
            torch.autograd.backward(out, pipe.recv(out, pipe.stage + 1))
            if not pipe.first:
                pipe.send(x.grad, pipe.stage - 1)
        outs, grads = [self.t_emb], [self.t_in.grad]
        if pipe.first:
            outs.append(self.h)
            grads.append(self.h_in.grad)
        torch.autograd.backward(outs, grads)


class PipelinedTrainer(Trainer):
    """``Trainer`` whose DiT runs through the pipeline: a ``("data",
    "pipe")`` mesh (``make_pipe_mesh``), ``depth % pipe == 0``,
    ``num_microbatches`` (default: the pipe size) a data shard's batch."""

    def __init__(self, dit_model: nn.Module, vocab_size: int, mel_dim: int = 100,
                 cfg: TrainConfig = TrainConfig(), use_ctc: bool = True, mesh=None,
                 use_prosody: bool = False, num_microbatches: Optional[int] = None,
                 remat: bool = True, fsdp: bool = False, fsdp_min_size: int = 1 << 16):
        if mesh is None:
            raise ValueError("PipelinedTrainer needs a ('data', 'pipe') mesh (make_pipe_mesh)")
        if cfg.grad_accumulation_steps > 1:
            raise ValueError("gradient accumulation is not supported with pipeline parallelism: "
                             "raise num_microbatches instead (more microbatches a step)")
        super().__init__(dit_model, vocab_size, mel_dim=mel_dim, cfg=cfg, use_ctc=use_ctc,
                         mesh=mesh, use_prosody=use_prosody, fsdp=fsdp,
                         fsdp_min_size=fsdp_min_size)
        self.pipe = _Pipe(mesh)
        stage_blocks(dit_model.arch.depth, self.pipe.size, 0)
        self.num_microbatches = num_microbatches or self.pipe.size
        self.remat = remat

    def check_mesh(self, mesh) -> None:
        names = tuple(mesh.mesh_dim_names or ())
        if "model" in names:
            raise ValueError("pipeline parallelism composes with 'data', not with a 'model' "
                             "axis (as in JAX)")
        if names != ("data", "pipe"):
            raise ValueError(f"PipelinedTrainer needs a ('data', 'pipe') mesh "
                             f"(make_pipe_mesh), not {names}")

    def plans(self, params: nn.ModuleDict) -> tuple:
        stages = pipe_param_stages(params["dit"], self.pipe.size, "dit.")
        fsdp = {}
        if self.fsdp:
            fsdp = {f"dit.{k}": v for k, v in fsdp_param_dims(
                params["dit"], axis_size(self.mesh, "data"), None, self.fsdp_min_size).items()}
        return {}, fsdp, stages

    def split_model(self, params: nn.ModuleDict) -> None:
        pass  # the stages' blocks are placed by ParamPlacement

    def clip_scale(self, norm: torch.Tensor) -> torch.Tensor:
        """The JAX pipelined trainer's clip: ``max / (norm + 1e-12)`` above
        ``max``."""
        mx = self.cfg.max_grad_norm
        return torch.where(norm > mx, mx / (norm + 1e-12), 1.0)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, step_rng_host=None,
                   draws: Optional[Dict] = None):
        import random

        from lemas_tts_tpu_torch.cfm.loss import cfm_training_loss

        r = step_rng_host if step_rng_host is not None else random
        drop_audio = r.random() < self.cfg.audio_drop_prob
        drop_text = r.random() < self.cfg.text_drop_prob
        d = axis_size(self.mesh, "data")
        B = batch["mel"].shape[0]
        if B % (d * self.num_microbatches):
            raise ValueError(f"global batch {B} must divide into data={d} shards of "
                             f"{self.num_microbatches} microbatches")
        params = state.params
        batch, draws = self.local_batch(batch, generator, draws, "prosody_to_mel" in params)
        if self.fsdp:
            self.unshard(state)
        run = PipelineRun(params["dit"], self.pipe, self.num_microbatches, self.remat)
        aux = {k: params[k] for k in ("accent", "ctc") if k in params}
        loss, metrics = cfm_training_loss(
            run, aux, batch, generator=generator, draws=draws,
            frac_lengths_mask=self.cfg.frac_lengths_mask, drop_audio_cond=drop_audio,
            drop_text=drop_text, vocab_size=self.vocab_size if "ctc" in params else None,
            prosody_to_mel=params["prosody_to_mel"] if "prosody_to_mel" in params else None,
            group=self.mesh.get_group("data"))
        run.backward(loss)
        # the metrics are the last stage's
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].detach().float() for k in keys])
        dist.broadcast(vals, self.pipe.peer(self.pipe.size - 1), group=self.pipe.group)
        metrics = dict(zip(keys, vals.unbind()))
        state.step += 1
        self.mesh_update(state)
        state.updates += 1
        metrics.update(drop_audio_cond=drop_audio, drop_text=drop_text)
        return state, metrics
