"""Training step: global-norm clip, AdamW with linear warmup, gradient
accumulation and an EMA of the DiT (counterpart of
``lemas_tts_tpu/cfm/train.py``).

The optimizer follows the JAX package's optax chain
``clip_by_global_norm(max_grad_norm)`` then ``adamw(schedule)``:

- the clip scales by ``max_norm / norm`` only when the norm reaches
  ``max_norm`` (``clip_grad_norm_`` would divide by ``norm + 1e-6`` always);
- AdamW at optax's defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
  on every parameter; torch's default decay is 1e-2), and a parameter with
  no gradient gets a zero one, so the decay reaches it as in optax;
- the schedule is ``optax.linear_schedule(0, lr, warmup)`` then constant,
  counted in optimizer updates: the first update has lr 0.

Gradient accumulation (``optax.MultiSteps``) averages ``k`` mini-steps'
gradients and steps the optimizer, the schedule and the EMA (decay 0.999)
only at the boundary. The step counter counts mini-steps, as JAX's does.
The forward runs on the DiT's training route, so no kernel of ``ops/`` runs
in training.

On a ``("data", "model")`` mesh (``parallel/mesh.py:make_mesh``; SPMD, every
process calls ``train_step`` with the whole global batch):

- the DiT is split over ``model`` by the JAX tensor-parallel plan
  (``parallel/tensor.py``), the heads (accent, CTC, prosody) are whole;
- each process takes its rows of the batch and of the loss's draws, which
  are drawn for the global batch from the same generator, so a data mesh's
  step is the unmeshed step (dropout masks excepted: each data shard
  draws its own, ``DiT.dropout_fold``); the loss is the global batch's
  (``cfm/loss.py``, ``group``) and the gradients are averaged over
  ``data``; the clip's norm sums the ``model`` parts;
- ``fsdp`` (ZeRO-3, the JAX ``fsdp_param_pspecs``; a no-op without a mesh,
  as in JAX): each DiT leaf of at least ``fsdp_min_size`` elements keeps one
  more dimension split over ``data`` in its parameter, AdamW moments and
  EMA. The step all-gathers those leaves before the forward and frees them
  after the update; the gradient is averaged whole, clipped, and each
  process keeps its part (the JAX pipelined trainer's composition), so the
  step is the plain data-parallel one;
- ``checkpoint_payload`` gathers the full tensors in the reference layout
  on every process (process 0 writes, ``cfm/checkpoint.py``) and
  ``restore_state`` takes each process's parts.

Between steps the state lives in the placement's *master* layout
(``ParamPlacement``): ``state.params`` computes with the working tensors,
which under ``fsdp`` are empty outside a step.
"""

from __future__ import annotations

import copy
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lemas_tts_tpu_torch.cfm.checkpoint import ema_update
from lemas_tts_tpu_torch.cfm.loss import (PROSODY_DROPOUT, AccentClassifier, CTCHead,
                                          cfm_training_loss, loss_draws)
from lemas_tts_tpu_torch.config import TrainConfig
from lemas_tts_tpu_torch.parallel import tensor
from lemas_tts_tpu_torch.parallel.mesh import (ParamPlacement, axis_rank, axis_size,
                                               fsdp_param_dims, tp_param_dims)

PROSODY_DIM = 512
# the Trainer's modules under their names in the reference file layout
FILE_NAMES = {"dit": "transformer", "accent": "accent_classifier", "ctc": "ctc",
              "prosody_to_mel": "prosody_to_mel"}
FILE_KEYS = {v: k for k, v in FILE_NAMES.items()}


def make_schedule(cfg: TrainConfig):
    """Learning rate after ``count`` optimizer updates."""
    warm = int(cfg.num_warmup_updates)

    def schedule(count: int) -> float:
        if warm <= 0 or count >= warm:
            return float(cfg.learning_rate)
        return float(cfg.learning_rate) * count / warm

    return schedule


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.AdamW:
    """AdamW at optax's defaults; ``step_optimizer`` sets the lr."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax ``clip_by_global_norm``: scale by max_norm / norm when the norm
    is not below max_norm (``norm``: the global norm, when ``grads`` are one
    process's parts). Returns the norm."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def step_optimizer(optimizer: torch.optim.Optimizer, params: List[nn.Parameter],
                   cfg: TrainConfig, count: int, divide_by: int = 1,
                   placement: Optional[ParamPlacement] = None) -> None:
    """One optimizer update from the gradients in ``params``' ``.grad``:
    zero gradients where there are none, the mean over ``divide_by``
    mini-steps, the clip, the scheduled lr, AdamW. ``placement``: the
    parameters (``placement.names``, no FSDP) are this process's parts on a
    mesh; the gradient is the whole step's (``reduce_grads``) and the
    clip's norm the global one."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = None
    if placement is not None:
        placement.reduce_grads(grads, placement.names, divide_by)
        norm = placement.global_norm(grads, placement.names)
    elif divide_by > 1:
        torch._foreach_div_(grads, float(divide_by))
    clip_by_global_norm(grads, cfg.max_grad_norm, norm)
    lr = make_schedule(cfg)(count)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


@dataclass
class TrainState:
    step: int  # mini-steps taken
    params: nn.ModuleDict  # {"dit", "accent", "ctc"?, "prosody_to_mel"?}
    optimizer: torch.optim.Optimizer
    ema_params: nn.Module  # EMA of params["dit"], f32
    updates: int = 0  # optimizer updates taken (the schedule's count)
    mini_step: int = 0  # mini-steps into the current accumulation window


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``device``."""
    return {k: (torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
                if v is not None else None) for k, v in batch.items()}


def rows_of(batch: Dict[str, Any], n: int, i: int) -> Dict[str, Any]:
    """Part ``i`` of ``n`` of every tensor of ``batch`` along its batch
    axis (other values as they are)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            if v.shape[0] % n:
                raise ValueError(f"{k}: batch {v.shape[0]} does not split over {n} data shards")
            b = v.shape[0] // n
            v = v[i * b:(i + 1) * b]
        out[k] = v
    return out


class Trainer:
    """Builds the training state and takes training steps for the CFM/DiT
    stack on the DiT's device, unmeshed or on a ``("data", "model")`` mesh
    (module docstring)."""

    def __init__(self, dit_model: nn.Module, vocab_size: int, mel_dim: int = 100,
                 cfg: TrainConfig = TrainConfig(), use_ctc: bool = True, mesh: Any = None,
                 use_prosody: bool = False, fsdp: bool = False, fsdp_min_size: int = 1 << 16):
        self.dit_model = dit_model
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.mel_dim = mel_dim
        self.use_ctc = use_ctc
        self.use_prosody = use_prosody
        self.accum = max(int(cfg.grad_accumulation_steps), 1)
        self.ema_decay = 0.999
        self.mesh = mesh
        self.fsdp = bool(fsdp) and mesh is not None  # as in JAX: fsdp without a mesh is a no-op
        self.fsdp_min_size = fsdp_min_size
        self.placement: Optional[ParamPlacement] = None
        if mesh is not None:
            self.check_mesh(mesh)

    def check_mesh(self, mesh) -> None:
        names = tuple(mesh.mesh_dim_names or ())
        if names != ("data", "model"):
            raise ValueError(f"Trainer needs a ('data', 'model') mesh (make_mesh), not {names}")

    def init_state(self, seed: int = 0) -> TrainState:
        """Heads (accent, CTC) and ``prosody_to_mel`` (normal x 0.02, zero
        bias) from ``seed``, an f32 EMA copy of the DiT, the optimizer."""
        dim = self.dit_model.arch.dim
        device = next(self.dit_model.parameters()).device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            params = nn.ModuleDict({"dit": self.dit_model,
                                    "accent": AccentClassifier(self.mel_dim, dim)})
            if self.use_ctc:
                params["ctc"] = CTCHead(self.mel_dim, dim, self.vocab_size)
            if self.use_prosody:
                lin = nn.Linear(PROSODY_DIM, self.mel_dim)
                nn.init.normal_(lin.weight, std=0.02)
                nn.init.zeros_(lin.bias)
                params["prosody_to_mel"] = lin
        params.to(device).train()
        ema = copy.deepcopy(self.dit_model).float().requires_grad_(False)
        if self.mesh is not None:
            return self.shard_state(params, ema)
        return TrainState(step=0, params=params,
                          optimizer=make_optimizer(self.cfg, list(params.parameters())),
                          ema_params=ema)

    # --------------------------------------------------------------- the mesh
    def plans(self, params: nn.ModuleDict) -> tuple:
        """(tensor-parallel, FSDP, stage) plans of ``params``' full
        parameters, by name in ``params``."""
        dit = params["dit"]
        tp = tp_param_dims(dit) if axis_size(self.mesh, "model") > 1 else {}
        fsdp = (fsdp_param_dims(dit, axis_size(self.mesh, "data"), tp, self.fsdp_min_size)
                if self.fsdp else {})
        return ({f"dit.{k}": v for k, v in tp.items()}, {f"dit.{k}": v for k, v in fsdp.items()},
                {})

    def split_model(self, params: nn.ModuleDict) -> None:
        """Split the DiT for this process (``parallel/tensor.py``)."""
        tensor.shard_(params["dit"], self.mesh)

    def shard_state(self, params: nn.ModuleDict, ema: nn.Module) -> TrainState:
        """The whole state of ``init_state`` placed on the mesh: the model
        split and the master tensors (the JAX ``shard_state``)."""
        pl = self.placement = ParamPlacement(params, self.mesh, *self.plans(params))
        full = {n: p.detach() for n, p in params.named_parameters()}
        ema_full = {f"dit.{n}": p.detach() for n, p in ema.named_parameters()}
        self.split_model(params)
        params["dit"].dropout_fold = axis_rank(self.mesh, "data")
        named = dict(params.named_parameters())
        self.masters = {}
        for n in pl.owned_names():
            work = pl.working(n, full[n])
            named[n].data = work if n not in pl.fsdp else work.new_empty(0)
            self.masters[n] = (named[n] if n not in pl.fsdp
                               else nn.Parameter(pl.master(n, work)))
        for n in pl.names:
            if not pl.owned(n):
                named[n].data = named[n].data.new_empty(0)
        for n, p in ema.named_parameters():
            key = f"dit.{n}"
            p.data = (pl.master(key, pl.working(key, ema_full[key])) if pl.owned(key)
                      else p.data.new_empty(0))
        masters = [self.masters[n] for n in pl.owned_names()]
        return TrainState(step=0, params=params, optimizer=make_optimizer(self.cfg, masters),
                          ema_params=ema)

    def unshard(self, state: TrainState) -> None:
        """Gather the FSDP leaves into the module for a step (once per
        accumulation window)."""
        pl = self.placement
        named = dict(state.params.named_parameters())
        with torch.no_grad():
            for n in pl.fsdp:
                if pl.owned(n) and named[n].numel() == 0:
                    named[n].data = pl.unshard(n, self.masters[n].detach())

    def reshard(self, state: TrainState) -> None:
        """Free the gathered FSDP leaves after an update."""
        named = dict(state.params.named_parameters())
        for n in self.placement.fsdp:
            named[n].data = named[n].data.new_empty(0)

    def clip_scale(self, norm: torch.Tensor) -> torch.Tensor:
        """The clip's factor (optax ``clip_by_global_norm``)."""
        mx = self.cfg.max_grad_norm
        return torch.where(norm < mx, 1.0, mx / norm)

    @torch.no_grad()
    def mesh_update(self, state: TrainState, divide_by: int = 1) -> None:
        """One optimizer update on the mesh from the gradients of this
        process's rows: the whole step's gradient (``reduce_grads``), the
        clip on the global norm, each master's part, the scheduled AdamW,
        the EMA of the DiT's masters."""
        pl = self.placement
        named = dict(state.params.named_parameters())
        names = pl.owned_names()
        for n in names:
            if named[n].grad is None:
                named[n].grad = torch.zeros_like(named[n])
        grads = [named[n].grad for n in names]
        pl.reduce_grads(grads, names, divide_by)
        torch._foreach_mul_(grads, self.clip_scale(pl.global_norm(grads, names)))
        for n in pl.fsdp:
            if pl.owned(n):
                self.masters[n].grad = pl.master(n, named[n].grad)
        lr = make_schedule(self.cfg)(state.updates)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        for p in named.values():
            p.grad = None
        if self.fsdp:
            self.reshard(state)
        pairs = [(e, self.masters[f"dit.{n}"]) for n, e in state.ema_params.named_parameters()
                 if pl.owned(f"dit.{n}")]
        ema_update([e for e, _ in pairs], [m for _, m in pairs], decay=self.ema_decay)

    def local_batch(self, batch: Dict[str, torch.Tensor], generator, draws, prosody: bool):
        """This process's rows of ``batch`` and of the loss's draws for the
        global batch."""
        draws = loss_draws(batch, generator, draws, self.cfg.frac_lengths_mask,
                           PROSODY_DROPOUT if prosody else 0.0)
        d, r = axis_size(self.mesh, "data"), axis_rank(self.mesh, "data")
        return rows_of(batch, d, r), {**rows_of(draws, d, r), "dropout": draws.get("dropout")}

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   step_rng_host: Optional[random.Random] = None,
                   draws: Optional[Dict] = None):
        """One mini-step; the optimizer steps at each accumulation boundary.
        The CFG drops are drawn on the host (audio p 0.3, text p 0.1)."""
        r = step_rng_host if step_rng_host is not None else random
        drop_audio = r.random() < self.cfg.audio_drop_prob
        drop_text = r.random() < self.cfg.text_drop_prob
        params = state.params
        aux = {k: params[k] for k in ("accent", "ctc") if k in params}
        group = None
        if self.mesh is not None:
            batch, draws = self.local_batch(batch, generator, draws, "prosody_to_mel" in params)
            group = self.mesh.get_group("data")
            if self.fsdp:
                self.unshard(state)
        loss, metrics = cfm_training_loss(
            params["dit"], aux, batch, generator=generator, draws=draws,
            frac_lengths_mask=self.cfg.frac_lengths_mask, drop_audio_cond=drop_audio,
            drop_text=drop_text, vocab_size=self.vocab_size if "ctc" in params else None,
            prosody_to_mel=params["prosody_to_mel"] if "prosody_to_mel" in params else None,
            group=group)
        loss.backward()
        state.step += 1
        state.mini_step += 1
        if state.mini_step == self.accum:
            if self.mesh is not None:
                self.mesh_update(state, divide_by=self.accum)
            else:
                step_optimizer(state.optimizer, list(params.parameters()), self.cfg,
                               state.updates, divide_by=self.accum)
                ema_update(state.ema_params.parameters(), params["dit"].parameters(),
                           decay=self.ema_decay)
            state.updates += 1
            state.mini_step = 0
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(drop_audio_cond=drop_audio, drop_text=drop_text)
        return state, metrics

    # ------------------------------------------------------------ checkpoints
    def checkpoint_payload(self, state: TrainState) -> Dict[str, Any]:
        """The state in the reference trainer's file layout (``cfm/checkpoint.py``);
        gradients of an open accumulation window go with it. On a mesh every
        process calls it (it gathers) and gets the whole payload."""
        if self.mesh is not None:
            model, ema, opt, grads = self.gather_payload(state)
        else:
            model = {f"{FILE_NAMES[name]}.{k}": v for name, mod in state.params.items()
                     for k, v in mod.state_dict().items()}
            ema = {f"ema_model.transformer.{k}": v
                   for k, v in state.ema_params.state_dict().items()}
            opt = state.optimizer.state_dict()
            grads = [p.grad for p in state.params.parameters()]
        payload = {"model_state_dict": {k: v.detach().cpu() for k, v in model.items()},
                   "ema_model_state_dict": {k: v.detach().cpu() for k, v in ema.items()},
                   "optimizer_state_dict": opt, "step": int(state.step),
                   "updates": int(state.updates), "mini_step": int(state.mini_step)}
        if state.mini_step:
            payload["accum_grads"] = [None if g is None else g.detach().cpu() for g in grads]
        return payload

    @torch.no_grad()
    def gather_payload(self, state: TrainState) -> tuple:
        """The full tensors of a meshed state: parameters and EMA from the
        masters, the AdamW moments under the unmeshed optimizer's indices,
        an open window's gradients as their mean over ``data`` (each
        process adds its next mini-steps to that mean, and the update's mean
        over ``data`` stays the window's)."""
        pl = self.placement
        full = {n: pl.gather(n, self.masters.get(n)) for n in pl.names}
        model = {}
        for name, mod in state.params.items():
            for k, v in mod.state_dict().items():
                model[f"{FILE_NAMES[name]}.{k}"] = full.get(f"{name}.{k}", v)
        ema = {f"ema_model.transformer.{k}": pl.gather(f"dit.{k}", p)
               for k, p in state.ema_params.named_parameters()}
        opt = state.optimizer.state_dict()
        local = {n: j for j, n in enumerate(pl.owned_names())}
        moments = {}
        if opt["state"]:
            step = next(iter(opt["state"].values()))["step"]
            for i, n in enumerate(pl.names):
                one = opt["state"].get(local.get(n), {})
                moments[i] = {"step": step.clone(),
                              **{k: pl.gather(n, one.get(k)).cpu()
                                 for k in ("exp_avg", "exp_avg_sq")}}
        opt = {"state": moments, "param_groups": [dict(g, params=list(range(len(pl.names))))
                                                  for g in opt["param_groups"]]}
        grads = []
        if state.mini_step:
            d, group = axis_size(self.mesh, "data"), self.mesh.get_group("data")
            for n, p in state.params.named_parameters():
                g = p.grad
                if g is not None:
                    g = g.clone()
                    dist.all_reduce(g, group=group)
                    g = pl.gather(n, g / d, master=False)
                grads.append(g)
        return model, ema, opt, grads

    def restore_state(self, state: TrainState, payload: Dict[str, Any]) -> TrainState:
        """Load a checkpoint payload into ``state`` (a fresh ``init_state``);
        on a mesh each process takes its parts."""
        state.step = int(payload["step"])
        state.updates = int(payload["updates"])
        state.mini_step = int(payload["mini_step"])
        if self.mesh is not None:
            return self.restore_parts(state, payload)
        parts: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, v in payload["model_state_dict"].items():
            head, _, rest = k.partition(".")
            parts.setdefault(FILE_KEYS[head], {})[rest] = v
        for name, sd in parts.items():
            state.params[name].load_state_dict(sd)
        pre = "ema_model.transformer."
        state.ema_params.load_state_dict({k[len(pre):]: v for k, v in
                                          payload["ema_model_state_dict"].items()
                                          if k.startswith(pre)})
        state.optimizer.load_state_dict(payload["optimizer_state_dict"])
        for p, g in zip(state.params.parameters(), payload.get("accum_grads", [])):
            p.grad = None if g is None else g.to(p.device)
        return state

    @torch.no_grad()
    def restore_parts(self, state: TrainState, payload: Dict[str, Any]) -> TrainState:
        pl = self.placement
        named = dict(state.params.named_parameters())
        model = payload["model_state_dict"]
        dev = pl.device

        def full_of(n):
            head, _, rest = n.partition(".")
            return model[f"{FILE_NAMES[head]}.{rest}"].to(dev)

        for n in pl.owned_names():
            work = pl.working(n, full_of(n))
            if n in pl.fsdp:
                self.masters[n].data = pl.master(n, work)
                named[n].data = work.new_empty(0)
            else:
                named[n].data = work
        for name, mod in state.params.items():  # persistent buffers, whole on every process
            extra = {k: model[f"{FILE_NAMES[name]}.{k}"] for k in mod.state_dict()
                     if f"{name}.{k}" not in named}
            if extra:
                mod.load_state_dict(extra, strict=False)
        pre = "ema_model.transformer."
        ema = payload["ema_model_state_dict"]
        for k, p in state.ema_params.named_parameters():
            n = f"dit.{k}"
            if pl.owned(n):
                p.data = pl.master(n, pl.working(n, ema[pre + k].to(dev)))
        opt = payload["optimizer_state_dict"]
        local_state = {}
        for j, n in enumerate(pl.owned_names()):
            one = opt["state"].get(pl.names.index(n))
            if one is not None:
                local_state[j] = {k: (v if k == "step" else
                                      pl.master(n, pl.working(n, v.to(dev))))
                                  for k, v in one.items()}
        groups = [dict(g, params=list(range(len(pl.owned_names()))))
                  for g in opt["param_groups"]]
        state.optimizer.load_state_dict({"state": local_state, "param_groups": groups})
        saved = payload.get("accum_grads")
        if saved:
            if self.fsdp:
                self.unshard(state)
            for n, g in zip(pl.names, saved):
                if g is not None and pl.owned(n):
                    named[n].grad = pl.working(n, g.to(dev))
        return state
