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
in training. Multi-GPU (``mesh``, ``fsdp``) is not ported.
"""

from __future__ import annotations

import copy
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from lemas_tts_tpu_torch.cfm.checkpoint import ema_update
from lemas_tts_tpu_torch.cfm.loss import AccentClassifier, CTCHead, cfm_training_loss
from lemas_tts_tpu_torch.config import TrainConfig

PROSODY_DIM = 512
MULTI_GPU = ("multi-GPU training (mesh, FSDP) is not ported: ROADMAP item A14 (a); "
             "pipeline parallelism is A14 (c)")


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
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: scale by max_norm / norm when the norm
    is not below max_norm. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def step_optimizer(optimizer: torch.optim.Optimizer, params: List[nn.Parameter],
                   cfg: TrainConfig, count: int, divide_by: int = 1) -> None:
    """One optimizer update from the gradients in ``params``' ``.grad``:
    zero gradients where there are none, the mean over ``divide_by``
    mini-steps, the clip, the scheduled lr, AdamW."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if divide_by > 1:
        torch._foreach_div_(grads, float(divide_by))
    clip_by_global_norm(grads, cfg.max_grad_norm)
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


class Trainer:
    """Builds the training state and takes training steps for the CFM/DiT
    stack on the DiT's device."""

    def __init__(self, dit_model: nn.Module, vocab_size: int, mel_dim: int = 100,
                 cfg: TrainConfig = TrainConfig(), use_ctc: bool = True, mesh: Any = None,
                 use_prosody: bool = False, fsdp: bool = False):
        if mesh is not None or fsdp:
            raise NotImplementedError(MULTI_GPU)
        self.dit_model = dit_model
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.mel_dim = mel_dim
        self.use_ctc = use_ctc
        self.use_prosody = use_prosody
        self.accum = max(int(cfg.grad_accumulation_steps), 1)
        self.ema_decay = 0.999

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
        return TrainState(step=0, params=params,
                          optimizer=make_optimizer(self.cfg, list(params.parameters())),
                          ema_params=ema)

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
        loss, metrics = cfm_training_loss(
            params["dit"], aux, batch, generator=generator, draws=draws,
            frac_lengths_mask=self.cfg.frac_lengths_mask, drop_audio_cond=drop_audio,
            drop_text=drop_text, vocab_size=self.vocab_size if "ctc" in params else None,
            prosody_to_mel=params["prosody_to_mel"] if "prosody_to_mel" in params else None)
        loss.backward()
        state.step += 1
        state.mini_step += 1
        if state.mini_step == self.accum:
            plist = list(params.parameters())
            step_optimizer(state.optimizer, plist, self.cfg, state.updates,
                           divide_by=self.accum)
            state.updates += 1
            state.mini_step = 0
            ema_update(state.ema_params.parameters(), params["dit"].parameters(),
                       decay=self.ema_decay)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(drop_audio_cond=drop_audio, drop_text=drop_text)
        return state, metrics

    # ------------------------------------------------------------ checkpoints
    def checkpoint_payload(self, state: TrainState) -> Dict[str, Any]:
        """The state in the reference trainer's file layout (``cfm/checkpoint.py``);
        gradients of an open accumulation window go with it."""
        model = {}
        names = {"dit": "transformer", "accent": "accent_classifier", "ctc": "ctc",
                 "prosody_to_mel": "prosody_to_mel"}
        for name, mod in state.params.items():
            for k, v in mod.state_dict().items():
                model[f"{names[name]}.{k}"] = v.detach().cpu()
        ema = {f"ema_model.transformer.{k}": v.detach().cpu()
               for k, v in state.ema_params.state_dict().items()}
        opt = state.optimizer.state_dict()
        payload = {"model_state_dict": model, "ema_model_state_dict": ema,
                   "optimizer_state_dict": opt, "step": int(state.step),
                   "updates": int(state.updates), "mini_step": int(state.mini_step)}
        if state.mini_step:
            payload["accum_grads"] = [None if p.grad is None else p.grad.detach().cpu()
                                      for p in state.params.parameters()]
        return payload

    def restore_state(self, state: TrainState, payload: Dict[str, Any]) -> TrainState:
        """Load a checkpoint payload into ``state`` (a fresh ``init_state``)."""
        names = {"transformer": "dit", "accent_classifier": "accent", "ctc": "ctc",
                 "prosody_to_mel": "prosody_to_mel"}
        parts: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, v in payload["model_state_dict"].items():
            head, _, rest = k.partition(".")
            parts.setdefault(names[head], {})[rest] = v
        for name, sd in parts.items():
            state.params[name].load_state_dict(sd)
        pre = "ema_model.transformer."
        state.ema_params.load_state_dict({k[len(pre):]: v for k, v in
                                          payload["ema_model_state_dict"].items()
                                          if k.startswith(pre)})
        state.optimizer.load_state_dict(payload["optimizer_state_dict"])
        state.step = int(payload["step"])
        state.updates = int(payload["updates"])
        state.mini_step = int(payload["mini_step"])
        for p, g in zip(state.params.parameters(), payload.get("accum_grads", [])):
            p.grad = None if g is None else g.to(p.device)
        return state
