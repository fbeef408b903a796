"""Few-step progressive distillation of the CFM sampler (counterpart of
``lemas_tts_tpu/cfm/distill.py``).

A student DiT, initialised from the teacher, learns the teacher's average
velocity over each of its own sway-warped Euler intervals, with the
teacher's classifier-free guidance baked in: the teacher integrates
``substeps`` CFG Euler sub-steps along a fine grid nested in the student's
coarse grid (one resolved sway exponent for both, so
``fine[k * substeps] == coarse[k]``). A K-step student samples with
``steps=K, cfg_strength=0`` (``student_sampler_settings``). Stages chain
(32 -> 16 -> 8) with the previous EMA student as the next teacher, which
then runs without CFG (``next_stage``).

As in JAX, the whole loss runs on the DiT's training route (the kernels
define no backward): the student's forward with ``autograd=True``, and the
teacher's sub-steps on the same route under ``torch.no_grad()`` (JAX's
``stop_gradient``). Both models recompute their blocks in the backward pass
(``checkpoint_activations``), as the JAX distiller's clone of a serving
model does. ``student_model`` may have another head geometry with the same
parameters (the wide-head 8 x 128 student of a 16 x 64 teacher).

Random draws: ``draws`` may carry ``x0`` [B, T, D], ``frac`` [B], ``span``
[B] and ``seg`` [B] (each sample's student interval); the rest come from
``generator`` (``Distiller.draws``).

On a ``("data", "model")`` mesh (the JAX ``Distiller(mesh=)``), teacher
and student are split over ``model`` by the tensor-parallel plan
(``parallel/tensor.py``), each process takes its rows of the global batch
and of the draws made for it, the loss and its metrics are the global
batch's (``group``, as ``cfm/loss.py``), the gradient is averaged over
``data`` and the clip's norm sums the ``model`` parts; the EMA is split as
the student. ``full_state_dict`` gathers a split module's weights.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from lemas_tts_tpu_torch.cfm.checkpoint import ema_update
from lemas_tts_tpu_torch.cfm.loss import group_sum
from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, resolve_sway_coef, warped_time_grid
from lemas_tts_tpu_torch.cfm.train import make_optimizer, rows_of, step_optimizer
from lemas_tts_tpu_torch.config import TrainConfig
from lemas_tts_tpu_torch.parallel import tensor
from lemas_tts_tpu_torch.parallel.mesh import ParamPlacement, axis_rank, axis_size, tp_param_dims
from lemas_tts_tpu_torch.utils.masks import lens_to_mask, mask_from_frac_lengths


@dataclass
class DistillState:
    step: int
    params: nn.Module  # the student DiT (trainable)
    teacher_params: nn.Module  # the teacher DiT (frozen)
    optimizer: torch.optim.Optimizer
    ema_params: Optional[nn.Module] = None  # EMA of the student, f32


def student_sampler_settings(student_steps: int,
                             sway_sampling_coef: Optional[float] = None) -> SamplerSettings:
    """Sampler settings of a distilled student: K steps, CFG baked in
    (``cfg_strength=0``: one forward a step), the sway it was trained on."""
    return SamplerSettings(steps=student_steps, cfg_strength=0.0,
                           sway_sampling_coef=sway_sampling_coef)


def _train_path(model: nn.Module) -> nn.Module:
    """A copy of ``model`` for the distill loss, with activation
    checkpointing on (the JAX distiller's clone of a serving model)."""
    m = copy.deepcopy(model)
    m.arch = dataclasses.replace(m.arch, checkpoint_activations=True)
    return m


class Distiller:
    """Progressive distillation for one halving stage: ``student_steps`` is
    the target NFE; ``dit_model`` gives the teacher's geometry and
    ``student_model`` (default: the same) the student's."""

    def __init__(self, dit_model: nn.Module, student_steps: int,
                 cfg: TrainConfig = TrainConfig(), *, teacher_cfg_strength: float = 2.0,
                 sway_sampling_coef: Optional[float] = None, substeps: int = 2,
                 velocity_clamp: float = 20.0, frac_lengths_mask=(0.7, 1.0), mesh: Any = None,
                 student_model: Optional[nn.Module] = None):
        assert student_steps >= 1 and substeps >= 1
        if mesh is not None and tuple(mesh.mesh_dim_names or ()) != ("data", "model"):
            raise ValueError(f"Distiller needs a ('data', 'model') mesh (make_mesh), not "
                             f"{mesh.mesh_dim_names}")
        self.mesh = mesh
        self.placement: Optional[ParamPlacement] = None
        self.dit_model = dit_model
        self.student_model = student_model if student_model is not None else dit_model
        self.student_steps = student_steps
        self.cfg = cfg
        self.teacher_cfg_strength = teacher_cfg_strength
        self.sway_sampling_coef = sway_sampling_coef
        self.substeps = substeps
        self.velocity_clamp = velocity_clamp
        self.frac_lengths_mask = frac_lengths_mask
        self.ema_decay = 0.999
        self.resolved_sway_coef = resolve_sway_coef(student_steps, sway_sampling_coef)
        self.coarse_grid = warped_time_grid(student_steps, self.resolved_sway_coef)
        self.fine_grid = warped_time_grid(student_steps * substeps, self.resolved_sway_coef)

    # ------------------------------------------------------------------ init
    def init_state(self, teacher_params: Mapping[str, torch.Tensor]) -> DistillState:
        """The teacher's state dict into a frozen teacher and a trainable
        student (its copy: a ``student_model`` must hold the same parameter
        names and shapes), an f32 EMA of the student, the optimizer."""
        want = self.student_model.state_dict()
        same = (set(want) == set(teacher_params)
                and all(tuple(want[k].shape) == tuple(teacher_params[k].shape) for k in want))
        if not same:
            raise ValueError(
                "student_model parameter tree differs from the teacher's — teacher-copy init "
                "requires identical names and shapes (e.g. the wide-head split heads·dim_head "
                "must keep the inner dim)")
        teacher = _train_path(self.dit_model)
        teacher.load_state_dict(teacher_params)
        teacher.requires_grad_(False)
        student = _train_path(self.student_model)
        student.load_state_dict(teacher_params)
        student.requires_grad_(True)
        ema = copy.deepcopy(student).float().requires_grad_(False)
        if self.mesh is not None:
            split = axis_size(self.mesh, "model") > 1
            self.placement = ParamPlacement(student, self.mesh,
                                            tp_param_dims(student) if split else {})
            for m in (teacher, student, ema):
                tensor.shard_(m, self.mesh)
        return DistillState(step=0, params=student, teacher_params=teacher,
                            optimizer=make_optimizer(self.cfg, list(student.parameters())),
                            ema_params=ema)

    # ------------------------------------------------------------------ loss
    @property
    def _teacher_uses_cfg(self) -> bool:
        return self.teacher_cfg_strength >= 1e-5

    def _teacher_velocity(self, teacher, x, cond, attn_mask, te_cond, te_uncond, t, B):
        """The CFG velocity as the sampler computes it: one 2B forward,
        ``cfg·(1-t)²``, ± clamp; a baked teacher (strength 0) one clamped
        guided pass."""
        clamp = self.velocity_clamp
        if not self._teacher_uses_cfg:
            pred = teacher(x, cond, None, t, attn_mask, text_embed=te_cond, autograd=True)
            return torch.clamp(pred, -clamp, clamp)
        pred2 = teacher(torch.cat([x, x]), torch.cat([cond, torch.zeros_like(cond)]), None,
                        torch.cat([t, t]), torch.cat([attn_mask, attn_mask]),
                        text_embed=torch.cat([te_cond, te_uncond]), autograd=True)
        pred, null_pred = pred2[:B], pred2[B:]
        cfg_t = self.teacher_cfg_strength * torch.square(1.0 - t)[:, None, None]
        return torch.clamp(pred + (pred - null_pred) * cfg_t, -clamp, clamp)

    def draws(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
              draws: Optional[Dict] = None) -> Dict:
        """Every random draw of ``loss`` for ``batch``: those in ``draws``
        as given, the others from ``generator`` in the loss's order
        (``frac``, ``span``, ``seg``, ``x0``)."""
        out = dict(draws or {})
        B, T, D = batch["mel"].shape
        dev = batch["mel"].device

        def draw(key, make):
            if out.get(key) is None:
                out[key] = make()

        lo, hi = self.frac_lengths_mask
        draw("frac", lambda: lo + (hi - lo) * torch.rand(B, generator=generator, device=dev))
        draw("span", lambda: torch.rand(B, generator=generator, device=dev))
        draw("seg", lambda: torch.randint(0, self.student_steps, (B,), generator=generator,
                                          device=dev))
        draw("x0", lambda: torch.randn((B, T, D), generator=generator, device=dev))
        return out

    def loss(self, student, teacher, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, draws: Optional[Dict] = None,
             group=None):
        """``(loss, metrics)`` of one batch (``mel``, ``mel_lengths``,
        ``text``); differentiable in the student only. ``group``: the batch
        is this process's rows, and the loss and metrics are the global
        batch's."""
        draws = self.draws(batch, generator, draws)
        mel = batch["mel"].float()
        lengths = batch["mel_lengths"]
        text = batch["text"]
        B, T, D = mel.shape
        dev = mel.device

        attn_mask = lens_to_mask(lengths, T)
        gen_mask = (mask_from_frac_lengths(lengths, draws["frac"], T, rand=draws["span"])
                    & attn_mask)
        cond = torch.where((attn_mask & ~gen_mask)[..., None], mel, 0.0)

        seg = draws["seg"].long()
        coarse = torch.as_tensor(self.coarse_grid, device=dev)
        fine = torch.as_tensor(self.fine_grid, device=dev)
        t0, t1 = coarse[seg], coarse[seg + 1]

        x0 = torch.where(attn_mask[..., None], draws["x0"], 0.0)
        x = (1.0 - t0)[:, None, None] * x0 + t0[:, None, None] * mel

        with torch.no_grad():  # the teacher's target carries no gradient
            te_c = teacher.embed_text(text, T, False)
            te_u = teacher.embed_text(text, T, True) if self._teacher_uses_cfg else None
            x_t = x
            for j in range(self.substeps):
                ta = fine[seg * self.substeps + j]
                tb = fine[seg * self.substeps + j + 1]
                v = self._teacher_velocity(teacher, x_t, cond, attn_mask, te_c, te_u, ta, B)
                x_t = x_t + (tb - ta)[:, None, None] * v
        target_v = (x_t - x) / torch.clamp(t1 - t0, min=1e-8)[:, None, None]

        te_s = student.embed_text(text, T, False)
        pred_v = student(x, cond, None, t0, attn_mask, text_embed=te_s, autograd=True)

        err = torch.square(pred_v - target_v)
        w = gen_mask[..., None].float()
        # one all-reduce over the data shards: the loss's sums and the metrics'
        sums = group_sum(torch.stack([torch.sum(err * w), torch.sum(w), t0.sum(),
                                      torch.square(target_v).sum().detach()]), group)
        n = B * (1 if group is None else dist.get_world_size(group))
        loss = sums[0] / torch.clamp(sums[1] * D, min=1.0) * D
        loss = torch.nan_to_num(loss, nan=0.0, posinf=300.0, neginf=300.0)
        metrics = {"loss": loss, "t_mean": sums[2] / n,
                   "target_v_rms": torch.sqrt(sums[3] / (n * T * D))}
        return loss, metrics

    # ------------------------------------------------------------------ step
    def distill_step(self, state: DistillState, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict] = None):
        """One optimizer step of the student (clip, AdamW with warmup, EMA).
        On a mesh every process calls it with the whole global batch."""
        group = None
        if self.mesh is not None:
            d, r = axis_size(self.mesh, "data"), axis_rank(self.mesh, "data")
            draws = rows_of(self.draws(batch, generator, draws), d, r)
            batch, group = rows_of(batch, d, r), self.mesh.get_group("data")
        loss, metrics = self.loss(state.params, state.teacher_params, batch, generator, draws,
                                  group)
        loss.backward()
        step_optimizer(state.optimizer, list(state.params.parameters()), self.cfg, state.step,
                       placement=self.placement)
        if state.ema_params is not None:
            ema_update(state.ema_params.parameters(), state.params.parameters(),
                       decay=self.ema_decay)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    def full_state_dict(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """The whole state dict of a student-shaped module (the student or
        its EMA); on a mesh a collective that gathers the ``model`` parts."""
        if self.mesh is None:
            return {k: v.detach() for k, v in module.state_dict().items()}
        named = dict(module.named_parameters())
        return {k: self.placement.gather(k, v.detach()) if k in named else v.detach()
                for k, v in module.state_dict().items()}

    # ------------------------------------------------------------------ chain
    def next_stage(self, student_steps: Optional[int] = None) -> "Distiller":
        """The next halving stage: its teacher is this stage's (EMA) student,
        with guidance already baked in (strength 0), in the student's
        geometry."""
        return Distiller(
            self.student_model,
            student_steps if student_steps is not None else max(1, self.student_steps // 2),
            cfg=self.cfg, teacher_cfg_strength=0.0, sway_sampling_coef=self.sway_sampling_coef,
            substeps=self.substeps, velocity_clamp=self.velocity_clamp,
            frac_lengths_mask=self.frac_lengths_mask, mesh=self.mesh)
