"""Probe progressive distillation at flagship geometry on the card
(counterpart of ``lemas_tts_tpu/scripts/distill_probe.py``).

It gives the 32 -> 16 -> 8 chain (``cfm/distill.py``) a measured grid at
real model size. Quality is teacher-relative: the student's K-step
trajectory against the teacher's full-NFE CFG trajectory from the same
noise, so random weights are meaningful (the question is whether
distillation closes the step-halving gap at this scale, not audio quality;
``--ckpt`` runs real weights).

The teacher's trajectory and every student's samples run the serving model
(bf16, K1-K3 on the card, CUDA graphs for the timed runs, no grad). The
distillation steps run on the DiT's training route (autograd, f32 master
weights, as ``scripts/distill.py``), since the kernels refuse grad.

Per stage it reports:

- ``mse_init``: divergence of the untrained student (the teacher's weights
  sampled at K steps without CFG), the gap distillation must close;
- ``mse_trained``: the same after ``--steps`` optimizer steps (EMA weights),
  with the first and last loss;
- ``speedup_vs_teacher``: the student sampler's card time against the
  teacher's (``fwd_ratio`` is the exact forward-count ratio).

    python -m lemas_tts_tpu_torch.scripts.distill_probe \\
        --stages 16,8 --steps 300 --batch_frames 4000 --lr 1e-4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from lemas_tts_tpu_torch.scripts._probe_common import add_device_arg


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--teacher_nfe", type=int, default=32)
    p.add_argument("--cfg", type=float, default=2.0,
                   help="teacher CFG strength baked in at stage 1")
    p.add_argument("--sway", type=float, default=1.0)
    p.add_argument("--stages", type=str, default="16,8")
    p.add_argument("--steps", type=int, default=300, help="optimizer steps per stage")
    p.add_argument("--batch_frames", type=int, default=4000,
                   help="frame budget per distill batch (flagship training uses 40000; the "
                        "probe trades batch for steps)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--synthetic", type=int, default=256,
                   help="synthetic training samples (40-300 frames each)")
    p.add_argument("--batch", type=int, default=2, help="probe eval batch")
    p.add_argument("--n", type=int, default=1024, help="probe eval bucket")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--depth", type=int, default=22)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--student_heads", type=int, default=0,
                   help="student head count (0 = the teacher's geometry); 8 with "
                        "--student_dim_head 128 probes the wide-head geometry "
                        "(scripts/widehead_probe.py); heads*dim_head must equal the "
                        "teacher's inner dim (teacher-copy init)")
    p.add_argument("--student_dim_head", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    return p


def run(args, model=None, inputs=None) -> list[dict]:
    """One record per stage; ``model`` (the teacher as a serving model) and
    ``inputs`` default to ``probe_model_and_inputs(args)``."""
    import torch

    from lemas_tts_tpu_torch.cfm.data import DataLoader
    from lemas_tts_tpu_torch.cfm.distill import Distiller, student_sampler_settings
    from lemas_tts_tpu_torch.cfm.graph import GraphPool
    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, sway_time_grid
    from lemas_tts_tpu_torch.cfm.train import batch_to_device
    from lemas_tts_tpu_torch.config import TrainConfig
    from lemas_tts_tpu_torch.eval.metrics import mel_mse
    from lemas_tts_tpu_torch.scripts._probe_common import (make_sampler, measure,
                                                            probe_model_and_inputs, random_dit)
    from lemas_tts_tpu_torch.scripts.train import synthetic_dataset

    if model is None:
        model, inputs = probe_model_and_inputs(args)
    device = inputs[0].device
    arch, mel_dim = model.arch, model.mel_dim
    vocab = model.text_embed.text_embed.num_embeddings - 1
    s_arch = None
    if args.student_heads:
        inner = arch.heads * arch.dim_head
        sh = args.student_heads
        sd = args.student_dim_head or inner // sh
        if sh * sd != inner:
            raise SystemExit(f"student geometry h{sh}d{sd} != inner {inner}")
        s_arch = dataclasses.replace(arch, heads=sh, dim_head=sd)
        print(json.dumps({"student_geometry": f"h{sh}d{sd}"}))
    # f32 masters: updates at the probe's lr would vanish in bf16's resolution
    teacher = {k: v.float() for k, v in model.state_dict().items()}

    def train_model(a):
        return random_dit(a, mel_dim, vocab, device, dtype=torch.float32, state=teacher)

    t_train = train_model(arch)
    s_train = train_model(s_arch) if s_arch is not None else None
    serve = random_dit(s_arch, mel_dim, vocab, device, state=teacher) if s_arch else model
    pool = GraphPool()

    ref_settings = SamplerSettings(steps=args.teacher_nfe, cfg_strength=args.cfg,
                                   sway_sampling_coef=args.sway)
    ref_mel, t_teacher = measure(make_sampler(model, ref_settings, inputs, pool), device,
                                 args.reps)
    scale = float(np.mean(np.square(ref_mel)))
    print(json.dumps({"teacher_nfe": args.teacher_nfe, "cfg": args.cfg,
                      "time_s": round(t_teacher, 4)}))

    tcfg = TrainConfig(learning_rate=args.lr, num_warmup_updates=max(1, args.steps // 20),
                       batch_size_per_gpu=args.batch_frames)
    loader = DataLoader(synthetic_dataset(args.synthetic, mel_dim, 898, args.seed), tcfg,
                        seed=args.seed, to_device=lambda b: batch_to_device(b, device))
    grid = sway_time_grid(args.teacher_nfe, args.sway)
    k_cfg = ref_settings.cfg_active_steps(grid)
    teacher_fwds = 2 * k_cfg + (args.teacher_nfe - k_cfg)

    records = []
    for si, k in enumerate(int(s) for s in args.stages.split(",") if s.strip()):
        s_settings = student_sampler_settings(k, args.sway)

        def divergence(state):
            serve.load_state_dict(state)
            mel, _ = measure(make_sampler(serve, s_settings, inputs, graph=False), device,
                             timed=False)
            return float(mel_mse(mel, ref_mel))

        # after stage 0 the teacher is the previous (possibly wide) student
        distiller = Distiller(t_train if si == 0 else (s_train or t_train), k, cfg=tcfg,
                              teacher_cfg_strength=args.cfg if si == 0 else 0.0,
                              sway_sampling_coef=args.sway, student_model=s_train)
        state = distiller.init_state(teacher)
        mse_init = divergence(teacher)
        loss0 = loss_last = None
        step = 0
        t0 = time.time()
        for epoch in range(10 ** 9):
            for batch in loader.epoch(args.seed + 997 * si + epoch):
                if step >= args.steps:
                    break
                gen = torch.Generator(device).manual_seed(31_000_000 * (si + 1) + step)
                state, metrics = distiller.distill_step(state, batch, gen)
                step += 1
                if step == 1:
                    loss0 = float(metrics["loss"])
                if step == args.steps:
                    loss_last = float(metrics["loss"])
            if step >= args.steps:
                break
        train_s = time.time() - t0
        teacher = {n: v.clone() for n, v in distiller.full_state_dict(state.ema_params).items()}
        del state, distiller
        mse_trained = divergence(teacher)
        _, t_student = measure(make_sampler(serve, s_settings, inputs, pool), device, args.reps)
        rec = {
            "stage": k,
            "mse_init": mse_init,
            "mse_trained": mse_trained,
            "rel_l2_trained": round(float(np.sqrt(mse_trained / max(scale, 1e-20))), 6),
            "loss_first": loss0,
            "loss_last": loss_last,
            "steps": step,
            "train_s": round(train_s, 1),
            "time_s": round(t_student, 4),
            "speedup_vs_teacher": round(t_teacher / t_student, 3),
            "fwd_ratio": round(teacher_fwds / k, 2),
        }
        records.append(rec)
        print(json.dumps(rec))
    return records


def main(argv=None) -> int:
    run(build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
