"""Progressive-distillation CLI: bake CFG in and halve the NFE, stage by stage
(counterpart of ``lemas_tts_tpu/scripts/distill.py``, the same flags):

  python -m lemas_tts_tpu_torch.scripts.distill --config multilingual \\
      --teacher ckpts/run1 --stages 16,8 --steps_per_stage 2000 \\
      --data manifest.jsonl --ckpt_dir ckpts/distilled

Teacher sources: a training directory of ``scripts/train.py`` (its EMA
weights), a stage directory of this script, a reference ``.pt`` /
``.safetensors`` CFM checkpoint (EMA preferred), or a JAX native (orbax)
directory: a JAX training run (its ``model_last``'s EMA params) or a native
DiT tree (``load_teacher``). Each stage writes
``<ckpt_dir>/stage_<K>/model.pt`` (the stage's EMA student, in the
reference layout) and ``student.json`` beside it, which ``TTS`` and
``serve_http`` read to pin the student's sampler settings (``steps=K``,
``cfg_strength=0``). ``--student_heads``/``--student_dim_head`` give the
student another head split of the same inner width (e.g. 8 x 128 for a
16 x 64 teacher), recorded in ``student.json``'s ``arch``.

Runs on CUDA unless ``--device cpu``. Under ``torchrun --nproc_per_node N``
(a job of more than one process) the stages run on a ``("data", "model")``
mesh over every process, ``--model_parallel`` its tensor-parallel degree:
every process loads the same global batches and distils its rows, and
process 0 logs and writes the stages (``cfm/distill.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Distill the CFM sampler to few steps.")
    p.add_argument("--config", type=str, default="multilingual")
    p.add_argument("--vocab_file", type=str, default="")
    p.add_argument("--teacher", type=str, required=True,
                   help="Training or stage directory, a reference .pt/.safetensors, "
                        "or a JAX orbax directory.")
    p.add_argument("--stages", type=str, default="16,8",
                   help="Comma-separated student NFE per stage (halving chain).")
    p.add_argument("--steps_per_stage", type=int, default=2000)
    p.add_argument("--teacher_cfg", type=float, default=2.0,
                   help="CFG strength baked in during the FIRST stage.")
    p.add_argument("--sway", type=float, default=1.0)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--data", type=str, default="", help="JSONL manifest path.")
    p.add_argument("--synthetic", type=int, default=0,
                   help="Use N synthetic samples (smoke runs).")
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="Tensor-parallel degree of the ('data', 'model') mesh in a job.")
    p.add_argument("--block_cache", type=str, default="",
                   help="block-cache spec to record in student.json (TTS then serves the "
                        "student with it; empty = cache off, the default)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_file", type=str, default="")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--tiny", action="store_true",
                   help="Tiny arch override (hermetic smoke distillation).")
    p.add_argument("--student_heads", type=int, default=0,
                   help="Student attention heads (0 = the teacher's); with "
                        "--student_dim_head it must keep heads*dim_head.")
    p.add_argument("--student_dim_head", type=int, default=0,
                   help="Student head dim (0 = the teacher's).")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; never falls back to another device.")
    return p


def load_teacher(path: str):
    """The teacher backbone's state dict from a training directory (EMA), a
    stage directory or a reference checkpoint file (EMA preferred), or from
    a JAX native (orbax) directory, read as the JAX ``load_teacher`` reads
    it: a training run's ``model_last`` (or the run's directory itself) gives
    its ``ema_params``, else its ``params["dit"]``; any other tree (a stage,
    ``convert_checkpoint`` output) is the DiT's params."""
    from lemas_tts_tpu_torch.infer.checkpoints import is_native, load_native
    from lemas_tts_tpu_torch.weights import (checkpoint_file, dit_state_from_jax,
                                             load_reference_checkpoint)

    p = Path(path)
    native = next((c for c in (p / "model_last", p) if is_native(c)), None)
    if native is not None:
        tree = load_native(native)
        if "ema_params" in tree:
            tree = tree["ema_params"] if tree["ema_params"] is not None else tree["params"]["dit"]
        return dit_state_from_jax(tree)
    return load_reference_checkpoint(str(checkpoint_file(path)), use_ema=True)[0]


def save_stage(out: Path, student_sd, meta: dict) -> None:
    """``out/model.pt`` (the EMA student as ``ema_model.transformer.*``) and
    ``out/student.json``."""
    import torch

    out.mkdir(parents=True, exist_ok=True)
    torch.save({"ema_model_state_dict": {f"ema_model.transformer.{k}": v.detach().cpu()
                                         for k, v in student_sd.items()}}, out / "model.pt")
    (out / "student.json").write_text(json.dumps(meta, indent=1))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch
    import torch.distributed as dist

    from lemas_tts_tpu_torch.api import seeded_init, select_device
    from lemas_tts_tpu_torch.cfm.data import DataLoader
    from lemas_tts_tpu_torch.cfm.distill import Distiller
    from lemas_tts_tpu_torch.cfm.train import batch_to_device
    from lemas_tts_tpu_torch.config import DiTArch, TrainConfig, load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT
    from lemas_tts_tpu_torch.parallel.distributed import initialize, is_primary
    from lemas_tts_tpu_torch.parallel.mesh import axis_size, make_mesh
    from lemas_tts_tpu_torch.scripts.train import load_dataset, resolve_vocab
    from lemas_tts_tpu_torch.utils.profiling import JsonLogger

    device = select_device(args.device)
    initialize(device_type=device.type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(world, args.model_parallel, device.type) if world > 1 else None
    logger = JsonLogger(path=args.log_file or None) if is_primary() else None

    def log(event, **fields):
        if logger is not None:
            logger.log(event, **fields)
    cfg = load_model_config(args.config)
    tcfg = TrainConfig(learning_rate=args.lr,
                       num_warmup_updates=max(1, args.steps_per_stage // 20),
                       batch_size_per_gpu=2000 if args.tiny else TrainConfig().batch_size_per_gpu)
    vocab = resolve_vocab(args.vocab_file)
    if args.tiny:
        arch, mel_dim = DiTArch(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, text_dim=16,
                                conv_layers=1, dropout=0.0), 8
    else:
        arch, mel_dim = cfg.arch, cfg.mel_spec.n_mel_channels
    dataset = load_dataset(args, mel_dim, vocab)
    if dataset is None:
        print("need --data or --synthetic", file=sys.stderr)
        return 2

    def build(a):
        return seeded_init(lambda: DiT(a, mel_dim=mel_dim, text_num_embeds=vocab.size),
                           args.seed).to(device)

    dit = build(arch)
    student_arch = None
    if args.student_heads or args.student_dim_head:
        s_heads = args.student_heads or arch.heads
        s_dh = args.student_dim_head or arch.dim_head
        if s_heads * s_dh != arch.heads * arch.dim_head:
            print(f"--student_heads*--student_dim_head must equal the teacher inner dim "
                  f"{arch.heads * arch.dim_head} (got {s_heads}*{s_dh})", file=sys.stderr)
            return 2
        student_arch = dataclasses.replace(arch, heads=s_heads, dim_head=s_dh)
    student_dit = build(student_arch) if student_arch is not None else None
    if args.block_cache:
        from lemas_tts_tpu_torch.cfm.sampler import parse_block_cache

        if parse_block_cache(args.block_cache) is None:
            raise SystemExit(f"--block_cache {args.block_cache!r} is not a valid spec")
    loader = DataLoader(dataset, tcfg, seed=args.seed,
                        batch_multiple=1 if mesh is None else axis_size(mesh, "data"),
                        to_device=lambda b: batch_to_device(b, device))
    teacher = load_teacher(args.teacher)
    stages = [int(s) for s in args.stages.split(",") if s.strip()]

    for si, k in enumerate(stages):
        # the first stage bakes the teacher's CFG in; later teachers (earlier
        # students) are guided already and run single-pass, in the student geometry
        distiller = Distiller(dit if si == 0 or student_dit is None else student_dit, k,
                              cfg=tcfg, teacher_cfg_strength=args.teacher_cfg if si == 0 else 0.0,
                              sway_sampling_coef=args.sway, student_model=student_dit, mesh=mesh)
        state = distiller.init_state(teacher)
        t0 = time.time()
        step = 0
        for epoch in range(10 ** 9):
            for batch in loader.epoch(args.seed + 101 * si + epoch):
                if step >= args.steps_per_stage:
                    break
                gen = torch.Generator(device).manual_seed(7_000_000 * (si + 1) + step)
                state, metrics = distiller.distill_step(state, batch, gen)
                step += 1
                if step % args.log_every == 0 or step == args.steps_per_stage:
                    log("distill_step", stage=k, step=step, loss=float(metrics["loss"]),
                        batch=list(batch["mel"].shape[:2]),
                        sps=step / max(time.time() - t0, 1e-9))
            if step >= args.steps_per_stage:
                break
        teacher = {n: v.clone() for n, v in distiller.full_state_dict(state.ema_params).items()}
        meta = {"student_steps": k, "cfg_strength": 0.0, "sway_sampling_coef": args.sway,
                "teacher": args.teacher, "teacher_cfg_strength": args.teacher_cfg,
                "stage_index": si, "steps_per_stage": args.steps_per_stage}
        if student_arch is not None:
            # TTS rebuilds the DiT with this head split before loading the weights
            meta["arch"] = {"heads": student_arch.heads, "dim_head": student_arch.dim_head}
        if args.block_cache:
            meta["block_cache"] = args.block_cache
        out = Path(args.ckpt_dir) / f"stage_{k}"
        if is_primary():
            save_stage(out, teacher, meta)
        if world > 1:
            dist.barrier()
        del state, distiller
        log("stage_done", stage=k, path=str(out))
        if is_primary():
            print(f"[distill] stage NFE={k} done -> {out} (sample with steps={k}, "
                  f"cfg_strength=0)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
