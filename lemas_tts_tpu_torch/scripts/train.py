"""Training CLI: flow-matching CFM training with resume (counterpart of
``lemas_tts_tpu/scripts/train.py``, the same flags):

  python -m lemas_tts_tpu_torch.scripts.train --config multilingual \\
      --data manifest.jsonl --ckpt_dir ckpts/run1

 - data: a JSONL manifest (one ``{"mel": path.npy, "text": "...", "lang": k}``
   a line) or ``--synthetic N`` samples from ``--seed``;
 - checkpoints: ``model_<step>.pt`` / ``model_last.pt`` with the reference
   save policy (``cfm/checkpoint.py``); ``--resume`` continues from the
   latest;
 - metrics: JSON lines to stderr or ``--log_file``; each ``train_step`` line
   carries the loss, the batch's padded shape [B, T] and the steps a second.

Runs on CUDA unless ``--device cpu``. ``--checkpoint_activations``
recomputes each DiT block in the backward pass (``arch.checkpoint_activations``).

Multi-GPU: run it under ``torchrun --nproc_per_node N`` (one process per
GPU; on the CPU with ``--device cpu``, over gloo). In a job of more than
one process the mesh spans every process: ``("data", "model")`` with
``--model_parallel`` (tensor parallelism) and ``--fsdp`` (ZeRO-3 over
``data``), or ``("data", "pipe")`` with ``--pipe_parallel`` stages and
``--microbatches`` (default: the stages; composes with ``--fsdp``, not
with ``--model_parallel``). Every process loads the same global batches
(a multiple of ``data`` x microbatches) and trains its rows; process 0
logs and writes the checkpoints. Without a job, or in a job of one, there
is no mesh (``--fsdp`` and ``--model_parallel`` change nothing, as in JAX).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import sys
import time
from typing import Any, Dict, List


def load_manifest(path: str, vocab) -> List[Dict[str, Any]]:
    """JSONL manifest -> in-memory dataset."""
    import numpy as np

    from lemas_tts_tpu_torch.utils.vocab import text_to_ids

    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            mel = np.load(rec["mel"], mmap_mode="r")
            tokens = rec["text"].split("|") if "|" in rec["text"] else rec["text"]
            out.append({
                "mel": np.asarray(mel, np.float32),
                "text": text_to_ids(tokens, vocab),
                "lang": int(rec.get("lang", 0)),
                "audio_16k": np.load(rec["audio_16k"]) if "audio_16k" in rec else None,
                "prosody_idx": rec.get("prosody_idx"),
            })
    return out


def synthetic_dataset(n: int, mel_dim: int, vocab_size: int, seed: int = 0):
    """``n`` random samples of 40-299 frames and 4-23 tokens (the JAX CLI's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(rng.integers(40, 300))
        out.append({
            "mel": rng.standard_normal((t, mel_dim)).astype(np.float32),
            "text": rng.integers(0, vocab_size, rng.integers(4, 24)).astype(np.int32),
            "lang": int(rng.integers(0, 12)),
        })
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the CFM/DiT acoustic model.")
    p.add_argument("--config", type=str, default="multilingual")
    p.add_argument("--vocab_file", type=str, default="")
    p.add_argument("--data", type=str, default="", help="JSONL manifest path.")
    p.add_argument("--synthetic", type=int, default=0,
                   help="Use N synthetic samples (smoke runs).")
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in --ckpt_dir.")
    p.add_argument("--steps", type=int, default=0, help="0 -> epochs from config.")
    p.add_argument("--epochs", type=int, default=0, help="0 -> config value.")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="Tensor-parallel degree of the ('data', 'model') mesh.")
    p.add_argument("--pipe_parallel", type=int, default=1,
                   help="GPipe stages over the DiT blocks (parallel/pipeline.py); exclusive of "
                        "--model_parallel > 1.")
    p.add_argument("--microbatches", type=int, default=0,
                   help="Pipeline microbatches per step (0 -> the pipe degree).")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3 parameter/moment/EMA sharding over the 'data' axis (composes "
                        "with --model_parallel and with --pipe_parallel).")
    p.add_argument("--grad_accum", type=int, default=0,
                   help="Gradient accumulation mini-steps per optimizer update "
                        "(0 -> config value).")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_file", type=str, default="")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--tiny", action="store_true",
                   help="Tiny arch override (hermetic smoke training).")
    p.add_argument("--checkpoint_activations", action="store_true",
                   help="Recompute each DiT block in the backward pass.")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; never falls back to another device.")
    return p


def job_mesh(args, device):
    """Join a configured job (``torchrun``'s environment) and make the
    mesh of the flags: None without a job or in a job of one."""
    import torch.distributed as dist

    from lemas_tts_tpu_torch.parallel.distributed import initialize
    from lemas_tts_tpu_torch.parallel.mesh import make_mesh
    from lemas_tts_tpu_torch.parallel.pipeline import make_pipe_mesh

    initialize(device_type=device.type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.pipe_parallel > 1:
        if args.model_parallel > 1:
            raise ValueError("--pipe_parallel composes with data parallelism, not "
                             "--model_parallel")
        if world % args.pipe_parallel:
            raise ValueError(f"--pipe_parallel {args.pipe_parallel} in a job of {world} "
                             f"processes: run one process per device (torchrun "
                             f"--nproc_per_node)")
        return make_pipe_mesh(world, args.pipe_parallel, device.type)
    return make_mesh(world, args.model_parallel, device.type) if world > 1 else None


def resolve_vocab(vocab_file: str):
    from lemas_tts_tpu_torch.utils.vocab import Vocab, get_tokenizer

    if vocab_file:
        return get_tokenizer(vocab_file, "custom")
    return Vocab(char_map={chr(97 + i): i for i in range(26)}, size=26)


def resolve_arch(args, cfg):
    """(arch, mel_dim) of the config, or of the tiny override."""
    from lemas_tts_tpu_torch.config import DiTArch

    if args.tiny:
        return DiTArch(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, text_dim=16,
                       conv_layers=1), 8
    return cfg.arch, cfg.mel_spec.n_mel_channels


def load_dataset(args, mel_dim: int, vocab):
    if args.synthetic:
        return synthetic_dataset(args.synthetic, mel_dim, vocab.size, args.seed)
    if args.data:
        return load_manifest(args.data, vocab)
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.microbatches and args.pipe_parallel <= 1:
        print("--microbatches only applies with --pipe_parallel > 1", file=sys.stderr)
        return 2

    import torch

    from lemas_tts_tpu_torch.api import seeded_init, select_device
    from lemas_tts_tpu_torch.cfm.checkpoint import CheckpointManager
    from lemas_tts_tpu_torch.cfm.data import DataLoader
    from lemas_tts_tpu_torch.cfm.train import Trainer, batch_to_device
    from lemas_tts_tpu_torch.config import TrainConfig, load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT
    from lemas_tts_tpu_torch.parallel.distributed import is_primary
    from lemas_tts_tpu_torch.parallel.mesh import axis_size
    from lemas_tts_tpu_torch.parallel.pipeline import PipelinedTrainer
    from lemas_tts_tpu_torch.utils.profiling import JsonLogger

    device = select_device(args.device)
    mesh = job_mesh(args, device)
    logger = JsonLogger(path=args.log_file or None) if is_primary() else None

    def log(event, **fields):
        if logger is not None:
            logger.log(event, **fields)
    cfg = load_model_config(args.config)
    tcfg = TrainConfig(
        epochs=args.epochs or TrainConfig().epochs,
        batch_size_per_gpu=2000 if args.tiny else TrainConfig().batch_size_per_gpu,
        grad_accumulation_steps=args.grad_accum or TrainConfig().grad_accumulation_steps)
    vocab = resolve_vocab(args.vocab_file)
    arch, mel_dim = resolve_arch(args, cfg)
    if args.checkpoint_activations:
        arch = dataclasses.replace(arch, checkpoint_activations=True)
    dataset = load_dataset(args, mel_dim, vocab)
    if dataset is None:
        print("need --data or --synthetic", file=sys.stderr)
        return 2

    dit = seeded_init(lambda: DiT(arch, mel_dim=mel_dim, text_num_embeds=vocab.size,
                                  use_prosody_encoder=cfg.use_prosody_encoder), args.seed)
    common = dict(vocab_size=vocab.size, mel_dim=mel_dim, cfg=tcfg, use_ctc=cfg.use_ctc_loss,
                  use_prosody=cfg.use_prosody_encoder, mesh=mesh, fsdp=args.fsdp)
    if args.pipe_parallel > 1:
        microbatches = args.microbatches or args.pipe_parallel
        trainer = PipelinedTrainer(dit.to(device), num_microbatches=microbatches, **common)
        batch_multiple = axis_size(mesh, "data") * microbatches
    else:
        trainer = Trainer(dit.to(device), **common)
        batch_multiple = 1 if mesh is None else axis_size(mesh, "data")
    loader = DataLoader(dataset, tcfg, seed=args.seed, batch_multiple=batch_multiple,
                        to_device=lambda b: batch_to_device(b, device))
    mgr = CheckpointManager(args.ckpt_dir, tcfg)
    state = trainer.init_state(args.seed)
    if args.resume:
        try:
            trainer.restore_state(state, mgr.restore())
            log("resumed", step=state.step)
        except FileNotFoundError:
            log("resume_requested_but_no_checkpoint")

    host_rng = random.Random(args.seed)
    max_steps = args.steps or tcfg.epochs * max(1, len(loader))
    step = start = state.step
    t0 = time.time()
    done = step >= max_steps
    for epoch in range(10 ** 9):
        if done:
            break
        for batch in loader.epoch(args.seed + epoch):
            if step >= max_steps:
                done = True
                break
            gen = torch.Generator(device).manual_seed(1000 + step)
            draws = {"dropout": torch.Generator().manual_seed(1000 + step)}
            state, metrics = trainer.train_step(state, batch, gen, host_rng, draws)
            step = state.step
            if mgr.due(step):
                mgr.maybe_save(step, trainer.checkpoint_payload(state))
            if step % args.log_every == 0 or step == max_steps:
                log("train_step", step=step, loss=float(metrics["loss"]),
                    flow=float(metrics["flow_loss"]), batch=list(batch["mel"].shape[:2]),
                    sps=(step - start) / max(time.time() - t0, 1e-9))
    mgr.write(mgr.last_path, trainer.checkpoint_payload(state))
    log("train_done", step=step)
    if is_primary():
        print(f"[train] done at step {step} -> {args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
