"""Zero-shot multilingual TTS CLI (counterpart of
``lemas_tts_tpu/scripts/tts_multilingual.py``, same flags and defaults).

The canonical invocation mirrors the reference ``tts_multilingual.sh:27-30``:
NFE 64, CFG 5.0, sway 3.0, ``--separate_langs``::

    python -m lemas_tts_tpu_torch.scripts.tts_multilingual --ref_audio ref.wav \\
        --ref_text "..." --text "..." --vocab_file vocab.txt --separate_langs

It runs on CUDA; ``--device cpu`` runs it on the CPU. It never retries on
another device: without CUDA, and without ``--device cpu``, it fails.
"""

from __future__ import annotations

import argparse
import random
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Zero-shot multilingual TTS (PyTorch/CUDA).")
    # model / assets
    p.add_argument("--model", type=str, default="multilingual",
                   help="Model config name (bundled) or a JSON/YAML path.")
    p.add_argument("--ckpt_file", type=str, default="",
                   help="Checkpoint: reference .safetensors/.pt.")
    p.add_argument("--vocab_file", type=str, default="", help="Path to vocab.txt.")
    p.add_argument("--frontend", type=str, default="phone",
                   choices=["phone", "char", "none"], help="Text frontend type.")
    p.add_argument("--use_ema", action="store_true",
                   help="Use EMA weights from the checkpoint.")
    p.add_argument("--enable_prosody_encoder", action="store_true",
                   help="Condition on the reference's prosody (random encoder weights "
                        "without --prosody_ckpt_path).")
    p.add_argument("--prosody_cfg_path", type=str, default="")
    p.add_argument("--prosody_ckpt_path", type=str, default="")
    p.add_argument("--vocoder_local_path", type=str, default=None)
    # inputs / outputs
    p.add_argument("--ref_audio", type=str, required=True, help="Reference WAV file.")
    p.add_argument("--ref_text", type=str, required=True,
                   help="Reference transcript ('' transcribes the reference with Whisper, "
                        "which needs the transformers package).")
    p.add_argument("--text", type=str, required=True, help="Text to synthesize.")
    p.add_argument("--output_wave", type=str, default="output.wav")
    p.add_argument("--output_spec", type=str, default="",
                   help="Optional spectrogram PNG path.")
    p.add_argument("--denoise", action="store_true",
                   help="UVR5 (MDX-Net) denoising of the reference before synthesis: "
                        "needs --uvr5_model; writes <ref stem>_vocal.wav at 44.1 kHz.")
    p.add_argument("--uvr5_model", type=str, default="",
                   help="MDX weights (.onnx/.ckpt/.pt) for --denoise.")
    # sampling
    p.add_argument("--nfe_step", type=int, default=64, help="Number of sampling steps (NFE).")
    p.add_argument("--cfg_strength", type=float, default=5.0, help="CFG strength.")
    p.add_argument("--sway_sampling_coef", type=float, default=3.0)
    p.add_argument("--cfg_cutoff", type=float, default=None,
                   help="Skip the uncond CFG forward once cfg_strength*(1-t)^2 < cutoff.")
    p.add_argument("--block_cache", type=str, default=None,
                   help="Block-range residual cache 'lo-hi:every[+hN][+tN]' (e.g. '2-20:2'): "
                        "those DiT blocks are recomputed only on refresh steps.")
    p.add_argument("--ode_method", type=str, default="euler", choices=["euler", "midpoint"],
                   help="ODE solver: euler (reference parity) | midpoint (2nd order).")
    p.add_argument("--ref_ratio", type=float, default=1.0,
                   help="GRL conditioning clip ratio (<1 shuffles the ref mel).")
    p.add_argument("--no_ref_audio", action="store_true",
                   help="Disable reference audio conditioning.")
    p.add_argument("--separate_langs", action="store_true",
                   help="Apply language tags per token (for multilingual models).")
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--use_acc_grl", action="store_true",
                   help="Use accent GRL conditioning (if the model supports it).")
    p.add_argument("--fix_duration", type=float, default=None)
    p.add_argument("--seed", type=int, default=-1, help="-1 → random.")
    # device / dtype
    p.add_argument("--device", type=str, default=None,
                   help="cuda | cpu (default: cuda; never falls back to the CPU).")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=[None, "bfloat16", "float32"])
    add_attn_backend(p)
    return p


def add_attn_backend(p: argparse.ArgumentParser) -> None:
    p.add_argument("--attn_backend", type=str, default=None, choices=["vmem", "splash", "xla"],
                   help="Attention backend (default vmem): vmem runs the fused kernels "
                        "(K1-K3, K5), splash the split-head chain on the splash kernel (K6), "
                        "xla plain PyTorch attention with no kernel of this package.")


def build_tts(args):
    """The TTS facade on ``--device`` (None: CUDA), with no fallback to
    another device."""
    from lemas_tts_tpu_torch.api import TTS

    return TTS(model=args.model, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
               ode_method=args.ode_method, use_ema=args.use_ema,
               vocoder_local_path=args.vocoder_local_path,
               use_prosody_encoder=args.enable_prosody_encoder,
               prosody_cfg_path=args.prosody_cfg_path, prosody_ckpt_path=args.prosody_ckpt_path,
               device=args.device,
               frontend=None if args.frontend == "none" else args.frontend,
               compute_dtype=args.compute_dtype, attn_backend=args.attn_backend)


def denoise_reference(args) -> str | None:
    """``--denoise``: the reference through UVR5 on ``--device``, written
    beside it as ``<stem>_vocal.wav``; None (after saying why) without a
    weights file: a random network must not clean the reference."""
    from pathlib import Path

    if not (args.uvr5_model and Path(args.uvr5_model).is_file()):
        print("[tts] --denoise requires --uvr5_model pointing at MDX weights "
              "(.onnx/.ckpt); refusing to denoise with a randomly initialized network",
              file=sys.stderr)
        return None
    from lemas_tts_tpu_torch.uvr5 import UVR5

    path = UVR5(model_path=args.uvr5_model, device=args.device).denoise_file(args.ref_audio)
    print(f"[tts] denoised reference → {path}")
    return path


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    seed = args.seed if args.seed >= 0 else random.randint(0, 2 ** 31 - 1)
    ref_audio = args.ref_audio
    if args.denoise:
        ref_audio = denoise_reference(args)
        if ref_audio is None:
            return 2
    tts = build_tts(args)
    wav, sr, _spec = tts.infer(
        ref_file=ref_audio, ref_text=args.ref_text, gen_text=args.text,
        nfe_step=args.nfe_step, cfg_strength=args.cfg_strength,
        sway_sampling_coef=args.sway_sampling_coef, cfg_cutoff=args.cfg_cutoff,
        speed=args.speed, separate_langs=args.separate_langs, use_acc_grl=args.use_acc_grl,
        ref_ratio=args.ref_ratio, no_ref_audio=args.no_ref_audio,
        fix_duration=args.fix_duration, use_prosody_encoder=args.enable_prosody_encoder,
        seed=seed, file_wave=args.output_wave,
        file_spec=args.output_spec or None, block_cache=args.block_cache)
    print(f"[tts] wrote {args.output_wave}: {len(wav) / sr:.2f} s @ {sr} Hz (seed {seed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
