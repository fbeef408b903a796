"""Speech-editing CLI: regenerate word spans via alignment JSONs (counterpart
of ``lemas_tts_tpu/scripts/speech_edit_multilingual.py``, same flags and
defaults: NFE 64, CFG 5, sway 3).

A single WAV or a directory of WAVs, each paired with ``<basename>.json`` in
``--align_dir``, is edited and written to ``--save_dir``::

    python -m lemas_tts_tpu_torch.scripts.speech_edit_multilingual --wav utt.wav \\
        --align_dir align/ --save_dir out/ --vocab_file vocab.txt

It runs on CUDA; ``--device cpu`` runs it on the CPU, with no fallback.
``--attn_backend`` (``vmem``, ``splash``, ``xla``) picks the attention route
of the edit's sampler, as in the TTS CLI.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional, Tuple

from lemas_tts_tpu_torch.scripts.tts_multilingual import add_attn_backend, build_tts


def build_tokens_from_text(tts, text: str) -> List[str]:
    """Raw text -> one frontend token sequence (reference
    ``speech_edit_multilingual.py:29-64``)."""
    t = text.strip()
    if not t.endswith((".", "。", "!", "？", "?", "！")):
        t = t + "."
    if tts.frontend is None:
        return list(t)
    if tts.frontend.dtype == "phone":
        phones = tts.frontend.text2phn(t + " ").replace("(cmn)", "(zh)")
        return [tok for tok in phones.split("|") if tok]
    lang, norm = tts.frontend.text2norm(t + " ")
    return [f"({lang.replace('cmn', 'zh')})"] + list(norm)


def collect_pairs(wav: Optional[str], wav_dir: str, align_dir: str,
                  save_dir: str) -> List[Tuple[str, str, str]]:
    """(wav, json, save) triples (reference ``:289-317``)."""
    if wav is not None:
        wav_paths = [wav]
    else:
        # .mp3 too, as in the JAX CLI: read_audio refuses it loudly
        wav_paths = sorted(os.path.join(wav_dir, f) for f in os.listdir(wav_dir)
                           if f.lower().endswith((".wav", ".mp3")))
    pairs = []
    for wp in wav_paths:
        base = os.path.splitext(os.path.basename(wp))[0]
        pairs.append((wp, os.path.join(align_dir, base + ".json"),
                      os.path.join(save_dir, base + ".wav")))
    return pairs


def run_edit_for_pair(tts, wav_path: str, json_path: str, save_path: str, *, nfe_step: int,
                      cfg_strength: float, sway_sampling_coef: float, ref_ratio: float,
                      no_ref_audio: bool, use_acc_grl: bool, use_prosody_encoder: bool,
                      seed: Optional[int]) -> None:
    """Edit one utterance (reference ``:210-287``)."""
    import numpy as np

    from lemas_tts_tpu_torch.config import SamplerConfig
    from lemas_tts_tpu_torch.infer.editing import edit_speech, parse_align_json
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    wav, sr = read_audio(wav_path)
    if wav.ndim == 2:
        wav = wav.mean(axis=0)
    wav = np.clip(wav, -0.999, 0.999)

    spec = parse_align_json(json_path)
    segment = wav[int(round(spec.utt_start * sr)): int(round(spec.utt_end * sr))]
    tokens = tts.process_phone_list(build_tokens_from_text(tts, spec.target_text))

    print(f"\n[EDIT] {os.path.basename(wav_path)}")
    print(f"  display_text : {spec.display_text}")
    print(f"  target_text  : {spec.target_text}")
    print(f"  edit_span    : {spec.parts_to_edit} (sec, relative to utterance)")

    cfg = SamplerConfig(nfe_steps=nfe_step, cfg_strength=cfg_strength,
                        sway_sampling_coef=sway_sampling_coef, ode_method=tts.ode_method,
                        use_acc_grl=use_acc_grl, use_prosody_encoder=use_prosody_encoder,
                        ref_ratio=ref_ratio, no_ref_audio=no_ref_audio)
    t0 = time.time()
    out, out_sr, _mel = edit_speech(tts.synth, segment, sr, tokens, spec.parts_to_edit, cfg=cfg,
                                    seed=seed)
    write_wav(save_path, out, out_sr)
    print(f"  saved: {save_path}  ({time.time() - t0:.3f} s)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multilingual speech editing (PyTorch/CUDA).")
    p.add_argument("--wav", type=str, default=None, help="Single input WAV (else --wav_dir).")
    p.add_argument("--wav_dir", type=str, default="")
    p.add_argument("--align_dir", type=str, required=True,
                   help="Directory of <basename>.json alignment files.")
    p.add_argument("--save_dir", type=str, required=True)
    # model / assets (same surface as tts_multilingual)
    p.add_argument("--model", type=str, default="multilingual")
    p.add_argument("--ckpt_file", type=str, default="")
    p.add_argument("--vocab_file", type=str, default="")
    p.add_argument("--frontend", type=str, default="phone", choices=["phone", "char", "none"])
    p.add_argument("--use_ema", action="store_true")
    # the reference spells this flag --use_prosody_encoder here but
    # --enable_prosody_encoder in the TTS CLI; accept both
    p.add_argument("--enable_prosody_encoder", "--use_prosody_encoder",
                   dest="enable_prosody_encoder", action="store_true")
    p.add_argument("--prosody_cfg_path", type=str, default="")
    p.add_argument("--prosody_ckpt_path", type=str, default="")
    p.add_argument("--vocoder_local_path", type=str, default=None)
    # sampling (edit defaults mirror the reference speech_edit_multilingual.sh)
    p.add_argument("--nfe_step", type=int, default=64)
    p.add_argument("--cfg_strength", type=float, default=5.0)
    p.add_argument("--sway_sampling_coef", type=float, default=3.0)
    p.add_argument("--ode_method", type=str, default="euler", choices=["euler", "midpoint"])
    p.add_argument("--ref_ratio", type=float, default=1.0)
    p.add_argument("--no_ref_audio", action="store_true")
    # unused but kept for invocation compatibility (reference :367)
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--use_acc_grl", action="store_true")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--device", type=str, default=None,
                   help="cuda | cpu (default: cuda; never falls back to the CPU).")
    p.add_argument("--compute_dtype", type=str, default=None)
    add_attn_backend(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    tts = build_tts(args)
    seed = args.seed if args.seed >= 0 else None
    pairs = collect_pairs(args.wav, args.wav_dir, args.align_dir, args.save_dir)
    n_ok = 0
    for wav_path, json_path, save_path in pairs:
        if not os.path.isfile(json_path):
            print(f"[edit] skip {wav_path}: no alignment {json_path}", file=sys.stderr)
            continue
        run_edit_for_pair(tts, wav_path, json_path, save_path, nfe_step=args.nfe_step,
                          cfg_strength=args.cfg_strength,
                          sway_sampling_coef=args.sway_sampling_coef, ref_ratio=args.ref_ratio,
                          no_ref_audio=args.no_ref_audio, use_acc_grl=args.use_acc_grl,
                          use_prosody_encoder=args.enable_prosody_encoder, seed=seed)
        n_ok += 1
    print(f"[edit] done: {n_ok}/{len(pairs)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
