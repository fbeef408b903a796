"""Objective evaluation CLI: score synthesized audio against references
(counterpart of ``lemas_tts_tpu/scripts/evaluate.py``, the same flags):

  python -m lemas_tts_tpu_torch.scripts.evaluate --manifest eval.jsonl \\
      --out results.json [--dtw] [--speaker_ckpt enc.pt]

Manifest: JSONL, one utterance a line —
  {"ref": "ref.wav", "hyp": "synth.wav", "text": "optional transcript",
   "hyp_text": "optional transcript of hyp"}
``ref``/``hyp`` may also be ``.npy`` log-mels ([T, D] or [D, T]); WAVs are
mel-ized with the config's frontend. Reported: mel MSE/MAE and MCD
(DTW-aligned with ``--dtw``), speaker cosine (with ``--speaker_ckpt``, a
torch file of a ``models.speaker.SpeakerEncoder`` state dict at the default
channel widths; its input and embedding widths are read from the file),
WER/CER (with transcripts; ``--asr`` transcribes a hyp WAV that has no
``hyp_text`` with Whisper, ``infer/asr.py``, on ``--device``). Runs on CUDA
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate synthesized speech.")
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--out", type=str, default="", help="JSON summary path.")
    p.add_argument("--per_utt", type=str, default="",
                   help="Optional per-utterance JSONL path.")
    p.add_argument("--config", type=str, default="multilingual",
                   help="Model config supplying the mel frontend params.")
    p.add_argument("--dtw", action="store_true",
                   help="DTW-align frames for MCD (length-mismatched pairs).")
    p.add_argument("--n_coeffs", type=int, default=13)
    p.add_argument("--speaker_ckpt", type=str, default="",
                   help="SpeakerEncoder state dict (torch file) for speaker cosine.")
    p.add_argument("--asr", action="store_true",
                   help="Transcribe hyp wavs for WER/CER when hyp_text is absent.")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; never falls back to another device.")
    return p


def _load_mel(path: str, frontend, sr_expect: int, device):
    """wav or .npy -> ([T, D] float32 numpy log-mel, the wave at
    ``sr_expect`` or None for a mel)."""
    import numpy as np
    import torch

    if path.endswith(".npy"):
        m = np.load(path)
        if m.ndim != 2:
            raise ValueError(f"{path}: expected 2-D mel, got {m.shape}")
        D = frontend.n_mel_channels  # the mel axis; a square passes as [T, D]
        if m.shape[0] == D and m.shape[1] != D:
            m = m.T
        return np.asarray(m, np.float32), None
    from lemas_tts_tpu_torch.ops.resample import resample
    from lemas_tts_tpu_torch.utils.audio_io import read_audio

    wav, sr = read_audio(path)
    if wav.ndim > 1:
        wav = wav.mean(axis=0)
    w = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    if sr != sr_expect:
        w = resample(w, sr, sr_expect)
    return frontend(w[None])[0].T.float().cpu().numpy(), w.cpu().numpy()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from lemas_tts_tpu_torch.api import select_device
    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.eval.metrics import cer, mcd, mel_mae, mel_mse, wer
    from lemas_tts_tpu_torch.ops.mel import MelFrontend

    device = select_device(args.device)
    cfg = load_model_config(args.config)
    ms = cfg.mel_spec
    frontend = MelFrontend(n_fft=ms.n_fft, hop_length=ms.hop_length, win_length=ms.win_length,
                           n_mel_channels=ms.n_mel_channels,
                           target_sample_rate=ms.target_sample_rate,
                           mel_spec_type=ms.mel_spec_type)

    spk = None
    if args.speaker_ckpt:
        from lemas_tts_tpu_torch.eval.metrics import speaker_similarity
        from lemas_tts_tpu_torch.models.speaker import SpeakerConfig, SpeakerEncoder

        sd = torch.load(args.speaker_ckpt, map_location="cpu", weights_only=True)
        enc = SpeakerEncoder(SpeakerConfig(input_dim=sd["blocks.0.conv.conv.weight"].shape[1],
                                           embed_dim=sd["fc.weight"].shape[0]))
        enc.load_state_dict(sd)
        enc = enc.to(device).eval()
        spk = lambda a, b: speaker_similarity(enc, a, b)  # noqa: E731

    rows = []
    with open(args.manifest, "r", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    if not rows:
        print("empty manifest", file=sys.stderr)
        return 2

    per_utt = []
    for rec in rows:
        ref_mel, _ = _load_mel(rec["ref"], frontend, ms.target_sample_rate, device)
        hyp_mel, hyp_wav = _load_mel(rec["hyp"], frontend, ms.target_sample_rate, device)
        t = min(len(ref_mel), len(hyp_mel))
        r = {"ref": rec["ref"], "hyp": rec["hyp"],
             "mel_mse": float(mel_mse(ref_mel[None, :t], hyp_mel[None, :t])),
             "mel_mae": float(mel_mae(ref_mel[None, :t], hyp_mel[None, :t])),
             "mcd_db": mcd(ref_mel, hyp_mel, n_coeffs=args.n_coeffs, use_dtw=args.dtw)}
        if spk is not None:
            r["speaker_cos"] = spk(ref_mel, hyp_mel)
        text, hyp_text = rec.get("text"), rec.get("hyp_text")
        if text is not None and hyp_text is None and args.asr and hyp_wav is not None:
            from lemas_tts_tpu_torch.infer.asr import transcribe

            hyp_text = transcribe((hyp_wav, ms.target_sample_rate), device=device)
        if text is not None and hyp_text is not None:
            r["wer"] = wer(text, hyp_text)
            r["cer"] = cer(text, hyp_text)
        per_utt.append(r)

    keys = sorted({k for r in per_utt for k in r if isinstance(r[k], (int, float))})
    summary = {"n_utterances": len(per_utt),
               **{k: float(np.mean([r[k] for r in per_utt if k in r])) for k in keys}}
    out = json.dumps(summary, sort_keys=True)
    print(out)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(out + "\n")
    if args.per_utt:
        with open(args.per_utt, "w", encoding="utf-8") as f:
            for r in per_utt:
                f.write(json.dumps(r, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
