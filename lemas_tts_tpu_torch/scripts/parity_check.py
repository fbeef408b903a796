"""Checkpoint parity harness: per-language mel MSE against the PyTorch
reference (counterpart of ``lemas_tts_tpu/scripts/parity_check.py``).

The north-star gate is mel MSE < 1e-3 against the reference checkpoints.
This script makes that gate one command once pretrained assets exist (none
are in the repository, and nothing can be downloaded):

1. **Capture** (needs the reference repository and its torch dependencies,
   torchaudio included, importable; it fails with exit code 2 elsewhere)::

       python -m lemas_tts_tpu_torch.scripts.parity_check --capture \
           --ref_repo /path/to/LEMAS-TTS --ckpt_file model.safetensors \
           --manifest cases.json --bundle ref_bundle/

   runs the reference pipeline (``lemas_tts/infer/utils_infer.py:399-625``)
   per case and stores what a faithful replay needs: the generated mel
   ([D, T], the generated region only, ``utils_infer.py:545-546``), the
   initial noise y0 drawn inside ``CFM.sample`` (``model/cfm.py:430-435``;
   caught by a ``torch.randn`` wrapper), the post-clamp duration in frames,
   and the phone-token lists fed to the model.

2. **Compare** (default)::

       python -m lemas_tts_tpu_torch.scripts.parity_check \
           --ckpt_file model.safetensors --vocab_file vocab.txt \
           --bundle ref_bundle/ [--threshold 1e-3] [--out report.json]

   replays every case through the port's pipeline on ``--device`` (CUDA
   unless ``--device cpu``) with the captured noise, durations and tokens
   pinned (``Synthesizer.synthesize_chunks`` ``noise_override`` /
   ``duration_override``), scores mel MSE / MAE / MCD per case, aggregates
   per language, prints the table, and exits non-zero if any language's
   mean MSE exceeds the threshold.

Case manifest (JSON)::

    {"cases": [{
        "name": "en_0", "lang": "en",
        "ref_audio": "prompts/en.wav",        # ideally already 24 kHz mono
        "ref_units": ["h", "ə", ...],          # phone tokens (or raw string)
        "gen_units": ["w", "ɜː", ...],
        "nfe": 32, "cfg_strength": 2.0, "sway": -1.0,
        "speed": 1.0, "seed": 0}, ...]}

Relative paths are resolved against the manifest's directory. Captured
bundles carry ``captured.json`` (the manifest plus per-case ``duration``
and file names) next to ``<name>.mel.npy`` / ``<name>.noise.npy``, the
same format as the JAX package's.

Cases should use reference audio already at the model sample rate: two
resamplers differ numerically, which would contaminate a model-parity
measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Mel-MSE parity against reference checkpoints.")
    p.add_argument("--manifest", type=str, default="",
                   help="Case manifest JSON (required with --capture; "
                        "compare mode reads the bundle's captured.json).")
    p.add_argument("--bundle", type=str, required=True,
                   help="Reference-output bundle directory (written by "
                        "--capture, read by compare).")
    p.add_argument("--capture", action="store_true",
                   help="Run the PyTorch reference and write the bundle.")
    p.add_argument("--ref_repo", type=str, default="",
                   help="Path to the reference repo (capture mode).")
    # model flags (shared with the TTS CLI)
    p.add_argument("--model", type=str, default="multilingual")
    p.add_argument("--ckpt_file", type=str, default="")
    p.add_argument("--vocab_file", type=str, default="")
    p.add_argument("--vocoder_local_path", type=str, default=None)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--use_prosody_encoder", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; never falls back to another device.")
    # scoring
    p.add_argument("--threshold", type=float, default=1e-3,
                   help="Per-language mean mel-MSE gate (compare mode).")
    p.add_argument("--out", type=str, default="",
                   help="JSON report path (compare mode).")
    return p


def _load_manifest(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        m = json.load(f)
    if "cases" not in m or not m["cases"]:
        raise ValueError(f"{path}: manifest has no cases")
    return m


def _resolve(base: str, path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(base, path)


def _units(case: Dict[str, Any], key: str):
    u = case[key]
    return u if isinstance(u, str) else list(u)


# --------------------------------------------------------------- capture


def capture(args) -> int:
    if not args.manifest:
        print("--capture requires --manifest", file=sys.stderr)
        return 2
    manifest = _load_manifest(args.manifest)
    base = os.path.dirname(os.path.abspath(args.manifest))
    os.makedirs(args.bundle, exist_ok=True)

    if args.ref_repo:
        sys.path.insert(0, args.ref_repo)
    try:
        import torch
        import torchaudio  # noqa: F401  (infer_process loads audio with it)
        from lemas_tts.infer.utils_infer import (  # type: ignore
            infer_process, load_model, load_vocoder)
        from lemas_tts.model import DiT  # type: ignore
    except ImportError as e:  # pragma: no cover - needs the torch reference
        print(f"capture mode needs torch + the reference repo: {e}",
              file=sys.stderr)
        return 2

    mel_spec_type = manifest.get("mel_spec_type", "vocos")
    model_cfg = manifest.get("model_cfg", dict(
        dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512, conv_layers=4))
    vocoder = load_vocoder(vocoder_name=mel_spec_type,
                           is_local=bool(args.vocoder_local_path),
                           local_path=args.vocoder_local_path or "")
    model = load_model(DiT, model_cfg, args.ckpt_file,
                       mel_spec_type=mel_spec_type,
                       vocab_file=args.vocab_file, use_ema=args.use_ema)

    n_mel = manifest.get("n_mel_channels", 100)
    captured_cases: List[Dict[str, Any]] = []
    real_randn = torch.randn
    for case in manifest["cases"]:
        name = case["name"]
        drawn: List[Any] = []

        def randn_spy(*shape, **kw):
            out = real_randn(*shape, **kw)
            sh = shape[0] if len(shape) == 1 and isinstance(
                shape[0], (tuple, list)) else shape
            if len(sh) == 2 and sh[-1] == n_mel:  # the y0 draw (cfm.py:434)
                drawn.append(out.detach().cpu().float().numpy())
            return out

        torch.manual_seed(int(case.get("seed", 0)))
        torch.randn = randn_spy
        try:
            _wave, _sr, mel = infer_process(
                _resolve(base, case["ref_audio"]),
                _units(case, "ref_units"),
                [_units(case, "gen_units")],
                model, vocoder, mel_spec_type=mel_spec_type,
                nfe_step=int(case.get("nfe", 32)),
                cfg_strength=float(case.get("cfg_strength", 2.0)),
                sway_sampling_coef=case.get("sway", -1.0),
                use_acc_grl=bool(case.get("use_acc_grl", True)),
                use_prosody_encoder=bool(
                    case.get("use_prosody_encoder", False)),
                speed=float(case.get("speed", 1.0)),
                fix_duration=case.get("fix_duration"),
            )
        finally:
            torch.randn = real_randn
        if not drawn:
            print(f"{name}: no y0 draw intercepted", file=sys.stderr)
            return 1
        import numpy as np

        noise = drawn[0]
        np.save(os.path.join(args.bundle, f"{name}.mel.npy"),
                np.asarray(mel, np.float32))
        np.save(os.path.join(args.bundle, f"{name}.noise.npy"), noise)
        captured_cases.append({
            **case,
            "ref_audio": _resolve(base, case["ref_audio"]),
            "duration": int(noise.shape[0]),  # post-clamp (cfm.py:300-305)
            "mel": f"{name}.mel.npy",
            "noise": f"{name}.noise.npy",
        })
        print(f"captured {name}: dur={noise.shape[0]} mel={mel.shape}")

    with open(os.path.join(args.bundle, "captured.json"), "w",
              encoding="utf-8") as f:
        json.dump({**manifest, "cases": captured_cases}, f, indent=1)
    print(f"bundle written to {args.bundle}")
    return 0


# --------------------------------------------------------------- compare


def compare(args) -> int:
    import numpy as np

    from lemas_tts_tpu_torch.api import TTS
    from lemas_tts_tpu_torch.config import SamplerConfig
    from lemas_tts_tpu_torch.eval.metrics import mcd, mel_mae, mel_mse
    from lemas_tts_tpu_torch.utils.audio_io import read_audio

    cap_path = os.path.join(args.bundle, "captured.json")
    manifest = _load_manifest(args.manifest or cap_path)
    base = args.bundle

    tts = TTS(
        model=args.model, ckpt_file=args.ckpt_file,
        vocab_file=args.vocab_file, use_ema=args.use_ema,
        vocoder_local_path=args.vocoder_local_path,
        use_prosody_encoder=args.use_prosody_encoder,
        device=args.device, frontend=None,
    )

    rows: List[Dict[str, Any]] = []
    for case in manifest["cases"]:
        name = case["name"]
        wav, sr = read_audio(_resolve(base, case["ref_audio"]))
        if wav.ndim > 1:
            wav = wav.mean(axis=0)
        noise = np.load(_resolve(base, case["noise"]))
        ref_mel = np.load(_resolve(base, case["mel"]))  # [D, T]
        cfg = SamplerConfig(
            nfe_steps=int(case.get("nfe", 32)),
            cfg_strength=float(case.get("cfg_strength", 2.0)),
            sway_sampling_coef=case.get("sway", -1.0),
            speed=float(case.get("speed", 1.0)),
            use_acc_grl=bool(case.get("use_acc_grl", True)),
            use_prosody_encoder=bool(case.get("use_prosody_encoder", False)),
        )
        _wave, _sr, mel = tts.synth.synthesize_chunks(
            wav, sr, _units(case, "ref_units"), [_units(case, "gen_units")],
            cfg=cfg,
            noise_override=noise,
            duration_override=[int(case["duration"])],
        )
        t = min(mel.shape[1], ref_mel.shape[1])
        a, b = mel[:, :t].T[None], ref_mel[:, :t].T[None]
        rows.append({
            "name": name, "lang": case.get("lang", "?"),
            "frames": int(t), "frames_ours": int(mel.shape[1]),
            "frames_ref": int(ref_mel.shape[1]),
            "mel_mse": float(mel_mse(a, b)),
            "mel_mae": float(mel_mae(a, b)),
            "mcd_db": mcd(mel.T[:t], ref_mel.T[:t]),
        })
        print(f"{name:16s} lang={rows[-1]['lang']:4s} "
              f"mse={rows[-1]['mel_mse']:.3e} mae={rows[-1]['mel_mae']:.3e} "
              f"mcd={rows[-1]['mcd_db']:.3f}dB frames={t}")

    langs: Dict[str, List[Dict[str, Any]]] = {}
    for r in rows:
        langs.setdefault(r["lang"], []).append(r)
    per_lang = {
        lang: {
            "n": len(rs),
            "mel_mse": float(np.mean([r["mel_mse"] for r in rs])),
            "mel_mae": float(np.mean([r["mel_mae"] for r in rs])),
            "mcd_db": float(np.mean([r["mcd_db"] for r in rs])),
        }
        for lang, rs in sorted(langs.items())
    }
    print(f"\n{'lang':6s} {'n':>3s} {'mel_mse':>11s} {'mel_mae':>11s} "
          f"{'mcd_db':>8s}  gate(<{args.threshold:g})")
    failed = []
    for lang, s in per_lang.items():
        ok = s["mel_mse"] < args.threshold
        if not ok:
            failed.append(lang)
        print(f"{lang:6s} {s['n']:3d} {s['mel_mse']:11.3e} "
              f"{s['mel_mae']:11.3e} {s['mcd_db']:8.3f}  "
              f"{'ok' if ok else 'FAIL'}")

    report = {"threshold": args.threshold, "per_lang": per_lang,
              "cases": rows, "failed_langs": failed}
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
    return 1 if failed else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return capture(args) if args.capture else compare(args)


if __name__ == "__main__":
    sys.exit(main())
