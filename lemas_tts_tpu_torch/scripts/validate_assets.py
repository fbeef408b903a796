"""One-command real-asset validation runbook (counterpart of
``lemas_tts_tpu/scripts/validate_assets.py``, its flags plus ``--device``
and ``--smoke_nfe``). It chains what only a machine with the pretrained
assets can check: converting the reference checkpoints, one synthesis on
them, mel parity against reference-produced outputs, the live espeak phone
contract, and re-probing the serving defaults on real weights:

    python -m lemas_tts_tpu_torch.scripts.validate_assets \\
        --ckpt model_last.safetensors --vocab_file vocab.txt \\
        --vocos pretrained/vocos-mel-24khz \\
        --ref_repo /path/to/LEMAS-TTS --ref_audio prompts/en_24k.wav \\
        --out validated/

Steps (each prints one ``[step]`` JSON line; ``--only``/``--skip`` select,
``--dry_run`` prints the stand-alone commands without running them); every
step runs the port's own CLI or ``TTS`` on ``--device`` (CUDA unless
``--device cpu``):

1. ``convert_cfm``        reference CFM/DiT checkpoint -> orbax ``<out>/native_model``
2. ``convert_vocoder``    Vocos/BigVGAN weights -> orbax ``<out>/vocos_native``
                          (``bigvgan_native``)
3. ``convert_uvr5``       MDX-Net .onnx/.ckpt -> orbax ``<out>/uvr5_native``
4. ``smoke_infer``        one ``TTS.infer`` (``--smoke_nfe`` steps) on the
                          converted model -> a finite, non-silent
                          ``<out>/smoke.wav``
5. ``parity_capture``     reference-side mel capture (``parity_check --capture``)
6. ``parity_compare``     replay the bundle (``parity_check``); mel MSE < ``--threshold``
7. ``phone_goldens``      phone goldens from the real espeak backend
                          (``capture_phone_goldens``) -> ``<out>/phone_goldens.json``
8. ``reprobe_cutoff``     ``SERVING_CFG_CUTOFF`` on the converted weights (``cutoff_probe``)
9. ``reprobe_blockcache`` ``SERVING_BLOCK_CACHE`` and a fallback grid (``blockcache_probe``)
10. ``reprobe_quant``     ``SERVING_QUANT`` int8 against bf16 (``quant_probe``)

A step whose inputs or dependencies are absent reports ``skip`` with the
reason and the chain goes on; the exit code is non-zero only if a step that
ran failed. A record of a step that ran carries the kernel launches it made
(``launches``, by kernel name; none on the CPU, where the wrappers run their
plain versions).

Differences from the JAX runbook: ``--device`` goes to every step;
``--smoke_nfe`` (default 16, the JAX smoke's) sets the smoke's steps;
``parity_capture`` names its bundle with ``--bundle``, the flag
``parity_check`` takes (the JAX runbook passes ``--out``, which the capture
refuses).
Without ``tensorstore`` (the port reads and writes orbax with it, an
optional dependency) the ``convert_*`` steps report ``skip`` with that
reason, ``smoke_infer`` loads the reference files directly and the
``reprobe_*`` steps probe the reference ``--ckpt`` file: that is what the
port can do on such a machine. With it, they load ``<out>/native_model`` as
the JAX runbook does.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from contextlib import redirect_stdout
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

STEPS = ("convert_cfm", "convert_vocoder", "convert_uvr5", "smoke_infer",
         "parity_capture", "parity_compare", "phone_goldens",
         "reprobe_cutoff", "reprobe_blockcache", "reprobe_quant")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Validate real pretrained assets end-to-end.")
    p.add_argument("--ckpt", type=str, default="", help="reference CFM/DiT .safetensors or .pt")
    p.add_argument("--vocab_file", type=str, default="")
    p.add_argument("--vocos", type=str, default="", help="vocos dir (pytorch_model.bin) or file")
    p.add_argument("--bigvgan", type=str, default="",
                   help="BigVGAN generator .pt/.bin (instead of --vocos)")
    p.add_argument("--uvr5", type=str, default="", help="MDX-Net .onnx (optional denoiser)")
    p.add_argument("--model", type=str, default="multilingual",
                   help="model config name or YAML path (api.TTS)")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--ref_repo", type=str, default="",
                   help="reference LEMAS-TTS repo for parity capture")
    p.add_argument("--ref_audio", type=str, default="",
                   help="24 kHz mono reference prompt for smoke/parity")
    p.add_argument("--ref_text", type=str, default="This is the reference prompt.",
                   help="transcript of --ref_audio (empty: Whisper ASR, which needs the "
                        "model at hand)")
    p.add_argument("--bundle", type=str, default="",
                   help="existing reference bundle (skip parity_capture)")
    p.add_argument("--manifest", type=str, default="", help="case manifest for parity_capture")
    p.add_argument("--threshold", type=float, default=1e-3,
                   help="parity + serving-default mel-MSE bar")
    p.add_argument("--pick_mse", type=float, default=1e-4,
                   help="block-cache re-probe calibration budget")
    p.add_argument("--probe_args", type=str, default="",
                   help="extra args appended to the reprobe CLIs (e.g. '--dim 64 --depth 2 "
                        "--heads 4 --mel_dim 20 --vocab 28 --n 64 --batch 2' for a "
                        "non-flagship checkpoint)")
    p.add_argument("--smoke_nfe", type=int, default=16, help="NFE steps of smoke_infer")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu, for every step; never falls back.")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--only", type=str, default="", help=f"comma list from {','.join(STEPS)}")
    p.add_argument("--skip", type=str, default="")
    p.add_argument("--dry_run", action="store_true",
                   help="print the equivalent stand-alone commands only")
    return p


@dataclass
class Step:
    name: str
    argv: Optional[List[str]]  # `python -m lemas_tts_tpu_torch.scripts.<module> ...`
    skip_reason: Optional[str]  # set: report skip, run nothing
    run: Optional[Callable] = None  # check after the CLI (its stdout), or the step itself
    note: str = ""
    module: str = ""
    # a path an earlier step of this run writes: missing at run time means
    # skip with that reason (the producing step failed or was deselected)
    requires: Optional[str] = None


def _exists(path: str) -> bool:
    return bool(path) and Path(path).exists()


def have_tensorstore() -> bool:
    try:
        import tensorstore  # noqa: F401
    except ImportError:
        return False
    return True


def _emit(rec: Dict) -> None:
    print("[step] " + json.dumps(rec), flush=True)


def _call_cli(module: str, argv: List[str]) -> str:
    """Run a ``scripts/`` CLI in this process, its stdout captured (and
    copied to stderr); raises on a non-zero return."""
    import importlib

    mod = importlib.import_module(f"lemas_tts_tpu_torch.scripts.{module}")
    buf = io.StringIO()

    class _Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            sys.stderr.write(s)
            return len(s)

    with redirect_stdout(_Tee()):
        rc = mod.main(argv)
    if rc not in (None, 0):
        raise RuntimeError(f"{module} exited {rc}")
    return buf.getvalue()


def _launches() -> Dict[str, int]:
    from lemas_tts_tpu_torch.ops.launches import counters

    return {k: f.launches for k, f in counters().items()}


def _records(stdout: str) -> List[Dict]:
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


def build_steps(args) -> List[Step]:
    out = Path(args.out)
    native_model = str(out / "native_model")
    native_voc = str(out / ("bigvgan_native" if args.bigvgan else "vocos_native"))
    dev = ["--device", args.device] if args.device else []
    orbax = have_tensorstore()
    no_ts = "tensorstore not importable: the port writes orbax directories with it"
    steps: List[Step] = []

    # ---- 1-3 conversions
    steps.append(Step(
        "convert_cfm", module="convert_checkpoint",
        argv=["--ckpt", args.ckpt, "--out", native_model]
        + (["--use_ema"] if args.use_ema else []) + dev,
        skip_reason=("--ckpt not provided/found" if not _exists(args.ckpt) else
                     None if orbax else no_ts),
        note="expect: '[convert] cfm ...' with a ~330M param count for the flagship model"))
    if args.bigvgan:
        voc_argv = ["--bigvgan", args.bigvgan, "--out", native_voc]
        voc_skip = None if _exists(args.bigvgan) else "--bigvgan not found"
    else:
        voc_argv = ["--vocos", args.vocos, "--out", native_voc]
        voc_skip = None if _exists(args.vocos) else "--vocos not provided/found"
    steps.append(Step("convert_vocoder", module="convert_checkpoint", argv=voc_argv + dev,
                      skip_reason=voc_skip or (None if orbax else no_ts),
                      note="expect: vocoder param count + orbax dir"))
    steps.append(Step(
        "convert_uvr5", module="convert_checkpoint",
        argv=["--uvr5", args.uvr5, "--out", str(out / "uvr5_native")] + dev,
        skip_reason=("--uvr5 not provided" if not _exists(args.uvr5) else
                     None if orbax else no_ts),
        note="expect: '[convert] uvr5 (derived config: ...)'"))

    # ---- 4 smoke infer
    def smoke() -> Dict:
        import numpy as np

        from lemas_tts_tpu_torch.api import TTS
        from lemas_tts_tpu_torch.utils.audio_io import write_wav

        # the orbax artifact step 1 wrote, so the converted model on disk is
        # itself load-checked; the reference file when there is none
        ckpt = native_model if Path(native_model).is_dir() else args.ckpt
        tts = TTS(model=args.model, ckpt_file=ckpt, vocab_file=args.vocab_file,
                  use_ema=args.use_ema, vocoder_local_path=(args.vocos or args.bigvgan) or None,
                  device=args.device)
        wave, sr, _ = tts.infer(args.ref_audio, args.ref_text, "Hello from the runbook.",
                                nfe_step=args.smoke_nfe, seed=0)
        if wave.size == 0 or not np.isfinite(wave).all():
            raise RuntimeError("smoke infer produced empty/non-finite audio")
        peak = float(np.abs(wave).max())
        if peak < 1e-4:
            raise RuntimeError(f"smoke infer is silent (peak {peak:.1e}): "
                               "checkpoint/vocoder mismatch?")
        write_wav(str(out / "smoke.wav"), wave.astype(np.float32), sr)
        return {"audio_s": round(wave.size / sr, 2), "peak": round(peak, 3), "loaded": ckpt}

    smoke_skip = None
    if not (_exists(args.ckpt) and _exists(args.vocab_file)):
        smoke_skip = "needs --ckpt and --vocab_file"
    elif not _exists(args.ref_audio):
        smoke_skip = ("needs --ref_audio (no ASR in zero-egress envs either: pass ref text "
                      "via a manifest for parity instead)")
    steps.append(Step("smoke_infer", argv=None, skip_reason=smoke_skip, run=smoke,
                      note="expect: audible non-silent wave at <out>/smoke.wav (listen to it!)"))

    # ---- 5-6 parity
    bundle = args.bundle or str(out / "ref_bundle")
    cap_skip = None
    if args.bundle:
        cap_skip = "using existing --bundle"
    elif not (_exists(args.ref_repo) and _exists(args.manifest)):
        cap_skip = "needs --ref_repo and --manifest (torch-side capture)"
    steps.append(Step(
        "parity_capture", module="parity_check",
        argv=["--capture", "--ref_repo", args.ref_repo, "--ckpt_file", args.ckpt,
              "--manifest", args.manifest, "--vocab_file", args.vocab_file,
              "--model", args.model, "--bundle", bundle]
        + (["--use_ema"] if args.use_ema else []) + dev,
        skip_reason=cap_skip,
        note="expect: <bundle>/captured.json + one .mel.npy/.noise.npy per case"))
    steps.append(Step(
        "parity_compare", module="parity_check",
        argv=["--bundle", bundle, "--ckpt_file", args.ckpt, "--vocab_file", args.vocab_file,
              "--model", args.model, "--threshold", str(args.threshold),
              "--out", str(out / "parity_report.json")]
        + (["--use_ema"] if args.use_ema else [])
        + (["--vocoder_local_path", args.vocos] if args.vocos else []) + dev,
        skip_reason=(None if (_exists(bundle) or cap_skip is None)
                     else "no bundle (parity_capture skipped)"),
        note=f"expect: per-language mel MSE < {args.threshold:g}; report at "
             "<out>/parity_report.json"))

    # ---- 7 phone goldens
    from lemas_tts_tpu_torch.text import tokenizer as tok

    steps.append(Step(
        "phone_goldens", module="capture_phone_goldens",
        argv=["--out", str(out / "phone_goldens.json")]
        + (["--vocab_file", args.vocab_file] if args.vocab_file else []) + dev,
        skip_reason=None if tok.available() else "espeak-ng unavailable",
        note="expect: backend 'espeak' in the JSON; copy over tests/data/phone_goldens.json "
             "so the tests pin the real contract"))

    # ---- 8-10 serving-default re-probes
    from lemas_tts_tpu_torch.config import SERVING_BLOCK_CACHE, SERVING_CFG_CUTOFF

    def check_cutoff(stdout: str) -> Dict:
        mine = [r for r in _records(stdout)
                if r.get("cutoff") == SERVING_CFG_CUTOFF and "mel_mse" in r]
        if not mine:
            raise RuntimeError("probe emitted no record for the serving default cutoff "
                               f"{SERVING_CFG_CUTOFF}")
        mse = mine[0]["mel_mse"]
        if mse > args.threshold:
            raise RuntimeError(f"SERVING_CFG_CUTOFF={SERVING_CFG_CUTOFF} diverges {mse:.2e} mel "
                               f"MSE on real weights (> {args.threshold:g}): lower the default "
                               "in config.py")
        return {"mel_mse": mse}

    def check_cache(stdout: str) -> Dict:
        recs = _records(stdout)
        mine = [r for r in recs if r.get("spec") == SERVING_BLOCK_CACHE]
        if not mine or "mel_mse" not in mine[0]:
            raise RuntimeError("probe emitted no record for the serving default spec "
                               f"{SERVING_BLOCK_CACHE!r}")
        mse = mine[0]["mel_mse"]
        picked = [r.get("picked") for r in recs if "picked" in r]
        if mse > args.threshold:
            raise RuntimeError(
                f"SERVING_BLOCK_CACHE={SERVING_BLOCK_CACHE!r} diverges {mse:.2e} mel MSE on "
                f"real weights (> {args.threshold:g}): probe picked "
                f"{picked[0] if picked else None!r} at the {args.pick_mse:g} budget; "
                "update config.py")
        return {"mel_mse": mse, "picked": picked[0] if picked else None}

    def check_quant(stdout: str) -> Dict:
        serving = [r for r in _records(stdout) if r.get("mode") == "serving"]
        if not serving:
            raise RuntimeError("quant probe emitted no serving-mode record")
        worst = max(r["mel_mse_int8_vs_bf16"] for r in serving)
        if worst > args.threshold:
            raise RuntimeError(f"SERVING_QUANT int8 diverges {worst:.2e} mel MSE from the bf16 "
                               f"trajectory on real weights (> {args.threshold:g}): set "
                               "LEMAS_SERVING_QUANT='' / config.SERVING_QUANT=None")
        return {"mel_mse_int8_vs_bf16": worst}

    probe_skip = (None if _exists(args.ckpt)
                  else "needs --ckpt (random-weight probes already run in CI/bench)")
    probe_ckpt = native_model if orbax else args.ckpt
    extra = (args.probe_args.split() if args.probe_args else []) + dev
    steps.append(Step(
        "reprobe_cutoff", module="cutoff_probe",
        argv=["--ckpt", probe_ckpt, "--cutoffs", str(SERVING_CFG_CUTOFF)] + extra,
        skip_reason=probe_skip, run=check_cutoff, requires=probe_ckpt,
        note="expect: serving-default cutoff mel MSE well under the bar on real weights"))
    steps.append(Step(
        "reprobe_blockcache", module="blockcache_probe",
        argv=["--ckpt", probe_ckpt, "--cfg_cutoff", str(SERVING_CFG_CUTOFF),
              "--specs", ",".join(dict.fromkeys([SERVING_BLOCK_CACHE, "2-20:2", "2-14:2"])),
              "--pick_mse", str(args.pick_mse)] + extra,
        skip_reason=probe_skip, run=check_cache, requires=probe_ckpt,
        note="expect: serving-default spec within the bar on real weights; 'picked' names "
             "the fastest spec inside the --pick_mse budget"))
    steps.append(Step(
        "reprobe_quant", module="quant_probe", argv=["--ckpt", probe_ckpt] + extra,
        skip_reason=probe_skip, run=check_quant, requires=probe_ckpt,
        note="expect: int8-vs-bf16 trajectory divergence well under the bar on real weights"))
    return steps


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    only = {s for s in args.only.split(",") if s}
    skip = {s for s in args.skip.split(",") if s}
    unknown = (only | skip) - set(STEPS)
    if unknown:
        print(f"unknown steps: {sorted(unknown)} (choose from {STEPS})", file=sys.stderr)
        return 2
    Path(args.out).mkdir(parents=True, exist_ok=True)
    steps = build_steps(args)

    if args.dry_run:
        for st in steps:
            if st.argv is not None:
                print(f"# {st.name}: {st.note}")
                print(f"python -m lemas_tts_tpu_torch.scripts.{st.module} {' '.join(st.argv)}")
            else:
                print(f"# {st.name}: {st.note} (in-process TTS smoke)")
        return 0

    failed, summary = [], []
    for st in steps:
        reason = ("deselected" if (only and st.name not in only) or st.name in skip
                  else st.skip_reason)
        if reason is None and st.requires and not Path(st.requires).exists():
            reason = f"missing {st.requires} (producing step failed or was deselected)"
        if reason:
            _emit({"step": st.name, "status": "skip", "reason": reason})
            summary.append((st.name, "skip"))
            continue
        t0, before = time.perf_counter(), _launches()
        try:
            stdout = _call_cli(st.module, st.argv) if st.argv is not None else ""
            extra = {}
            if st.run is not None:
                extra = st.run(stdout) if st.argv is not None else st.run()
            status = "pass"
        except Exception as e:  # noqa: BLE001 - the runbook reports, then chains on
            extra, status = {"error": str(e)}, "FAIL"
            failed.append(st.name)
        made = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
        _emit({"step": st.name, "status": status, "time_s": round(time.perf_counter() - t0, 1),
               **extra, **({"launches": made} if made else {})})
        summary.append((st.name, status))
    print(json.dumps({"summary": dict(summary), "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
