"""Gradio web UI for zero-shot TTS and speech denoising (counterpart of
``lemas_tts_tpu/scripts/inference_gradio.py``, its flags):

    python -m lemas_tts_tpu_torch.scripts.inference_gradio --ckpt_file model.pt \\
        --vocab_file vocab.txt [--uvr5_model Kim_Vocal_1.onnx] [--port 7860]

Reference audio and text in, generation settings (NFE 64, CFG 5, sway 3,
ref_ratio by default), a UVR5 denoise button, the seed used, and a system
stats panel. The model is built once per (model, checkpoint, vocab,
prosody, device) and cached (``get_tts``); ``fast_mode`` is JAX's preset, CFG
truncation at 1.0 and the serving block cache ``SERVING_BLOCK_CACHE``.

The handlers are module-level functions built by ``make_handlers(args,
error)``, so they run without ``gradio`` (``error`` is the exception a
handler raises at a user: ``gradio.Error`` in the app). ``build_app`` wires
them into ``gradio`` when it is installed; without it ``main`` prints the
JAX message and returns 2. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

_model_cache: Dict[tuple, object] = {}
_cache_lock = threading.Lock()


def get_tts(model: str, ckpt_file: str, vocab_file: str, use_prosody_encoder: bool = False,
            device: Optional[str] = None):
    """The ``TTS`` of one configuration, built once and then reused."""
    from lemas_tts_tpu_torch.api import TTS

    key = (model, ckpt_file, vocab_file, use_prosody_encoder, device)
    with _cache_lock:
        tts = _model_cache.get(key)
        if tts is None:
            # a checkpoint named for prosody turns the encoder on (reference :237)
            if "prosody" in os.path.basename(ckpt_file):
                use_prosody_encoder = True
            tts = TTS(model=model, ckpt_file=ckpt_file, vocab_file=vocab_file,
                      use_prosody_encoder=use_prosody_encoder, device=device)
            _model_cache[key] = tts
        return tts


def list_checkpoints(root: Optional[str] = None) -> Dict[str, list]:
    """Checkpoints per project directory under ``pretrained_models/ckpts``:
    ``.safetensors``, ``.pt``, ``.bin`` files and orbax directories."""
    from lemas_tts_tpu_torch.api import find_pretrained_root

    base = Path(root) if root else find_pretrained_root() / "ckpts"
    out: Dict[str, list] = {}
    if not base.is_dir():
        return out
    for proj in sorted(p for p in base.iterdir() if p.is_dir()):
        ckpts = sorted(str(f) for f in proj.iterdir()
                       if f.suffix in (".safetensors", ".pt", ".bin")
                       or (f.is_dir() and (f / "_METADATA").exists()))
        if ckpts:
            out[proj.name] = ckpts
    return out


def system_stats() -> str:
    """The host's and the cards' state, for the stats panel."""
    import torch

    lines = [f"torch {torch.__version__}, CUDA devices: {torch.cuda.device_count()}"]
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        lines.append(f"  {torch.cuda.get_device_name(i)}: {(total - free) / 2**30:.2f} / "
                     f"{total / 2**30:.2f} GiB in use, {torch.cuda.memory_allocated(i) / 2**30:.2f}"
                     " GiB allocated here")
    try:
        load1, load5, _ = os.getloadavg()
        lines.append(f"cpu load: {load1:.2f} (1m) {load5:.2f} (5m)")
    except OSError:
        pass
    from lemas_tts_tpu_torch.utils.profiling import TIMERS

    for name, s in sorted(TIMERS.snapshot().items()):
        lines.append(f"{name:<28} n={int(s['count']):>5}  mean={s['mean_s'] * 1000:8.2f}ms  "
                     f"max={s['max_s'] * 1000:8.2f}ms")
    return "\n".join(lines)


def _to_float_audio(wav: np.ndarray) -> np.ndarray:
    """Gradio numpy audio -> float32 in [-1, 1]; an integer dtype scales by
    its own full scale (int16 and int32 uploads differ by 65536x)."""
    wav = np.asarray(wav)
    if wav.dtype.kind == "i":
        wav = wav.astype(np.float32) / float(np.iinfo(wav.dtype).max + 1)
    return wav.astype(np.float32)


def make_handlers(args, error: Callable[[str], Exception] = RuntimeError
                  ) -> Tuple[Callable, Callable]:
    """``(infer_fn, denoise_fn)`` for the parsed ``args`` (``model``,
    ``ckpt_file``, ``vocab_file``, ``uvr5_model``, ``device``); a handler
    raises ``error(message)`` for a request it refuses."""
    from lemas_tts_tpu_torch.config import SERVING_BLOCK_CACHE

    uvr_holder: dict = {}

    def denoise_fn(audio: Optional[Tuple[int, np.ndarray]]):
        """(sr, wave) from the UI -> (44.1 kHz, int16 vocals)."""
        if audio is None:
            return None
        from lemas_tts_tpu_torch.uvr5 import UVR5

        if not (args.uvr5_model and Path(args.uvr5_model).is_file()):
            raise error("denoising requires --uvr5_model MDX weights; refusing to run a "
                        "randomly initialized separator on your audio")
        if "uvr" not in uvr_holder:
            uvr_holder["uvr"] = UVR5(model_path=args.uvr5_model, device=args.device)
        sr, wav = audio
        wav = _to_float_audio(wav)
        if wav.ndim == 2:
            wav = wav.T  # gradio gives [T, ch]
        den, out_sr = uvr_holder["uvr"].denoise(wav, sr)
        # clip before the int16 cast: separation output is not peak-normalized
        return out_sr, (np.clip(den, -1.0, 1.0) * 32767).astype(np.int16)

    def infer_fn(ref_audio, ref_text, gen_text, nfe_step, cfg_strength, sway, ref_ratio, speed,
                 separate_langs, remove_silence, fast_mode, seed_text):
        """One request from the UI -> ((sr, int16 wave), the seed used)."""
        if ref_audio is None or not gen_text:
            raise error("reference audio and generation text are required")
        sr, wav = ref_audio
        wav = _to_float_audio(wav)
        if wav.ndim == 2:
            wav = wav.T.mean(axis=0)
        tts = get_tts(args.model, args.ckpt_file, args.vocab_file, device=args.device)
        seed = int(seed_text) if str(seed_text).strip() else None
        from lemas_tts_tpu_torch.utils.audio_io import write_wav

        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
            write_wav(f.name, wav.astype(np.float32), sr)
            ref_path = f.name
        try:
            wave, out_sr, _ = tts.infer(
                ref_path, ref_text or "", gen_text, nfe_step=int(nfe_step),
                cfg_strength=float(cfg_strength), sway_sampling_coef=float(sway),
                use_acc_grl=ref_ratio < 1,  # the GRL shuffle path gates ref_ratio
                ref_ratio=float(ref_ratio) if ref_ratio < 1 else None, speed=float(speed),
                separate_langs=bool(separate_langs),
                # JAX's measured preset: CFG truncation at 1.0 and the block cache
                cfg_cutoff=1.0 if fast_mode else None,
                block_cache=SERVING_BLOCK_CACHE if fast_mode else None,
                seed=seed, show_info=lambda *a, **k: None)
        finally:
            os.unlink(ref_path)  # one temporary WAV a request would fill the disk
        if remove_silence:
            from lemas_tts_tpu_torch.infer.audio_prep import remove_long_silence

            wave = remove_long_silence(np.asarray(wave), out_sr)
        return ((out_sr, (np.clip(np.asarray(wave), -1.0, 1.0) * 32767).astype(np.int16)),
                str(tts.seed))

    return infer_fn, denoise_fn


def build_app(args):
    import gradio as gr

    infer_fn, denoise_fn = make_handlers(args, gr.Error)
    with gr.Blocks(title="lemas-tts-tpu-torch") as app:
        gr.Markdown("# lemas-tts-tpu-torch: zero-shot multilingual TTS (CUDA)")
        with gr.Row():
            with gr.Column():
                ref_audio = gr.Audio(label="Reference audio", type="numpy")
                ref_text = gr.Textbox(label="Reference text ('' -> ASR)")
                gen_text = gr.Textbox(label="Text to generate", lines=4)
                with gr.Accordion("Denoise reference (UVR5)", open=False):
                    den_btn = gr.Button("Denoise")
                with gr.Accordion("Advanced", open=True):
                    nfe = gr.Slider(4, 128, value=64, step=2, label="NFE steps")
                    cfgs = gr.Slider(0.0, 10.0, value=5.0, step=0.5, label="CFG strength")
                    sway = gr.Slider(-1.0, 5.0, value=3.0, step=0.5, label="Sway coef")
                    ref_ratio = gr.Slider(0.0, 1.0, value=1.0, step=0.05, label="Ref ratio (GRL)")
                    speed = gr.Slider(0.3, 2.0, value=1.0, step=0.1, label="Speed")
                    separate = gr.Checkbox(value=True, label="Separate langs")
                    fast = gr.Checkbox(value=False,
                                       label="Fast mode (CFG truncation + block cache)")
                    rm_sil = gr.Checkbox(value=False, label="Remove silences")
                    seed_in = gr.Textbox(label="Seed (blank -> random)")
                go = gr.Button("Generate Audio", variant="primary")
            with gr.Column():
                out_audio = gr.Audio(label="Generated audio")
                seed_out = gr.Textbox(label="Seed used")
                stats = gr.Textbox(label="System stats", lines=8)
                stats_btn = gr.Button("Refresh stats")
        den_btn.click(denoise_fn, inputs=[ref_audio], outputs=[ref_audio])
        go.click(infer_fn, inputs=[ref_audio, ref_text, gen_text, nfe, cfgs, sway, ref_ratio,
                                   speed, separate, rm_sil, fast, seed_in],
                 outputs=[out_audio, seed_out])
        stats_btn.click(lambda: system_stats(), outputs=[stats])
    return app


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lemas-tts-tpu-torch Gradio server")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--share", action="store_true")
    p.add_argument("--api", action="store_true", help="Enable the gradio API.")
    p.add_argument("--model", type=str, default="multilingual")
    p.add_argument("--ckpt_file", type=str, default="")
    p.add_argument("--vocab_file", type=str, default="")
    p.add_argument("--uvr5_model", type=str, default="")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; never falls back to another device.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        import gradio  # noqa: F401
    except ImportError:
        print("gradio is not installed — `pip install gradio` to serve the UI", file=sys.stderr)
        return 2
    app = build_app(args)
    app.queue().launch(server_name=args.host, server_port=args.port, share=args.share,
                       show_api=args.api)
    return 0


if __name__ == "__main__":
    sys.exit(main())
