"""Offline batch denoising / separation CLI (counterpart of
``lemas_tts_tpu/scripts/denoise.py``, same flags and behaviour).

Reference: the ``__main__`` batch tool in ``uvr5/multiprocess_cuda_infer.py``
(arg surface ``:436-452``, dir walk + resume ``:364-377``, per-file runner
``:395-400``). One process drives one device; a small host thread pool
pipelines audio decode/encode around the device's work. Output naming
matches the reference runner (``onnx_inference``, ``:303-335``):
``<stem>_vocal.wav`` and, with ``--save_background``,
``<stem>_background.wav``::

    python -m lemas_tts_tpu_torch.scripts.denoise -m Kim_Vocal_1.onnx -a in/ -r out/ -b

It runs on CUDA; ``--device cpu`` runs it on the CPU. It never retries on
another device: without CUDA, and without ``--device cpu``, it fails.
``--data_parallel`` (the JAX package's chunk batches sharded over devices)
is refused: multi-GPU is not ported.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np


def collect_files(audio_path: str, result_path: str) -> List[Tuple[str, str]]:
    """Walk ``audio_path`` for .wav files → (input path, output stem) pairs,
    skipping inputs whose vocal stem already exists in ``result_path``
    (resume semantics of reference ``walkFile``,
    ``multiprocess_cuda_infer.py:364-377``). Output stems mirror the input
    directory structure so same-named files in different subdirs can't
    clobber each other (the reference's flat naming could)."""
    p = Path(audio_path)
    if p.is_file():
        return [(str(p), p.stem)]
    out = []
    for root, _dirs, files in os.walk(str(p)):
        for f in sorted(files):
            if f.lower().endswith(".wav"):
                wav_path = Path(root) / f
                stem = wav_path.relative_to(p).with_suffix("").as_posix()
                if not (Path(result_path) / f"{stem}_vocal.wav").exists():
                    out.append((str(wav_path), stem))
    return out


def build_separator(args: argparse.Namespace):
    """Model factory on ``--device`` (None: CUDA): MDX-Net or the VR-arch
    cascade."""
    if args.data_parallel:
        raise NotImplementedError("--data_parallel (chunk batches sharded over several "
                                  "devices) is not ported: multi-GPU is ROADMAP item A14")
    if args.process_method == "VR Arc":
        from lemas_tts_tpu_torch.uvr5.vr_network import VRSeparator

        if args.model_path:
            return VRSeparator.from_file(args.model_path,
                                         band_params=args.vr_model_param or None,
                                         window_size=args.window_size, device=args.device)
        return VRSeparator(window_size=args.window_size, device=args.device)
    from lemas_tts_tpu_torch.uvr5.inference import UVR5

    # the facade owns the from_file / random-init-with-warning policy
    return UVR5(args.model_path or None, is_denoise=args.is_denoise,
                batch_size=args.batch_size, device=args.device).sep


def process_files(
    sep,
    files: Sequence,
    result_path: str,
    *,
    save_background: bool = False,
    io_workers: int = 2,
    aggressiveness: float = 0.0,
) -> List[str]:
    """Run separation over ``files`` (paths, or (path, output-stem) pairs from
    :func:`collect_files`), pipelining host IO with device compute: decode of
    file i+1 and encode of file i-1 overlap the demix of file i. Returns the
    written vocal-stem paths."""
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav
    from lemas_tts_tpu_torch.uvr5.vr_network import VRSeparator

    items = [(f, Path(f).stem) if isinstance(f, str) else tuple(f) for f in files]
    os.makedirs(result_path, exist_ok=True)
    written: List[str] = []
    total_audio = 0.0
    t_start = time.time()

    with ThreadPoolExecutor(max_workers=max(1, io_workers)) as pool:
        pending_writes: List = []
        max_pending = 2 * max(1, io_workers)
        decode_futs = [pool.submit(read_audio, f) for f, _ in items[:2]]
        for i, (path, stem) in enumerate(items):
            wav, sr = decode_futs[i].result()
            if i + 2 < len(items):
                decode_futs.append(pool.submit(read_audio, items[i + 2][0]))

            vocal_path = os.path.join(result_path, f"{stem}_vocal.wav")
            if isinstance(sep, VRSeparator):
                vocal, bg, out_sr = sep.separate_full(wav, sr, aggressiveness=aggressiveness)
                if not save_background:
                    bg = None
            else:
                vocal, bg, out_sr = sep.separate(wav, sr, save_background=save_background)
            total_audio += vocal.shape[-1] / out_sr
            pending_writes.append(pool.submit(write_wav, vocal_path, np.asarray(vocal), out_sr))
            written.append(vocal_path)
            if save_background and bg is not None:
                bg_path = os.path.join(result_path, f"{stem}_background.wav")
                pending_writes.append(pool.submit(write_wav, bg_path, np.asarray(bg), out_sr))
            # bound the encode backlog so pending waveforms don't pile up in
            # host memory when the device outruns the IO workers
            while len(pending_writes) > max_pending:
                pending_writes.pop(0).result()
        for fut in pending_writes:
            fut.result()

    dt = time.time() - t_start
    if files:
        print(f"[denoise] {len(files)} files, {total_audio:.1f}s audio in "
              f"{dt:.1f}s — overall RTF {total_audio / max(dt, 1e-9):.2f}x")
    return written


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Batch vocal denoising (UVR5 MDX-Net / VR-arch), PyTorch/CUDA.")
    ap.add_argument("-m", "--model_path", type=str, default="",
                    help="MDX .onnx or torch .ckpt weights")
    ap.add_argument("-a", "--audio_path", type=str, required=True,
                    help="input .wav file or directory (recursive)")
    ap.add_argument("-r", "--result_path", type=str, required=True,
                    help="output directory for <stem>_vocal.wav stems")
    ap.add_argument("-p", "--process_method", type=str, default="MDX-Net",
                    choices=["MDX-Net", "VR Arc"])
    ap.add_argument("-b", "--save_background", action="store_true",
                    help="also write <stem>_background.wav")
    ap.add_argument("--vr_model_param", type=str, default="",
                    help="VR-arch band-param config: registry name (e.g. "
                         "4band_v2), JSON path, or empty for single-band")
    ap.add_argument("--window_size", type=int, default=512,
                    help="VR-arch mask-prediction window (frames)")
    ap.add_argument("--no_denoise", dest="is_denoise", action="store_false",
                    help="disable the sign-flip noise-cancelling average")
    ap.add_argument("--batch_size", type=int, default=8,
                    help="demix chunks per device call")
    ap.add_argument("--data_parallel", action="store_true",
                    help="shard chunk batches over all visible devices (not ported: refused)")
    ap.add_argument("--io_workers", type=int, default=2,
                    help="host threads for decode/encode pipelining")
    ap.add_argument("--aggressiveness", type=float, default=0.0,
                    help="VR-arch low-band mask aggressiveness")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda | cpu (default: cuda; never falls back to the CPU).")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    args = build_parser().parse_args(argv)
    files = collect_files(args.audio_path, args.result_path)
    print(f"[denoise] {len(files)} files to process")
    if not files:
        return []
    sep = build_separator(args)
    return process_files(sep, files, args.result_path, save_background=args.save_background,
                         io_workers=args.io_workers, aggressiveness=args.aggressiveness)


if __name__ == "__main__":
    main()
