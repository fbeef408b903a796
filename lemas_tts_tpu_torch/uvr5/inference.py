"""MDX-Net separation / denoising engine (counterpart of
``lemas_tts_tpu/uvr5/inference.py``).

Follows the reference pipeline (``uvr5/multiprocess_cuda_infer.py:181-335``):
4-channel real-STFT packing (symmetric hann, center=True), DC-bin zeroing,
chunk-slide demixing with edge trim and overlap concat, optional denoise
sign-flip averaging, match-mix passthrough and background stem. The network
is :class:`~lemas_tts_tpu_torch.uvr5.mdxnet.ConvTDFNet` on one device; the
STFTs, the network and the resample to 44.1 kHz run there, the chunking and
stitching on the host in numpy.

``device=None`` means CUDA and raises without it; only ``device="cpu"`` runs
on the CPU. The network runs in f32: on CUDA, the caller's
``torch.backends.{cuda.matmul,cudnn}.allow_tf32`` settings apply.
"""

from __future__ import annotations

import time
import warnings
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from lemas_tts_tpu_torch.api import seeded_init, select_device
from lemas_tts_tpu_torch.ops.resample import resample
from lemas_tts_tpu_torch.ops.stft import istft, stft
from lemas_tts_tpu_torch.uvr5.mdxnet import (
    ConvTDFNet,
    MDXConfig,
    infer_config_from_state_dict,
    seeded_init_,
)

MDX_SAMPLE_RATE = 44100


def refuse_mesh(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh / --data_parallel (chunk batches sharded over several devices) is not "
            "ported: multi-GPU is ROADMAP item A14")


def hann_symmetric(n: int, device=None) -> torch.Tensor:
    """torch.hann_window(periodic=False) (``multiprocess_cuda_infer.py:199``),
    computed in f64 and rounded to f32 as the JAX package's."""
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))
    return torch.from_numpy(w.astype(np.float32)).to(device)


def load_state(module: torch.nn.Module, sd: Mapping[str, Any]) -> torch.nn.Module:
    """``module.load_state_dict`` of the entries of ``sd`` (tensors or numpy
    arrays) that ``module`` has: an ``.onnx`` file's initializers also hold
    graph constants. Every parameter and buffer of ``module`` must be there."""
    own = module.state_dict()
    module.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in sd.items() if k in own})
    return module


class MDXSeparator:
    """One MDX model on one device."""

    def __init__(
        self,
        cfg: MDXConfig,
        state: Mapping[str, Any],
        *,
        is_denoise: bool = True,
        compensate: float = 1.035,
        # default: 4 when denoising (the sign-flip pair doubles the network
        # batch), 8 for the plain single-apply separation path
        batch_size: Optional[int] = None,
        adjust: float = 1.0,
        mesh: Optional[Any] = None,
        device: Optional[str] = None,
    ):
        refuse_mesh(mesh)
        self.device = select_device(device)
        self.cfg = cfg
        self.model = load_state(seeded_init(lambda: ConvTDFNet(cfg), 0), state)
        self.model = self.model.to(self.device).eval()
        self.is_denoise = is_denoise
        self.compensate = compensate
        self.adjust = adjust
        self.batch_size = batch_size if batch_size is not None else (4 if is_denoise else 8)
        self.trim = cfg.n_fft // 2
        self.chunk_size = cfg.hop * (cfg.dim_t - 1)
        self.gen_size = self.chunk_size - 2 * self.trim
        self._window = hann_symmetric(cfg.n_fft, self.device)

    # ------------------------------------------------------------ model load
    @classmethod
    def from_file(cls, path: str, **kw) -> "MDXSeparator":
        """Load from .onnx (initializer parse) or torch .ckpt/.pt; a file
        with BatchNorm statistics gives ``norm="affine"``."""
        p = Path(path)
        if p.suffix == ".onnx":
            from lemas_tts_tpu_torch.uvr5.onnx_weights import load_onnx_initializers

            sd = load_onnx_initializers(str(p))
        else:
            from lemas_tts_tpu_torch.weights import load_torch_file

            sd = load_torch_file(str(p))
            sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
        norm = "affine" if "first_conv.1.running_mean" in sd else "group"
        return cls(infer_config_from_state_dict(sd, norm=norm), sd, **kw)

    @classmethod
    def random_init(cls, cfg: Optional[MDXConfig] = None,
                    generator: Optional[torch.Generator] = None, **kw) -> "MDXSeparator":
        """Random weights from ``generator`` (default: seed 0)."""
        cfg = cfg or MDXConfig()
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        model = seeded_init_(seeded_init(lambda: ConvTDFNet(cfg), 0), generator)
        return cls(cfg, model.state_dict(), **kw)

    # ------------------------------------------------------- spectral packing
    def pack_stft(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 2, chunk] stereo → [B, 4, dim_t, dim_f] packed real spec
        (reference ``stft``, ``:206-212``: [L_re, L_im, R_re, R_im])."""
        B, c = x.shape[0], self.cfg
        spec = stft(x.reshape(-1, self.chunk_size), c.n_fft, c.hop, window=self._window,
                    center=True)[..., : c.dim_t]  # [2B, n_bins, T]
        packed = torch.stack([spec.real, spec.imag], dim=1)  # [2B, 2, F, T]
        packed = packed.reshape(B, 4, c.n_bins, c.dim_t)[:, :, : c.dim_f]
        return packed.transpose(-1, -2)

    def unpack_istft(self, s: torch.Tensor) -> torch.Tensor:
        """[B, 4, dim_t, dim_f] → [B, 2, chunk] (reference ``istft``,
        ``:214-222``: zero-pad the cropped top bins, inverse FFT,
        overlap-add)."""
        B, c = s.shape[0], self.cfg
        s = torch.nn.functional.pad(s, (0, c.n_bins - c.dim_f)).transpose(-1, -2)
        s = s.reshape(B * 2, 2, c.n_bins, c.dim_t)
        wav = istft(torch.complex(s[:, 0].contiguous(), s[:, 1].contiguous()), c.n_fft, c.hop,
                    window=self._window)
        return wav.reshape(B, 2, -1)

    # ------------------------------------------------------------- model run
    def spec_to_spec(self, spek: torch.Tensor) -> torch.Tensor:
        """The network on a packed batch; when denoising, the sign-flip
        noise-cancelling average (``:267``) as one forward over 2B rows."""
        with torch.no_grad():
            if self.is_denoise:
                B = spek.shape[0]
                both = self.model(torch.cat([-spek, spek], dim=0))
                return -both[:B] * 0.5 + both[B:] * 0.5
            return self.model(spek)

    def run_model(self, mix, is_match_mix: bool = False) -> np.ndarray:
        """[B, 2, chunk] → [2, B*gen] (reference ``run_model``, ``:259-271``)."""
        mix = torch.as_tensor(np.asarray(mix, np.float32)).to(self.device)
        spek = self.pack_stft(mix) * self.adjust
        spek[..., :3] = 0.0  # zero the 3 lowest-frequency bins (:262)
        spec_pred = spek if is_match_mix else self.spec_to_spec(spek)
        wav = self.unpack_istft(spec_pred)[:, :, self.trim: -self.trim]
        return wav.transpose(0, 1).reshape(2, -1).cpu().numpy()

    # ---------------------------------------------------------------- demix
    def initialize_mix(self, mix: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pad + slide into chunk windows (reference ``initialize_mix``,
        ``:241-256``). mix: [2, T] → ([n, 2, chunk_size], pad)."""
        n_sample = mix.shape[1]
        pad = self.gen_size - n_sample % self.gen_size
        mix_p = np.concatenate(
            [np.zeros((2, self.trim), np.float32), mix.astype(np.float32),
             np.zeros((2, pad), np.float32), np.zeros((2, self.trim), np.float32)], axis=1)
        waves = []
        i = 0
        while i < n_sample + pad:
            waves.append(mix_p[:, i: i + self.chunk_size])
            i += self.gen_size
        return np.stack(waves, axis=0), pad

    def demix(self, mix: Dict[int, np.ndarray], is_match_mix: bool = False,
              margin: int = 0) -> np.ndarray:
        """Chunked separation (reference ``demix_base``, ``:274-301``).
        mix: {slice_index: [2, T]} → [2, T_total]. A ragged last batch is
        padded with zero chunks to the batch size, as in the JAX package."""
        out = None
        keys = list(mix.keys())
        for sl in keys:
            mix_waves, pad = self.initialize_mix(mix[sl])
            parts = []
            for i in range(0, mix_waves.shape[0], self.batch_size):
                chunk = mix_waves[i: i + self.batch_size]
                n_real = chunk.shape[0]
                if n_real < self.batch_size:
                    chunk = np.concatenate(
                        [chunk, np.zeros((self.batch_size - n_real, 2, self.chunk_size),
                                         np.float32)])
                out_b = self.run_model(chunk, is_match_mix=is_match_mix)
                parts.append(out_b[:, : n_real * self.gen_size])
            tar = np.concatenate(parts, axis=-1)[:, :-pad]
            start = 0 if sl == 0 else margin
            end = None if sl == keys[-1] or margin == 0 else -margin
            seg = tar[:, start:end] * (1.0 / self.adjust)
            out = seg if out is None else np.concatenate([out, seg], axis=-1)
        return out

    # ------------------------------------------------------------- top level
    def separate(
        self, audio: np.ndarray, sr: int, save_background: bool = False
    ) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
        """Full-file separation (reference ``onnx_inference``, ``:303-335``):
        mono→stereo, resample to 44.1 kHz, demix; optional background stem via
        match-mix minus compensated vocal. Returns (vocal [2,T], bg|None, sr)."""
        x = np.asarray(audio, dtype=np.float32)
        if x.ndim == 1:
            x = np.stack([x, x])
        elif x.shape[0] == 1:
            x = np.concatenate([x, x], axis=0)
        if sr != MDX_SAMPLE_RATE:
            x = resample(torch.from_numpy(x).to(self.device), sr, MDX_SAMPLE_RATE).cpu().numpy()
        t0 = time.time()
        vocal = self.demix({0: x})
        bg = None
        if save_background:
            raw = self.demix({0: x}, is_match_mix=True)
            n = min(vocal.shape[-1], raw.shape[-1])
            bg = raw[:, :n] - vocal[:, :n] * self.compensate
        dt = time.time() - t0
        dur = vocal.shape[-1] / MDX_SAMPLE_RATE
        print(f"[uvr5] denoised {dur:.2f}s in {dt:.2f}s (RTF {dur / max(dt, 1e-9):.2f}x)")
        return vocal, bg, MDX_SAMPLE_RATE


class UVR5:
    """Denoising facade used by the CLIs (reference wrapper classes
    ``tts_multilingual.py:38-86`` / ``inference_gradio.py:49-90``). Without
    a weights file it warns and builds random weights, as the JAX facade
    does; the CLIs refuse to denoise without one."""

    def __init__(self, model_path: Optional[str] = None,
                 is_denoise: bool = True, batch_size: int = 8,
                 separator: Optional[MDXSeparator] = None,
                 mesh: Optional[Any] = None, device: Optional[str] = None):
        refuse_mesh(mesh)
        if separator is not None:
            self.sep = separator
        elif model_path and Path(model_path).is_file():
            self.sep = MDXSeparator.from_file(model_path, is_denoise=is_denoise,
                                              batch_size=batch_size, device=device)
        else:
            select_device(device)  # fail before the warning and the build
            warnings.warn(f"no UVR5 weights at {model_path!r} — random init (testing only)")
            self.sep = MDXSeparator.random_init(is_denoise=is_denoise, batch_size=batch_size,
                                                device=device)

    def denoise(self, audio: np.ndarray, sr: int) -> Tuple[np.ndarray, int]:
        """Array in → mono denoised array @44.1 kHz out."""
        vocal, _, out_sr = self.sep.separate(audio, sr)
        return vocal.mean(axis=0), out_sr

    def denoise_file(self, path: str, out_path: Optional[str] = None) -> str:
        from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

        wav, sr = read_audio(path)
        den, out_sr = self.denoise(wav, sr)
        if out_path is None:
            p = Path(path)
            out_path = str(p.with_name(p.stem + "_vocal.wav"))
        write_wav(out_path, den, out_sr)
        return out_path
