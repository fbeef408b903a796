"""Objective evaluation metrics for TTS output (counterpart of
``lemas_tts_tpu/eval/metrics.py``):

 - mel-domain: masked MSE/MAE and MCD (mel-cepstral distortion, with
   optional DTW alignment for outputs of different lengths);
 - waveform-domain: spectral convergence and log-STFT magnitude MAE;
 - speaker: cosine similarity of ``models/speaker.py`` embeddings;
 - text: WER/CER against a transcript.

Mel, MCD and STFT math run as torch ops on the inputs' device; DTW and the
edit distances run on the host (numpy / Python), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from lemas_tts_tpu_torch.ops.stft import stft_magnitude


def _f32(x) -> torch.Tensor:
    return x.float() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, np.float32))


# --------------------------------------------------------------------- mel


def _length_mask(x: torch.Tensor, lengths) -> torch.Tensor:
    B, T = x.shape[:2]
    if lengths is None:
        return torch.ones((B, T), dtype=torch.bool, device=x.device)
    lengths = torch.as_tensor(lengths, device=x.device)
    return torch.arange(T, device=x.device)[None, :] < lengths[:, None]


def mel_mse(a, b, lengths=None) -> torch.Tensor:
    """Masked mean-squared error between two [B, T, D] mels."""
    a, b = _f32(a), _f32(b)
    m = _length_mask(a, lengths)[..., None]
    return torch.sum(torch.square(a - b) * m) / torch.clamp(m.sum() * a.shape[-1], min=1.0)


def mel_mae(a, b, lengths=None) -> torch.Tensor:
    """Masked mean absolute error between two [B, T, D] mels."""
    a, b = _f32(a), _f32(b)
    m = _length_mask(a, lengths)[..., None]
    return torch.sum(torch.abs(a - b) * m) / torch.clamp(m.sum() * a.shape[-1], min=1.0)


def spectral_distance(wav_a, wav_b, n_fft: int = 1024, hop_length: int = 256):
    """Waveform-domain divergence between [B, T] (or [T]) waveform batches:
    ``(spectral_convergence, log_stft_mae)`` — ‖|A|−|B|‖_F / ‖|B|‖_F and the
    mean |log(|A| + 1e-5) − log(|B| + 1e-5)|."""
    a, b = torch.atleast_2d(_f32(wav_a)), torch.atleast_2d(_f32(wav_b))
    t = min(a.shape[-1], b.shape[-1])
    ma = stft_magnitude(a[:, :t], n_fft, hop_length)
    mb = stft_magnitude(b[:, :t], n_fft, hop_length)
    sc = torch.linalg.norm(ma - mb) / torch.clamp(torch.linalg.norm(mb), min=1e-9)
    log_mae = torch.mean(torch.abs(torch.log(ma + 1e-5) - torch.log(mb + 1e-5)))
    return sc, log_mae


def _dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II basis [n_out, n_in] (cepstra from log-mel)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= np.sqrt(0.5)
    return basis.astype(np.float32)


def mel_cepstra(log_mel, n_coeffs: int = 13) -> torch.Tensor:
    """[..., T, D] log-mel -> [..., T, n_coeffs] mel-cepstra (DCT-II)."""
    log_mel = _f32(log_mel)
    basis = torch.as_tensor(_dct_matrix(n_coeffs, log_mel.shape[-1]), device=log_mel.device)
    return log_mel @ basis.t()


_MCD_CONST = 10.0 / math.log(10.0) * math.sqrt(2.0)


def mcd(a, b, n_coeffs: int = 13, use_dtw: bool = False) -> float:
    """Mel-cepstral distortion in dB between two [T, D] log-mels, without
    coefficient 0 (energy). ``use_dtw`` DTW-aligns the frames first;
    otherwise the common prefix is compared frame by frame."""
    ca = mel_cepstra(a, n_coeffs)[:, 1:].cpu().numpy()
    cb = mel_cepstra(b, n_coeffs)[:, 1:].cpu().numpy()
    if use_dtw:
        pairs = _dtw_path(ca, cb)
        diff = ca[[i for i, _ in pairs]] - cb[[j for _, j in pairs]]
    else:
        t = min(len(ca), len(cb))
        diff = ca[:t] - cb[:t]
    per_frame = np.sqrt(np.sum(diff * diff, axis=-1))
    return float(_MCD_CONST * np.mean(per_frame))


def _dtw_path(a: np.ndarray, b: np.ndarray) -> list[tuple[int, int]]:
    """Classic O(T²) DTW on Euclidean frame distance; returns the warp path."""
    ta, tb = len(a), len(b)
    dist = np.sqrt(np.maximum(
        np.sum(a * a, -1)[:, None] - 2 * a @ b.T + np.sum(b * b, -1)[None, :], 0.0))
    acc = np.full((ta + 1, tb + 1), np.inf, np.float64)
    acc[0, 0] = 0.0
    for i in range(1, ta + 1):
        row_prev = acc[i - 1]
        row = acc[i]
        for j in range(1, tb + 1):
            row[j] = dist[i - 1, j - 1] + min(row_prev[j], row[j - 1], row_prev[j - 1])
    path = []
    i, j = ta, tb
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        moves = ((acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1))
        _, i, j = min(moves)
    path.reverse()
    return path


# ------------------------------------------------------------------ speaker


@torch.no_grad()
def speaker_similarity(encoder, mel_a, mel_b) -> float:
    """Cosine similarity of the speaker embeddings of two [T, D] (or
    [B, T, D]) mels through a ``models.speaker.SpeakerEncoder`` (eval mode,
    on the encoder's device). 1.0 = same voice."""
    device = next(encoder.parameters()).device

    def embed(m):
        m = _f32(m).to(device)
        if m.dim() == 2:
            m = m[None]
        e = encoder(m).reshape(m.shape[0], -1)
        return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-8)

    ea, eb = embed(mel_a), embed(mel_b)
    return float(torch.mean(torch.sum(ea * eb, dim=-1)))


# --------------------------------------------------------------------- text


def _edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (substitution/insertion/deletion cost 1)."""
    n, m = len(ref), len(hyp)
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def wer(ref_text: str, hyp_text: str) -> float:
    """Word error rate (whitespace tokens, case-folded)."""
    ref = ref_text.lower().split()
    hyp = hyp_text.lower().split()
    if not ref:
        return 0.0 if not hyp else float(len(hyp))
    return _edit_distance(ref, hyp) / len(ref)


def cer(ref_text: str, hyp_text: str) -> float:
    """Character error rate (whitespace collapsed, case-folded)."""
    ref = " ".join(ref_text.lower().split())
    hyp = " ".join(hyp_text.lower().split())
    if not ref:
        return 0.0 if not hyp else float(len(hyp))
    return _edit_distance(ref, hyp) / len(ref)
