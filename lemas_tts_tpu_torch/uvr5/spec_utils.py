"""Spectrogram utilities for the UVR5 separation family (counterpart of
``lemas_tts_tpu/uvr5/spec_utils.py``).

Numpy equivalents of the reference toolkit (``uvr5/lib_v5/spec_utils.py``):
stereo/mid-side STFT packing, multi-band spectrogram combination (VR band
params), high-frequency mirroring reconstruction, stem ensembling, and the
per-channel aggressiveness mask shaping. The STFTs and resamples run on
``device`` through the port's ``ops/stft.py`` and ``ops/resample.py``
(``None`` means CUDA and raises without it); the mask arithmetic stays in
numpy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from lemas_tts_tpu_torch.api import select_device
from lemas_tts_tpu_torch.ops.resample import resample as _resample
from lemas_tts_tpu_torch.ops.stft import hann_window, istft as _istft, stft as _stft

MIN_SPEC = "min_mag"
MAX_SPEC = "max_mag"
AVERAGE = "average"


def resample_on(wave: np.ndarray, orig_sr: int, new_sr: int, device=None) -> np.ndarray:
    """``ops/resample.py:resample`` of a host array on ``device``."""
    dev = select_device(device)
    return _resample(torch.from_numpy(np.asarray(wave, np.float32)).to(dev), orig_sr,
                     new_sr).cpu().numpy()


def stft_stereo(wave: np.ndarray, n_fft: int, hop_length: int, device=None) -> np.ndarray:
    """[2, T] → complex [2, bins, frames] (reference ``stft``, ``:420-428``)."""
    dev = select_device(device)
    x = torch.from_numpy(np.asarray(wave, np.float32)).to(dev)
    return _stft(x, n_fft, hop_length, window=hann_window(n_fft, dev)).cpu().numpy()


def istft_stereo(spec: np.ndarray, n_fft: int, hop_length: int,
                 length: Optional[int] = None, device=None) -> np.ndarray:
    """complex [2, bins, frames] → [2, T] (reference ``istft``, ``:430-437``)."""
    dev = select_device(device)
    s = torch.from_numpy(np.asarray(spec, np.complex64)).to(dev)
    return _istft(s, n_fft, hop_length, window=hann_window(n_fft, dev),
                  length=length).cpu().numpy()


def wave_to_spectrogram(
    wave: np.ndarray, hop_length: int, n_fft: int,
    mid_side: bool = False, mid_side_b2: bool = False, reverse: bool = False,
    device=None,
) -> np.ndarray:
    """Stereo wave → spectrogram with optional mid/side encodings
    (reference ``wave_to_spectrogram``, ``:60-78``)."""
    wave = np.asarray(wave, np.float32)
    if reverse:
        wave = np.stack([np.flip(wave[0]), np.flip(wave[1])])
    elif mid_side:
        wave = np.stack([(wave[0] + wave[1]) / 2, wave[0] - wave[1]])
    elif mid_side_b2:
        wave = np.stack([wave[1] * 0.5 + wave[0] * 0.5 * 0.5,
                         wave[0] * 0.5 - wave[1] * 0.5 * 0.5])
    return stft_stereo(wave, n_fft, hop_length, device=device)


def spectrogram_to_wave(
    spec: np.ndarray, hop_length: int,
    mid_side: bool = False, mid_side_b2: bool = False, reverse: bool = False,
    n_fft: Optional[int] = None, device=None,
) -> np.ndarray:
    """Inverse of :func:`wave_to_spectrogram` (reference ``:267-281``)."""
    n_fft = n_fft if n_fft is not None else (spec.shape[1] - 1) * 2
    wave = istft_stereo(spec, n_fft, hop_length, device=device)
    if reverse:
        return np.stack([np.flip(wave[0]), np.flip(wave[1])])
    if mid_side:
        return np.stack([wave[0] + wave[1] / 2, wave[0] - wave[1] / 2])
    if mid_side_b2:  # note: reference round-trips b2 at 0.5× by design
        return np.stack([wave[1] / 1.25 + 0.4 * wave[0],
                         wave[0] / 1.25 - 0.4 * wave[1]])
    return wave


def combine_spectrograms(specs: Dict[int, np.ndarray],
                         bands: Sequence[dict], total_bins: int) -> np.ndarray:
    """Stack per-band spectrogram crops into one full-band spectrogram
    (reference ``combine_spectrograms``, ``:154-178``). ``bands[d]`` has
    ``crop_start``/``crop_stop``; band d+1 is keyed ``d+1`` in ``specs``."""
    # bands resampled to different rates can differ by a frame or two —
    # trim to the shortest, like the reference's `l = min(...)` (:157)
    frames = min(s.shape[2] for s in specs.values())
    out = np.zeros((2, total_bins + 1, frames), np.complex64)
    offset = 0
    for d, band in enumerate(bands, start=1):
        h = band["crop_stop"] - band["crop_start"]
        out[:, offset: offset + h] = specs[d][:, band["crop_start"]:band["crop_stop"], :frames]
        offset += h
    if offset > total_bins:
        raise ValueError("too many crops")
    return out


def make_padding(width: int, cropsize: int, offset: int):
    """Window padding for chunked VR inference (reference ``make_padding``,
    ``spec_utils.py:51-58``): returns (left, right, roi_size)."""
    left = offset
    roi_size = cropsize - offset * 2
    if roi_size == 0:
        roi_size = cropsize
    right = roi_size - (width % roi_size) + left
    return left, right, roi_size


def fft_lp_filter(spec: np.ndarray, bin_start: int, bin_stop: int) -> np.ndarray:
    """Linear-ramp low-pass between the crossover bins, zero above
    (reference ``fft_lp_filter``, ``spec_utils.py:347-355``; vectorized)."""
    spec = np.array(spec, copy=True)
    n = bin_stop - bin_start
    if n > 0:
        g = 1.0 - (np.arange(1, n + 1, dtype=np.float64) / n)
        spec[:, bin_start:bin_stop, :] *= g[None, :, None]
    spec[:, bin_stop:, :] = 0
    return spec


def fft_hp_filter(spec: np.ndarray, bin_start: int, bin_stop: int) -> np.ndarray:
    """Linear-ramp high-pass from ``bin_start`` down to ``bin_stop``, zero at
    and below ``bin_stop`` (reference ``fft_hp_filter``,
    ``spec_utils.py:357-365``; vectorized over the descending loop)."""
    spec = np.array(spec, copy=True)
    n = bin_start - bin_stop
    if n > 0:
        g = 1.0 - (np.arange(1, n + 1, dtype=np.float64) / n)
        # reference iterates b = bin_start, bin_start-1, …, bin_stop+1
        spec[:, bin_stop + 1: bin_start + 1, :] *= g[::-1][None, :, None]
    spec[:, : bin_stop + 1, :] = 0
    return spec


def combine_spectrograms_mp(specs: Dict[int, np.ndarray], mp: dict) -> np.ndarray:
    """Band-param-dict version of :func:`combine_spectrograms` including the
    global pre-filter (reference ``combine_spectrograms``,
    ``spec_utils.py:154-178``): single-band configs get a ramp low-pass at
    the pre-filter window; multi-band configs get the -3.5 dB/bin gain taper."""
    bands = [mp["band"][d] for d in sorted(mp["band"])]
    spec_c = combine_spectrograms(specs, bands, mp["bins"])
    pfs, pfe = mp["pre_filter_start"], mp["pre_filter_stop"]
    if pfs > 0:
        if len(bands) == 1:
            spec_c = fft_lp_filter(spec_c, pfs, pfe)
        else:
            gp = 1.0
            for b in range(pfs + 1, pfe):
                g = math.pow(10, -(b - pfs) * (3.5 - gp) / 20.0)
                gp = g
                spec_c[:, b, :] *= g
    return spec_c


def cmb_spectrogram_to_wave(
    spec_m: np.ndarray,
    mp: dict,
    extra_bins_h: Optional[int] = None,
    extra_bins: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """Full-band combined spectrogram → waveform at the config sample rate
    (reference ``cmb_spectrogram_to_wave``, ``spec_utils.py:307-345``): each
    band's bin window is scattered back into its own n_fft frame grid,
    cross-over lp/hp ramps applied, iSTFT'd at the band rate, and the partial
    waves are resampled up band-by-band and summed. ``extra_bins`` optionally
    re-injects the preserved high end (the ``--high_end_process`` path)."""
    band_ids = sorted(mp["band"])
    bands_n = len(band_ids)
    kw = dict(mid_side=mp.get("mid_side", False), mid_side_b2=mp.get("mid_side_b2", False),
              reverse=mp.get("reverse", False), device=device)
    offset = 0
    wave = None
    for d in band_ids:
        bp = mp["band"][d]
        spec_s = np.zeros((2, bp["n_fft"] // 2 + 1, spec_m.shape[2]), np.complex64)
        h = bp["crop_stop"] - bp["crop_start"]
        spec_s[:, bp["crop_start"]:bp["crop_stop"], :] = spec_m[:, offset: offset + h, :]
        offset += h
        if d == bands_n:  # top band: native rate, optional high-end restore
            if extra_bins_h:
                max_bin = bp["n_fft"] // 2
                spec_s[:, max_bin - extra_bins_h: max_bin, :] = extra_bins[:, :extra_bins_h, :]
            if bp.get("hpf_start", 0) > 0:
                spec_s = fft_hp_filter(spec_s, bp["hpf_start"], bp["hpf_stop"] - 1)
            band_wave = spectrogram_to_wave(spec_s, bp["hl"], n_fft=bp["n_fft"], **kw)
            if bands_n == 1:
                wave = band_wave
            else:  # resample ratios can drift length by a few samples
                n = min(wave.shape[-1], band_wave.shape[-1])
                wave = wave[:, :n] + band_wave[:, :n]
        else:
            sr_next = mp["band"][d + 1]["sr"]
            if d == 1:  # bottom band: lp only, then upsample
                spec_s = fft_lp_filter(spec_s, bp["lpf_start"], bp["lpf_stop"])
                band_wave = spectrogram_to_wave(spec_s, bp["hl"], n_fft=bp["n_fft"], **kw)
                wave = resample_on(band_wave, bp["sr"], sr_next, device)
            else:  # mid bands: hp + lp, add, upsample
                spec_s = fft_hp_filter(spec_s, bp["hpf_start"], bp["hpf_stop"] - 1)
                spec_s = fft_lp_filter(spec_s, bp["lpf_start"], bp["lpf_stop"])
                band_wave = spectrogram_to_wave(spec_s, bp["hl"], n_fft=bp["n_fft"], **kw)
                n = min(wave.shape[-1], band_wave.shape[-1])
                wave = resample_on(wave[:, :n] + band_wave[:, :n], bp["sr"], sr_next, device)
    return wave


def mirroring_mp(algorithm: str, spec_m: np.ndarray,
                 input_high_end: np.ndarray, mp: dict) -> np.ndarray:
    """Band-param-dict wrapper over :func:`mirroring`."""
    return mirroring(algorithm, spec_m, input_high_end, mp["pre_filter_start"])


def mirroring(algorithm: str, spec_m: np.ndarray, input_high_end: np.ndarray,
              pre_filter_start: int) -> np.ndarray:
    """High-frequency reconstruction by mirroring the band below the filter
    cutoff (reference ``mirroring``, ``:367-378``)."""
    hi = input_high_end.shape[1]
    mirror = np.flip(
        np.abs(spec_m[:, pre_filter_start - 10 - hi: pre_filter_start - 10, :]), 1)
    if algorithm == "mirroring":
        mirror = mirror * np.exp(1.0j * np.angle(input_high_end))
        return np.where(np.abs(input_high_end) <= np.abs(mirror), input_high_end, mirror)
    if algorithm == "mirroring2":
        mi = np.multiply(mirror, input_high_end * 1.7)
        return np.where(np.abs(input_high_end) <= np.abs(mi), input_high_end, mi)
    raise ValueError(algorithm)


def ensembling(algorithm: str, specs: List[np.ndarray]) -> np.ndarray:
    """Combine stems per time-frequency cell by magnitude
    (reference ``ensembling``, ``:481-497``)."""
    spec = specs[0]
    for other in specs[1:]:
        ln = min(spec.shape[2], other.shape[2])
        spec, other = spec[:, :, :ln], other[:, :, :ln]
        if algorithm == MIN_SPEC:
            spec = np.where(np.abs(other) <= np.abs(spec), other, spec)
        elif algorithm == MAX_SPEC:
            spec = np.where(np.abs(other) >= np.abs(spec), other, spec)
        elif algorithm == AVERAGE:
            spec = (spec + other) / 2
        else:
            raise ValueError(algorithm)
    return spec


def adjust_aggr(mask: np.ndarray, is_non_accom_stem: bool,
                aggressiveness: dict) -> np.ndarray:
    """Raise the mask power per channel, more below ``split_bin``
    (reference ``adjust_aggr``, ``:380-401``)."""
    aggr = aggressiveness["value"]
    if aggr == 0:
        return mask
    if is_non_accom_stem:
        aggr = 1 - aggr
    aggr_lr = [aggr, aggr]
    corr = aggressiveness.get("aggr_correction")
    if corr is not None:
        aggr_lr[0] += corr["left"]
        aggr_lr[1] += corr["right"]
    split = aggressiveness["split_bin"]
    mask = np.array(mask, copy=True)
    for ch in range(2):
        mask[ch, :split] = np.power(mask[ch, :split], 1 + aggr_lr[ch] / 3)
        mask[ch, split:] = np.power(mask[ch, split:], 1 + aggr_lr[ch])
    return mask


def merge_artifacts(y_mask: np.ndarray, thres: float = 0.01,
                    min_range: int = 64, fade_size: int = 32) -> np.ndarray:
    """Raise the mask toward 1 over long fully-active frame ranges, with
    linear fade ramps at the range edges (reference ``merge_artifacts``,
    ``:216-264``: ``y_mask += weight * (1 - y_mask)``)."""
    if min_range < fade_size * 2:
        raise ValueError("min_range must be >= fade_size * 2")
    mask = np.array(y_mask, copy=True)
    active = np.where(y_mask.min(axis=(0, 1)) > thres)[0]
    if len(active) == 0:
        return mask
    breaks = np.where(np.diff(active) != 1)[0]
    starts = np.insert(active[breaks + 1], 0, active[0])
    ends = np.append(active[breaks], active[-1])
    long_enough = np.where(ends - starts > min_range)[0]
    weight = np.zeros_like(mask)
    if len(long_enough) > 0:
        old_e = None
        for s, e in zip(starts[long_enough], ends[long_enough]):
            s, e = int(s), int(e)
            if old_e is not None and s - old_e < fade_size:
                s = old_e - fade_size * 2
            if s != 0:
                weight[:, :, s: s + fade_size] = np.linspace(0, 1, fade_size)
            else:
                s -= fade_size
            if e != mask.shape[2]:
                weight[:, :, e - fade_size: e] = np.linspace(1, 0, fade_size)
            else:
                e += fade_size
            weight[:, :, s + fade_size: e - fade_size] = 1.0
            old_e = e
    return mask + weight * (1.0 - mask)


def normalize(wave: np.ndarray, is_normalize: bool = False) -> np.ndarray:
    """Clip-guard peak normalization (reference ``spec_utils.py:111-127``,
    minus its console chatter)."""
    maxv = np.max(np.abs(wave)) if wave.size else 0.0
    if maxv > 1.0 and is_normalize:
        wave = wave / maxv
    return wave


def to_shape(x: np.ndarray, target_shape) -> np.ndarray:
    """Zero-pad trailing edges up to ``target_shape`` (reference
    ``spec_utils.py:523-530``)."""
    pads = tuple((0, t - s) for s, t in zip(x.shape, target_shape))
    return np.pad(x, pads, mode="constant")


def augment_audio(export_path: str, audio_file: str, rate: float,
                  is_normalization: bool = False, is_pitch: bool = False) -> str:
    """Offline time-stretch / pitch-shift augmentation via rubberband
    (reference ``spec_utils.py:542-563``); host-side by design. Requires the
    ``rubberband`` CLI — raises RuntimeError otherwise."""
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav
    from lemas_tts_tpu_torch.uvr5 import pyrb

    wav, sr = read_audio(audio_file)
    if wav.ndim == 1:
        wav = np.stack([wav, wav])
    elif wav.shape[0] == 1:
        wav = np.concatenate([wav, wav], axis=0)
    fn = pyrb.pitch_shift if is_pitch else pyrb.time_stretch
    wav_1 = fn(wav[0], sr, rate)
    wav_2 = fn(wav[1], sr, rate)
    if wav_1.shape > wav_2.shape:
        wav_2 = to_shape(wav_2, wav_1.shape)
    elif wav_1.shape < wav_2.shape:
        wav_1 = to_shape(wav_1, wav_2.shape)
    mix = normalize(np.stack([wav_1, wav_2]), is_normalization)
    write_wav(export_path, mix, sr)
    return export_path
