"""Mask-based speech editing: regenerate word spans inside an utterance
(counterpart of ``lemas_tts_tpu/infer/editing.py``).

An alignment JSON gives the utterance interval and per-word intervals; the
words in ``modified_index`` are replaced by new text, a frame-level keep mask
is built over the mel sequence (False = regenerate, ±0.1 s safety margin),
and the same sampler as TTS (``Synthesizer.run_sampler``: a CUDA graph per
bucket on the card, ``cfm/sampler.py:sample_mel`` on the CPU) runs with that
mask: kept frames come back bit-exactly, regenerated frames follow the new
text. The sampler takes the midpoint method and the block cache as the
synthesis paths do, and runs the attention route of the model's
``attn_backend`` (``TTS(attn_backend=)``, the edit CLI's ``--attn_backend``).

Alignment JSON schema (reference ``speech_edit_multilingual.py:232-258``):
  ``interval``: [start_s, end_s] of the utterance inside the file
  ``modified_index``: [i, j) word range to replace
  ``words``: [{"interval": [s, e], ...}, ...]
  ``modified_text``: [orig_phrase, new_phrase]
  ``display_text``: full original transcript

With a prosody model and ``cfg.use_prosody_encoder`` the utterance's
prosody embedding conditions the edit as it does a synthesis: its
``prosody_to_mel`` offset over the utterance's frames of the cond mel, the
embedding as the DiT's prosody text.

As in ``infer/pipeline.py``, the seeded noise comes from a
``torch.Generator``, so one seed gives other noise than in the JAX package;
``noise_override`` pins it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from lemas_tts_tpu_torch.cfm.sampler import DURATION_BUCKETS, pick_bucket
from lemas_tts_tpu_torch.config import SamplerConfig
from lemas_tts_tpu_torch.infer.pipeline import (TEXT_BUCKETS, Synthesizer, clip_and_shuffle,
                                                initial_noise, to_device)
from lemas_tts_tpu_torch.models.dit import PROSODY_DIM
from lemas_tts_tpu_torch.ops.resample import resample
from lemas_tts_tpu_torch.utils.vocab import pad_text_batch, text_to_ids


@dataclass(frozen=True)
class EditSpec:
    """One edit task parsed from an alignment JSON."""

    utt_start: float
    utt_end: float
    parts_to_edit: List[Tuple[float, float]]  # seconds, relative to utterance
    target_text: str
    display_text: str


def parse_align_json(path_or_dict, margin: float = 0.1) -> EditSpec:
    """Alignment JSON -> :class:`EditSpec`
    (reference ``speech_edit_multilingual.py:229-258``)."""
    if isinstance(path_or_dict, dict):
        data = path_or_dict
    else:
        with open(path_or_dict, "r", encoding="utf-8") as f:
            data = json.load(f)
    utt_start, utt_end = data["interval"]
    start_idx, end_idx = data["modified_index"]
    words = data["words"]
    start_idx = max(0, start_idx)
    end_idx = min(len(words), end_idx)
    if start_idx >= end_idx:
        raise ValueError("modified_index range is empty")
    word_start = words[start_idx]["interval"][0]
    word_end = words[end_idx - 1]["interval"][1]
    edit_start = max(0.0, word_start - utt_start - margin)
    # asymmetric on purpose: the margin sits on the clamp bound, as in the
    # reference (:251); build_edit_mask applies the symmetric ±margin again
    edit_end = min(word_end - utt_start, utt_end - utt_start + margin)
    orig, new = data["modified_text"]
    return EditSpec(utt_start=utt_start, utt_end=utt_end,
                    parts_to_edit=[(edit_start, edit_end)],
                    target_text=data["display_text"].replace(orig, new),
                    display_text=data["display_text"])


def build_edit_mask(parts_to_edit: Sequence[Tuple[float, float]], n_samples: int, sr: int,
                    hop_length: int, margin: float = 0.1) -> np.ndarray:
    """Frame-level keep mask [total_frames + 1] (True = keep original)
    (reference ``speech_edit_multilingual.py:126-158`` frame math)."""
    total_frames = n_samples // hop_length
    mask = np.zeros(0, dtype=bool)
    offset = 0.0  # samples
    for start, end in parts_to_edit:
        start = max(start - margin, 0.0)
        end = min(end + margin, n_samples / sr)
        part_samples = int(round((end - start) * sr))
        start_samples = int(round(start * sr))
        n_keep = int(round((start_samples - offset) / hop_length))
        n_edit = int(round(part_samples / hop_length))
        if n_keep > 0:
            mask = np.concatenate([mask, np.ones(n_keep, dtype=bool)])
        if n_edit > 0:
            mask = np.concatenate([mask, np.zeros(n_edit, dtype=bool)])
        offset = end * sr
    if mask.shape[0] < total_frames + 1:
        mask = np.concatenate([mask, np.ones(total_frames + 1 - mask.shape[0], dtype=bool)])
    return mask[: total_frames + 1]


@torch.no_grad()
def edit_speech(synth: Synthesizer, wav: np.ndarray, sr: int, text_tokens: Sequence[str],
                parts_to_edit: Sequence[Tuple[float, float]],
                cfg: SamplerConfig = SamplerConfig(), seed: Optional[int] = None,
                margin: float = 0.1, noise_override: Optional[np.ndarray] = None,
                ) -> Tuple[np.ndarray, int, np.ndarray]:
    """Regenerate ``parts_to_edit`` (seconds) of ``wav`` following
    ``text_tokens``. Returns (full edited wave, sr, mel [D, T]).

    Mirrors ``gen_wav_multilingual`` (``speech_edit_multilingual.py:67-207``):
    RMS normalize, resample, mel, keep-mask sampling, full-sequence vocoder
    decode, RMS restore. ``noise_override`` ([N, D], zero-padded/truncated to
    the bucket) replaces the seeded noise. The sampler settings, the block
    cache included, are the synthesis paths' (``Synthesizer._settings``); the
    exact paste of kept frames holds under the cache too."""
    tgt_sr = synth.mel_cfg.target_sample_rate
    hop = synth.mel_cfg.hop_length
    D = synth.mel_cfg.n_mel_channels
    dev = synth.device

    audio = np.asarray(wav, dtype=np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=0)
    rms = float(np.sqrt(np.mean(np.square(audio)))) if audio.size else 0.0
    if 0 < rms < cfg.target_rms:
        audio = audio * (cfg.target_rms / rms)
    if sr != tgt_sr:
        audio = resample(torch.from_numpy(np.ascontiguousarray(audio)).to(dev), sr,
                         tgt_sr).cpu().numpy()

    cond_mel = synth.ref_mel(audio)  # [frames, D]
    frames = cond_mel.shape[0]
    total_frames = audio.shape[-1] // hop

    # the reference applies the ±0.1 s margin twice: when parsing the
    # alignment (:249-251) and in gen_wav (:130-131); both are mirrored
    edit_mask = build_edit_mask(parts_to_edit, audio.shape[-1], tgt_sr, hop, margin=margin)

    ids = text_to_ids(list(text_tokens), synth.vocab)
    # duration = max(max(text_len, lens) + 1, duration_arg) (cfm.py:300-304)
    duration = min(max(max(len(ids), frames) + 1, total_frames), cfg.max_duration)
    N = pick_bucket(duration, DURATION_BUCKETS)
    nt = pick_bucket(len(ids), TEXT_BUCKETS)
    text_ids = pad_text_batch([ids], pad_to=nt)

    cond = np.zeros((1, N, D), dtype=np.float32)
    frames = min(frames, N)  # utterances beyond the largest bucket are truncated
    cond[0, :frames] = cond_mel[:frames]
    edit_mask = edit_mask[:N]
    k = min(frames, edit_mask.shape[0])
    keep = np.zeros((1, N), dtype=bool)
    keep[0, :k] = edit_mask[:k]

    rng = np.random.default_rng(seed)
    y0 = initial_noise(N, D, dev, seed, rng, noise_override)

    cond_mean = cond_mel[:frames].mean(axis=0, keepdims=True)
    prosody_text = None
    if synth.uses_prosody(cfg):
        emb, offset = synth.prosody_embedding(audio)
        cond[:, :frames] += offset[None, None, :]
        prosody_text = np.broadcast_to(emb[None, None, :], (1, nt, PROSODY_DIM)).astype(np.float32)
    step_cond = None
    if cfg.use_acc_grl and cfg.ref_ratio is not None and cfg.ref_ratio < 1:
        shuffled = clip_and_shuffle(cond_mel[:frames], cfg.ref_ratio, int(tgt_sr / hop), rng)
        step_cond = cond.copy()
        step_cond[0, :frames] = shuffled
    if cfg.no_ref_audio:  # cfm.py:320-324
        random_cond = rng.standard_normal(cond.shape).astype(np.float32) * 0.1 + cond_mean
        cond = random_cond / random_cond.mean(axis=1, keepdims=True) * cond_mean

    out = synth.run_sampler(
        synth._settings(cfg), to_device(cond, dev), to_device(keep, dev),
        to_device(text_ids, dev), to_device(np.asarray([duration], np.int64), dev), y0[None],
        None if step_cond is None else to_device(step_cond, dev),
        None if prosody_text is None else to_device(prosody_text, dev))
    out = out.cpu().numpy().astype(np.float32)  # [1, N, D]
    if cfg.no_ref_audio:  # mean re-alignment (cfm.py:464-467)
        gen = ~keep[0, :duration]
        if gen.any():
            region = out[0, :duration][gen]
            out[0, :duration][gen] = region - (region.mean(axis=0) - cond_mean[0])

    mel = out[0, :duration, :]  # full sequence, kept frames bit-exact
    wave = synth.vocode_batch([mel])[0]
    if 0 < rms < cfg.target_rms:
        wave = wave * (rms / cfg.target_rms)
    return np.clip(wave, -0.999, 0.999), tgt_sr, mel.T
