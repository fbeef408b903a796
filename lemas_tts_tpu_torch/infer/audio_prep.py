"""Host-side reference-audio conditioning: silence clipping & trimming
(copy of ``lemas_tts_tpu/infer/audio_prep.py`` without the native scanner).

Numpy re-implementation of the pydub-based preprocessing
(``utils_infer.py:306-393,631-640``): same thresholds (dBFS), same 6 s/12 s
clipping cascade, same keep-silence padding — without the ffmpeg/pydub
dependency. Audio is float32 mono [-1, 1]; dBFS is relative to full scale.
"""

from __future__ import annotations

import numpy as np


def dbfs(x: np.ndarray) -> float:
    """pydub AudioSegment.dBFS: 20*log10(rms / full_scale)."""
    if x.size == 0:
        return -float("inf")
    rms = float(np.sqrt(np.mean(np.square(x.astype(np.float64)))))
    if rms <= 0:
        return -float("inf")
    return 20.0 * np.log10(rms)


def _ms(n_samples: int, sr: int) -> float:
    return n_samples * 1000.0 / sr


def _samples(ms: float, sr: int) -> int:
    return int(round(ms * sr / 1000.0))


def detect_silence(
    x: np.ndarray, sr: int, min_silence_len: int = 1000,
    silence_thresh: float = -50.0, seek_step: int = 10,
) -> list[tuple[int, int]]:
    """Silent [start_ms, end_ms) ranges (pydub.silence.detect_silence logic)."""
    length_ms = int(_ms(len(x), sr))
    if length_ms < min_silence_len:
        return []
    win = _samples(min_silence_len, sr)
    silence_starts = []
    last_start = length_ms - min_silence_len

    for start_ms in range(0, last_start + 1, seek_step):
        s = _samples(start_ms, sr)
        if dbfs(x[s : s + win]) < silence_thresh:
            silence_starts.append(start_ms)
    if last_start > 0 and last_start % seek_step:
        # pydub always tests the final (unaligned) window too
        s = _samples(last_start, sr)
        if dbfs(x[s : s + win]) < silence_thresh:
            silence_starts.append(last_start)
    if not silence_starts:
        return []
    # merge overlapping windows
    ranges = []
    cur_start = prev = silence_starts[0]
    for st in silence_starts[1:]:
        if st - prev > seek_step:
            ranges.append((cur_start, prev + min_silence_len))
            cur_start = st
        prev = st
    ranges.append((cur_start, prev + min_silence_len))
    return ranges


def detect_nonsilent(
    x: np.ndarray, sr: int, min_silence_len: int = 1000,
    silence_thresh: float = -50.0, seek_step: int = 10,
) -> list[tuple[int, int]]:
    length_ms = int(_ms(len(x), sr))
    silent = detect_silence(x, sr, min_silence_len, silence_thresh, seek_step)
    if not silent:
        return [(0, length_ms)] if length_ms > 0 else []
    out = []
    pos = 0
    for s, e in silent:
        if s > pos:
            out.append((pos, s))
        pos = e
    if pos < length_ms:
        out.append((pos, length_ms))
    return out


def split_on_silence(
    x: np.ndarray, sr: int, min_silence_len: int = 1000,
    silence_thresh: float = -50.0, keep_silence: int = 1000, seek_step: int = 10,
) -> list[np.ndarray]:
    """Non-silent chunks padded by keep_silence ms. Overlapping padded ranges
    are split at their midpoint (pydub.silence.split_on_silence semantics —
    without this, audio between nearby chunks appears in BOTH, stuttering the
    stitched reference)."""
    spans = detect_nonsilent(x, sr, min_silence_len, silence_thresh, seek_step)
    ranges = [[s - keep_silence, e + keep_silence] for s, e in spans]
    for cur, nxt in zip(ranges, ranges[1:]):
        if nxt[0] < cur[1]:
            mid = (cur[1] + nxt[0]) // 2
            cur[1] = mid
            nxt[0] = mid
    out = []
    for s, e in ranges:
        s2 = max(0, _samples(s, sr))
        e2 = min(len(x), _samples(e, sr))
        out.append(x[s2:e2])
    return out


def remove_silence_edges(x: np.ndarray, sr: int, silence_threshold: float = -42.0) -> np.ndarray:
    """Trim leading/trailing silence (``utils_infer.py:306-319``): leading by
    10 ms chunks, trailing by 1 ms steps."""
    step = _samples(10, sr)
    start = 0
    while start + step <= len(x) and dbfs(x[start : start + step]) < silence_threshold:
        start += step
    x = x[start:]
    one_ms = max(1, _samples(1, sr))
    end = len(x)
    while end > one_ms and dbfs(x[end - one_ms : end]) <= silence_threshold:
        end -= one_ms
    return x[:end]


def clip_ref_audio(x: np.ndarray, sr: int, show_info=print) -> np.ndarray:
    """Reference-audio ≤12 s silence-aware clipping cascade
    (``preprocess_ref_audio_text``, ``utils_infer.py:331-361``)."""

    def accumulate(segs):
        acc = np.zeros(0, dtype=x.dtype)
        for seg in segs:
            if _ms(len(acc), sr) > 6000 and _ms(len(acc) + len(seg), sr) > 12000:
                show_info("Audio is over 12s, clipping short.")
                break
            acc = np.concatenate([acc, seg])
        return acc

    clipped = accumulate(split_on_silence(x, sr, 1000, -50.0, 1000, 10))
    if _ms(len(clipped), sr) > 12000:
        clipped = accumulate(split_on_silence(x, sr, 100, -40.0, 1000, 10))
    if _ms(len(clipped), sr) > 12000:
        clipped = clipped[: _samples(12000, sr)]
        show_info("Audio is over 12s, clipping short. (3)")

    clipped = remove_silence_edges(clipped, sr)
    # + 50 ms trailing silence (utils_infer.py:361)
    return np.concatenate([clipped, np.zeros(_samples(50, sr), dtype=x.dtype)])

