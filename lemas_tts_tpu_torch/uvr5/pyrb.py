"""Rubberband CLI wrapper: time-stretch / pitch-shift via shell-out.

Reference ``uvr5/lib_v5/pyrb.py:23-92`` (used only by UVR5's offline
``spec_utils.augment_audio`` path — SURVEY.md §2.4 lists it as optional).
A copy of ``lemas_tts_tpu/uvr5/pyrb.py``. Host-side CPU work by design: a
time-stretcher runs once per offline augmentation. Uses our own WAV codec instead of
soundfile, and fails loudly when the ``rubberband`` binary is absent.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional

import numpy as np

_RUBBERBAND = "rubberband"


def _run_rubberband(y: np.ndarray, sr: int, args: Dict[str, object]) -> np.ndarray:
    if shutil.which(_RUBBERBAND) is None:
        raise RuntimeError(
            "Failed to execute rubberband. Please verify that rubberband-cli "
            "is installed."
        )
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

    assert sr > 0
    fd, infile = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    fd, outfile = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    try:
        # audio_io expects [channels, T]; rubberband reads/writes WAV
        wav = y.T if y.ndim == 2 else y  # soundfile layout [T, C] → ours
        write_wav(infile, wav, sr)
        cmd = [_RUBBERBAND, "-q"]
        for k, v in args.items():
            cmd += [str(k), str(v)]
        cmd += [infile, outfile]
        subprocess.check_call(cmd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
        out, _ = read_audio(outfile)
        return np.squeeze(out) if y.ndim == 1 else out.T
    finally:
        os.unlink(infile)
        os.unlink(outfile)


def time_stretch(y: np.ndarray, sr: int, rate: float,
                 rbargs: Optional[Dict[str, object]] = None) -> np.ndarray:
    """Stretch duration by ``rate`` (reference ``pyrb.py:67-80``)."""
    if rate <= 0:
        raise ValueError("rate must be strictly positive")
    if rate == 1.0:
        return y
    rbargs = dict(rbargs or {})
    rbargs.setdefault("--tempo", rate)
    return _run_rubberband(y, sr, rbargs)


def pitch_shift(y: np.ndarray, sr: int, n_steps: float,
                rbargs: Optional[Dict[str, object]] = None) -> np.ndarray:
    """Shift pitch by ``n_steps`` semitones (reference ``pyrb.py:82-92``)."""
    if n_steps == 0:
        return y
    rbargs = dict(rbargs or {})
    rbargs.setdefault("--pitch", n_steps)
    return _run_rubberband(y, sr, rbargs)
