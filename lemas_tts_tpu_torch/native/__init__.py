"""The C++ host runtime (counterpart of ``lemas_tts_tpu/native/``), loaded
with ``ctypes``: host audio DSP (``audio``: WAV codec, resampler, dBFS
scan, RMS) and the serving micro-batcher (``batcher``).

The sources are the port's own copies, ``csrc/host/audioproc.cpp`` and
``csrc/host/scheduler.cpp``. Each builds at first use with ``g++ -O3
-std=c++17 -fPIC -shared`` into ``lemas_tts_tpu_torch/build/``, under a
name that carries a hash of its source and flags, so an edited source is
rebuilt and a current library reused. An ``fcntl`` lock on the build
directory is held across processes while a library is built, and the
library is written under a temporary name and renamed into place, so
processes that start together build it once and never load a partial file.

Differences from the JAX package: a failed build raises ``RuntimeError``
with the compiler's output (the JAX loader returns None and every caller
takes a Python fallback); only ``Batcher(native=False)`` names the
pure-Python batcher, explicitly. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra",
             "-fvisibility=hidden")
LIBS = {"audioproc": (), "scheduler": ("-lpthread",)}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the host runtime (csrc/host/*.cpp) is built with "
                           "a C++17 compiler at first use (set CXX or put g++ on PATH)")
    return cxx


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS[name]).encode())
    h.update((HOST_SRC / f"{name}.cpp").read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """The library ``name``, built if missing; raises with the compiler's
    output if the build fails."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / ".host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.is_file():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(HOST_SRC / f"{name}.cpp"),
               *LIBS[name]]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {name}.cpp failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """``lib<name>`` loaded (and built if needed); its entry points are typed
    by the caller (``audio``, ``batcher``)."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
