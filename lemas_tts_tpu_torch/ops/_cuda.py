"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``lemas_tts_tpu_torch/build/``; the file name carries a hash of the sources
and flags, so an edited kernel is rebuilt and a current one is reused. The
libraries are loaded with ``ctypes``: every pointer and the CUDA stream go as
``c_void_p``; a library's entry points are attributes of what ``library``
returns. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_NHD = [I, I, I] + [P] * 6 + [I] * 3 + [F, P]
# C entry points of each library csrc/<library>.cu, with their argtypes
ENTRY_POINTS = {
    "qkv_block": {"lemas_qkv_block": [I, I] + [P] * 13 + [I] * 5 + [P]},
    "ffn_block": {"lemas_ffn_block": [I, I] + [P] * 11 + [I] * 4 + [P]},
    "attention_nhd": {"lemas_attention_nhd": _NHD, "lemas_attention_nhd_pack": _NHD},
    "attention_bhnd": {"lemas_attention_bhnd": [I, I, I] + [P] * 5 + [I] * 3 + [F, P, P]},
    "attention_splash": {"lemas_attention_splash": [I, I, I] + [P] * 5 + [I] * 3 + [F, P]},
    "conv_taps": {"lemas_conv_taps_mish": [I, I] + [P] * 4 + [I] * 6 + [P]},
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(ENTRY_POINTS)) -> Dict[str, float]:
    """Compile every library in ``names`` that is missing, all ``nvcc``
    processes started together. Returns {name: seconds} for the ones built;
    raises with the compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log = proc.communicate()[0]
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        (BUILD / f"{name}.ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def library(name: str) -> ctypes.CDLL:
    """Kernel library ``name``, loaded (and built if needed), its entry
    points typed."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                for fn_name, argtypes in ENTRY_POINTS[name].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _loaded[name] = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"CUDA kernels take bfloat16 or float32, not {t.dtype}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def refuse_grad(kernel: str, *tensors) -> None:
    """The kernels define no backward: a launch writes into a fresh tensor
    through raw pointers, so autograd would see no ``grad_fn`` and the
    weights behind it would get no gradient. Under grad, with an input that
    requires one, raise instead (the plain version is not taken in its
    place: that would hide the route change)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel defines no backward and cannot run under grad on "
            "inputs that require it; train on the differentiable route "
            "(DiT.forward(..., deterministic=False) or autograd=True, as "
            "cfm.loss.cfm_training_loss and cfm.distill.Distiller call it), or run "
            "inference under torch.no_grad()")
