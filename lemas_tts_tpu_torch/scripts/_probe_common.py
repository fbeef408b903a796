"""Shared setup of the sampler probes (counterpart of
``lemas_tts_tpu/scripts/_probe_common.py``): one construction site for the
probe-geometry model and the synthetic probe inputs, so every probe measures
the same workload, and the probes' sampler runner and timer.

On CUDA a probe's sampler is one CUDA graph of a settings and bucket
(``cfm/graph.py:GraphedSampler``): its first call runs eagerly and captures,
and only replays after it are timed, with CUDA events. On the CPU (``--device
cpu``, for tests) it is ``sample_mel``, timed by the host clock.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def add_device_arg(p) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; never falls back to another device.")


def random_dit(arch, mel_dim: int, vocab: int, device: torch.device,
               attn_backend: str = "vmem", seed: int = 1, dtype: Optional[torch.dtype] = None,
               quant: Optional[str] = None, state: Optional[dict] = None):
    """A port ``DiT`` on ``device``, eval mode: its weights ``state`` or
    ``normal * 0.02`` from ``seed`` (``utils/misc.py:fast_random_params``),
    W8A8 (``quant``: ``"int8"``/``"int8_ff"``) from those float weights, the
    matrices stored in ``dtype`` (default: bf16 on CUDA, f32 on the CPU)."""
    from lemas_tts_tpu_torch.models.dit import DiT, cast_matrices
    from lemas_tts_tpu_torch.ops.quant import MODES, quantize_dense_tree
    from lemas_tts_tpu_torch.utils.misc import fast_random_params

    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with torch.device(device):
        model = DiT(arch, mel_dim=mel_dim, text_num_embeds=vocab, compute_dtype=dtype,
                    attn_backend=attn_backend)
    model.to(device)
    if state is not None:
        model.load_state_dict(state)
    else:
        fast_random_params(model, torch.Generator(device).manual_seed(seed))
    if quant:
        quantize_dense_tree(model, MODES[quant])
    return cast_matrices(model, dtype).to(device).eval()


def probe_checkpoint(path: str) -> dict:
    """The backbone's state dict from a probe's ``--ckpt``: a directory is a
    native (orbax) artifact, what ``convert_checkpoint``/``validate_assets``
    write; a file a reference ``.pt``/``.safetensors`` checkpoint (EMA
    weights preferred), as in the JAX probes."""
    from lemas_tts_tpu_torch.infer.checkpoints import load_cfm_checkpoint, load_native_cfm
    from lemas_tts_tpu_torch.weights import dit_state_from_jax

    if Path(path).is_dir():
        return dit_state_from_jax(load_native_cfm(path)[0])
    return load_cfm_checkpoint(path)["dit"]


def probe_model_and_inputs(args):
    """``(model, inputs)`` for a probe namespace with ``ckpt``, ``dim``,
    ``depth``, ``heads``, ``seed``, ``batch``, ``n`` (and optionally
    ``dim_head``, ``mel_dim``, ``vocab``, ``text_dim``, ``conv_layers``,
    ``quant``, ``device``).

    ``inputs`` = (cond, cond_mask, text_ids, duration, y0) on the device at
    [batch, n]: ~2 s of synthetic reference mel (``ref = min(188, n // 4)``
    frames) conditioning the rest of the bucket, drawn from numpy's
    ``default_rng(seed)`` in the JAX helper's order, so both packages get the
    same arrays."""
    from lemas_tts_tpu_torch.api import select_device
    from lemas_tts_tpu_torch.config import DiTArch

    device = select_device(getattr(args, "device", None))
    dim_head = getattr(args, "dim_head", None) or (
        args.dim // args.heads if args.dim < 1024 else 64)
    D = getattr(args, "mel_dim", None) or 100
    vocab = getattr(args, "vocab", None) or 898
    arch = DiTArch(dim=args.dim, depth=args.depth, heads=args.heads, dim_head=dim_head,
                   text_dim=getattr(args, "text_dim", None) or 512,
                   conv_layers=getattr(args, "conv_layers", None) or 4)
    state = None
    if getattr(args, "ckpt", None):
        state = probe_checkpoint(args.ckpt)
    model = random_dit(arch, D, vocab, device, state=state,
                       quant=getattr(args, "quant", None) or None)

    rng = np.random.default_rng(args.seed)
    B, N = args.batch, args.n
    ref = min(188, N // 4)  # ~2 s of reference audio at the flagship buckets
    nt = min(256, max(8, N // 4))
    text = rng.integers(1, min(800, vocab - 1), (B, nt)).astype(np.int32)
    cond = np.zeros((B, N, D), np.float32)
    cond[:, :ref] = rng.standard_normal((B, ref, D)) * 0.5 - 5.0
    cond_mask = np.zeros((B, N), bool)
    cond_mask[:, :ref] = True
    y0 = rng.standard_normal((B, N, D)).astype(np.float32)
    inputs = tuple(torch.from_numpy(a).to(device) for a in (
        cond, cond_mask, text, np.full((B,), N, np.int64), y0))
    return model, inputs


def make_sampler(model, settings, inputs: Sequence[torch.Tensor], pool=None,
                 graph: bool = True) -> Callable:
    """``fn()`` -> mel [B, N, D] f32 of ``settings`` on ``inputs``: on CUDA
    and with ``graph`` a ``GraphedSampler`` of the inputs' bucket (the first
    call captures; graphs given one ``pool`` share its memory), else
    ``sample_mel`` (a probe that only compares mels needs no graph)."""
    from lemas_tts_tpu_torch.cfm.graph import GraphedSampler, GraphPool
    from lemas_tts_tpu_torch.cfm.sampler import sample_mel, sway_time_grid

    cond, cond_mask, text, duration, y0 = inputs
    grid = sway_time_grid(settings.steps, settings.sway_sampling_coef, settings.t_start)
    if graph and cond.device.type == "cuda":
        B, N, D = cond.shape
        g = GraphedSampler(model, settings, grid, B, N, D, text.shape[1], cond.device,
                           pool if pool is not None else GraphPool())
        return lambda: g(*inputs)
    return lambda: sample_mel(model, cond=cond, cond_mask=cond_mask, text_ids=text,
                              duration=duration, y0=y0, time_grid=grid, settings=settings)


def seconds(fn: Callable, device: torch.device) -> float:
    """One call of ``fn``: card seconds between CUDA events on CUDA, host
    seconds on the CPU."""
    if device.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def measure(fn: Callable, device: torch.device, reps: int = 3, timed: bool = True):
    """``(mel as f32 numpy, best-of-``reps`` seconds)``: the first call (on
    CUDA the eager run and capture) gives the mel and is never timed; NaN
    seconds when not ``timed``."""
    mel = fn().float().cpu().numpy()
    if not timed:
        return mel, float("nan")
    return mel, min((seconds(fn, device) for _ in range(max(1, reps))), default=math.nan)


def call_us(fn: Callable, device: torch.device, reps: int) -> float:
    """Microseconds a call of ``fn`` over ``reps`` calls: card time on CUDA
    (``utils/profiling.py:device_ms``, calls queued behind a spin), host time
    on the CPU (after one warm-up call)."""
    if device.type == "cuda":
        from lemas_tts_tpu_torch.utils.profiling import device_ms

        return device_ms([fn], iters=reps) * 1e3
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def attention_inputs(B: int, N: int, inner: int, dtype: torch.dtype, device: torch.device):
    """q, k, v [B, N, inner] from numpy's ``default_rng(0)`` and a key mask
    hiding the last 64 frames of every row (the JAX probes' inputs)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, N, inner)).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    mask = torch.from_numpy(np.repeat((np.arange(N) < N - 64)[None], B, 0)).to(device)
    return q, k, v, mask
