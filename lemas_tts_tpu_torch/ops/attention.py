"""Self-attention for the DiT, MMDiT and UNetT blocks.

Counterpart of ``lemas_tts_tpu/ops/attention.py``:

- ``vmem_attention`` (K5): split-head ``[B, H, N, D]`` attention with a key
  mask, ``1/sqrt(D)`` applied to the f32 scores after the product, the
  unnormalised p rounded to the compute dtype before the PV product and
  ``/ l`` last. CUDA tensors launch ``csrc/attention_bhnd.cu`` (d64, d128,
  any N) or raise;
- ``splash_attention`` (K6): the JAX wrapper around JAX's own Pallas splash
  kernel, with segment ids taken from the mask, so a pad query attends the
  pad keys and an all-padded batch row attends every key. q is scaled by
  ``1/sqrt(D)`` rounded to q's dtype and rounded itself before the product;
  scores, softmax and the PV product in f32. CUDA tensors launch
  ``csrc/attention_splash.cu`` at N % 128 == 0 or raise; other N go to K5,
  as JAX hands them to its XLA ``sdpa``;
- ``sdpa``: the JAX package's XLA attention (the ``"xla"`` backend) in plain
  PyTorch ops: normalised p rounded to the compute dtype before the PV
  product. It launches no kernel of this package;
- ``attention(..., backend=)``: the split-head entry the models call, with
  the JAX backend names ``"vmem"`` (K5, the port's default), ``"splash"``
  and ``"xla"``;
- ``vmem_attention_nhd`` (K3): flat-layout ``[B, N, H*D]`` attention with the
  interleaved-pair rope applied to q and k inside the kernel and ``1/sqrt(D)``
  folded into q; ``pack_pair=True`` is the head-pair-packed variant (K4,
  d64 pairs), the same function. CUDA tensors launch
  ``csrc/attention_nhd.cu`` or raise. The running max starts where the JAX
  kernels start it (``nhd_start_max``), so a query row whose keys are all
  masked gets what JAX gives: the mean of v, or 0 from K3's chunked regime.

CPU tensors take the ``*_plain`` versions. Each kernel wrapper counts its
launches in ``.launches``.

A rounding-point difference within tolerance (not a fault): at
N % 128 != 0 the JAX ``vmem_attention`` and ``splash_attention`` hand the
call to XLA ``sdpa``, which normalises p before rounding it for the PV
product; the port runs K5 at such N (p rounded unnormalised, ``/ l``
last). In f32 the two agree to ~4e-7; in bf16 both roundings have the same
relative precision, and JAX's own two routes differ by the same amount.
"""

from __future__ import annotations

import math

import torch

from lemas_tts_tpu_torch.ops import _cuda, launches

NEG_INF = -1e30  # score of a padded key
M_FLOOR = -1e29  # K3's running-max floor in its chunked regime
Q_TILE = 64  # the flat kernels take N in whole 64-row tiles of q and of keys


def _f32_scale(d: int) -> float:
    """1/sqrt(d) rounded to f32, as the kernels receive it."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))


def vmem_attention_plain(q, k, v, mask=None):
    """K5's arithmetic in PyTorch, at the Pallas kernel's rounding points."""
    B, H, N, D = q.shape
    cdt = q.dtype
    scale = _f32_scale(D)
    outs = []
    for b in range(B):  # one batch row at a time bounds the [H, N, N] f32 scores
        s = torch.matmul(q[b].float(), k[b].float().transpose(-1, -2)) * scale
        if mask is not None:
            s = s.masked_fill(~mask[b, None, None, :], NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        outs.append((torch.matmul(p.to(cdt).float(), v[b].float()) / l).to(cdt))
    return torch.stack(outs)


def _launch_bhnd(library: str, q, k, v, mask, scale: float):
    """Check split-head q, k, v [B, H, N, D] and the mask on CUDA and launch
    ``lemas_<library>`` (K5 or K6) on them; returns the output."""
    _cuda.require(q.device.type == "cuda", f"no kernel for device {q.device}")
    _cuda.require(q.dim() == 4, f"q must be [B, H, N, D], got {tuple(q.shape)}")
    B, H, N, D = q.shape
    _cuda.require(D in (64, 128),
                  f"split-head attention kernel takes dim_head 64 or 128, not {D}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    for t in (k, v):
        _cuda.require(t.device == q.device and t.dtype == q.dtype and t.shape == q.shape,
                      "q, k, v must match in shape, dtype, device")
    if mask is not None:
        _cuda.require(mask.dtype == torch.bool and mask.is_contiguous()
                      and tuple(mask.shape) == (B, N) and mask.device == q.device,
                      "mask must be contiguous bool [B, N] on q's device")
    out = torch.empty_like(q)
    err = getattr(_cuda.library(library), f"lemas_{library}")(
        q.device.index, _cuda.dtype_code(q), D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), B, N, H, scale,
        _cuda.stream_ptr(q.device))
    _cuda.check(err, library)
    return out


def vmem_attention(q, k, v, mask=None):
    """q, k, v [B, H, N, D]; mask [B, N] bool (True = keep) or None.
    Returns [B, H, N, D] in q's dtype."""
    if q.device.type == "cpu":
        return vmem_attention_plain(q, k, v, mask)
    _cuda.refuse_grad("vmem_attention (K5)", q, k, v)
    out = _launch_bhnd("attention_bhnd", q, k, v, mask, _f32_scale(q.shape[-1]))
    launches.count(vmem_attention)
    return out


vmem_attention.launches = 0

SPLASH_BLOCK = 128  # splash's block size: other N go to sdpa in JAX, to K5 here
SPLASH_MASKED = -0.7 * float(torch.finfo(torch.float32).max)  # splash's mask value


def splash_q_scale(d: int, dtype: torch.dtype) -> float:
    """1/sqrt(d) in q's dtype: the JAX wrapper multiplies q by a weakly typed
    Python float, which takes q's dtype (bf16 0.08837890625 at d 128)."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=dtype))


def splash_attention_plain(q, k, v, mask=None):
    """K6's function in PyTorch, at splash's rounding points: q scaled and
    rounded to its dtype, then f32 logits, softmax and PV (p never rounded),
    ``o * (1 / l)``; query i sees key j iff ``mask[i] == mask[j]``."""
    B, H, N, D = q.shape
    cdt = q.dtype
    qs = (q.float() * splash_q_scale(D, cdt)).to(cdt)
    outs = []
    for b in range(B):  # one batch row at a time bounds the [H, N, N] f32 scores
        s = torch.matmul(qs[b].float(), k[b].float().transpose(-1, -2))
        if mask is not None:
            same = mask[b, :, None] == mask[b, None, :]
            s = s.masked_fill(~same[None], SPLASH_MASKED)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        outs.append((torch.matmul(p, v[b].float()) * (1.0 / l)).to(cdt))
    return torch.stack(outs)


def splash_attention(q, k, v, mask=None):
    """q, k, v [B, H, N, D]; mask [B, N] bool (True = valid) or None (one
    segment). Returns [B, H, N, D] in q's dtype. At N % 128 != 0 it computes
    what JAX computes there (XLA ``sdpa``): K5, the key-mask kernel."""
    if q.shape[-2] % SPLASH_BLOCK:
        return vmem_attention(q, k, v, mask)
    if q.device.type == "cpu":
        return splash_attention_plain(q, k, v, mask)
    _cuda.refuse_grad("splash_attention (K6)", q, k, v)
    out = _launch_bhnd("attention_splash", q, k, v, mask, splash_q_scale(q.shape[-1], q.dtype))
    launches.count(splash_attention)
    return out


splash_attention.launches = 0


def sdpa(q, k, v, mask=None):
    """The JAX package's XLA attention, the ``"xla"`` backend, in plain
    PyTorch ops (no kernel of this package): f32 scores times ``1/sqrt(D)``,
    padded keys -1e30, f32 softmax, p rounded to the compute dtype, PV
    accumulated in f32."""
    B, H, N, D = q.shape
    cdt = q.dtype
    scale = _f32_scale(D)
    outs = []
    for b in range(B):  # one batch row at a time bounds the [H, N, N] f32 scores
        s = torch.matmul(q[b].float(), k[b].float().transpose(-1, -2)) * scale
        if mask is not None:
            s = s.masked_fill(~mask[b, None, None, :], NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.matmul(p.to(cdt).float(), v[b].float()).to(cdt))
    return torch.stack(outs)


BACKENDS = ("vmem", "splash", "xla")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected one of {BACKENDS}")
    return backend


def attention(q, k, v, mask=None, backend: str = "vmem"):
    """Split-head attention as the models call it (the JAX ``attention``):
    ``"vmem"`` K5, ``"splash"`` K6, ``"xla"`` plain ``sdpa``."""
    if backend == "vmem":
        return vmem_attention(q, k, v, mask)
    if backend == "splash":
        return splash_attention(q, k, v, mask)
    check_backend(backend)
    return sdpa(q, k, v, mask)


def nhd_supported(heads: int, dim_head: int, n: int, qk_norm=None, pe_attn_head=None,
                  has_rope: bool = True) -> bool:
    """Geometries the flat-layout kernel takes: d64 heads in pairs (the
    flagship) or d128 heads, rope on every head, no qk norm, N % 64."""
    return (qk_norm is None and pe_attn_head is None and has_rope
            and ((dim_head == 64 and heads % 2 == 0) or dim_head == 128)
            and n % Q_TILE == 0)


def _rope(x, cos, sin, scale=None):
    # x [B, N, H, D] in the compute dtype; (x0, x1) -> x * cos + (-x1, x0) * sin
    # in f32, optionally * scale, rounded to the compute dtype
    xf = x.float()
    rot = torch.stack([-xf[..., 1::2], xf[..., 0::2]], dim=-1).flatten(-2)
    out = xf * cos + rot * sin
    if scale is not None:
        out = out * scale
    return out.to(x.dtype)


def nhd_start_max(n: int, pack_pair: bool = False) -> float:
    """Where the K3/K4 softmax starts its running max, as the JAX kernels do:
    K3 is one-shot (no floor: -inf) unless N > 2048 and N % 512 == 0, where it
    runs chunked from M_FLOOR; K4 is one-shot at every N. A row whose keys
    are all masked then gets the mean of v, or 0 from a chunked K3
    (``csrc/attention_nhd.cu:k3_start_max`` is the same rule)."""
    if not pack_pair and n > 2048 and n % 512 == 0:
        return M_FLOOR
    return -math.inf


def vmem_attention_nhd_plain(q, k, v, mask, angles, heads, *, start_max: float):
    """K3's (and K4's) arithmetic in PyTorch, at the kernels' rounding points;
    ``start_max`` is ``nhd_start_max`` of the kernel it stands for."""
    B, N, inner = q.shape
    D = inner // heads
    cdt = q.dtype
    cos = torch.cos(angles).repeat_interleave(2, dim=-1)[None, :, None, :]  # [1, N, 1, D]
    sin = torch.sin(angles).repeat_interleave(2, dim=-1)[None, :, None, :]
    scale = torch.tensor(_f32_scale(D), dtype=torch.float32)
    qr = _rope(q.view(B, N, heads, D), cos, sin, scale).transpose(1, 2)  # [B, H, N, D]
    kr = _rope(k.view(B, N, heads, D), cos, sin).transpose(1, 2)
    vh = v.view(B, N, heads, D).transpose(1, 2)
    outs = []
    for b in range(B):  # one batch row at a time bounds the [H, N, N] f32 scores
        s = torch.matmul(qr[b].float(), kr[b].float().transpose(-1, -2))
        if mask is not None:
            s = s.masked_fill(~mask[b, None, None, :], NEG_INF)
        m = s.amax(-1, keepdim=True).clamp_min(start_max)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(cdt).float(), vh[b].float()) / l.clamp_min(1e-30)
        outs.append(o.to(cdt).transpose(0, 1).reshape(N, inner))
    return torch.stack(outs)


def _launch_nhd(entry: str, q, k, v, mask, angles, heads: int):
    _cuda.require(q.device.type == "cuda", f"no kernel for device {q.device}")
    B, N, inner = q.shape
    D = inner // heads
    _cuda.require(inner == heads * D and nhd_supported(heads, D, N),
                  f"attention kernel does not take heads={heads}, D={D}, N={N}")
    for t in (q, k, v):
        _cuda.require(t.device == q.device and t.dtype == q.dtype and t.is_contiguous()
                      and t.shape == q.shape, "q, k, v must match in shape, dtype, device")
    _cuda.require(angles.dtype == torch.float32 and angles.is_contiguous()
                  and tuple(angles.shape) == (N, D // 2) and angles.device == q.device,
                  "angles must be contiguous f32 [N, D/2] on q's device")
    if mask is not None:
        _cuda.require(mask.dtype == torch.bool and mask.is_contiguous()
                      and tuple(mask.shape) == (B, N) and mask.device == q.device,
                      "mask must be contiguous bool [B, N] on q's device")
    out = torch.empty_like(q)
    err = getattr(_cuda.library("attention_nhd"), entry)(
        q.device.index, _cuda.dtype_code(q), D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), angles.data_ptr(), out.data_ptr(),
        B, N, heads, _f32_scale(D), _cuda.stream_ptr(q.device))
    _cuda.check(err, entry)
    return out


def vmem_attention_nhd(q, k, v, mask, angles, heads: int, pack_pair: bool = False):
    """q, k, v [B, N, H*D] (heads not split); mask [B, N] bool or None;
    angles [N, D/2] f32 rope angles. Returns [B, N, H*D]. ``pack_pair``
    takes the head-pair-packed kernel (``vmem_attention_nhd_pack``)."""
    if pack_pair:
        return vmem_attention_nhd_pack(q, k, v, mask, angles, heads)
    if q.device.type == "cpu":
        return vmem_attention_nhd_plain(q, k, v, mask, angles, heads,
                                        start_max=nhd_start_max(q.shape[1]))
    _cuda.refuse_grad("vmem_attention_nhd (K3)", q, k, v, angles)
    out = _launch_nhd("lemas_attention_nhd", q, k, v, mask, angles, heads)
    launches.count(vmem_attention_nhd)
    return out


vmem_attention_nhd.launches = 0


def vmem_attention_nhd_pack(q, k, v, mask, angles, heads: int):
    """K4: ``vmem_attention_nhd`` for d64 head pairs, one kernel block per
    head pair (the same function as K3, bit for bit)."""
    if q.device.type == "cpu":
        return vmem_attention_nhd_plain(q, k, v, mask, angles, heads,
                                        start_max=nhd_start_max(q.shape[1], pack_pair=True))
    _cuda.refuse_grad("vmem_attention_nhd_pack (K4)", q, k, v, angles)
    _cuda.require(q.shape[-1] == heads * 64 and heads % 2 == 0,
                  f"the head-pair kernel takes d64 heads in pairs, not {heads} heads of "
                  f"{q.shape[-1] / heads:g}")
    out = _launch_nhd("lemas_attention_nhd_pack", q, k, v, mask, angles, heads)
    launches.count(vmem_attention_nhd_pack)
    return out


vmem_attention_nhd_pack.launches = 0
