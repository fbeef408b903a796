"""Fused DiT block halves: ``qkv_block`` (K1) and ``ffn_block`` (K2).

Counterpart of ``lemas_tts_tpu/ops/ffn.py``. Each function is a CUDA kernel
(``csrc/qkv_block.cu``, ``csrc/ffn_block.cu``) with a plain PyTorch version
beside it that rounds at the same points as the Pallas kernels:

- LayerNorm statistics in f32 with the fast variance ``E[x^2] - mu^2`` and
  eps 1e-6, no affine;
- ``normed`` rounded to the compute dtype *before* ``* (1 + scale) + shift``,
  which runs in the compute dtype;
- products accumulate in f32, are rounded to the compute dtype, and only then
  get ``+ bias``.

Dispatch is by the tensors' device: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. In bf16 both run on the warp-specialised
wgmma/TMA GEMM of ``csrc/gemm_sm90.cuh`` and take an LN-modulate scratch from
their wrapper: ``qkv_block`` the modulated ``m`` ``[B*N, D]``, ``ffn_block``
the LayerNorm mean and rstd ``[B*N, 2]`` f32. In f32 both run the ``mma.sync``
GEMM of ``csrc/ln_mod_gemm.cuh``. Weights are in torch ``Linear`` layout
``[out, in]``. Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lemas_tts_tpu_torch.ops import _cuda, launches

LN_EPS = 1e-6
# The f32 kernels' tiles (csrc/ln_mod_gemm.cuh BM, BN, BK) bound the shapes
# both types take: the bf16 GEMM (csrc/gemm_sm90.cuh) runs 128-row tiles with
# rows past B*N masked, 64-deep stages with the depth past D read as zeros,
# and masks the columns past the output, so it takes every such shape.
ROW_TILE = 64  # rows per f32 block
COL_TILE = 128  # output columns per f32 block
K_TILE = 32  # reduction depth per f32 stage
# The bf16 qkv_block's LN-modulate (csrc/qkv_block.cu): a pass that writes m
# once (True) or the GEMM's prologue (False). The pass took the less card time
# on an H100 80GB HBM3 at 700 W (chip_smoke.py times both; PERF.md).
QKV_LN_PASS = True


def ln_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``T(LN(x)) * (1 + scale) + shift`` with the kernels' rounding points;
    x [B, N, D], scale/shift [B, D]."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    normed = ((xf - mu) * torch.rsqrt(var + LN_EPS)).to(x.dtype)
    return normed * (1 + scale[:, None]) + shift[:, None]


def _dense(m: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # f32-accumulated product rounded to the compute dtype, then + bias
    return torch.matmul(m, w.to(m.dtype).t()) + b.to(m.dtype)


def qkv_block_plain(x, scale, shift, wq, bq, wk, bk, wv, bv):
    m = ln_modulate(x, scale.to(x.dtype), shift.to(x.dtype))
    return _dense(m, wq, bq), _dense(m, wk, bk), _dense(m, wv, bv)


def ffn_block_plain(x, scale, shift, gate, w1, b1, w2, b2):
    cdt = x.dtype
    m = ln_modulate(x, scale.to(cdt), shift.to(cdt))
    h = F.gelu(_dense(m, w1, b1), approximate="tanh")
    return x + gate.to(cdt)[:, None] * _dense(h, w2, b2)


def qkv_block_supported(n: int, d: int, inner: int) -> bool:
    """Shapes the CUDA kernels take (the f32 kernel's tiles; the bf16 one
    takes all of them): whole row tiles inside each batch row (N % 64), whole
    reduction stages (D % 32) and whole column tiles inside each of q, k, v
    (inner % 128)."""
    return n % ROW_TILE == 0 and d % K_TILE == 0 and inner % COL_TILE == 0


def ffn_block_supported(n: int, d: int, inner: int) -> bool:
    """Shapes the CUDA kernel takes: N % 64, and D and the hidden width
    multiples of 128 (each is a column tile width of one launch and the
    reduction depth of the other)."""
    return n % ROW_TILE == 0 and d % COL_TILE == 0 and inner % COL_TILE == 0


def _check_cuda(x: torch.Tensor, *others: torch.Tensor) -> None:
    _cuda.require(x.dim() == 3, f"x must be [B, N, D], got {tuple(x.shape)}")
    for t in (x, *others):
        _cuda.require(t.device == x.device, "all operands must be on one device")
        _cuda.require(t.dtype == x.dtype,
                      f"operand dtype {t.dtype} differs from x's {x.dtype}")
        _cuda.require(t.is_contiguous(), "operands must be contiguous")


def qkv_block(x, scale, shift, wq, bq, wk, bk, wv, bv, *, ln_pass=QKV_LN_PASS):
    """LN -> AdaLN modulate -> q/k/v projections. x [B, N, D]; scale, shift
    [B, D]; w* [I, D]; b* [I]. Returns q, k, v, each [B, N, I]. ``ln_pass``
    picks the bf16 kernel's LN-modulate form (the default is the faster; the
    other is there to be timed against it)."""
    if x.device.type == "cpu":
        return qkv_block_plain(x, scale, shift, wq, bq, wk, bk, wv, bv)
    _cuda.require(x.device.type == "cuda", f"no kernel for device {x.device}")
    _cuda.refuse_grad("qkv_block (K1)", x, scale, shift, wq, bq, wk, bk, wv, bv)
    _check_cuda(x, scale, shift, wq, bq, wk, bk, wv, bv)
    B, N, D = x.shape
    inner = wq.shape[0]
    _cuda.require(qkv_block_supported(N, D, inner),
                  f"qkv_block kernel does not take N={N}, D={D}, I={inner}")
    for w, b in ((wq, bq), (wk, bk), (wv, bv)):
        _cuda.require(tuple(w.shape) == (inner, D) and tuple(b.shape) == (inner,),
                      "q/k/v weights must be [I, D] with biases [I]")
    _cuda.require(tuple(scale.shape) == (B, D) and tuple(shift.shape) == (B, D),
                  "scale and shift must be [B, D]")
    q, k, v = (torch.empty(B, N, inner, device=x.device, dtype=x.dtype) for _ in range(3))
    # the bf16 kernel's LN-modulate scratch: m, or each row's (mean, rstd)
    scratch = None
    if x.dtype == torch.bfloat16:
        scratch = (torch.empty(B * N, D, device=x.device, dtype=x.dtype) if ln_pass
                   else torch.empty(B * N, 2, device=x.device, dtype=torch.float32))
    err = _cuda.library("qkv_block").lemas_qkv_block(
        x.device.index, _cuda.dtype_code(x), x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        wq.data_ptr(), bq.data_ptr(), wk.data_ptr(), bk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B * N, N, D, inner, int(ln_pass), _cuda.stream_ptr(x.device))
    _cuda.check(err, "qkv_block")
    launches.count(qkv_block)
    return q, k, v


qkv_block.launches = 0


def ffn_block(x, scale, shift, gate, w1, b1, w2, b2):
    """x + gate * FF(LN(x) * (1 + scale) + shift). x [B, N, D]; scale,
    shift, gate [B, D]; w1 [F, D], b1 [F], w2 [D, F], b2 [D]. Returns
    [B, N, D]."""
    if x.device.type == "cpu":
        return ffn_block_plain(x, scale, shift, gate, w1, b1, w2, b2)
    _cuda.require(x.device.type == "cuda", f"no kernel for device {x.device}")
    _cuda.refuse_grad("ffn_block (K2)", x, scale, shift, gate, w1, b1, w2, b2)
    _check_cuda(x, scale, shift, gate, w1, b1, w2, b2)
    B, N, D = x.shape
    Fh = w1.shape[0]
    _cuda.require(ffn_block_supported(N, D, Fh),
                  f"ffn_block kernel does not take N={N}, D={D}, F={Fh}")
    _cuda.require(tuple(w1.shape) == (Fh, D) and tuple(b1.shape) == (Fh,)
                  and tuple(w2.shape) == (D, Fh) and tuple(b2.shape) == (D,),
                  "w1 must be [F, D], w2 [D, F]")
    for t in (scale, shift, gate):
        _cuda.require(tuple(t.shape) == (B, D), "scale, shift and gate must be [B, D]")
    h = torch.empty(B, N, Fh, device=x.device, dtype=x.dtype)
    # the bf16 kernel's LayerNorm (mean, rstd) per row; f32 computes its own
    stats = (torch.empty(B * N, 2, device=x.device, dtype=torch.float32)
             if x.dtype == torch.bfloat16 else None)
    out = torch.empty_like(x)
    err = _cuda.library("ffn_block").lemas_ffn_block(
        x.device.index, _cuda.dtype_code(x), x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        gate.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        h.data_ptr(), None if stats is None else stats.data_ptr(), out.data_ptr(), B * N, N, D,
        Fh, _cuda.stream_ptr(x.device))
    _cuda.check(err, "ffn_block")
    launches.count(ffn_block)
    return out


ffn_block.launches = 0
