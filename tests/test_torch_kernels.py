"""The port's K1-K3 (qkv_block, ffn_block, vmem_attention_nhd) against the
JAX Pallas kernels run in interpret mode, on the CPU, and what every kernel
wrapper (K1-K5) does on the CPU and on other devices, and the widths at
which the DiT block takes the fused kernels.

On the CPU the port's wrappers take their plain PyTorch versions, which
round at the same points as the CUDA kernels; the kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``. Tolerances:
f32 2e-5 (summation order only), bf16 3e-2 (one bf16 ulp at |x| ~ 4, where
the two frameworks round a product or a sum at different places).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.ops import attention as jattn
from lemas_tts_tpu.ops import ffn as jffn
from lemas_tts_tpu.ops.rope import rope_angles as jrope_angles
from lemas_tts_tpu_torch.ops import attention as tattn
from lemas_tts_tpu_torch.ops import ffn as tffn

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _ffn_inputs(seed, B, N, D, F):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((B, N, D)), scale=rng.standard_normal((B, D)) * 0.1,
        shift=rng.standard_normal((B, D)) * 0.1, gate=rng.standard_normal((B, D)),
        w1=rng.standard_normal((D, F)) * 0.05, b1=rng.standard_normal(F) * 0.1,
        w2=rng.standard_normal((F, D)) * 0.05, b2=rng.standard_normal(D) * 0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,D,F", [(2, 256, 128, 256), (1, 512, 128, 128)])
def test_ffn_block_matches_pallas(dtype, B, N, D, F):
    jdt, tdt = DTYPES[dtype]
    p = _ffn_inputs(0, B, N, D, F)
    act = {k: p[k].astype(np.float32) for k in ("x", "scale", "shift", "gate")}
    ref = jffn.ffn_block(*(jnp.asarray(act[k], jdt) for k in ("x", "scale", "shift", "gate")),
                         *(jnp.asarray(p[k], jnp.float32) for k in ("w1", "b1", "w2", "b2")),
                         interpret=True)
    got = tffn.ffn_block(*(_t(act[k], tdt) for k in ("x", "scale", "shift", "gate")),
                         _t(p["w1"].T, torch.float32), _t(p["b1"], torch.float32),
                         _t(p["w2"].T, torch.float32), _t(p["b2"], torch.float32))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_block_matches_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    B, N, D, I = 2, 256, 128, 128
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    scale, shift = (rng.standard_normal((B, D)).astype(np.float32) * 0.1 for _ in range(2))
    ws = [rng.standard_normal((D, I)) * 0.05 for _ in range(3)]
    bs = [rng.standard_normal(I) * 0.1 for _ in range(3)]
    ref = jffn.qkv_block(jnp.asarray(x, jdt), jnp.asarray(scale, jdt), jnp.asarray(shift, jdt),
                         *(jnp.asarray(a, jnp.float32) for w, b in zip(ws, bs) for a in (w, b)),
                         interpret=True)
    got = tffn.qkv_block(_t(x, tdt), _t(scale, tdt), _t(shift, tdt),
                         *(_t(a, torch.float32) for w, b in zip(ws, bs) for a in (w.T, b)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


# The widths of the CPU parity tests of the fused branch (test_torch_dit.py:
# N 256, D = I = 128; test_torch_modules.py's (2, 64) block: N 128) and of
# the flagship (N 1024, and the straddling N 1088 that chip_smoke.py checks
# K1 at, D = I = 1024): a narrowed predicate must not quietly move the CPU
# parity tests, or the flagship, off the kernels.
@pytest.mark.parametrize("n,d,inner", [(128, 128, 128), (256, 128, 128), (1024, 1024, 1024),
                                       (1088, 1024, 1024)])
def test_qkv_block_supported_keeps_test_and_flagship_widths(n, d, inner):
    assert tffn.qkv_block_supported(n, d, inner)


@pytest.mark.parametrize("dim,heads,n", [(128, 2, 128), (128, 2, 256), (1024, 16, 1024)])
def test_dit_block_takes_fused_branch_at_test_and_flagship_widths(dim, heads, n):
    from lemas_tts_tpu_torch.models.modules import DiTBlock

    blk = DiTBlock(dim, heads, 64, ff_mult=2)
    assert blk.fused_attn_ok(n) and blk.fused_ff_ok(n)


# Every query row keeps at least one valid key (fully masked rows: below).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,dim_head,N,block_kv", [
    (2, 64, 128, None),   # d64 pairs, one-shot softmax
    (4, 64, 256, None),
    (2, 64, 256, 128),    # d64 pairs, kv-chunked online softmax
    (2, 128, 128, None),  # d128 single heads
    (3, 128, 256, None),  # an odd head count is legal at d128
    (2, 128, 256, 128),   # d128, kv-chunked
])
def test_attention_nhd_matches_pallas(dtype, heads, dim_head, N, block_kv):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    B = 2
    q, k, v = (rng.standard_normal((B, N, heads * dim_head)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(N)[None, :] < np.asarray([N - 48, N])[:, None]
    angles = np.array(jrope_angles(N, dim_head))
    ref = jattn.vmem_attention_nhd(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(mask),
        jnp.asarray(angles), heads=heads, interpret=True, block_kv=block_kv)
    got = tattn.vmem_attention_nhd(_t(q, tdt), _t(k, tdt), _t(v, tdt), torch.from_numpy(mask),
                                   torch.from_numpy(angles), heads)
    assert got.dtype == tdt and got.shape == (B, N, heads * dim_head)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# Batch row 1 has no valid key. The JAX K3 runs its softmax one-shot unless
# N > 2048 and N % 512 == 0 (no running-max floor: the row gets the mean of
# v) and chunked from the floor -1e29 at N 2560 (the row gets 0); the JAX K4
# is one-shot at every N.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,pack_pair,row", [
    (256, False, "mean of v"),
    (256, True, "mean of v"),
    (2560, False, "zero"),
    (2560, True, "mean of v"),
])
def test_attention_nhd_all_masked_row_matches_pallas(dtype, N, pack_pair, row):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    B, heads, dim_head = 2, 2, 64
    q, k, v = (rng.standard_normal((B, N, heads * dim_head)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, N), bool)
    mask[0, N - 40:] = False
    mask[1] = False
    angles = np.array(jrope_angles(N, dim_head))
    ref = jattn.vmem_attention_nhd(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(mask),
        jnp.asarray(angles), heads=heads, interpret=True, pack_pair=pack_pair)
    tv = _t(v, tdt)
    got = tattn.vmem_attention_nhd(_t(q, tdt), _t(k, tdt), tv, torch.from_numpy(mask),
                                   torch.from_numpy(angles), heads, pack_pair=pack_pair)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    want = (torch.zeros(N, heads * dim_head) if row == "zero"
            else tv[1].float().mean(0).expand(N, -1))
    np.testing.assert_allclose(got[1].float().numpy(), want.numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_sdpa_matches_jax():
    """The split-head entry the models call (K5's plain version on the CPU,
    any head width) against the JAX XLA sdpa, with and without a key mask."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32) for _ in range(3))
    mask = np.arange(40)[None, :] < np.asarray([29, 40])[:, None]
    for m in (mask, None):
        ref = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         None if m is None else jnp.asarray(m))
        got = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_cpu_calls_leave_launch_counters_at_zero():
    """Plain versions on the CPU are not kernel launches."""
    counters = (tffn.qkv_block, tffn.ffn_block, tattn.vmem_attention_nhd,
                tattn.vmem_attention_nhd_pack, tattn.vmem_attention)
    before = [f.launches for f in counters]
    x = torch.randn(1, 64, 128)
    z = torch.zeros(1, 128)
    w, b = torch.randn(128, 128) * 0.05, torch.zeros(128)
    q, k, v = tffn.qkv_block(x, z, z, w, b, w, b, w, b)
    tffn.ffn_block(x, z, z, z, w, b, w, b)
    for pack_pair in (False, True):
        tattn.vmem_attention_nhd(q, k, v, None, torch.zeros(64, 32), heads=2,
                                 pack_pair=pack_pair)
    tattn.vmem_attention(*(t.view(1, 64, 2, 64).transpose(1, 2) for t in (q, k, v)))
    assert [f.launches for f in counters] == before == [0] * 5


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA never reaches a plain
    version: the wrapper raises."""
    x = torch.empty(1, 64, 128, device="meta")
    z = torch.empty(1, 128, device="meta")
    w, b = torch.empty(128, 128, device="meta"), torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tffn.qkv_block(x, z, z, w, b, w, b, w, b)
    with pytest.raises(ValueError, match="no kernel"):
        tffn.ffn_block(x, z, z, z, w, b, w, b)
    for pack_pair in (False, True):
        with pytest.raises(ValueError, match="no kernel"):
            tattn.vmem_attention_nhd(x, x, x, None, torch.empty(64, 32, device="meta"), heads=2,
                                     pack_pair=pack_pair)
    with pytest.raises(ValueError, match="no kernel"):
        tattn.vmem_attention(*(x.view(1, 64, 2, 64),) * 3)
