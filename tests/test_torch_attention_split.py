"""The port's split-head attention (K5, ``vmem_attention``) and the
head-pair route of the flat attention (K4, ``pack_pair=True``) against the
JAX package on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions, which
round where the CUDA kernels round; ``chip_smoke.py`` holds the kernels
against these on the card. The JAX K5 runs as a Pallas kernel in interpret
mode where it takes the shape (N % 128 == 0, D % 64 == 0) and falls back to
its XLA ``sdpa`` otherwise. Metric: relative L2 error, f32 <= 1e-5
(summation order only), bf16 <= 2e-2 (a few bf16 ulps where the two
frameworks round p or a product at other places).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lemas_tts_tpu.ops import attention as jattn
from lemas_tts_tpu.ops.rope import rope_angles as jrope_angles
from lemas_tts_tpu_torch.ops import attention as tattn

REL_L2 = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _split_inputs(seed, B, H, N, D, dtype, masked_rows):
    """q, k, v [B, H, N, D] as numpy rounded to ``dtype``, and a key mask
    with ragged valid lengths and the rows in ``masked_rows`` fully masked."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    qkv = [np.array(jnp.asarray(rng.standard_normal((B, H, N, D)), jdt).astype(jnp.float32))
           for _ in range(3)]
    valid = np.asarray([N - 37 * (b % 3) - 5 * (b % 2) for b in range(B)])
    mask = np.arange(N)[None, :] < valid[:, None]
    mask[list(masked_rows)] = False
    return qkv, mask


def _run_both(qkv, mask, dtype, jax_fn):
    jdt, tdt = DTYPES[dtype]
    ref = jax_fn(*(jnp.asarray(a, jdt) for a in qkv), jnp.asarray(mask))
    got = tattn.vmem_attention(*(torch.from_numpy(a).to(tdt) for a in qkv),
                               torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == qkv[0].shape
    return got.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D", [(128, 64), (256, 64), (128, 128), (256, 128)])
@pytest.mark.parametrize("masked_rows", [(), (1,)], ids=["ragged", "row_all_masked"])
def test_vmem_attention_matches_pallas(dtype, N, D, masked_rows):
    qkv, mask = _split_inputs(0, 3, 2, N, D, dtype, masked_rows)
    got, ref = _run_both(qkv, mask, dtype,
                         lambda q, k, v, m: jattn.vmem_attention(q, k, v, m, interpret=True))
    assert _rel_l2(got, ref) <= REL_L2[dtype]
    if masked_rows:  # no valid key: the mean of v, as the Pallas kernel gives
        mean_v = qkv[2][1].mean(axis=1)  # [H, D]
        np.testing.assert_allclose(got[1], np.broadcast_to(mean_v[:, None], got[1].shape),
                                   rtol=REL_L2[dtype], atol=REL_L2[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [100, 200])
@pytest.mark.parametrize("masked_rows", [(), (1,)], ids=["ragged", "row_all_masked"])
def test_vmem_attention_ragged_n_matches_jax_sdpa(dtype, N, masked_rows):
    """N % 128 != 0: the JAX package runs its XLA sdpa there, the port the
    same kernel as at every N (p rounded before it is normalised: a rounding
    point within tolerance). A batch row whose keys are all masked gets the
    mean of v from both, with no key of the ragged tail in that mean."""
    qkv, mask = _split_inputs(1, 2, 3, N, 64, dtype, masked_rows)
    got, ref = _run_both(qkv, mask, dtype, jattn.sdpa)
    assert _rel_l2(got, ref) <= REL_L2[dtype]
    if masked_rows:
        mean_v = qkv[2][1].mean(axis=1)  # [H, D] over the N keys
        np.testing.assert_allclose(got[1], np.broadcast_to(mean_v[:, None], got[1].shape),
                                   rtol=REL_L2[dtype], atol=REL_L2[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,N", [(2, 128), (4, 256)])
def test_pack_pair_route_matches_pallas(dtype, heads, N):
    """``pack_pair=True`` against the JAX head-pair-packed kernel (interpret
    mode). Every row keeps a valid key: on an all-masked row the JAX one-shot
    kernels give the mean of v and K3/K4 of the port give 0."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    B = 2
    q, k, v = (rng.standard_normal((B, N, heads * 64)).astype(np.float32) for _ in range(3))
    mask = np.arange(N)[None, :] < np.asarray([N - 48, N])[:, None]
    angles = np.array(jrope_angles(N, 64))
    ref = jattn.vmem_attention_nhd(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(mask),
        jnp.asarray(angles), heads=heads, interpret=True, pack_pair=True)
    got = tattn.vmem_attention_nhd(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                   torch.from_numpy(mask), torch.from_numpy(angles), heads,
                                   pack_pair=True)
    assert got.dtype == tdt and got.shape == (B, N, heads * 64)
    assert _rel_l2(got.float().numpy(), np.asarray(ref, np.float32)) <= REL_L2[dtype]
