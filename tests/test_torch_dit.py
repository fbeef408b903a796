"""The port's DiT against the JAX DiT on its kernel paths.

The JAX DiT is built with ``attn_backend="vmem"``, so each block runs its
Pallas kernels in interpret mode on the CPU: all three (qkv_block,
vmem_attention_nhd, ffn_block) for the flagship geometry, and the split-head
vmem_attention plus ffn_block for a block with ``pe_attn_head`` (F5-TTS v0
``F5TTS_Base``, with ``text_mask_padding=False``) or ``qk_norm``. The port's
DiT on the CPU runs the same chains through the plain versions of its
kernels. Width 128 (2 heads x 64), depth 2, ff_mult 2, N = 256 with padded
keys, f32. Tolerance 2e-4: two blocks of f32 products summed in another
order, as in ``tests/test_ffn_kernel.py``'s block check.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.config import DiTArch as JArch
from lemas_tts_tpu.models.dit import DiT as JDiT
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.config import DiTArch
from lemas_tts_tpu_torch.models.dit import DiT

ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1)


def _build(arch):
    jdit = JDiT(arch=JArch(**arch), mel_dim=20, text_num_embeds=11, attn_backend="vmem")
    params = jdit.init(jax.random.key(0), jnp.zeros((1, 32, 20)), jnp.zeros((1, 32, 20)),
                       jnp.zeros((1, 8), jnp.int32), jnp.zeros((1,)))
    dit = DiT(DiTArch(**arch), mel_dim=20, text_num_embeds=11)
    dit.load_state_dict(weights.dit_state_from_jax(params))
    return jdit, params, dit.eval()


@pytest.fixture(scope="module")
def models():
    return _build(ARCH)


def _compare(models, drop_text):
    jdit, params, dit = models
    rng = np.random.default_rng(0)
    B, N = 2, 256
    x = rng.standard_normal((B, N, 20)).astype(np.float32)
    cond = rng.standard_normal((B, N, 20)).astype(np.float32)
    text = np.full((B, 40), -1, np.int32)
    text[0, :30] = rng.integers(0, 11, 30)
    text[1, :12] = rng.integers(0, 11, 12)
    time = np.asarray([0.3, 0.8], np.float32)
    mask = np.arange(N)[None, :] < np.asarray([200, N])[:, None]
    ref = np.asarray(jdit.apply(params, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(text),
                                jnp.asarray(time), jnp.asarray(mask), drop_text=drop_text))
    with torch.no_grad():
        got = dit(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(text),
                  torch.from_numpy(time), torch.from_numpy(mask), drop_text=drop_text).numpy()
    assert got.shape == ref.shape == (B, N, 20)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("drop_text", [False, True])
def test_dit_fused_path_matches_jax(models, drop_text):
    _compare(models, drop_text)


@pytest.mark.parametrize("extra", [dict(pe_attn_head=1, text_mask_padding=False),
                                   dict(qk_norm="rms_norm")], ids=["f5tts_v0", "qk_norm"])
def test_dit_split_head_path_matches_jax(extra):
    """Blocks the flat kernels do not take: AdaLN and the projections
    unfused, then the split-head kernel (K5); the FF side stays fused (K2)."""
    _compare(_build(dict(ARCH, **extra)), drop_text=False)
