"""Modules of the PyTorch port against their JAX counterparts on the CPU, in
f32, on the same inputs (made with numpy) and the same weights (carried with
``lemas_tts_tpu_torch.weights``). Tolerances are stated per test: 1e-5 where
only the summation order differs, larger where an FFT or a long conv chain
sits between input and output."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.models.modules import DiTBlock as JDiTBlock
from lemas_tts_tpu.models.vocos import Vocos as JVocos
from lemas_tts_tpu.ops import mel as jmel
from lemas_tts_tpu.ops import resample as jresample
from lemas_tts_tpu.ops import rope as jrope
from lemas_tts_tpu.ops import stft as jstft
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.models.modules import DiTBlock
from lemas_tts_tpu_torch.models.vocos import Vocos
from lemas_tts_tpu_torch.ops import mel, resample, rope, stft


def test_rope_matches_jax():
    angles = rope.rope_angles(96, 64)
    np.testing.assert_array_equal(angles.numpy(), np.asarray(jrope.rope_angles(96, 64)))
    x = np.random.default_rng(0).standard_normal((2, 3, 96, 64)).astype(np.float32)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(angles.numpy()))
    got = rope.apply_rope(torch.from_numpy(x), angles)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rope.abs_pos_embedding(32, 100),
                                  jrope.abs_pos_embedding(32, 100))


def test_stft_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3000)).astype(np.float32)
    ref = np.asarray(jstft.stft(jnp.asarray(x), 256, 64))
    got = stft.stft(torch.from_numpy(x), 256, 64).numpy()
    assert got.shape == ref.shape
    # rFFT of 256 points: summation order, 1e-4 of a |X| up to ~40
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_istft_matches_jax_and_padded_equals_exact():
    rng = np.random.default_rng(2)
    n_fft, hop, T = 256, 64, 40
    spec = (rng.standard_normal((2, n_fft // 2 + 1, T))
            + 1j * rng.standard_normal((2, n_fft // 2 + 1, T))).astype(np.complex64)
    fmask = np.arange(T)[None, :] < np.asarray([29, T])[:, None]
    ref = np.asarray(jstft.istft(jnp.asarray(spec), n_fft, hop, frame_mask=jnp.asarray(fmask)))
    got = stft.istft(torch.from_numpy(spec), n_fft, hop,
                     frame_mask=torch.from_numpy(fmask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # a bucket-padded decode equals the exact-length decode on its valid part
    exact = stft.istft(torch.from_numpy(spec[:1, :, :29]), n_fft, hop).numpy()
    np.testing.assert_allclose(got[0, : exact.shape[1]], exact[0], rtol=1e-6, atol=1e-6)


def test_vocos_mel_matches_jax():
    t = np.arange(4000) / 8000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.05 * np.random.default_rng(3).standard_normal(4000)).astype(np.float32)
    ref = np.asarray(jmel.vocos_mel_spectrogram(jnp.asarray(wav)[None], n_fft=256,
                                                hop_length=64, win_length=256,
                                                sample_rate=8000, n_mels=20))
    got = mel.MelFrontend(256, 64, 256, 20, 8000)(torch.from_numpy(wav)[None]).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)  # log of FFT magnitudes


@pytest.mark.parametrize("orig,new,T", [(16000, 24000, 4801), (24000, 8000, 3000),
                                        (44100, 24000, 2205)])
def test_resample_values_and_length(orig, new, T):
    x = np.random.default_rng(4).standard_normal(T).astype(np.float32)
    ref = np.asarray(jresample.resample(jnp.asarray(x), orig, new))
    got = resample.resample(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == ref.shape == (int(np.ceil(new * T / orig)),)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heads,dim_head,qk_norm,pe_attn_head", [
    (2, 64, None, None), (4, 16, None, None), (4, 16, "rms_norm", 2)])
def test_dit_block_matches_jax(heads, dim_head, qk_norm, pe_attn_head):
    """(2, 64) takes the fused chain (plain versions of K1-K3 on the CPU);
    the others are geometries the kernels do not take: the unfused chain,
    with qk RMSNorm and rope on the first heads only in the last case."""
    rng = np.random.default_rng(5)
    B, N, D = 2, 128, 128
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    t = rng.standard_normal((B, D)).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray([100, N])[:, None]
    angles = np.array(jrope.rope_angles(N, dim_head))
    jblk = JDiTBlock(D, heads=heads, dim_head=dim_head, ff_mult=2, qk_norm=qk_norm,
                     pe_attn_head=pe_attn_head)
    params = jblk.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t))
    ref = jblk.apply(params, jnp.asarray(x), jnp.asarray(t), mask=jnp.asarray(mask),
                     rope_angles_arr=jnp.asarray(angles))
    blk = DiTBlock(D, heads, dim_head, ff_mult=2, qk_norm=qk_norm, pe_attn_head=pe_attn_head)
    blk.load_state_dict(weights.dit_block_state_from_jax(params["params"]))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask),
                  torch.from_numpy(angles))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_vocos_decode_matches_jax():
    rng = np.random.default_rng(6)
    jvoc = JVocos(input_channels=20, dim=32, intermediate_dim=64, num_layers=2, n_fft=256,
                  hop_length=64)
    params = jvoc.init(jax.random.key(1), jnp.zeros((1, 20, 16)))
    mel_in = rng.standard_normal((2, 20, 48)).astype(np.float32)
    fmask = np.arange(48)[None, :] < np.asarray([31, 48])[:, None]
    ref = np.asarray(jvoc.apply(params, jnp.asarray(mel_in), jnp.asarray(fmask),
                                method=JVocos.decode))
    voc = Vocos(input_channels=20, dim=32, intermediate_dim=64, num_layers=2, n_fft=256,
                hop_length=64)
    voc.load_state_dict(weights.vocos_state_from_jax(params))
    with torch.no_grad():
        got = voc.decode(torch.from_numpy(mel_in), torch.from_numpy(fmask)).numpy()
        exact = voc.decode(torch.from_numpy(mel_in[:1, :, :31])).numpy()
    assert got.shape == ref.shape
    # exp-magnitude iSTFT of a random-weight net: outputs reach ~1e2
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(got[0, : exact.shape[1]], exact[0], rtol=1e-5,
                               atol=1e-5 * np.abs(exact).max())
