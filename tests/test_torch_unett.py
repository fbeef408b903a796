"""The UNetT backbone (E2-TTS) of the port against the JAX package on the CPU.

- ``UNetT`` at width 128 (2 heads x 64), depth 4, with each skip type
  (``concat``, ``add``, ``none``), a key mask, rope on the first head
  (``pe_attn_head: 1``, the E2 TTS Base setting) or on every head, the text
  embedding with or without its ConvNeXt stack; weights carried over from
  JAX by ``unett_state_from_jax``. The port's attention runs the plain
  version of its split-head kernel at the ragged N + 1 (the time token); the
  JAX model its ``xla`` attention.
- A tiny ``TTS`` with ``backbone: UNetT``: ``synthesize_chunks`` against the
  JAX ``TTS`` with the same noise; the block cache (DiT-only) is dropped
  with a warning, as in JAX; prosody text is refused.
- ``configs/e2tts_base.json`` holds the published E2 TTS Base widths.
Tolerance 2e-4 of the peak (f32), the repo's usual bar.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu import TTS as JTTS
from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig
from lemas_tts_tpu.models.unett import UNetT as JUNetT
from lemas_tts_tpu_torch import TTS, weights
from lemas_tts_tpu_torch.config import DiTArch, SamplerConfig, load_model_config
from lemas_tts_tpu_torch.models.unett import UNetT


def _close(got, want, tol=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("skip,pe_attn_head,conv_layers", [
    ("concat", 1, 0), ("add", 1, 1), ("none", None, 1), ("concat", None, 2)])
def test_unett_matches_jax(skip, pe_attn_head, conv_layers):
    arch = dict(dim=128, depth=4, heads=2, dim_head=64, ff_mult=4, text_dim=None,
                text_mask_padding=False, conv_layers=conv_layers, pe_attn_head=pe_attn_head)
    jm = JUNetT(mel_dim=20, text_num_embeds=11, skip_connect_type=skip, **{
        k: v for k, v in arch.items()})
    params = jm.init(jax.random.key(0), jnp.zeros((1, 32, 20)), jnp.zeros((1, 32, 20)),
                     jnp.zeros((1, 8), jnp.int32), jnp.zeros((1,)))
    model = UNetT(DiTArch(**arch), mel_dim=20, text_num_embeds=11, skip_connect_type=skip)
    model.load_state_dict(weights.unett_state_from_jax(params))
    assert (model.layers[3][0] is None) == (skip != "concat") and model.layers[0][0] is None
    rng = np.random.default_rng(1)
    B, N = 2, 96
    x, cond = (rng.standard_normal((B, N, 20)).astype(np.float32) for _ in range(2))
    text = np.full((B, 30), -1, np.int32)
    text[0, :21] = rng.integers(0, 11, 21)
    text[1, :9] = rng.integers(0, 11, 9)
    time = np.asarray([0.25, 0.9], np.float32)
    mask = np.arange(N)[None, :] < np.asarray([N, 70])[:, None]
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(text),
                               jnp.asarray(time), jnp.asarray(mask)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(text),
                           torch.from_numpy(time), torch.from_numpy(mask))
        with pytest.raises(NotImplementedError, match="prosody"):
            model(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(text),
                  torch.from_numpy(time), prosody_text=torch.zeros(B, 30, 512))
    _close(got.numpy(), want)


def test_unett_refuses_odd_depth_and_unknown_skip():
    arch = DiTArch(dim=64, depth=3, heads=1, dim_head=64, conv_layers=0)
    with pytest.raises(ValueError, match="even"):
        UNetT(arch, mel_dim=20)
    with pytest.raises(ValueError, match="skip"):
        UNetT(DiTArch(dim=64, depth=2, heads=1, dim_head=64), mel_dim=20,
              skip_connect_type="mul")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("unett")
    cfg = d / "tiny_unett.yaml"
    cfg.write_text(open("tests/data/tiny.yaml").read().replace("backbone: DiT",
                                                               "backbone: UNetT"))
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!"])
                     + "\n")
    kw = dict(model=str(cfg), vocab_file=str(vocab), frontend=None, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtts, tts = JTTS(**kw), TTS(**kw)
    assert isinstance(tts.dit, UNetT)
    tts.load_weights(weights.unett_state_from_jax(jtts.synth.dit_params),
                     weights.vocos_state_from_jax(jtts.synth.vocoder_params))
    return jtts, tts


@pytest.mark.parametrize("opts", [dict(), dict(cfg_cutoff=0.5),
                                  dict(block_cache="0-22:2+t2")])
def test_synthesize_chunks_with_unett_matches_jax(pair, opts, caplog):
    jtts, tts = pair
    noise = np.random.default_rng(1).standard_normal((512, 20)).astype(np.float32)
    kw = dict(nfe_steps=4, cfg_strength=2.0, sway_sampling_coef=1.0, max_duration=512, **opts)
    rng = np.random.default_rng(0)
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(12000) / 16000)
           + 0.05 * rng.standard_normal(12000)).astype(np.float32)
    args = (ref, 16000, "hello there. ", ["general kenobi.", "you are a bold one."])
    jw, jsr, jmel = jtts.synth.synthesize_chunks(*args, cfg=JSamplerConfig(**kw), seed=3,
                                                 noise_override=noise)
    w, sr, mel = tts.synth.synthesize_chunks(*args, cfg=SamplerConfig(**kw), seed=3,
                                             noise_override=noise)
    assert sr == jsr
    _close(mel, jmel)
    _close(w, jw)
    if "block_cache" in opts:  # DiT-only: the exact path, as in JAX
        assert tts.synth._settings(SamplerConfig(**kw)).block_cache_range is None


def test_e2tts_base_config_is_the_published_arch():
    """F5-TTS ``E2TTS_Base``: UNetT, dim 1024, depth 24, 16 x 64 heads,
    ff_mult 4, the text embedding at mel width without a ConvNeXt stack,
    rope on the first head, Vocos 24 kHz mels (333M parameters with the
    2546-token vocab of the paper's Emilia pinyin set)."""
    cfg = load_model_config("e2tts_base")
    a, m = cfg.arch, cfg.mel_spec
    assert (cfg.backbone, a.dim, a.depth, a.heads, a.dim_head, a.ff_mult, a.text_dim,
            a.conv_layers, a.pe_attn_head, a.text_mask_padding) == (
        "UNetT", 1024, 24, 16, 64, 4, None, 0, 1, False)
    assert (m.mel_spec_type, m.target_sample_rate, m.n_mel_channels, m.hop_length) == (
        "vocos", 24000, 100, 256)
    with torch.device("meta"):
        model = UNetT(a, mel_dim=m.n_mel_channels, text_num_embeds=2545)
    n = sum(p.numel() for p in model.parameters())
    assert 330e6 < n < 336e6, n
