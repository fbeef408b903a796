"""The BigVGAN vocoder of the port against the JAX package on the CPU.

- The Kaiser-sinc taps equal JAX's; ``upsample2x`` / ``downsample2x`` (the
  port's ``F.conv_transpose1d`` / ``F.conv1d`` with ``groups=C`` against the
  JAX zero-stuffing and depthwise ``conv_general_dilated``), the snake, the
  generator and the masked ``decode`` at the ``TINY`` widths of
  ``tests/test_bigvgan.py``, weights carried over from JAX, f32.
- Weight-norm folding: a reference-layout generator state dict (``weight_g``
  / ``weight_v``, the alias-free ``filter`` buffers, wrapped as NVIDIA's
  ``{"generator": ...}``) loads through ``load_bigvgan_checkpoint`` and drives
  the port as JAX's ``convert_bigvgan`` of the same dict drives the JAX model.
- ``bigvgan_mel_spectrogram`` and its Slaney filterbank against JAX.
- A tiny ``TTS`` with ``mel_spec_type: bigvgan`` (the generator held at the
  ``TINY`` widths in both packages): ``synthesize_chunks`` against the JAX
  ``TTS`` with the same noise, the duration bucket, and the trims (``frames x
  hop`` samples: the generator is a pure conv stack) of every entry point.
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
from lemas_tts_tpu.models import bigvgan as jbig
from lemas_tts_tpu.ops import mel as jmel
from lemas_tts_tpu_torch import TTS, weights
from lemas_tts_tpu_torch.config import SamplerConfig
from lemas_tts_tpu_torch.models import bigvgan
from lemas_tts_tpu_torch.ops import mel

TINY = dict(num_mels=20, upsample_initial_channel=32, upsample_rates=(4, 2),
            upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 3)))


def _close(got, want, tol=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("args", [(0.25, 0.3, 12), (0.5 / 3, 0.2, 18), (0.2, 0.3, 11),
                                  (0.0, 0.3, 12)])
def test_kaiser_taps_equal_jax(args):
    np.testing.assert_array_equal(bigvgan.kaiser_sinc_filter1d(*args),
                                  jbig.kaiser_sinc_filter1d(*args))


@pytest.mark.parametrize("T", [64, 37])
def test_resampling_matches_jax(T):
    x = np.random.default_rng(T).standard_normal((2, T, 5)).astype(np.float32)  # [B, T, C]
    xt = torch.from_numpy(x).transpose(1, 2)  # the port is channel-first
    taps = bigvgan.resample_taps(2)
    up = bigvgan.upsample2x(xt, taps)
    _close(up.transpose(1, 2).numpy(), jbig.upsample2x(jnp.asarray(x)))
    _close(bigvgan.downsample2x(xt, taps).transpose(1, 2).numpy(),
           jbig.downsample2x(jnp.asarray(x)))
    assert up.shape[-1] == 2 * T


@pytest.mark.parametrize("variant,logscale", [("snakebeta", True), ("snake", False)])
def test_snake_activation_matches_jax(variant, logscale):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    jm = jbig.SnakeActivation1d(6, variant, logscale)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.uniform(0.2, 1.2, p.shape).astype(np.float32)), params)
    act = bigvgan.Activation1d(6, variant, logscale)
    act.act.alpha.data = torch.from_numpy(np.array(params["params"]["alpha"]))
    if variant == "snakebeta":
        act.act.beta.data = torch.from_numpy(np.array(params["params"]["beta"]))
    got = act(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    _close(got.detach().numpy(), jm.apply(params, jnp.asarray(x)))


@pytest.fixture(scope="module")
def tiny():
    cfg = jbig.BigVGANConfig(**TINY)
    jm = jbig.BigVGAN(cfg=cfg)
    rng = np.random.default_rng(2)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 20, 8)))
    # non-trivial snake scales (the init is 0 in log scale)
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (jnp.asarray(0.3 * rng.standard_normal(p.shape).astype(np.float32))
                         if path[-1].key in ("alpha", "beta") else p), params)
    model = bigvgan.BigVGAN(bigvgan.BigVGANConfig(**TINY)).eval()
    model.load_state_dict(weights.bigvgan_state_from_jax(params))
    return jm, params, model


def test_generator_matches_jax(tiny):
    jm, params, model = tiny
    x = np.random.default_rng(3).standard_normal((2, 20, 23)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 23 * 8) and model.wave_length(23) == 23 * 8
    _close(got, jm.apply(params, jnp.asarray(x)))


def test_masked_decode_matches_jax(tiny):
    jm, params, model = tiny
    x = np.random.default_rng(4).standard_normal((2, 20, 19)).astype(np.float32)
    mask = np.arange(19)[None, :] < np.asarray([19, 11])[:, None]
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(mask),
                               method=jbig.BigVGAN.decode))
    with torch.no_grad():
        got = model.decode(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    _close(got, want)
    assert (got[1, 11 * 8:] == 0).all() and np.abs(got[1, : 11 * 8]).max() > 0


TINY_HOP64 = dict(TINY, upsample_rates=(4, 4, 2, 2), upsample_kernel_sizes=(8, 8, 4, 4))


def _tiny_for_hop(mp):
    """``BigVGANConfig.for_hop`` of both packages gives the TINY generator at
    hop 64 (the published widths would take a minute of JAX on the CPU)."""
    for cls in (jbig.BigVGANConfig, bigvgan.BigVGANConfig):
        mp.setattr(cls, "for_hop", classmethod(lambda c, hop, mels=100, **kw: c(**TINY_HOP64)))


def _tiny_bigvgan_yaml(d):
    cfg = d / "tiny_bigvgan.yaml"
    cfg.write_text(open("tests/data/tiny.yaml").read()
                   .replace("mel_spec_type: vocos", "mel_spec_type: bigvgan"))
    return str(cfg)


def test_weight_norm_folds_at_load(tmp_path, monkeypatch):
    """A reference generator file (weight norm, filters, the ``generator``
    wrapper) loads into the port, through ``TTS(vocoder_local_path=...)`` too;
    the JAX converter of the same dict gives the same wave."""
    cfg = jbig.BigVGANConfig(**TINY_HOP64)
    rng = np.random.default_rng(5)
    model = bigvgan.BigVGAN(bigvgan.BigVGANConfig(**TINY_HOP64))
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith(".weight") and v.dim() == 3:
            p = k[: -len(".weight")]
            sd[f"{p}.weight_v"] = rng.standard_normal(tuple(v.shape)).astype(np.float32)
            sd[f"{p}.weight_g"] = rng.uniform(0.5, 1.5, (v.shape[0], 1, 1)).astype(np.float32)
        else:
            sd[k] = (0.2 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
    for a in range(4):  # the alias-free filters NVIDIA's generator stores
        sd[f"resblocks.0.activations.{a}.upsample.filter"] = np.ones((1, 1, 12), np.float32)
        sd[f"resblocks.0.activations.{a}.downsample.lowpass.filter"] = np.ones((1, 1, 12),
                                                                              np.float32)
    torch.save({"generator": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "bigvgan_generator.pt")
    found = weights.find_bigvgan_checkpoint(tmp_path)
    assert found == tmp_path / "bigvgan_generator.pt"
    assert weights.find_bigvgan_checkpoint(tmp_path / "none") is None
    state = weights.load_bigvgan_checkpoint(found)
    assert not any(k.endswith((".filter", "_g", "_v")) for k in state)
    model.load_state_dict(state)
    v, g = sd["conv_pre.weight_v"], sd["conv_pre.weight_g"]
    np.testing.assert_allclose(state["conv_pre.weight"].numpy(),
                               g * v / np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True)),
                               rtol=1e-6)
    params = {"params": jbig.convert_bigvgan({k: v for k, v in sd.items()
                                              if not k.endswith(".filter")}, cfg)}
    x = rng.standard_normal((1, 20, 9)).astype(np.float32)
    with torch.no_grad():
        _close(model.eval()(torch.from_numpy(x)).numpy(),
               jbig.BigVGAN(cfg=cfg).apply(params, jnp.asarray(x)))
    _tiny_for_hop(monkeypatch)
    kw = dict(model=_tiny_bigvgan_yaml(tmp_path), frontend=None, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TTS(**kw, vocoder_local_path=str(tmp_path))
        with pytest.raises(FileNotFoundError):
            TTS(**kw, vocoder_local_path=str(tmp_path / "none"))
    for k, v in state.items():
        torch.testing.assert_close(tts.vocoder.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("n,sr,n_fft,hop,n_mels", [(24000, 24000, 1024, 256, 100),
                                                  (8123, 8000, 256, 64, 20)])
def test_bigvgan_mel_matches_jax(n, sr, n_fft, hop, n_mels):
    rng = np.random.default_rng(n)
    t = np.arange(n) / sr
    wav = (0.3 * np.sin(2 * np.pi * 190 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    np.testing.assert_array_equal(mel.mel_filterbank_slaney(n_fft // 2 + 1, n_mels, sr),
                                  jmel.mel_filterbank_slaney(n_fft // 2 + 1, n_mels, sr))
    want = np.asarray(jmel.bigvgan_mel_spectrogram(jnp.asarray(wav), n_fft, hop, n_fft, sr,
                                                   n_mels))
    front = mel.MelFrontend(n_fft, hop, n_fft, n_mels, sr, mel_spec_type="bigvgan")
    got = front(torch.from_numpy(wav)[None])[0].numpy()
    assert got.shape == want.shape == (n_mels, n // hop)
    _close(got, want)


# ---------------------------------------------------------------- pipeline
@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX and port TTS on the tiny config with the BigVGAN mel and vocoder,
    the generator at the TINY widths in both."""
    d = tmp_path_factory.mktemp("bigvgan")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!"])
                     + "\n")
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _tiny_for_hop(mp)
        kw = dict(model=_tiny_bigvgan_yaml(d), vocab_file=str(vocab), frontend=None,
                  device="cpu")
        jtts, tts = JTTS(**kw), TTS(**kw)
    assert isinstance(tts.vocoder, bigvgan.BigVGAN) and tts.vocoder.cfg.total_upsample == 64
    tts.load_weights(weights.dit_state_from_jax(jtts.synth.dit_params),
                     weights.bigvgan_state_from_jax(jtts.synth.vocoder_params))
    return jtts, tts


def _reference(n=12000):
    rng = np.random.default_rng(0)
    t = np.arange(n) / 16000
    return (0.2 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("cfg_cutoff", [None, 0.5])
def test_synthesize_chunks_with_bigvgan_matches_jax(pair, cfg_cutoff):
    jtts, tts = pair
    noise = np.random.default_rng(1).standard_normal((512, 20)).astype(np.float32)
    kw = dict(nfe_steps=4, cfg_strength=2.0, sway_sampling_coef=1.0, cfg_cutoff=cfg_cutoff,
              max_duration=512)
    args = (_reference(), 16000, "hello there. ", ["general kenobi.", "you are a bold one."])
    jw, jsr, jm = jtts.synth.synthesize_chunks(*args, cfg=JSamplerConfig(**kw), seed=3,
                                               noise_override=noise)
    parts, sr, mels = tts.synth.synthesize_chunks(*args, cfg=SamplerConfig(**kw), seed=3,
                                                  noise_override=noise, return_parts=True)
    assert [len(w) for w in parts] == [64 * m.shape[0] for m in mels]  # frames x hop
    w, sr, m = tts.synth.synthesize_chunks(*args, cfg=SamplerConfig(**kw), seed=3,
                                           noise_override=noise)
    assert sr == jsr == 8000
    _close(m, jm)
    _close(w, jw)


def test_bigvgan_bucket_and_trims(pair):
    """The BigVGAN mel has ``T // hop`` frames (no ``+ 1``): the bucket estimate
    follows the JAX branch, and the requests path and ``vocode_batch`` trim
    ``frames x hop`` samples."""
    jtts, tts = pair
    cfg = SamplerConfig()
    for n in (16000, 33000, 65471):
        ref = np.zeros(n, np.float32)
        for units in ("x" * 40, "x" * 700):
            assert (tts.synth.estimate_bucket(ref, 16000, "hello. ", units, cfg)
                    == jtts.synth.estimate_bucket(ref, 16000, "hello. ", units, JSamplerConfig()))
    ref = _reference()
    assert tts.synth.ref_mel(ref[::2].copy()).shape[0] == 6000 // 64
    mels = [np.random.default_rng(i).standard_normal((n, 20)).astype(np.float32)
            for i, n in enumerate((30, 47))]
    waves = tts.synth.vocode_batch(mels)
    want = jtts.synth.vocode_batch(mels)
    for w, jw, m in zip(waves, want, mels):
        assert len(w) == len(jw) == 64 * m.shape[0]
        _close(w, jw)
    out = tts.synth.synthesize_requests(
        [dict(ref_wav=ref, ref_sr=16000, ref_units="hello there. ",
              gen_units="general kenobi.", seed=1)],
        cfg=SamplerConfig(nfe_steps=2, cfg_strength=2.0))
    w, sr, m = out[0]
    assert sr == 8000 and len(w) == 64 * m.shape[1] and np.isfinite(w).all()
