"""The port's MMDiT backbone against the JAX MMDiT on the CPU, and the slice
through ``TTS`` with the MMDiT backbone.

Weights go through ``weights.mmdit_state_from_jax``. The JAX MMDiT is built
with ``attn_backend="vmem"``: its joint attention runs the split-head Pallas
kernel (K5) in interpret mode where the joint length N + nt is a multiple of
128, and XLA ``sdpa`` where it is not; the port runs K5's plain version at
every length. Width 128 (2 heads x 64), depth 3 (the last block
context-pre-only), f32. Tolerance 2e-4: a few blocks of f32 products summed
in another order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu import TTS as JTTS
from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig
from lemas_tts_tpu.models.mmdit import MMDiT as JMMDiT
from lemas_tts_tpu_torch import TTS
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.config import DiTArch, SamplerConfig
from lemas_tts_tpu_torch.models.mmdit import MMDiT

ARCH = dict(dim=128, depth=3, heads=2, dim_head=64, ff_mult=2)
MEL, VOCAB = 20, 11


def _build(qk_norm):
    jm = JMMDiT(**ARCH, mel_dim=MEL, text_num_embeds=VOCAB, qk_norm=qk_norm,
                attn_backend="vmem")
    params = jm.init(jax.random.key(0), jnp.zeros((1, 32, MEL)), jnp.zeros((1, 32, MEL)),
                     jnp.zeros((1, 8), jnp.int32), jnp.zeros((1,)))
    m = MMDiT(DiTArch(**ARCH, qk_norm=qk_norm), mel_dim=MEL, text_num_embeds=VOCAB)
    m.load_state_dict(weights.mmdit_state_from_jax(params))
    return jm, params, m.eval()


@pytest.fixture(scope="module")
def models():
    return _build(None)


def _inputs(seed, B, N, nt):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, MEL)).astype(np.float32)
    cond = rng.standard_normal((B, N, MEL)).astype(np.float32)
    text = np.full((B, nt), -1, np.int32)
    text[0, : nt - 9] = rng.integers(0, VOCAB, nt - 9)
    text[1, : nt // 3] = rng.integers(0, VOCAB, nt // 3)
    time = np.asarray([0.3, 0.8], np.float32)
    mask = np.arange(N)[None, :] < np.asarray([N - 29, N])[:, None]
    return x, cond, text, time, mask


def _compare(models, N, nt, drop_text=False):
    jm, params, m = models
    x, cond, text, time, mask = _inputs(0, 2, N, nt)
    ref = np.asarray(jm.apply(params, *(jnp.asarray(a) for a in (x, cond, text, time, mask)),
                              drop_text=drop_text))
    with torch.no_grad():
        got = m(*(torch.from_numpy(a) for a in (x, cond, text, time, mask)),
                drop_text=drop_text).numpy()
    assert got.shape == ref.shape == (2, N, MEL)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("N,nt", [(96, 32), (100, 40)], ids=["joint_128", "joint_140"])
@pytest.mark.parametrize("drop_text", [False, True])
def test_mmdit_matches_jax(models, N, nt, drop_text):
    _compare(models, N, nt, drop_text)


def test_mmdit_qk_norm_matches_jax():
    _compare(_build("rms_norm"), 96, 32)


def test_mmdit_hoisted_text_embed_matches_inline(models):
    _, _, m = models
    x, cond, text, time, mask = (torch.from_numpy(a) for a in _inputs(1, 2, 64, 24))
    with torch.no_grad():
        te = m.embed_text(text, 64)
        assert te.shape == (2, 24, ARCH["dim"])  # the text keeps its own length
        hoisted = m(x, cond, None, time, mask, text_embed=te)
        inline = m(x, cond, text, time, mask)
    torch.testing.assert_close(hoisted, inline, rtol=0, atol=0)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("mmdit_slice")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!"])
                     + "\n")
    with pytest.warns(UserWarning):
        jtts = JTTS(model="tests/data/tiny_mmdit.yaml", vocab_file=str(vocab), frontend=None,
                    device="cpu")
        tts = TTS(model="tests/data/tiny_mmdit.yaml", vocab_file=str(vocab), frontend=None,
                  device="cpu")
    tts.load_weights(weights.mmdit_state_from_jax(jtts.synth.dit_params),
                     weights.vocos_state_from_jax(jtts.synth.vocoder_params))
    return jtts, tts


def test_synthesize_chunks_with_mmdit_matches_jax(pair):
    """The whole slice with the MMDiT backbone: same noise (``noise_override``),
    CFG on, a few NFE steps; the text bucket gives the MMDiT its own text
    length. Tolerance 2e-4 of each output's peak, as for the DiT slice."""
    jtts, tts = pair
    assert isinstance(tts.dit, MMDiT)
    rng = np.random.default_rng(0)
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(12000) / 16000)
           + 0.05 * rng.standard_normal(12000)).astype(np.float32)
    noise = rng.standard_normal((512, MEL)).astype(np.float32)
    kw = dict(nfe_steps=4, cfg_strength=2.0, sway_sampling_coef=1.0, max_duration=512)
    args = (ref, 16000, "hello there. ", ["general kenobi.", "you are a bold one."])
    jw, jsr, jmel = jtts.synth.synthesize_chunks(*args, cfg=JSamplerConfig(**kw), seed=3,
                                                 noise_override=noise)
    w, sr, mel = tts.synth.synthesize_chunks(*args, cfg=SamplerConfig(**kw), seed=3,
                                             noise_override=noise)
    assert sr == jsr and mel.shape == jmel.shape and w.shape == jw.shape
    np.testing.assert_allclose(mel, jmel, rtol=2e-4, atol=2e-4 * np.abs(jmel).max())
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-4 * np.abs(jw).max())
