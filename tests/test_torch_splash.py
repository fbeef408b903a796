"""The splash attention backend of the port (K6 and ``attn_backend``)
against the JAX package on the CPU.

- ``splash_attention_plain`` against the JAX ``splash_attention``, whose
  Pallas kernel (``make_splash_mha``, JAX's own TPU kernel) runs here in
  interpret mode: ``_splash_kernel`` is patched to build it with
  ``interpret=True`` and the same ``FullMask``, which changes nothing else
  in the JAX package. Segment ids from the mask: a pad query attends the
  pad keys (its rows are held too, and differ from the key-mask function
  of K5), an all-masked batch row attends every key, no mask is one
  segment; masks that leave whole 128-key tiles of padding and a row that
  is mostly padding, on which the card's kernel skips tiles. f32
  ``rtol=2e-4``, bf16 rel-L2 <= 2e-2 (the bars of the kernels). At N % 128
  != 0 both packages compute ``sdpa``'s function (K5 here, XLA ``sdpa``
  there).
- The ``"xla"`` backend (``sdpa``, plain PyTorch) against JAX ``sdpa``, and
  ``attention``'s backend names.
- The DiT, MMDiT and UNetT at width 128 (2 heads x 64), depth 2, under
  ``"splash"`` and ``"xla"`` against the JAX modules with the same weights
  and backend, at a sequence (joint, or with the UNetT's time token) of 128
  or 256, where splash runs its kernel, and of 200, where it does not; the
  route is checked by counting the plain versions' calls. f32, 2e-4.
- ``TTS(attn_backend=...)`` on ``tests/data/tiny.yaml`` with pinned noise
  against the JAX ``TTS``; ``tts_multilingual --attn_backend splash`` on the
  CPU; an unknown backend raises ``ValueError``.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lemas_tts_tpu.ops.attention as jattn
from lemas_tts_tpu import TTS as JTTS
from lemas_tts_tpu.config import DiTArch as JArch
from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig
from lemas_tts_tpu.models.dit import DiT as JDiT
from lemas_tts_tpu.models.mmdit import MMDiT as JMMDiT
from lemas_tts_tpu.models.unett import UNetT as JUNetT
from lemas_tts_tpu_torch import TTS, weights
from lemas_tts_tpu_torch.config import DiTArch, SamplerConfig
from lemas_tts_tpu_torch.models.dit import DiT
from lemas_tts_tpu_torch.models.mmdit import MMDiT
from lemas_tts_tpu_torch.models.unett import UNetT
from lemas_tts_tpu_torch.ops import attention
from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

TINY = "tests/data/tiny.yaml"
ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1)
MEL, VOCAB = 20, 11


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _interpret_splash(heads: int, q_len: int, kv_len: int):
    """``make_splash_mha`` in interpret mode, built at each call: a kernel
    built under one ``jit`` trace holds that trace's mask arrays."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk,
        splash_attention_mask as sm,
    )

    mask = sm.MultiHeadMask([sm.FullMask((q_len, kv_len)) for _ in range(heads)])
    return sk.make_splash_mha(mask, head_shards=1, q_seq_shards=1, interpret=True)


@pytest.fixture
def jax_splash_interpreted(monkeypatch):
    """The JAX splash kernel in interpret mode, as its own tests run Pallas
    on the CPU."""
    monkeypatch.setattr(jattn, "_splash_kernel", _interpret_splash)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(seed, B, H, N, D, masking):
    rng = np.random.default_rng(seed)
    q, k, v = (2 * rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, N), bool)
    if masking == "tile_padding":  # whole 128-key tiles of padding behind the valid keys
        mask[0, max(N - 128 - 37, 37):] = False
        mask[1, N - 128:] = False
    elif masking == "mostly_padding":  # a tenth valid; row 1 one valid tile and a bit
        mask[0, N // 10:] = False
        if N >= 256:
            mask[1, 128 + N // 10:] = False
    else:
        mask[0, N - N // 4:] = False
    if masking == "all_masked":
        mask[1] = False
    return q, k, v, None if masking == "none" else mask


def _both(fn_jax, fn_port, q, k, v, mask, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(fn_jax(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             None if mask is None else jnp.asarray(mask)).astype(jnp.float32))
    got = fn_port(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                  None if mask is None else torch.from_numpy(mask)).float().numpy()
    return got, want


def _hold(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * np.abs(want).max())
    else:
        assert _rel_l2(got, want) <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D", [(128, 64), (256, 64), (128, 128), (384, 64), (512, 64),
                                 (256, 128)])
@pytest.mark.parametrize("masking", ["partial", "all_masked", "none", "tile_padding",
                                     "mostly_padding"])
def test_splash_plain_matches_jax_kernel(jax_splash_interpreted, dtype, N, D, masking):
    """Every row, pad query rows included, against JAX's splash kernel; the
    pad rows are held alone too (and, for a partly masked row, differ from
    what K5's key-mask function gives them)."""
    q, k, v, mask = _inputs(N + D, 2, 2, N, D, masking)
    got, want = _both(jattn.splash_attention, attention.splash_attention, q, k, v, mask, dtype)
    assert got.shape == want.shape == q.shape
    _hold(got, want, dtype)
    if mask is not None and not mask.all():
        pad = ~mask
        _hold(got.transpose(0, 2, 1, 3)[pad], want.transpose(0, 2, 1, 3)[pad], dtype)
    if masking == "partial":
        keymask = attention.vmem_attention_plain(
            *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask)).numpy()
        assert np.abs(keymask.transpose(0, 2, 1, 3)[pad]
                      - want.transpose(0, 2, 1, 3)[pad]).max() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masking", ["partial", "all_masked"])
def test_splash_at_ragged_n_is_sdpa(dtype, masking):
    """N 200: JAX hands splash to XLA ``sdpa``, the port to K5 (its plain
    version here); the two agree as ``tests/test_torch_attention_split.py``
    holds them."""
    q, k, v, mask = _inputs(7, 2, 2, 200, 64, masking)
    got, want = _both(jattn.splash_attention, attention.splash_attention, q, k, v, mask, dtype)
    _hold(got, want, dtype)
    ref, _ = _both(jattn.sdpa, attention.vmem_attention, q, k, v, mask, dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masking", ["partial", "all_masked", "none"])
def test_xla_backend_matches_jax_sdpa(dtype, masking):
    """The ``"xla"`` backend is JAX's ``sdpa`` at its rounding points (p
    normalised, then rounded): bit for bit in bf16 up to one rounding."""
    q, k, v, mask = _inputs(3, 2, 2, 200, 64, masking)
    got, want = _both(jattn.sdpa, lambda *a: attention.attention(*a, backend="xla"),
                      q, k, v, mask, dtype)
    _hold(got, want, dtype)


def test_attention_backend_names():
    q = torch.zeros(1, 2, 128, 64)
    for backend in attention.BACKENDS:
        assert attention.attention(q, q, q, None, backend=backend).shape == q.shape
    with pytest.raises(ValueError, match="backend"):
        attention.attention(q, q, q, None, backend="flash")
    with pytest.raises(ValueError, match="backend"):
        DiT(DiTArch(**ARCH), mel_dim=MEL, text_num_embeds=VOCAB, attn_backend="pallas")


@pytest.fixture
def plain_calls(monkeypatch):
    """Count the calls of each backend's plain version (the CPU route)."""
    calls = {"splash": 0, "xla": 0, "vmem": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name, attr in (("splash", "splash_attention_plain"), ("xla", "sdpa"),
                       ("vmem", "vmem_attention_plain")):
        monkeypatch.setattr(attention, attr, counting(name, getattr(attention, attr)))
    return calls


def _model_inputs(seed, B, N, nt):
    rng = np.random.default_rng(seed)
    x, cond = (rng.standard_normal((B, N, MEL)).astype(np.float32) for _ in range(2))
    text = np.full((B, nt), -1, np.int32)
    text[0, : nt - 5] = rng.integers(0, VOCAB, nt - 5)
    text[1, : nt // 3] = rng.integers(0, VOCAB, nt // 3)
    time = np.asarray([0.3, 0.8], np.float32)
    mask = np.arange(N)[None, :] < np.asarray([N - 29, N])[:, None]
    return x, cond, text, time, mask


# (backbone, N, text length, sequence the attention sees)
MODEL_CASES = [("DiT", 128, 40, 128), ("DiT", 200, 40, 200),
               ("MMDiT", 96, 32, 128), ("MMDiT", 100, 100, 200),
               ("UNetT", 127, 40, 128), ("UNetT", 199, 40, 200)]


@pytest.mark.parametrize("backend", ["splash", "xla"])
@pytest.mark.parametrize("backbone,N,nt,seq", MODEL_CASES)
def test_backbones_match_jax(jax_splash_interpreted, plain_calls, backend, backbone, N, nt,
                             seq):
    """The port's backbone under ``backend`` against the JAX one with the
    same weights and backend: K6's plain version runs once a block where the
    sequence is a multiple of 128, K5's where it is not (as JAX runs XLA
    ``sdpa``), and ``sdpa`` under ``"xla"``."""
    init = (jnp.zeros((1, 32, MEL)), jnp.zeros((1, 32, MEL)), jnp.zeros((1, 8), jnp.int32),
            jnp.zeros((1,)))
    if backbone == "DiT":
        jm = JDiT(arch=JArch(**ARCH), mel_dim=MEL, text_num_embeds=VOCAB, attn_backend=backend)
        params = jm.init(jax.random.key(0), *init)
        model = DiT(DiTArch(**ARCH), mel_dim=MEL, text_num_embeds=VOCAB, attn_backend=backend)
        model.load_state_dict(weights.dit_state_from_jax(params))
    elif backbone == "MMDiT":
        arch = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2)
        jm = JMMDiT(**arch, mel_dim=MEL, text_num_embeds=VOCAB, attn_backend=backend)
        params = jm.init(jax.random.key(0), *init)
        model = MMDiT(DiTArch(**arch), mel_dim=MEL, text_num_embeds=VOCAB, attn_backend=backend)
        model.load_state_dict(weights.mmdit_state_from_jax(params))
    else:
        arch = dict(ARCH, text_dim=None, text_mask_padding=False, pe_attn_head=1)
        jm = JUNetT(mel_dim=MEL, text_num_embeds=VOCAB, attn_backend=backend, **arch)
        params = jm.init(jax.random.key(0), *init)
        model = UNetT(DiTArch(**arch), mel_dim=MEL, text_num_embeds=VOCAB, attn_backend=backend)
        model.load_state_dict(weights.unett_state_from_jax(params))
    inputs = _model_inputs(0, 2, N, nt)
    want = np.asarray(jax.jit(jm.apply)(params, *(jnp.asarray(a) for a in inputs)))
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(a) for a in inputs)).numpy()
    assert got.shape == want.shape == (2, N, MEL)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * np.abs(want).max())
    route = "xla" if backend == "xla" else ("splash" if seq % 128 == 0 else "vmem")
    assert plain_calls == {k: (2 if k == route else 0) for k in plain_calls}


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("splash_tts")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!"])
                     + "\n")
    return vocab


@pytest.mark.parametrize("backend", ["splash", "xla"])
def test_tts_matches_jax(jax_splash_interpreted, plain_calls, vocab_file, backend):
    """``TTS(attn_backend=backend)`` on the tiny config: the blocks run the
    backend's route (duration bucket 256, so splash runs its kernel), and
    ``synthesize_chunks`` with pinned noise matches the JAX ``TTS`` with the
    same backend and weights (f32, 2e-4 of the peak)."""
    kw = dict(model=TINY, vocab_file=str(vocab_file), frontend=None, device="cpu",
              attn_backend=backend)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtts, tts = JTTS(**kw), TTS(**kw)
    tts.load_weights(weights.dit_state_from_jax(jtts.synth.dit_params),
                     weights.vocos_state_from_jax(jtts.synth.vocoder_params))
    assert all(b.attn.attn_backend == backend for b in tts.dit.transformer_blocks)
    rng = np.random.default_rng(0)
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(12000) / 16000)
           + 0.05 * rng.standard_normal(12000)).astype(np.float32)
    noise = rng.standard_normal((512, MEL)).astype(np.float32)
    cfg = dict(nfe_steps=2, cfg_strength=2.0, sway_sampling_coef=1.0, max_duration=512)
    args = (ref, 16000, "hello there. ", ["general kenobi."])
    jw, jsr, jmel = jtts.synth.synthesize_chunks(*args, cfg=JSamplerConfig(**cfg), seed=3,
                                                 noise_override=noise)
    w, sr, mel = tts.synth.synthesize_chunks(*args, cfg=SamplerConfig(**cfg), seed=3,
                                             noise_override=noise)
    assert sr == jsr and mel.shape == jmel.shape and w.shape == jw.shape
    np.testing.assert_allclose(mel, jmel, rtol=2e-4, atol=2e-4 * np.abs(jmel).max())
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-4 * np.abs(jw).max())
    # 2 steps x 2 blocks, the CFG pair in one batch
    assert plain_calls == {k: (4 if k == backend else 0) for k in plain_calls}


def test_tts_default_and_unknown_backend(vocab_file):
    """The port's default is ``"vmem"`` on either device (the JAX default
    off the TPU is ``"xla"``: a recorded delta); an unknown name raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TTS(model=TINY, vocab_file=str(vocab_file), frontend=None, device="cpu")
        assert tts.attn_backend == "vmem"
        assert all(b.attn.attn_backend == "vmem" for b in tts.dit.transformer_blocks)
        with pytest.raises(ValueError, match="backend"):
            TTS(model=TINY, vocab_file=str(vocab_file), device="cpu", attn_backend="flash")


def test_tts_cli_runs_splash_on_the_cpu(plain_calls, vocab_file, tmp_path):
    """``tts_multilingual --attn_backend splash --device cpu`` exits 0 with a
    finite WAV, its sampler on the splash route."""
    from lemas_tts_tpu_torch.scripts import tts_multilingual

    ref = tmp_path / "ref.wav"
    write_wav(str(ref), (0.2 * np.random.default_rng(1).standard_normal(16000))
              .astype(np.float32), 8000)
    out = tmp_path / "out.wav"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = tts_multilingual.main(["--attn_backend", "splash", "--device", "cpu", "--model",
                                    TINY, "--vocab_file", str(vocab_file), "--frontend", "none",
                                    "--ref_audio", str(ref), "--ref_text", "abc def",
                                    "--text", "hello", "--output_wave", str(out),
                                    "--nfe_step", "2", "--seed", "1"])
    w, sr = read_audio(str(out))
    assert rc == 0 and sr == 8000 and w.size > 0 and np.isfinite(w).all()
    assert plain_calls["splash"] == 4 and plain_calls["vmem"] == plain_calls["xla"] == 0
    with pytest.raises(SystemExit):
        tts_multilingual.build_parser().parse_args(["--attn_backend", "flash", "--ref_audio",
                                                    "a", "--ref_text", "b", "--text", "c"])
