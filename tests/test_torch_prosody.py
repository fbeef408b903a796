"""The prosody-conditioned model of the port against the JAX package on the
CPU: kaldi fbank, the ECAPA-TDNN encoder, the DiT's prosody projection and
long skip, the sampler's prosody routes and the pipeline.

- ``kaldi_fbank`` / ``extract_fbank_16k`` on seeded audio (and audio shorter
  than one 400-sample frame): rtol 1e-5, atol 1e-5 of the peak (f32; two
  FFT libraries).
- ECAPA at narrow widths (the ``TINY`` config of ``tests/test_prosody.py``
  with an embedding of 512), weights carried over from JAX, with and without
  a frame mask, also with a row whose frames are all masked (finite, as in
  JAX); and against the reference-layout torch mirror
  ``tests/torch_ref/ecapa_torch.py`` through its state dict, and through a
  checkpoint file with the reference prefix.
- The DiT with ``prosody_text`` (shorter and longer than N) and with the long
  skip; ``sample_mel`` with prosody text against JAX's in each route (CFG,
  cutoff tail, block cache, midpoint).
- ``synthesize_chunks`` on ``tests/data/tiny.yaml`` with
  ``use_prosody_encoder`` and a Pretssel config at narrow widths against the
  JAX ``TTS`` with the same noise: plain, with ``cfg_cutoff``, with a block
  cache, and through ``edit_speech``. Dropping the prosody text or the
  ``prosody_to_mel`` offset moves the result outside the tolerance.
Tolerance for modules and pipelines: 2e-4 of the peak (f32), the repo's
usual bar.
"""

import json
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu import TTS as JTTS
from lemas_tts_tpu.cfm import sampler as jsampler
from lemas_tts_tpu.config import DiTArch as JArch
from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig
from lemas_tts_tpu.infer import editing as jediting
from lemas_tts_tpu.models.dit import DiT as JDiT
from lemas_tts_tpu.models.prosody import ECAPA_TDNN as JECAPA
from lemas_tts_tpu.models.prosody import ECAPAConfig as JECAPAConfig
from lemas_tts_tpu.models.prosody import ProsodyEncoder as JProsodyEncoder
from lemas_tts_tpu.ops import fbank as jfbank
from lemas_tts_tpu_torch import TTS, weights
from lemas_tts_tpu_torch.cfm import sampler
from lemas_tts_tpu_torch.cfm.sampler import DURATION_BUCKETS, pick_bucket
from lemas_tts_tpu_torch.config import DiTArch, SamplerConfig
from lemas_tts_tpu_torch.infer import editing
from lemas_tts_tpu_torch.infer.pipeline import Synthesizer
from lemas_tts_tpu_torch.models.dit import DiT
from lemas_tts_tpu_torch.models.prosody import (ECAPA_TDNN, ECAPAConfig, ProsodyEncoder,
                                                remap_prosody_state_dict)
from lemas_tts_tpu_torch.ops import fbank

TINY = "tests/data/tiny.yaml"
ECAPA_TINY = dict(channels=(32, 32, 32, 96), kernel_sizes=(5, 3, 3, 1), dilations=(1, 2, 3, 1),
                  attention_channels=16, res2net_scale=4, se_channels=16, global_context=True,
                  groups=(1, 1, 1, 1), embed_dim=512, input_dim=80)
ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1)


def _close(got, want, tol=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _pretssel_cfg(path):
    c = ECAPA_TINY
    path.write_text(json.dumps({"model": {
        "prosody_channels": list(c["channels"]), "prosody_kernel_sizes": list(c["kernel_sizes"]),
        "prosody_dilations": list(c["dilations"]),
        "prosody_attention_channels": c["attention_channels"],
        "prosody_res2net_scale": c["res2net_scale"], "prosody_se_channels": c["se_channels"],
        "prosody_global_context": c["global_context"], "prosody_groups": list(c["groups"]),
        "prosody_embed_dim": c["embed_dim"], "input_feat_per_channel": c["input_dim"]}}))
    return str(path)


# ------------------------------------------------------------------- fbank
@pytest.mark.parametrize("n", [16000, 40000, 400, 399, 100, 1])
def test_fbank_matches_jax(n):
    rng = np.random.default_rng(n)
    t = np.arange(n) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 230 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    want = jfbank.extract_fbank_16k(wav)
    got = fbank.extract_fbank_16k(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape and got.shape[1] == 80
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if n >= 400:  # the batched form and the bank itself
        batch = np.stack([wav, wav[::-1].copy()])
        np.testing.assert_allclose(fbank.kaldi_fbank(torch.from_numpy(batch)).numpy(),
                                   np.asarray(jfbank.kaldi_fbank(jnp.asarray(batch))),
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(fbank.kaldi_mel_banks(80, 512, 16000),
                                  jfbank.kaldi_mel_banks(80, 512, 16000))


# ------------------------------------------------------------------- ECAPA
@pytest.fixture(scope="module")
def ecapa():
    jm = JECAPA(cfg=JECAPAConfig(**ECAPA_TINY))
    params = jm.init(jax.random.key(3), jnp.zeros((1, 16, 80)))
    model = ECAPA_TDNN(ECAPAConfig(**ECAPA_TINY))
    model.load_state_dict(weights.prosody_state_from_jax(params))
    return jm, params, model.eval()


@pytest.mark.parametrize("masked", ["none", "mask", "all-masked-row"])
def test_ecapa_matches_jax(ecapa, masked):
    jm, params, model = ecapa
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 57, 80)).astype(np.float32)
    mask = None
    if masked != "none":
        last = 0 if masked == "all-masked-row" else 12
        mask = np.arange(57)[None, :] < np.asarray([57, 31, last])[:, None]
    want = np.asarray(jm.apply(params, jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    _close(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_ecapa_loads_the_reference_state_dict(tmp_path):
    """The reference layout (``tests/torch_ref/ecapa_torch.py``) loads by name
    into the port, directly and from a checkpoint file whose keys carry the
    reference's ``prosody_encoder.`` prefix, and both give the mirror's output;
    the JAX encoder built from the same file agrees too."""
    from tests.torch_ref.ecapa_torch import EcapaTorch

    c = ECAPA_TINY
    torch.manual_seed(5)
    ref = EcapaTorch(list(c["channels"]), list(c["kernel_sizes"]), list(c["dilations"]),
                     c["attention_channels"], c["res2net_scale"], c["se_channels"],
                     c["embed_dim"], c["input_dim"]).eval()
    model = ECAPA_TDNN(ECAPAConfig(**ECAPA_TINY)).eval()
    model.load_state_dict(remap_prosody_state_dict(ref.state_dict()))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 41, 80)).astype(np.float32))
    with torch.no_grad():
        want = ref(x).numpy()
        _close(model(x).numpy(), want)
    ckpt = tmp_path / "prosody_encoder_UnitY2.pt"
    torch.save({f"prosody_encoder.{k}": v for k, v in ref.state_dict().items()}, ckpt)
    cfg = _pretssel_cfg(tmp_path / "pretssel_cfg.json")
    enc = ProsodyEncoder.build(cfg, str(ckpt), allow_random=False)
    assert enc.cfg == ECAPAConfig(**ECAPA_TINY)
    _close(enc(x).numpy(), want)
    wav = (0.1 * np.random.default_rng(7).standard_normal(24000)).astype(np.float32)
    jenc = JProsodyEncoder.build(cfg, str(ckpt), allow_random=False)
    _close(enc.embed(wav).numpy(), jenc.embed(wav))
    with pytest.raises(FileNotFoundError):
        ProsodyEncoder.build(cfg, str(tmp_path / "missing.pt"), allow_random=False)


# --------------------------------------------------------------- DiT parts
def _dits(**kw):
    arch = dict(ARCH, long_skip_connection=kw.get("long_skip", False))
    pros = kw.get("prosody", False)
    jdit = JDiT(arch=JArch(**arch), mel_dim=20, text_num_embeds=11, use_prosody_encoder=pros)
    params = jdit.init(jax.random.key(1), jnp.zeros((1, 32, 20)), jnp.zeros((1, 32, 20)),
                       jnp.zeros((1, 8), jnp.int32), jnp.zeros((1,)),
                       prosody_text=jnp.zeros((1, 8, 512)) if pros else None)
    dit = DiT(DiTArch(**arch), mel_dim=20, text_num_embeds=11, use_prosody_encoder=pros)
    dit.load_state_dict(weights.dit_state_from_jax(params))
    return jdit, params, dit.eval()


@pytest.mark.parametrize("variant,nt", [("prosody", 40), ("prosody", 300), ("long_skip", 40),
                                        ("prosody+long_skip", 40)])
def test_dit_variants_match_jax(variant, nt):
    """The prosody projection (its text zero-padded to N, or cut) and the long
    skip connection."""
    jdit, params, dit = _dits(prosody="prosody" in variant, long_skip="long_skip" in variant)
    if "long_skip" in variant:
        assert dit.long_skip_connection.weight.shape == (128, 256)
    rng = np.random.default_rng(2)
    B, N = 2, 256
    x, cond = (rng.standard_normal((B, N, 20)).astype(np.float32) for _ in range(2))
    text = np.full((B, 40), -1, np.int32)
    text[:, :25] = rng.integers(0, 11, (B, 25))
    time = np.asarray([0.2, 0.7], np.float32)
    mask = np.arange(N)[None, :] < np.asarray([190, N])[:, None]
    pt = rng.standard_normal((B, nt, 512)).astype(np.float32) if "prosody" in variant else None
    want = np.asarray(jdit.apply(params, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(text),
                                 jnp.asarray(time), jnp.asarray(mask),
                                 prosody_text=None if pt is None else jnp.asarray(pt)))
    with torch.no_grad():
        got = dit(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(text),
                  torch.from_numpy(time), torch.from_numpy(mask),
                  prosody_text=None if pt is None else torch.from_numpy(pt)).numpy()
    _close(got, want)


PROSODY_MODES = {"cfg": {}, "cutoff": dict(cfg_cutoff=0.5), "cache": dict(spec="0-2:2+t2"),
                 "cache-cutoff": dict(cfg_cutoff=0.5, spec="0-22:2+t2"),
                 "midpoint": dict(method="midpoint"), "no-cfg": dict(cfg_strength=0.0)}


@pytest.mark.parametrize("mode", list(PROSODY_MODES))
def test_sampler_prosody_routes_match_jax(mode):
    """Each route of ``sample_mel`` takes the prosody text (a long-skip DiT, so
    the cached loop carries the residual too)."""
    jdit, params, dit = _dits(prosody=True, long_skip=True)
    kw = dict(PROSODY_MODES[mode])
    spec = kw.pop("spec", None)
    base = dict(steps=5, cfg_strength=2.0, sway_sampling_coef=1.0)
    base.update(kw)
    jset = jsampler.SamplerSettings(**base, **jsampler.block_cache_fields(spec, 2))
    tset = sampler.SamplerSettings(**base, **sampler.block_cache_fields(spec, 2))
    rng = np.random.default_rng(3)
    B, N, nt = 2, 64, 16
    cond = np.zeros((B, N, 20), np.float32)
    cond[:, :20] = rng.standard_normal((B, 20, 20))
    keep = np.zeros((B, N), bool)
    keep[:, :20] = True
    text = np.full((B, nt), -1, np.int32)
    text[:, :9] = rng.integers(0, 11, (B, 9))
    dur = np.asarray([N, 51], np.int32)
    y0 = rng.standard_normal((B, N, 20)).astype(np.float32)
    pt = np.broadcast_to(rng.standard_normal((B, 1, 512)), (B, nt, 512)).astype(np.float32)
    args = (cond, keep, text, dur, y0)
    want = np.asarray(jsampler.make_sampler(jdit, jset)(params, *map(jnp.asarray, args), None,
                                                        jnp.asarray(pt)))
    got = sampler.sample_mel(dit, **dict(zip(("cond", "cond_mask", "text_ids", "duration", "y0"),
                                              map(torch.from_numpy, args))),
                             time_grid=sampler.sway_time_grid(5, 1.0), settings=tset,
                             prosody_text=torch.from_numpy(pt)).numpy()
    _close(got, want)
    plain = sampler.sample_mel(dit, **dict(zip(("cond", "cond_mask", "text_ids", "duration",
                                                "y0"), map(torch.from_numpy, args))),
                               time_grid=sampler.sway_time_grid(5, 1.0), settings=tset).numpy()
    assert not np.allclose(plain, want, rtol=2e-4, atol=2e-4 * np.abs(want).max())


# ---------------------------------------------------------------- pipeline
@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("prosody")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!"])
                     + "\n")
    cfg = _pretssel_cfg(d / "pretssel_cfg.json")
    kw = dict(model=TINY, vocab_file=str(vocab), frontend=None, device="cpu",
              use_prosody_encoder=True, prosody_cfg_path=cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtts, tts = JTTS(**kw), TTS(**kw)
    tts.load_weights(weights.dit_state_from_jax(jtts.synth.dit_params),
                     weights.vocos_state_from_jax(jtts.synth.vocoder_params),
                     prosody_state=weights.prosody_state_from_jax(jtts.prosody_encoder.params),
                     prosody_to_mel_state=weights.prosody_to_mel_from_jax(jtts.prosody_to_mel))
    assert tts.synth.prosody_encoder.cfg == ECAPAConfig(**ECAPA_TINY)
    return jtts, tts, d


def _reference(n=12000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.2 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


PIPE = {"plain": {}, "cutoff": dict(cfg_cutoff=0.5), "cache": dict(block_cache="0-22:2+t2")}
ARGS = ("hello there. ", ["general kenobi.", "you are a bold one."])


def _chunks(pair, kw, seed=3):
    jtts, tts, _ = pair
    noise = np.random.default_rng(1).standard_normal((512, 20)).astype(np.float32)
    kw = dict(nfe_steps=4, cfg_strength=2.0, sway_sampling_coef=1.0, max_duration=512, **kw)
    ref = _reference()
    want = jtts.synth.synthesize_chunks(ref, 16000, *ARGS, cfg=JSamplerConfig(**kw), seed=seed,
                                        noise_override=noise)
    got = tts.synth.synthesize_chunks(ref, 16000, *ARGS, cfg=SamplerConfig(**kw), seed=seed,
                                      noise_override=noise)
    return got, want


@pytest.mark.parametrize("mode", list(PIPE))
def test_synthesize_chunks_with_prosody_matches_jax(pair, mode):
    (w, sr, mel), (jw, jsr, jmel) = _chunks(pair, PIPE[mode])
    assert sr == jsr
    _close(mel, jmel)
    _close(w, jw)


@pytest.mark.parametrize("drop", ["prosody_text", "offset", "both"])
def test_dropped_prosody_fails_the_parity(pair, drop, monkeypatch):
    """The parity above holds the prosody text and the offset: dropping either
    moves the mel outside its tolerance."""
    run = Synthesizer.run_sampler
    prep = Synthesizer._prepare_ref

    def no_text(self, *a):
        return run(self, *a[:7])

    def no_offset(self, *a):
        out = prep(self, *a)
        if out["prosody_offset"] is not None:
            out["prosody_offset"] = np.zeros_like(out["prosody_offset"])
        return out

    if drop in ("prosody_text", "both"):
        monkeypatch.setattr(Synthesizer, "run_sampler", no_text)
    if drop in ("offset", "both"):
        monkeypatch.setattr(Synthesizer, "_prepare_ref", no_offset)
    (_, _, mel), (_, _, jmel) = _chunks(pair, {})
    assert mel.shape == jmel.shape
    assert not np.allclose(mel, jmel, rtol=2e-4, atol=2e-4 * np.abs(jmel).max())


def test_prosody_switch_per_request(pair):
    """``use_prosody_encoder=False`` on a prosody model is the unconditioned
    request (as in JAX), and differs from the conditioned one."""
    _, tts, d = pair
    kw = dict(show_info=lambda *_: None, nfe_step=3, seed=2)
    ref = (_reference(), 16000)
    on = tts.infer(ref, "hello there", "general kenobi", **kw)
    off = tts.infer(ref, "hello there", "general kenobi", use_prosody_encoder=False, **kw)
    assert on[0].shape == off[0].shape and np.isfinite(on[0]).all()
    assert not np.allclose(on[2], off[2])
    cfg = SamplerConfig(use_prosody_encoder=False)
    assert not tts.synth.uses_prosody(cfg) and tts.synth.uses_prosody(SamplerConfig())


def test_requests_and_stream_carry_each_prosody(pair):
    """``synthesize_requests`` (which the JAX package runs without prosody)
    gives each row its own reference's conditioning: row i equals a
    ``synthesize_chunks`` of request i alone; ``synthesize_stream`` yields the
    parts ``synthesize_chunks`` gives."""
    _, tts, _ = pair
    cfg = SamplerConfig(nfe_steps=3, cfg_strength=2.0, sway_sampling_coef=1.0)
    refs = [_reference(12000, 0), _reference(12000, 5)]  # one duration bucket
    gen = "general kenobi, you are a bold one."
    reqs = [dict(ref_wav=r, ref_sr=16000, ref_units="hello there. ", gen_units=gen, seed=7 + i)
            for i, r in enumerate(refs)]
    rows = tts.synth.synthesize_requests(reqs, cfg=cfg)
    for (w, sr, mel), r in zip(rows, reqs):
        cw, csr, cmel = tts.synth.synthesize_chunks(r["ref_wav"], 16000, r["ref_units"], [gen],
                                                    cfg=cfg, seed=r["seed"])
        _close(mel, cmel)
        _close(w, cw)
    assert not np.allclose(rows[0][2][:, :50], rows[1][2][:, :50])
    chunks = ["general kenobi.", "you are a bold one.", "hello there."]
    streamed = [w for w, _ in tts.synth.synthesize_stream(refs[0], 16000, "hello there. ", chunks,
                                                          cfg=cfg, seed=4, chunk_batch=2)]
    parts, _, _ = tts.synth.synthesize_chunks(refs[0], 16000, "hello there. ", chunks, cfg=cfg,
                                              seed=4, return_parts=True)
    assert len(streamed) == len(parts)
    for a, b in zip(streamed, parts):
        _close(a, b)


def test_edit_speech_with_prosody_matches_jax(pair):
    jtts, tts, _ = pair
    sr, seed, tokens, parts = 8000, 5, list("abc def."), [(0.5, 1.0)]
    wav = (0.2 * np.random.default_rng(1).standard_normal(2 * sr)).astype(np.float32)
    kw = dict(nfe_steps=3, cfg_strength=2.0, sway_sampling_coef=1.0)
    jw, jsr, jmel = jediting.edit_speech(jtts.synth, wav, sr, tokens, parts,
                                         cfg=JSamplerConfig(**kw), seed=seed)
    frames = tts.synth.ref_mel(wav).shape[0]
    N = pick_bucket(max(max(len(tokens), frames) + 1, len(wav) // 64), DURATION_BUCKETS)
    noise = np.asarray(jax.random.normal(jax.random.key(seed), (N, 20), jnp.float32))
    w, out_sr, mel = editing.edit_speech(tts.synth, wav, sr, tokens, parts,
                                         cfg=SamplerConfig(**kw), seed=seed, noise_override=noise)
    assert out_sr == jsr
    _close(mel, jmel)
    _close(w, jw)


def test_reference_checkpoint_with_prosody_and_long_skip_loads(tmp_path):
    """A reference CFM checkpoint (EMA layout) whose DiT has the prosody
    projection and the long skip, and which carries ``prosody_to_mel``, loads
    into the port as the JAX loader reads it into the JAX ``TTS``."""
    cfg = tmp_path / "tiny_skip.yaml"
    cfg.write_text(open(TINY).read().replace("    conv_layers: 1",
                                             "    conv_layers: 1\n    long_skip_connection: true"))
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join([" "] + list("abcdefghij")) + "\n")
    kw = dict(model=str(cfg), vocab_file=str(vocab), frontend=None, device="cpu",
              use_prosody_encoder=True, prosody_cfg_path=_pretssel_cfg(tmp_path / "p.json"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        seeded = TTS(**kw)  # random weights to save in the reference layout
        state = {f"ema_model.transformer.{k}": v for k, v in seeded.dit.state_dict().items()}
        g = torch.Generator().manual_seed(3)
        state.update({"ema_model.prosody_to_mel.weight": torch.randn(20, 512, generator=g),
                      "ema_model.prosody_to_mel.bias": torch.randn(20, generator=g),
                      "ema_model.step": torch.tensor(3)})
        torch.save({"ema_model_state_dict": state}, tmp_path / "model.pt")
        tts = TTS(**kw, ckpt_file=str(tmp_path / "model.pt"))
        jtts = JTTS(**kw, ckpt_file=str(tmp_path / "model.pt"))
    assert tts.dit.long_skip_connection is not None and tts.dit.prosody_text_proj is not None
    for k, v in weights.dit_state_from_jax(jtts.synth.dit_params).items():
        torch.testing.assert_close(tts.dit.state_dict()[k], v, rtol=0, atol=0)
    for k, v in weights.prosody_to_mel_from_jax(jtts.prosody_to_mel).items():
        torch.testing.assert_close(tts.prosody_to_mel.state_dict()[k], v, rtol=0, atol=0)
        torch.testing.assert_close(v, state[f"ema_model.prosody_to_mel.{k}"], rtol=0, atol=0)
