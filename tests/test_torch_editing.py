"""Speech editing, the three CLIs and WAV decoding of the port, against the
JAX package on the CPU.

- ``parse_align_json`` and ``build_edit_mask`` equal JAX's on the cases of
  ``tests/test_editing_cli.py``.
- ``edit_speech`` on the tiny config (weights carried over from JAX) with
  JAX's noise, drawn as ``lemas_tts_tpu/infer/editing.py:172-174`` draws it,
  passed as the port's ``noise_override``: the mel agrees within 2e-4 of its
  peak (f32), and its kept frames equal the cond mel bit for bit.
- The CLIs run end to end with ``--device cpu``, fail without CUDA when no
  device is given, and pass ``--block_cache``, ``--ode_method midpoint``,
  the prosody flags, ``--attn_backend`` and an empty ``--ref_text`` (ASR)
  on as the JAX CLIs do; ``--denoise --uvr5_model`` cleans the reference as
  the JAX CLI does.
- 24-bit and float32 WAV (and EXTENSIBLE headers) read equal to the JAX
  package's WAV decoder, ``audioproc_wav_decode`` of ``native/audioproc.cpp``,
  which the test compiles into its own directory.
"""

import ctypes
import json
import pathlib
import struct
import subprocess
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lemas_tts_tpu import TTS as JTTS
from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig
from lemas_tts_tpu.infer import editing as jediting
from lemas_tts_tpu.scripts import g2p as jg2p
from lemas_tts_tpu_torch import TTS
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.cfm.sampler import DURATION_BUCKETS, pick_bucket
from lemas_tts_tpu_torch.config import SamplerConfig
from lemas_tts_tpu_torch.infer import editing
from lemas_tts_tpu_torch.scripts import g2p, speech_edit_multilingual, tts_multilingual
from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

TINY = "tests/data/tiny.yaml"
ALIGN = {
    "interval": [1.0, 4.0], "modified_index": [1, 2],
    "words": [{"word": "hello", "interval": [1.1, 1.6]},
              {"word": "world", "interval": [1.8, 2.4]},
              {"word": "bye", "interval": [2.6, 3.1]}],
    "modified_text": ["world", "earth"], "display_text": "hello world bye",
}
VOCAB = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["(en)", "(zh)", "_", ",", ".", "!", "?",
                                                      "#1", "#2", "#3", "#4"]


@pytest.mark.parametrize("case", [ALIGN, {**ALIGN, "modified_index": [0, 3]},
                                  {**ALIGN, "modified_index": [-2, 9], "interval": [0.0, 3.2]},
                                  {**ALIGN, "modified_index": [2, 2]}])
def test_parse_align_json_matches_jax(case, tmp_path):
    path = tmp_path / "a.json"
    path.write_text(json.dumps(case))
    for src in (case, str(path)):
        try:
            want = jediting.parse_align_json(src)
        except ValueError:
            with pytest.raises(ValueError):
                editing.parse_align_json(src)
            continue
        got = editing.parse_align_json(src)
        assert (got.utt_start, got.utt_end, got.parts_to_edit, got.target_text,
                got.display_text) == (want.utt_start, want.utt_end, want.parts_to_edit,
                                      want.target_text, want.display_text)


@pytest.mark.parametrize("parts,seconds,margin", [
    ([(0.5, 1.0)], 2, 0.0), ([(0.5, 1.0)], 2, 0.1), ([(0.5, 1.0), (2.0, 2.5)], 3, 0.0),
    ([(0.0, 0.3), (2.9, 3.5)], 3, 0.1)])
def test_build_edit_mask_matches_jax(parts, seconds, margin):
    args = (parts, 8000 * seconds, 8000, 64)
    np.testing.assert_array_equal(editing.build_edit_mask(*args, margin=margin),
                                  jediting.build_edit_mask(*args, margin=margin))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("edit")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    with pytest.warns(UserWarning):
        jtts = JTTS(model=TINY, vocab_file=str(d / "vocab.txt"), frontend="phone", device="cpu")
        tts = TTS(model=TINY, vocab_file=str(d / "vocab.txt"), device="cpu")
    tts.load_weights(weights.dit_state_from_jax(jtts.synth.dit_params),
                     weights.vocos_state_from_jax(jtts.synth.vocoder_params))
    return jtts, tts, d


@pytest.mark.parametrize("opts", [dict(), dict(no_ref_audio=True),
                                  dict(use_acc_grl=True, ref_ratio=0.5)])
def test_edit_speech_matches_jax(pair, opts):
    jtts, tts, _ = pair
    sr, seed, tokens, parts = 8000, 5, list("abc def."), [(0.5, 1.0)]
    wav = (0.2 * np.random.default_rng(1).standard_normal(2 * sr)).astype(np.float32)
    kw = dict(nfe_steps=3, cfg_strength=2.0, sway_sampling_coef=1.0, **opts)
    jw, jsr, jmel = jediting.edit_speech(jtts.synth, wav, sr, tokens, parts,
                                         cfg=JSamplerConfig(**kw), seed=seed)
    # JAX's noise, drawn as lemas_tts_tpu/infer/editing.py:172-174 draws it
    frames = tts.synth.ref_mel(wav).shape[0]
    N = pick_bucket(max(max(len(tokens), frames) + 1, len(wav) // 64), DURATION_BUCKETS)
    noise = np.asarray(jax.random.normal(jax.random.key(seed), (N, 20), jnp.float32))
    w, out_sr, mel = editing.edit_speech(tts.synth, wav, sr, tokens, parts,
                                         cfg=SamplerConfig(**kw), seed=seed, noise_override=noise)
    assert out_sr == jsr and mel.shape == jmel.shape and w.shape == jw.shape
    np.testing.assert_allclose(mel, jmel, rtol=2e-4, atol=2e-4 * np.abs(jmel).max())
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-4 * np.abs(jw).max())
    if not opts.get("no_ref_audio"):  # kept frames: the cond mel, bit for bit
        keep = editing.build_edit_mask(parts, len(wav), sr, 64)[:frames]
        cond = tts.synth.ref_mel(wav)
        np.testing.assert_array_equal(mel.T[:frames][keep], cond[keep])
        assert (mel.T[:frames][~keep] != cond[~keep]).any(axis=1).all()


def test_edit_speech_refuses_block_cache(pair):
    """The block cache, once refused, is ported: an edit with it (and CFG
    truncation) matches the JAX edit with it, as the plain edit above does,
    and the kept frames are still the cond mel bit for bit."""
    jtts, tts, _ = pair
    sr, seed, tokens, parts = 8000, 6, list("abc def."), [(0.5, 1.0)]
    wav = (0.2 * np.random.default_rng(2).standard_normal(2 * sr)).astype(np.float32)
    kw = dict(nfe_steps=5, cfg_strength=2.0, sway_sampling_coef=1.0, cfg_cutoff=0.5,
              block_cache="0-22:2+t2")
    jw, jsr, jmel = jediting.edit_speech(jtts.synth, wav, sr, tokens, parts,
                                         cfg=JSamplerConfig(**kw), seed=seed)
    frames = tts.synth.ref_mel(wav).shape[0]
    N = pick_bucket(max(max(len(tokens), frames) + 1, len(wav) // 64), DURATION_BUCKETS)
    noise = np.asarray(jax.random.normal(jax.random.key(seed), (N, 20), jnp.float32))
    w, out_sr, mel = editing.edit_speech(tts.synth, wav, sr, tokens, parts,
                                         cfg=SamplerConfig(**kw), seed=seed, noise_override=noise)
    assert tts.synth._settings(SamplerConfig(**kw)).block_cache_range == (0, 2)
    assert out_sr == jsr and mel.shape == jmel.shape
    np.testing.assert_allclose(mel, jmel, rtol=2e-4, atol=2e-4 * np.abs(jmel).max())
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-4 * np.abs(jw).max())
    keep = editing.build_edit_mask(parts, len(wav), sr, 64)[:frames]
    np.testing.assert_array_equal(mel.T[:frames][keep], tts.synth.ref_mel(wav)[keep])


def _edit_dirs(d):
    wav_dir, align_dir = d / "wavs", d / "align"
    wav_dir.mkdir(exist_ok=True)
    align_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(2)
    write_wav(str(wav_dir / "utt1.wav"), (0.2 * rng.standard_normal(3 * 8000)).astype(np.float32),
              8000)
    (align_dir / "utt1.json").write_text(json.dumps({**ALIGN, "interval": [0.0, 3.0]}))
    return wav_dir, align_dir


def test_cli_end_to_end_on_the_cpu(pair):
    """Both model CLIs with --device cpu write finite WAVs (and the
    spectrogram image)."""
    _, _, d = pair
    wav_dir, align_dir = _edit_dirs(d)
    model = ["--model", TINY, "--vocab_file", str(d / "vocab.txt"), "--device", "cpu",
             "--nfe_step", "2", "--cfg_strength", "1.0"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = speech_edit_multilingual.main(["--wav_dir", str(wav_dir), "--align_dir",
                                            str(align_dir), "--save_dir", str(d / "out"),
                                            "--seed", "3"] + model)
        assert rc == 0
        rc = tts_multilingual.main(["--ref_audio", str(wav_dir / "utt1.wav"), "--ref_text",
                                    "abc def", "--text", "hello world\nbye", "--output_wave",
                                    str(d / "gen.wav"), "--output_spec", str(d / "gen.png"),
                                    "--separate_langs", "--seed", "4"] + model)
        assert rc == 0
    for path in (d / "out" / "utt1.wav", d / "gen.wav"):
        w, sr = read_audio(str(path))
        assert sr == 8000 and w.size > 0 and np.isfinite(w).all()
    assert (d / "gen.png").stat().st_size > 0


@pytest.mark.parametrize("lines,separate", [(["hello world", "abc def"], False),
                                            (["你好 world", "the cat, #2 sat.", "", "hola amigo"],
                                             True)])
def test_g2p_cli_matches_jax(tmp_path, lines, separate):
    src = tmp_path / "in.txt"
    src.write_text("\n".join(lines) + "\n")
    flags = ["--input", str(src), "--workers", "1"] + (["--separate_langs"] if separate else [])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert g2p.main(flags + ["--output", str(tmp_path / "port.txt")]) == 0
        assert jg2p.main(flags + ["--output", str(tmp_path / "jax.txt")]) == 0
    got = (tmp_path / "port.txt").read_text()
    assert got == (tmp_path / "jax.txt").read_text() and got.count("\n") == len(lines)


def test_g2p_cli_worker_pool(tmp_path):
    """More than three lines and two workers: the spawn pool gives the
    in-process result."""
    src = tmp_path / "in.txt"
    src.write_text("\n".join(["hello world", "abc def", "the cat sat", "on the mat", "bye"]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert g2p.main(["--input", str(src), "--output", str(tmp_path / "a.txt"),
                         "--workers", "2"]) == 0
        assert g2p.main(["--input", str(src), "--output", str(tmp_path / "b.txt"),
                         "--workers", "1"]) == 0
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def _cli_args(d, cli):
    if cli == "tts":
        return tts_multilingual.main, ["--ref_audio", str(d / "wavs" / "utt1.wav"), "--ref_text",
                                       "abc", "--text", "hi", "--output_wave", str(d / "x.wav"),
                                       "--model", TINY, "--vocab_file", str(d / "vocab.txt")]
    return speech_edit_multilingual.main, ["--wav", str(d / "wavs" / "utt1.wav"), "--align_dir",
                                           str(d / "align"), "--save_dir", str(d / "x"),
                                           "--model", TINY, "--vocab_file", str(d / "vocab.txt")]


@pytest.mark.parametrize("cli", ["tts", "edit"])
def test_cli_without_cuda_fails(pair, cli):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run on it")
    _edit_dirs(pair[2])
    main, args = _cli_args(pair[2], cli)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)


@pytest.mark.parametrize("cli,flags,feature", [
    ("tts", ["--denoise"], "denoise"), ("tts", ["--block_cache", "0-2:2"], "block_cache"),
    ("tts", ["--ode_method", "midpoint"], "midpoint"),
    ("tts", ["--enable_prosody_encoder"], "prosody"), ("tts", ["--ref_text", ""], "ASR"),
    ("tts", ["--attn_backend", "vmem"], "attn_backend"),
    ("edit", ["--ode_method", "midpoint"], "midpoint"),
    ("edit", ["--use_prosody_encoder"], "prosody"),
    ("edit", ["--attn_backend", "xla"], "attn_backend")])
def test_cli_refuses_unported_flags(pair, cli, flags, feature, monkeypatch):
    """Every flag here, once refused, is ported: the CLI runs end to end on
    the CPU, and hands the sampler the settings the JAX CLI hands its
    sampler for the same flags (``--block_cache``, ``--ode_method
    midpoint``, the prosody flags ``--enable_prosody_encoder`` /
    ``--use_prosody_encoder``), the attention backend its JAX model gets
    (``--attn_backend``), or the reference units of the same transcript
    (an empty ``--ref_text``: both packages' ``transcribe`` are replaced by
    one stub, which must see the same reference audio). The prosody runs
    take a Pretssel config at narrow widths (``--prosody_cfg_path``) in both
    packages, and the port's synthesizer then conditions on prosody.
    ``--denoise`` is ported too: see ``_denoise_case``."""
    _edit_dirs(pair[2])
    main, args = _cli_args(pair[2], cli)
    argv = args + flags + ["--device", "cpu", "--nfe_step", "2"]
    if feature == "denoise":
        _denoise_case(pair[2], argv, monkeypatch)
        return
    if feature == "prosody":
        cfg = pair[2] / "pretssel_cfg.json"
        cfg.write_text(json.dumps({"model": {
            "prosody_channels": [32, 32, 32, 96], "prosody_kernel_sizes": [5, 3, 3, 1],
            "prosody_dilations": [1, 2, 3, 1], "prosody_attention_channels": 16,
            "prosody_res2net_scale": 4, "prosody_se_channels": 16,
            "prosody_global_context": True, "prosody_groups": [1, 1, 1, 1],
            "prosody_embed_dim": 512, "input_feat_per_channel": 80}}))
        argv += ["--prosody_cfg_path", str(cfg)]
    heard = {}
    if feature == "ASR":
        from lemas_tts_tpu.infer import asr as jasr
        from lemas_tts_tpu.infer import preprocess as jpreprocess
        from lemas_tts_tpu_torch.infer import asr, preprocess

        def stub(side):
            def transcribe(ref_audio, language=None, device=None):
                heard[side] = ref_audio
                return "abc def"
            return transcribe

        monkeypatch.setattr(asr, "transcribe", stub("port"))
        monkeypatch.setattr(jasr, "transcribe", stub("jax"))
        monkeypatch.setattr(preprocess, "_ref_audio_cache", {})
        monkeypatch.setattr(jpreprocess, "_ref_audio_cache", {})
    from lemas_tts_tpu.infer import editing as jediting_mod
    from lemas_tts_tpu.infer.pipeline import Synthesizer as JSynthesizer
    from lemas_tts_tpu.scripts import speech_edit_multilingual as jedit_cli
    from lemas_tts_tpu.scripts import tts_multilingual as jtts_cli
    from lemas_tts_tpu_torch.infer.pipeline import Synthesizer

    class Seen(Exception):
        pass

    seen = {}

    def spy(key, fn=None):
        def wrapped(*a, **kw):
            seen[key], seen[f"{key} synth"], seen[f"{key} units"] = kw["cfg"], a[0], a[1:4]
            if fn is None:  # the JAX side: the settings are all it is asked for
                raise Seen
            return fn(*a, **kw)
        return wrapped

    if cli == "tts":
        monkeypatch.setattr(Synthesizer, "synthesize_chunks",
                            spy("port", Synthesizer.synthesize_chunks))
        monkeypatch.setattr(JSynthesizer, "synthesize_chunks", spy("jax"))
        jmain = jtts_cli.main
    else:
        monkeypatch.setattr(editing, "edit_speech", spy("port", editing.edit_speech))
        monkeypatch.setattr(jediting_mod, "edit_speech", spy("jax"))
        jmain = jedit_cli.main
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert main(argv) == 0
        with pytest.raises(Seen):
            jmain(argv)
    fields = ("nfe_steps", "cfg_strength", "sway_sampling_coef", "cfg_cutoff", "block_cache",
              "ode_method", "use_prosody_encoder")
    got = {f: getattr(seen["port"], f) for f in fields}
    assert got == {f: getattr(seen["jax"], f) for f in fields}
    if feature == "attn_backend":
        backend = flags[1]
        assert seen["jax synth"].dit_model.attn_backend == backend
        assert {b.attn.attn_backend for b in seen["port synth"].dit_model.transformer_blocks} \
            == {backend}
    elif feature == "ASR":
        (pw, psr), (jw, jsr) = heard["port"], heard["jax"]
        np.testing.assert_array_equal(pw, jw)
        assert psr == jsr == 8000
        units = seen["port units"][2]  # the phone units of "abc def. "
        assert units == seen["jax units"][2] and units[0] == "(en)" and len(units) > 4
    else:
        field, value = {"block_cache": ("block_cache", "0-2:2"),
                        "midpoint": ("ode_method", "midpoint"),
                        "prosody": ("use_prosody_encoder", True)}[feature]
        assert got[field] == value
    assert seen["port synth"].uses_prosody(seen["port"]) == (feature == "prosody")
    out = pair[2] / ("x.wav" if cli == "tts" else "x/utt1.wav")
    w, sr = read_audio(str(out))
    assert sr == 8000 and w.size > 0 and np.isfinite(w).all()


def _denoise_case(d, argv, monkeypatch):
    """``--denoise`` without ``--uvr5_model`` returns 2 in both CLIs, as the
    JAX CLI refuses a random network. With a tiny MDX ``.pt`` (random from a
    seed, at the 7680-point STFT ``infer_config_from_state_dict`` assumes)
    the port's CLI runs end to end on the CPU: it writes the reference's
    ``_vocal.wav`` at 44.1 kHz and synthesizes from it; its denoised
    reference equals the JAX CLI's (f32, ``rtol=2e-4, atol=2e-5`` of the
    peak)."""
    import torch

    from lemas_tts_tpu.infer.pipeline import Synthesizer as JSynthesizer
    from lemas_tts_tpu.scripts import tts_multilingual as jtts_cli
    from lemas_tts_tpu.uvr5 import inference as jinference
    from lemas_tts_tpu_torch.infer.pipeline import Synthesizer
    from lemas_tts_tpu_torch.uvr5 import inference, mdxnet

    assert tts_multilingual.main(argv) == 2
    assert jtts_cli.main(argv) == 2
    cfg = mdxnet.MDXConfig(dim_f=24, num_blocks=5, l=2, g=4, bn=2)
    model = mdxnet.seeded_init_(mdxnet.ConvTDFNet(cfg), torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), d / "tiny_mdx.pt")
    argv = argv + ["--uvr5_model", str(d / "tiny_mdx.pt")]

    class Seen(Exception):
        pass

    seen = {}

    def record(key, fn):
        def wrapped(self, *a, **kw):
            seen[key] = fn(self, *a, **kw)
            return seen[key]
        return wrapped

    def synth_spy(self, wav, sr, *a, **kw):
        seen["synth sr"] = sr
        return synthesize_chunks(self, wav, sr, *a, **kw)

    def stop(*a, **kw):
        raise Seen

    synthesize_chunks = Synthesizer.synthesize_chunks
    monkeypatch.setattr(inference.UVR5, "denoise", record("port", inference.UVR5.denoise))
    monkeypatch.setattr(jinference.UVR5, "denoise", record("jax", jinference.UVR5.denoise))
    monkeypatch.setattr(Synthesizer, "synthesize_chunks", synth_spy)
    monkeypatch.setattr(JSynthesizer, "synthesize_chunks", stop)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tts_multilingual.main(argv) == 0
        vocal, vsr = read_audio(str(d / "wavs" / "utt1_vocal.wav"))
        with pytest.raises(Seen):
            jtts_cli.main(argv)
    (got, got_sr), (want, want_sr) = seen["port"], seen["jax"]
    assert got_sr == want_sr == vsr == seen["synth sr"] == 44100
    assert got.shape == want.shape == (vocal.shape[-1],) == (3 * 44100,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * np.abs(want).max())
    w, sr = read_audio(str(d / "x.wav"))
    assert sr == 8000 and w.size > 0 and np.isfinite(w).all()


def _wav_bytes(samples: np.ndarray, fmt: int, bits: int, extensible: bool) -> bytes:
    ch = samples.shape[0]
    data = np.moveaxis(samples, 0, 1).tobytes()  # [T, ch, ...]: interleaved frames
    if extensible:
        fmt_ck = struct.pack("<HHIIHHHHIH14s", 0xFFFE, ch, 8000, 8000 * ch * bits // 8,
                             ch * bits // 8, bits, 22, bits, 0, fmt, b"\x00" * 14)
    else:
        fmt_ck = struct.pack("<HHIIHH", fmt, ch, 8000, 8000 * ch * bits // 8, ch * bits // 8,
                             bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_ck)) + fmt_ck
            + b"LIST" + struct.pack("<I", 4) + b"INFO"
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.fixture(scope="module")
def audioproc(tmp_path_factory):
    """The JAX package's WAV decoder (``native/audioproc.cpp``), compiled with
    the flags of ``native/Makefile`` into this module's own directory and
    loaded with the argtypes of ``lemas_tts_tpu/native/audio.py``: the
    reference does not depend on a shared ``native/build`` that parallel
    test workers may be building at the same time."""
    src = pathlib.Path(__file__).resolve().parent.parent / "native" / "audioproc.cpp"
    so = tmp_path_factory.mktemp("audioproc") / "libaudioproc.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
                    "-fvisibility=hidden", "-shared", "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.audioproc_wav_info.restype = ctypes.c_int
    lib.audioproc_wav_info.argtypes = [u8p, i64, ctypes.POINTER(i32), ctypes.POINTER(i32),
                                       ctypes.POINTER(i64)]
    lib.audioproc_wav_decode.restype = ctypes.c_int
    lib.audioproc_wav_decode.argtypes = [u8p, i64, f32p]

    def decode(data: bytes):
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        ch, sr, frames = i32(), i32(), i64()
        assert lib.audioproc_wav_info(buf, len(data), ctypes.byref(ch), ctypes.byref(sr),
                                      ctypes.byref(frames)) == 0
        out = np.empty((ch.value, frames.value), dtype=np.float32)
        assert lib.audioproc_wav_decode(buf, len(data),
                                        out.ctypes.data_as(f32p)) == 0
        return out, sr.value

    return decode


@pytest.mark.parametrize("kind", ["pcm24", "float32", "pcm24-ext", "float32-ext", "pcm16",
                                  "pcm32"])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_audio_matches_jax(tmp_path, audioproc, kind, channels):
    rng = np.random.default_rng(channels)
    x = np.clip(0.5 * rng.standard_normal((channels, 4001)), -1, 0.999).astype(np.float32)
    if kind.startswith("float32"):
        samples, fmt, bits = x.astype("<f4"), 3, 32
    elif kind.startswith("pcm24"):
        v = np.round(x * 8388607).astype("<i4")
        samples = v.view(np.uint8).reshape(channels, -1, 4)[..., :3]  # little-endian 3 bytes
        fmt, bits = 1, 24
    elif kind == "pcm16":
        samples, fmt, bits = np.round(x * 32767).astype("<i2"), 1, 16
    else:
        samples, fmt, bits = np.round(x * 2 ** 31 * 0.999).astype("<i4"), 1, 32
    path = tmp_path / f"{kind}.wav"
    path.write_bytes(_wav_bytes(np.ascontiguousarray(samples), fmt, bits, kind.endswith("ext")))
    got, sr = read_audio(str(path))
    want, jsr = audioproc(path.read_bytes())
    assert sr == jsr == 8000 and got.dtype == np.float32 and got.shape == (channels, 4001)
    np.testing.assert_array_equal(got, want)
    if kind.startswith(("float32", "pcm24")):
        np.testing.assert_allclose(got, x, atol=2 ** -22)


def test_read_audio_refuses_other_formats(tmp_path, monkeypatch):
    """With neither ``soundfile`` nor ``ffmpeg`` at hand, a container other
    than WAV raises, naming both; a WAV of a format neither decoder takes
    raises with its tag."""
    import sys

    (tmp_path / "b.wav").write_bytes(_wav_bytes(np.zeros((1, 8), np.uint8), 6, 8, False))
    with pytest.raises(ValueError, match="format tag 6"):
        read_audio(str(tmp_path / "b.wav"))
    monkeypatch.setitem(sys.modules, "soundfile", None)  # import soundfile -> ImportError
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    (tmp_path / "a.mp3").write_bytes(b"ID3")
    with pytest.raises(NotImplementedError, match="soundfile.*ffmpeg"):
        read_audio(str(tmp_path / "a.mp3"))
