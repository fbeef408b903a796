"""UVR5 MDX-Net of the port against the JAX package on the CPU, at the tiny
widths of ``tests/test_uvr5.py``.

- ``ConvTDFNet`` in both norm modes (GroupNorm; BatchNorm, which the JAX
  package folds into an affine): weights carried over from JAX params
  (``weights.mdx_state_from_jax``) and a reference-layout state dict
  (``tests/torch_ref/mdxnet_torch.py``, its GroupNorms swapped for
  BatchNorms with random statistics in the affine case) loaded as it is.
- ``MDXSeparator``: the packed STFT and its inverse, ``run_model``, the
  sign-flip average (odd in its input), ``demix`` with a ragged tail, the
  match-mix pass (returns its input), ``separate`` from 16 kHz with the
  background stem, ``from_file`` (``.pt`` with the ``model.`` prefix and
  ``.onnx``), ``infer_config_from_state_dict``, ``Mixer`` and the ``UVR5``
  facade's ``denoise_file``; the symmetric-window ``ops/stft.py`` and the
  resample to 44.1 kHz.
- ``device=None`` raises without CUDA, and a mesh of another device type
  is refused (``tests/test_torch_parallel.py`` runs real meshes).
Tolerance: f32, ``rtol=2e-4, atol=2e-5`` (``tests/test_uvr5.py``), relative
to the peak of waves and spectrograms.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.ops import resample as jresample
from lemas_tts_tpu.ops import stft as jstft
from lemas_tts_tpu.uvr5 import inference as jinf
from lemas_tts_tpu.uvr5 import mdxnet as jmdx
from lemas_tts_tpu.uvr5 import onnx_weights as jonnx
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.ops import resample, stft
from lemas_tts_tpu_torch.uvr5 import inference, mdxnet, onnx_weights
from tests.torch_ref.mdxnet_torch import ConvTDFNetTorch

SIZES = dict(dim_c=4, dim_f=24, dim_t=16, n_fft=64, hop=16, num_blocks=5, l=2, g=4, k=3, bn=2,
             bias=False)
CFG = {norm: mdxnet.MDXConfig(**SIZES, norm=norm) for norm in ("group", "affine")}
JCFG = {norm: jmdx.MDXConfig(**SIZES, norm=norm) for norm in ("group", "affine")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny CPU ops here run fastest on one thread, and the suite's
    parallel workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def close(got, want, rtol=2e-4, atol=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, np.abs(want).max()))


def _randomized(tree, rng):
    """Every leaf of a flax param tree redrawn: norm scales near 1, the rest
    small normals (the JAX init leaves norms at their identity)."""
    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "scale":
            return 1.0 + 0.2 * rng.standard_normal(leaf.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def jparams():
    """One JAX ``ConvTDFNet`` per norm mode, its params redrawn from a seed."""
    rng = np.random.default_rng(0)
    out = {}
    for norm, cfg in JCFG.items():
        p = jmdx.ConvTDFNet(cfg=cfg).init(jax.random.key(0),
                                          jnp.zeros((1, cfg.dim_t, cfg.dim_f, cfg.dim_c)))
        out[norm] = _randomized(p, rng)
    return out


@pytest.fixture(scope="module")
def seps(jparams):
    """(JAX, port) denoising separators on the same group-norm weights."""
    jsep = jinf.MDXSeparator(JCFG["group"], jparams["group"], batch_size=4)
    sep = inference.MDXSeparator(CFG["group"], weights.mdx_state_from_jax(jparams["group"]),
                                 batch_size=4, device="cpu")
    return jsep, sep


def _spec_input(seed, B=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, 4, SIZES["dim_t"], SIZES["dim_f"])).astype(np.float32)


def _jax_net(cfg, params, x):
    """JAX forward on a port-layout [B, C, T, F] input, back to that layout."""
    apply = jax.jit(jmdx.ConvTDFNet(cfg=cfg).apply)
    out = apply(params, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    return np.transpose(np.asarray(out), (0, 3, 1, 2))


@pytest.mark.parametrize("norm", ["group", "affine"])
def test_convtdfnet_from_jax_params(jparams, norm):
    model = mdxnet.ConvTDFNet(CFG[norm]).eval()
    model.load_state_dict(weights.mdx_state_from_jax(jparams[norm]))
    x = _spec_input(1)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    close(got, _jax_net(JCFG[norm], jparams[norm], x))


def _reference_state(norm, seed=3):
    """A reference-layout state dict: the torch mirror's, every tensor redrawn;
    for ``affine`` each GroupNorm becomes a BatchNorm with random statistics."""
    torch.manual_seed(seed)
    tm = ConvTDFNetTorch(SIZES["dim_c"], SIZES["dim_f"], SIZES["num_blocks"], SIZES["l"],
                         SIZES["g"], SIZES["k"], SIZES["bn"], SIZES["bias"])
    rng = np.random.default_rng(seed)
    sd = {k: (1.0 + 0.2 * rng.standard_normal(v.shape) if v.dim() == 1 and k.endswith("weight")
              else 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in tm.state_dict().items()}
    if norm == "affine":
        for k in [k for k, v in sd.items() if v.ndim == 1 and k.endswith(".weight")]:
            p = k[: -len(".weight")]
            sd[f"{p}.running_mean"] = (0.2 * rng.standard_normal(sd[k].shape)).astype(np.float32)
            sd[f"{p}.running_var"] = rng.uniform(0.5, 1.5, sd[k].shape).astype(np.float32)
    return sd


@pytest.mark.parametrize("norm", ["group", "affine"])
def test_convtdfnet_loads_reference_state_dict(norm):
    sd = _reference_state(norm)
    cfg = mdxnet.infer_config_from_state_dict(sd, n_fft=SIZES["n_fft"], hop=SIZES["hop"],
                                              dim_t=SIZES["dim_t"], norm=norm)
    assert cfg == CFG[norm]
    assert cfg == mdxnet.MDXConfig(**vars(jmdx.infer_config_from_state_dict(
        sd, n_fft=SIZES["n_fft"], hop=SIZES["hop"], dim_t=SIZES["dim_t"], norm=norm)))
    model = mdxnet.ConvTDFNet(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = _spec_input(2)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jp = {"params": jmdx.convert_convtdfnet(sd, JCFG[norm])}
    close(got, _jax_net(JCFG[norm], jp, x))


def test_pack_stft_and_unpack_istft_match_jax(seps):
    jsep, sep = seps
    rng = np.random.default_rng(4)
    mix = (0.3 * rng.standard_normal((3, 2, sep.chunk_size))).astype(np.float32)
    packed = sep.pack_stft(torch.from_numpy(mix)).numpy()  # [B, 4, T, F]
    jpacked = np.transpose(np.asarray(jsep.pack_stft(jnp.asarray(mix))), (0, 3, 1, 2))
    close(packed, jpacked)
    spec = _spec_input(5, B=3)
    wav = sep.unpack_istft(torch.from_numpy(spec)).numpy()
    jwav = np.asarray(jsep.unpack_istft(jnp.asarray(np.transpose(spec, (0, 2, 3, 1)))))
    assert wav.shape == (3, 2, sep.chunk_size)
    close(wav, jwav)


def test_run_model_matches_jax(seps):
    jsep, sep = seps
    rng = np.random.default_rng(6)
    mix = (0.3 * rng.standard_normal((4, 2, sep.chunk_size))).astype(np.float32)
    for match in (False, True):
        got = sep.run_model(mix, is_match_mix=match)
        assert got.shape == (2, 4 * sep.gen_size)
        close(got, jsep.run_model(mix, is_match_mix=match))


def test_sign_flip_average_is_odd(seps):
    """0.5 * (f(x) - f(-x)) is odd in x, as the JAX package's."""
    _, sep = seps
    spek = torch.from_numpy(_spec_input(7, B=1))
    a, b = sep.spec_to_spec(spek), sep.spec_to_spec(-spek)
    np.testing.assert_allclose(a.numpy(), -b.numpy(), rtol=1e-5, atol=1e-6)


def test_demix_ragged_tail_matches_jax(seps):
    """5 chunks at batch 4: the last batch is padded with zero chunks."""
    jsep, sep = seps
    rng = np.random.default_rng(8)
    x = (0.1 * rng.standard_normal((2, sep.gen_size * 4 + 123))).astype(np.float32)
    assert sep.initialize_mix(x)[0].shape[0] == 5
    got = sep.demix({0: x})
    assert got.shape == x.shape and np.isfinite(got).all()
    close(got, jsep.demix({0: x}))


def test_match_mix_returns_the_input(seps):
    """The match-mix pass skips the network: demix is the identity up to the
    zeroed lowest bins and the cropped top bins (``tests/test_uvr5.py``),
    and equals the JAX package's."""
    jsep, sep = seps
    t = np.arange(sep.gen_size * 3) / 44100
    hz = 12 * 44100 / SIZES["n_fft"]
    x = (0.5 * np.stack([np.sin(2 * np.pi * hz * t), np.cos(2 * np.pi * hz * t)])
         ).astype(np.float32)
    out = sep.demix({0: x}, is_match_mix=True)
    assert out.shape == x.shape
    assert np.abs(out[:, 64:-64] - x[:, 64:-64]).max() < 5e-2
    close(out, jsep.demix({0: x}, is_match_mix=True))


def test_separate_from_16k_with_background(seps):
    jsep, sep = seps
    rng = np.random.default_rng(9)
    sr = 16000
    t = np.arange(int(0.3 * sr)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.standard_normal(t.size)
           ).astype(np.float32)
    vocal, bg, out_sr = sep.separate(wav, sr, save_background=True)
    jvocal, jbg, jsr = jsep.separate(wav, sr, save_background=True)
    assert out_sr == jsr == 44100
    assert vocal.shape == (2, int(np.ceil(t.size * 44100 / sr)))
    close(vocal, jvocal)
    close(bg, jbg)


@pytest.mark.parametrize("sr", [24000, 16000])
def test_resample_to_44k_matches_jax(sr):
    rng = np.random.default_rng(sr)
    x = rng.standard_normal((2, sr // 5)).astype(np.float32)
    got = resample.resample(torch.from_numpy(x), sr, 44100).numpy()
    close(got, np.asarray(jresample.resample(jnp.asarray(x), sr, 44100)))


@pytest.mark.parametrize("length", [None, 700, 1000])
def test_stft_window_and_length_match_jax(length):
    """The symmetric window MDX uses, and ``length`` (trimmed or
    zero-padded) on the inverse; without ``window`` the periodic Hann is the
    default, bit for bit."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 900)).astype(np.float32)
    win = inference.hann_symmetric(64)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jinf.hann_symmetric(64)))
    spec = stft.stft(torch.from_numpy(x), 64, 16, window=win)
    jspec = jstft.stft(jnp.asarray(x), 64, 16, window=jinf.hann_symmetric(64))
    close(spec.numpy(), np.asarray(jspec))
    wav = stft.istft(spec, 64, 16, window=win, length=length)
    close(wav.numpy(), np.asarray(jstft.istft(jspec, 64, 16, window=jinf.hann_symmetric(64),
                                              length=length)))
    xt = torch.from_numpy(x)
    periodic = stft.hann_window(64)
    assert torch.equal(stft.stft(xt, 64, 16), stft.stft(xt, 64, 16, window=periodic))
    assert torch.equal(stft.istft(spec, 64, 16), stft.istft(spec, 64, 16, window=periodic))


def _pb_varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        out += bytes([b7 | (0x80 if v else 0)])
        if not v:
            return out


def _pb_field(num: int, wire: int, payload) -> bytes:
    tag = _pb_varint((num << 3) | wire)
    if wire == 0:
        return tag + _pb_varint(payload)
    return tag + _pb_varint(len(payload)) + payload


def _tensorproto(name: str, arr: np.ndarray) -> bytes:
    msg = b"".join(_pb_field(1, 0, d) for d in arr.shape)
    dtype = 7 if arr.dtype == np.int64 else 1
    msg += _pb_field(2, 0, dtype) + _pb_field(8, 2, name.encode())
    return msg + _pb_field(9, 2, arr.tobytes())


def _onnx_file(path, sd) -> None:
    """A hand-serialized ONNX ModelProto whose graph holds ``sd`` as
    initializers, plus a graph constant and an unrelated field."""
    graph = b"".join(_pb_field(5, 2, _tensorproto(k, v)) for k, v in sd.items())
    graph += _pb_field(5, 2, _tensorproto("onnx::Reshape_7", np.array([-1, 4], np.int64)))
    graph += _pb_field(2, 2, b"graphname")
    path.write_bytes(_pb_field(1, 0, 8) + _pb_field(7, 2, graph))


def test_onnx_reader_equals_jax(tmp_path):
    rng = np.random.default_rng(11)
    sd = {"first_conv.0.weight": rng.standard_normal((8, 4, 1, 1)).astype(np.float32),
          "first_conv.0.bias": rng.standard_normal(8).astype(np.float32)}
    _onnx_file(tmp_path / "m.onnx", sd)
    got = onnx_weights.load_onnx_initializers(str(tmp_path / "m.onnx"))
    want = jonnx.load_onnx_initializers(str(tmp_path / "m.onnx"))
    assert set(got) == set(want) == set(sd) | {"onnx::Reshape_7"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["onnx::Reshape_7"], [-1, 4])


@pytest.mark.parametrize("fmt", [".onnx", ".ckpt", ".pt"])
def test_from_file_matches_jax(tmp_path, fmt):
    """A group-norm model as ``.onnx`` initializers, a lightning-style
    ``.ckpt`` (``model.`` prefix) or a training ``.pt`` (``model_state_dict``)
    loads in both packages to the same denoiser; a BatchNorm ``.pt`` loads
    as ``norm="affine"``."""
    sd = _reference_state("group", seed=12)
    path = tmp_path / f"m{fmt}"
    if fmt == ".onnx":
        _onnx_file(path, sd)
    elif fmt == ".ckpt":
        torch.save({f"model.{k}": torch.from_numpy(v) for k, v in sd.items()}, path)
    else:
        torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    sep = inference.MDXSeparator.from_file(str(path), device="cpu")
    jsep = jinf.MDXSeparator.from_file(str(path))
    assert sep.cfg == mdxnet.MDXConfig(**vars(jsep.cfg))
    assert (sep.cfg.dim_f, sep.cfg.n_fft, sep.batch_size) == (24, 7680, 4)
    rng = np.random.default_rng(13)
    x = (0.1 * rng.standard_normal((2, 3000))).astype(np.float32)
    close(sep.demix({0: x}), jsep.demix({0: x}))
    if fmt == ".pt":
        bn = tmp_path / "bn.pt"
        torch.save({k: torch.from_numpy(v) for k, v in _reference_state("affine").items()}, bn)
        assert inference.MDXSeparator.from_file(str(bn), device="cpu").cfg.norm == "affine"


def test_mixer_matches_jax():
    rng = np.random.default_rng(5)
    n_stems, T = 4, 100
    w = rng.standard_normal((n_stems * 2, (n_stems + 1) * 2)).astype(np.float32)
    jp = {"params": jmdx.convert_mixer({"linear.weight": w})}
    x = rng.standard_normal((n_stems + 1, 2, T)).astype(np.float32)
    want = np.asarray(jmdx.Mixer(n_stems=n_stems).apply(jp, jnp.asarray(x)))
    mixer = mdxnet.Mixer(n_stems)
    mixer.load_state_dict(weights.mixer_state_from_jax(jp))
    assert torch.equal(mixer.linear.weight, torch.from_numpy(w))
    with torch.no_grad():
        close(mixer(torch.from_numpy(x)).numpy(), want)


def test_uvr5_denoise_file_matches_jax(tmp_path, seps):
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

    jsep, sep = seps
    sr = 16000
    t = np.arange(sr // 2) / sr
    wav = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    write_wav(str(tmp_path / "in.wav"), wav, sr)
    uvr = inference.UVR5(separator=sep)
    out_path = uvr.denoise_file(str(tmp_path / "in.wav"))
    assert out_path == str(tmp_path / "in_vocal.wav")
    den, out_sr = read_audio(out_path)
    assert out_sr == 44100 and den.shape == (1, int(np.ceil(t.size * 44100 / sr)))
    wav, _ = read_audio(str(tmp_path / "in.wav"))  # as denoise_file read it
    got, got_sr = uvr.denoise(wav, sr)
    want, want_sr = jinf.UVR5(separator=jsep).denoise(wav, sr)
    assert got.ndim == 1 and got_sr == want_sr == 44100
    close(got, want)
    # the file holds it truncated to 16 bits (x 32767) and read back (/ 32768)
    np.testing.assert_allclose(den[0], got, atol=2 / 32767)


def test_random_init_is_seeded_and_defaults_match_jax():
    """``random_init`` draws from an explicit generator; the batch defaults
    are the JAX package's (4 when denoising, 8 otherwise; the facade 8)."""
    a = inference.MDXSeparator.random_init(CFG["group"], torch.Generator().manual_seed(1),
                                           device="cpu")
    b = inference.MDXSeparator.random_init(CFG["group"], torch.Generator().manual_seed(1),
                                           device="cpu", is_denoise=False)
    c = inference.MDXSeparator.random_init(CFG["group"], torch.Generator().manual_seed(2),
                                           device="cpu")
    sa, sb, sc = (m.model.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert (a.batch_size, b.batch_size, a.compensate, a.adjust) == (4, 8, 1.035, 1.0)
    with pytest.warns(UserWarning, match="random init"):
        uvr = inference.UVR5(device="cpu")
    assert uvr.sep.batch_size == 8 and uvr.sep.cfg == mdxnet.MDXConfig()


def test_without_cuda_device_none_raises_and_mesh_is_refused(seps):
    from lemas_tts_tpu_torch.uvr5.vr_network import VRSeparator

    import types

    state = seps[1].model.state_dict()
    cuda_mesh = types.SimpleNamespace(device_type="cuda")  # a mesh of another device
    with pytest.raises(ValueError, match="cuda mesh"):
        inference.MDXSeparator(CFG["group"], state, device="cpu", mesh=cuda_mesh)
    with pytest.raises(ValueError, match="to the separator"):
        inference.UVR5(separator=seps[1], mesh=cuda_mesh)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None would run on it")
    for build in (lambda: inference.UVR5(),
                  lambda: inference.MDXSeparator(CFG["group"], state),
                  lambda: VRSeparator(n_fft=64, nout=8, nout_lstm=8)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(RuntimeError, match="CUDA"):
                build()
