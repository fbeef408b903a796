"""UVR5 ``spec_utils``, the band-param registry and the rubberband wrapper of
the port against the JAX package on the CPU.

Every function of ``lemas_tts_tpu/uvr5/spec_utils.py`` is called in both
packages on the same inputs: the STFT pair and its stereo/mid-side
encodings, the band-split combination with the pre-filter (single- and
multi-band), the lp/hp ramps, the multi-band synthesis (with and without the
high end re-injected), mirroring, ensembling, the aggressiveness shaping,
``merge_artifacts``, ``normalize``, ``to_shape`` and the rubberband-gated
``augment_audio``. The registry holds the same 24 configs, parsed to the
same dicts. Tolerance: f32, ``rtol=2e-4, atol=2e-5`` relative to the peak;
the numpy-only functions are equal bit for bit.
"""

import json
import shutil
import zipfile

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lemas_tts_tpu.ops import resample as jresample
from lemas_tts_tpu.uvr5 import band_params as jbp
from lemas_tts_tpu.uvr5 import pyrb as jpyrb
from lemas_tts_tpu.uvr5 import spec_utils as jsu
from lemas_tts_tpu_torch.uvr5 import band_params, pyrb
from lemas_tts_tpu_torch.uvr5 import spec_utils as su

CPU = dict(device="cpu")
TINY_MP = {
    "bins": 88, "unstable_bins": 0, "reduction_bins": 0, "sr": 8000,
    "pre_filter_start": 85, "pre_filter_stop": 88,
    "mid_side": False, "mid_side_b": False, "mid_side_b2": False,
    "stereo_w": False, "stereo_n": False, "reverse": False,
    "band": {
        1: {"sr": 1000, "hl": 16, "n_fft": 64, "crop_start": 0, "crop_stop": 16,
            "lpf_start": 8, "lpf_stop": 12, "res_type": "polyphase"},
        2: {"sr": 2000, "hl": 32, "n_fft": 64, "crop_start": 4, "crop_stop": 24,
            "hpf_start": 8, "hpf_stop": 4, "lpf_start": 16, "lpf_stop": 24,
            "res_type": "polyphase"},
        3: {"sr": 4000, "hl": 64, "n_fft": 96, "crop_start": 10, "crop_stop": 30,
            "hpf_start": 12, "hpf_stop": 6, "lpf_start": 24, "lpf_stop": 32,
            "res_type": "polyphase"},
        4: {"sr": 8000, "hl": 128, "n_fft": 128, "crop_start": 16, "crop_stop": 48,
            "hpf_start": 24, "hpf_stop": 12, "res_type": "kaiser_fast"},
    },
}
ONE_BAND = {**TINY_MP, "bins": 64, "pre_filter_start": 50, "pre_filter_stop": 60,
            "band": {1: {"sr": 8000, "hl": 32, "n_fft": 128, "crop_start": 0,
                         "crop_stop": 64, "hpf_start": 0, "res_type": "polyphase"}}}


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


def _stereo(seed=0, n=4096):
    return (0.3 * np.random.default_rng(seed).standard_normal((2, n))).astype(np.float32)


def _cspec(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("length", [None, 3000, 5000])
def test_stft_istft_stereo_match_jax(length):
    x = _stereo()
    spec = su.stft_stereo(x, 256, 64, **CPU)
    close(spec, jsu.stft_stereo(x, 256, 64))
    close(su.istft_stereo(spec, 256, 64, length=length, **CPU),
          jsu.istft_stereo(spec, 256, 64, length=length))


@pytest.mark.parametrize("mode", ["plain", "mid_side", "mid_side_b2", "reverse"])
def test_wave_spectrogram_roundtrip_matches_jax(mode):
    flags = {k: k == mode for k in ("mid_side", "mid_side_b2", "reverse")}
    x = _stereo(1)
    spec = su.wave_to_spectrogram(x, 256, 1024, **flags, **CPU)
    close(spec, jsu.wave_to_spectrogram(x, 256, 1024, **flags))
    wave = su.spectrogram_to_wave(spec, 256, **flags, **CPU)
    close(wave, jsu.spectrogram_to_wave(spec, 256, **flags))
    gain = 0.5 if mode == "mid_side_b2" else 1.0  # the reference round-trips b2 at 0.5
    n = min(x.shape[1], wave.shape[1])
    np.testing.assert_allclose(wave[:, 256:n - 256], gain * x[:, 256:n - 256], atol=2e-3)


def test_resample_on_matches_jax():
    x = _stereo(2, 3000)
    close(su.resample_on(x, 8000, 44100, **CPU),
          jresample.resample(jnp.asarray(x), 8000, 44100))


def test_combine_spectrograms_matches_jax():
    specs = {1: _cspec((2, 32, 6), 3), 2: _cspec((2, 32, 5), 4)}
    bands = [{"crop_start": 0, "crop_stop": 16}, {"crop_start": 4, "crop_stop": 20}]
    got = su.combine_spectrograms(specs, bands, total_bins=32)
    np.testing.assert_array_equal(got, jsu.combine_spectrograms(specs, bands, total_bins=32))
    assert got.shape == (2, 33, 5)
    for fn in (su.combine_spectrograms, jsu.combine_spectrograms):  # crops past the bins
        with pytest.raises(ValueError):
            fn(specs, bands, total_bins=20)


@pytest.mark.parametrize("mp", [TINY_MP, ONE_BAND], ids=["4band", "1band"])
def test_band_chain_matches_jax(mp):
    """combine_spectrograms_mp (taper / ramp pre-filter) and
    cmb_spectrogram_to_wave (with and without the high end re-injected)."""
    x = _stereo(5, 8000)
    specs, waves = {}, {}
    top = max(mp["band"])
    for d in sorted(mp["band"], reverse=True):
        bp = mp["band"][d]
        waves[d] = x if d == top else su.resample_on(waves[d + 1], mp["band"][d + 1]["sr"],
                                                     bp["sr"], **CPU)
        specs[d] = su.wave_to_spectrogram(waves[d], bp["hl"], bp["n_fft"], **CPU)
    spec_m = su.combine_spectrograms_mp(specs, mp)
    close(spec_m, jsu.combine_spectrograms_mp(specs, mp))
    close(su.cmb_spectrogram_to_wave(spec_m, mp, **CPU), jsu.cmb_spectrogram_to_wave(spec_m, mp))
    bp = mp["band"][top]
    h = (bp["n_fft"] // 2 - bp["crop_stop"]) + (mp["pre_filter_stop"] - mp["pre_filter_start"])
    extra = _cspec((2, h, spec_m.shape[2]), 6)
    close(su.cmb_spectrogram_to_wave(spec_m, mp, h, extra, **CPU),
          jsu.cmb_spectrogram_to_wave(spec_m, mp, h, extra))


@pytest.mark.parametrize("window", [(20, 40), (40, 40), (5, 60)])
def test_fft_filters_equal_jax(window):
    spec = _cspec((2, 64, 8), 7)
    a, b = window
    np.testing.assert_array_equal(su.fft_lp_filter(spec, a, b), jsu.fft_lp_filter(spec, a, b))
    np.testing.assert_array_equal(su.fft_hp_filter(spec, b, a), jsu.fft_hp_filter(spec, b, a))


@pytest.mark.parametrize("args", [(100, 512, 128), (1000, 512, 64), (33, 64, 32)])
def test_make_padding_equals_jax(args):
    assert su.make_padding(*args) == jsu.make_padding(*args)


@pytest.mark.parametrize("algorithm", ["mirroring", "mirroring2"])
def test_mirroring_equals_jax(algorithm):
    spec, hi = _cspec((2, 64, 6), 8), _cspec((2, 10, 6), 9)
    np.testing.assert_array_equal(su.mirroring(algorithm, spec, hi, 40),
                                  jsu.mirroring(algorithm, spec, hi, 40))
    np.testing.assert_array_equal(su.mirroring_mp(algorithm, spec, hi, {"pre_filter_start": 40}),
                                  jsu.mirroring_mp(algorithm, spec, hi, {"pre_filter_start": 40}))
    with pytest.raises(ValueError):
        su.mirroring("nope", spec, hi, 40)


@pytest.mark.parametrize("algorithm", [su.MIN_SPEC, su.MAX_SPEC, su.AVERAGE])
def test_ensembling_equals_jax(algorithm):
    specs = [_cspec((2, 8, 10), 10), _cspec((2, 8, 12), 11), _cspec((2, 8, 11), 12)]
    got = su.ensembling(algorithm, specs)
    assert got.shape == (2, 8, 10)
    np.testing.assert_array_equal(got, jsu.ensembling(algorithm, specs))


@pytest.mark.parametrize("aggr", [
    {"value": 0.3, "split_bin": 5},
    {"value": 0.6, "split_bin": 3, "aggr_correction": {"left": 0.1, "right": -0.05}},
    {"value": 0, "split_bin": 5}])
@pytest.mark.parametrize("non_accom", [False, True])
def test_adjust_aggr_equals_jax(aggr, non_accom):
    mask = np.random.default_rng(13).uniform(0, 1, (2, 10, 4)).astype(np.float32)
    np.testing.assert_array_equal(su.adjust_aggr(mask, non_accom, aggr),
                                  jsu.adjust_aggr(mask, non_accom, aggr))


@pytest.mark.parametrize("ranges", [[(20, 90)], [(0, 80), (85, 128)], [(5, 10)], []])
def test_merge_artifacts_equals_jax(ranges):
    mask = np.zeros((2, 3, 128), np.float32)
    for a, b in ranges:
        mask[:, :, a:b] = 0.5
    np.testing.assert_array_equal(su.merge_artifacts(mask, min_range=16, fade_size=4),
                                  jsu.merge_artifacts(mask, min_range=16, fade_size=4))
    with pytest.raises(ValueError, match="fade_size"):
        su.merge_artifacts(mask, min_range=10, fade_size=32)


def test_normalize_and_to_shape_equal_jax():
    big = np.array([2.0, -4.0])
    for flag in (True, False):
        np.testing.assert_array_equal(su.normalize(big, flag), jsu.normalize(big, flag))
    assert su.normalize(big, False) is big
    x = np.ones((2, 3))
    np.testing.assert_array_equal(su.to_shape(x, (2, 5)), jsu.to_shape(x, (2, 5)))


def test_pyrb_and_augment_audio_match_jax(tmp_path):
    """The identity fast paths need no binary; the shell-out runs where
    ``rubberband`` is installed (same file as JAX's) and otherwise raises
    the reference's RuntimeError in both packages."""
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

    y = np.random.default_rng(0).uniform(-0.5, 0.5, 400).astype(np.float32)
    assert pyrb.time_stretch(y, 8000, 1.0) is y and pyrb.pitch_shift(y, 8000, 0) is y
    for mod in (pyrb, jpyrb):
        with pytest.raises(ValueError):
            mod.time_stretch(y, 8000, 0.0)
    src = tmp_path / "in.wav"
    write_wav(str(src), y, 8000)
    if shutil.which("rubberband"):
        for pitch in (False, True):
            out = su.augment_audio(str(tmp_path / "a.wav"), str(src), 1.5, is_pitch=pitch)
            jout = jsu.augment_audio(str(tmp_path / "b.wav"), str(src), 1.5, is_pitch=pitch)
            np.testing.assert_array_equal(read_audio(out)[0], read_audio(jout)[0])
    else:
        for fn in (su.augment_audio, jsu.augment_audio):
            with pytest.raises(RuntimeError, match="rubberband"):
                fn(str(tmp_path / "out.wav"), str(src), 1.5)


def test_band_registry_equals_jax(tmp_path):
    """Same 24 names, each parsed to the same dict (int band keys, stereo
    flags defaulted); the default param, a JSON path and a ``.pth`` with an
    embedded ``param.json`` too."""
    names = band_params.list_band_params()
    assert names == jbp.list_band_params() and len(names) == 24
    for name in names + [None]:
        mp = band_params.load_band_params(name)
        assert mp == jbp.load_band_params(name), name
        assert all(isinstance(k, int) for k in mp["band"])
    assert band_params.DEFAULT_PARAM == jbp.DEFAULT_PARAM
    path = tmp_path / "p.json"
    path.write_text(json.dumps({"bins": 8, "sr": 8000, "band": {"1": {"sr": 8000}}}))
    assert band_params.load_band_params(str(path)) == jbp.load_band_params(str(path))
    with zipfile.ZipFile(tmp_path / "m.pth", "w") as zf:
        zf.writestr("param.json", path.read_text())
    assert band_params.load_band_params(str(tmp_path / "m.pth")) == \
        jbp.load_band_params(str(tmp_path / "m.pth"))
    with pytest.raises(FileNotFoundError):
        band_params.load_band_params("no_such_config")
    assert band_params.PARAM_DIR != jbp.PARAM_DIR  # the port reads its own copies
