"""UVR5 VR-arch ``CascadedNet`` and ``VRSeparator`` of the port against the
JAX package on the CPU, at narrow widths (``tests/test_vr_network.py``,
``tests/test_vr_legacy.py``); the legacy ``CascadedASPPNet`` is in
``tests/test_torch_vr_legacy.py``.

- ``CascadedNet`` (the BiLSTM cascade) loaded from the torch mirror's state
  dict (``tests/torch_ref/vr_torch.py``) as it is, and from the JAX
  package's variables (``weights.cascadednet_state_from_jax``), against the
  JAX forward.
- The upsampling (``F.interpolate(align_corners=True)``) against the JAX
  package's ``bilinear_2x_align_corners`` on odd sizes.
- ``VRSeparator.separate_full`` single-band (with ``aggressiveness`` and
  ``post_process``) and multi-band on a 4-band config (with and without the
  mirrored high end), against JAX's; seeded random init.
Tolerance: f32, ``rtol=2e-4, atol=2e-5`` relative to the peak.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.uvr5 import vr_network as jvr
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.uvr5 import vr_network
from tests.torch_ref.vr_torch import CascadedNetTorch

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


def _random_sd(module: torch.nn.Module, seed: int):
    """The module's state dict with every float tensor redrawn (running
    variances positive), as numpy."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if "num_batches" in k:
            continue
        t = torch.randn(v.shape, generator=g) * 0.1
        sd[k] = (t.abs() + 0.5 if "running_var" in k else t).numpy()
    return sd


def _load(model: torch.nn.Module, sd) -> torch.nn.Module:
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()})
    return model.eval()


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def cascaded():
    """A CascadedNet (n_fft 64, nout 8, LSTM 8) as a reference state dict and
    as the JAX variables converted from it."""
    sd = _random_sd(CascadedNetTorch(64, nout=8, nout_lstm=8), seed=1)
    variables, n_fft, nout, nout_lstm = jvr.convert_cascadednet(sd)
    assert vr_network.cascadednet_hparams(sd) == (n_fft, nout, nout_lstm) == (64, 8, 8)
    return sd, variables


def test_cascadednet_matches_jax(cascaded):
    sd, variables = cascaded
    x = np.abs(np.random.default_rng(0).standard_normal((2, 2, 33, 16))).astype(np.float32)
    net = jvr.CascadedNet(n_fft=64, nout=8, nout_lstm=8)
    want = np.asarray(jax.jit(net.apply)(variables, jnp.asarray(x)))
    from_ref = _load(vr_network.CascadedNet(64, 8, 8), sd)
    from_jax = _load(vr_network.CascadedNet(64, 8, 8),
                     weights.cascadednet_state_from_jax(variables))
    for model in (from_ref, from_jax):
        got = _forward(model, x)
        assert got.min() >= 0 and got.max() <= 1
        close(got, want)


@pytest.mark.parametrize("shape", [(1, 3, 5, 2), (2, 4, 7, 3)])
def test_upsampling_matches_jax_bilinear(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)  # [B, C, F, T]
    got = vr_network.upsample_cat(torch.from_numpy(x), None).numpy()
    want = np.asarray(jvr.bilinear_2x_align_corners(jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))
    close(got, np.transpose(want, (0, 3, 1, 2)), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def single_band(cascaded):
    """(JAX, port) single-band separators on the same weights: n_fft 64,
    hop 16, 96-frame windows (128 less 16 a side) in batches of 2."""
    sd, variables = cascaded
    kw = dict(n_fft=64, hop=16, nout=8, nout_lstm=8, window_size=128, offset=16, batch_size=2)
    return (jvr.VRSeparator(params=variables, **kw),
            vr_network.VRSeparator(state=sd, device="cpu", **kw))


def _stereo(n, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000
    return np.stack([0.3 * np.sin(2 * np.pi * 440 * t), 0.3 * np.sin(2 * np.pi * 660 * t)]
                    ).astype(np.float32) + 0.05 * rng.standard_normal((2, n)).astype(np.float32)


@pytest.mark.parametrize("opts", [dict(), dict(aggressiveness=0.3, post_process=True)])
def test_separate_full_single_band_matches_jax(single_band, opts):
    """One STFT over 251 frames: three windows, the JAX package padding the
    last batch to 2 windows, the port running it as it is."""
    jsep, sep = single_band
    x = _stereo(4000)
    got = sep.separate_full(x, 8000, **opts)
    want = jsep.separate_full(x, 8000, **opts)
    assert got[2] == want[2] == 8000 and got[0].shape == got[1].shape == x.shape
    close(got[0], want[0])
    close(got[1], want[1])
    aggr = opts.get("aggressiveness", 0.0)
    assert np.array_equal(sep.separate(x, 8000, aggr), sep.separate_full(x, 8000, aggr)[0])


def test_separate_full_multiband_matches_jax():
    """The 4-band chain (per-band resample and STFT, combined spectrogram,
    mirrored high end, per-band iSTFT and resample up) around a random-init
    CascadedNet at n_fft 2·bins."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsep = jvr.VRSeparator(n_fft=2 * TINY_MP["bins"], hop=64, nout=4, nout_lstm=8,
                               offset=4, window_size=32, band_params=TINY_MP)
    sep = vr_network.VRSeparator(n_fft=2 * TINY_MP["bins"], hop=64, nout=4, nout_lstm=8,
                                 offset=4, window_size=32, band_params=TINY_MP, device="cpu",
                                 state=weights.cascadednet_state_from_jax(jsep.params))
    x = _stereo(8000, seed=4)
    for hep in ("mirroring", "none"):
        got = sep.separate_full(x, 8000, high_end_process=hep)
        want = jsep.separate_full(x, 8000, high_end_process=hep)
        assert got[2] == want[2] == TINY_MP["sr"]
        close(got[0], want[0])
        close(got[1], want[1])


def test_random_init_is_seeded():
    kw = dict(n_fft=64, nout=8, nout_lstm=8, device="cpu")
    with pytest.warns(UserWarning, match="random init"):
        a = vr_network.VRSeparator(**kw, generator=torch.Generator().manual_seed(1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = vr_network.VRSeparator(**kw, generator=torch.Generator().manual_seed(1))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    bn = a.model.stg3_full_band_net.enc1.conv[1]
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
