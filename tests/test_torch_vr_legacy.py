"""UVR5 legacy VR-arch ``CascadedASPPNet`` of the port against the JAX
package on the CPU, at narrow widths (``tests/test_vr_legacy.py``).

- The sp (31191, and 33966 with its 7-branch ASPP), hp (123821), hp2
  (537238) and 129605 (five-stage, 6 branches) families: each loaded from
  the torch mirror's state dict (``tests/torch_ref/vr_legacy_torch.py``) as
  it is, and from the JAX package's variables
  (``weights.cascaded_aspp_state_from_jax``), against the JAX forward;
  ``infer_architecture``, ``is_legacy_state_dict`` and the capacity table
  against JAX's.
- A legacy checkpoint through ``VRSeparator.from_file``: the default 2-band
  param, and ``separate_full`` on a 4-band config against JAX's.
Tolerance: f32, ``rtol=2e-4, atol=2e-5`` relative to the peak.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.uvr5 import vr_legacy as jlegacy
from lemas_tts_tpu.uvr5 import vr_network as jvr
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.uvr5 import vr_legacy, vr_network
from tests.torch_ref.vr_legacy_torch import CascadedASPPNetTorch
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


def _stereo(n, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000
    return np.stack([0.3 * np.sin(2 * np.pi * 440 * t), 0.3 * np.sin(2 * np.pi * 660 * t)]
                    ).astype(np.float32) + 0.05 * rng.standard_normal((2, n)).astype(np.float32)


@pytest.mark.parametrize("arch", [31191, 33966, 123821, 537238, 129605])
def test_cascaded_aspp_net_matches_jax(arch):
    sd = _random_sd(CascadedASPPNetTorch(64, arch), seed=arch)
    assert vr_legacy.is_legacy_state_dict(sd) and jlegacy.is_legacy_state_dict(sd)
    assert not vr_legacy.is_legacy_state_dict(_random_sd(CascadedNetTorch(64, 8, 8), 0))
    assert vr_legacy.infer_architecture(sd) == jlegacy.infer_architecture(sd) == arch
    variables, jarch = jlegacy.convert_cascaded_aspp(sd)
    x = np.abs(np.random.default_rng(2).standard_normal((1, 2, 33, 32))).astype(np.float32)
    net = jlegacy.CascadedASPPNet(n_fft=64, nn_architecture=jarch)
    want = np.asarray(jax.jit(net.apply)(variables, jnp.asarray(x)))
    state = weights.cascaded_aspp_state_from_jax(variables)
    assert vr_legacy.infer_architecture(state) == arch
    for src in (sd, state):
        got = _forward(_load(vr_legacy.CascadedASPPNet(64, arch), src), x)
        assert got.shape == (1, 2, 33, 32)
        close(got, want)


def test_capacity_table_matches_jax():
    for arch in vr_legacy.NN_ARCH_SIZES:
        assert vr_legacy._capacity(arch) == jlegacy._capacity(arch)
    with pytest.raises(ValueError):
        vr_legacy._capacity(12345)


def test_legacy_from_file_matches_jax(tmp_path):
    """A legacy sp checkpoint (``.pth``) loads through ``from_file`` in both
    packages: with no band param the reference's default 2-band param
    (n_fft = 2·768, offset 128); with the 4-band config, the same stems
    (the nets' weights do not depend on n_fft)."""
    sd = _random_sd(CascadedASPPNetTorch(64, 31191), seed=5)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "legacy.pth")
    path = str(tmp_path / "legacy.pth")
    sep = vr_network.VRSeparator.from_file(path, device="cpu")
    jsep = jvr.VRSeparator.from_file(path)
    assert isinstance(sep.model, vr_legacy.CascadedASPPNet)
    assert (sep.offset, sep.n_fft, sep.hop, sep.window_size) == \
        (jsep.offset, jsep.n_fft, jsep.hop, jsep.window_size) == (128, 1536, 1024, 512)
    assert sep.mp == jsep.mp and sep.mp["bins"] == 768 and len(sep.mp["band"]) == 2
    sep = vr_network.VRSeparator.from_file(path, band_params=TINY_MP, window_size=288,
                                           device="cpu")
    jsep = jvr.VRSeparator.from_file(path, band_params=TINY_MP, window_size=288)
    x = _stereo(4000, seed=6)
    got, want = sep.separate_full(x, 8000), jsep.separate_full(x, 8000)
    assert got[2] == want[2] == TINY_MP["sr"]
    close(got[0], want[0])
    close(got[1], want[1])
