"""The conv position embedding's kernel, ``ops/conv.py:conv_taps_mish``.

On the CPU: its plain version against the JAX package's shifted-tap conv
(``lemas_tts_tpu/models/modules.py:GroupedConvTaps``) plus Mish on the same
numpy weights and inputs, SAME and VALID, ragged N, f32 and bf16 (bf16 at
the plain version's rounding points: JAX's rounded conv output, then Mish in
f32 and rounded again); the wrapper's dispatch and counter; the models'
routes (inference through the wrapper, twice a forward and in a graph's
record; training through the differentiable ``conv1d`` chain, with
gradients to both weights); the kernel's symbols against the benchmark's
roofline patterns. The ``card`` case holds the kernel against the plain
version on the chip (``python -m pytest tests/test_torch_conv_taps.py -m card
--noconftest``; the JAX imports stay inside the CPU tests). Tiny widths, one
torch thread.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lemas_tts_tpu_torch.ops import conv, launches

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(c, groups, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((c, c // groups, k)) * (c // groups * k) ** -0.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.3).astype(np.float32)
    return w, b


def _jax_conv_mish(x, w, b, groups, padding, dtype):
    """JAX ``GroupedConvTaps`` (its tap form: batch <= 2), then ``mish`` in
    f32: in f32 the JAX chain itself. In bf16 at the plain version's rounding
    points: JAX's CPU has no bf16 x bf16 -> f32 product, so the taps run in
    f32 on the bf16 operands (the same products, exact in f32, and the same
    f32 sums), and the conv output is rounded to bf16 before Mish and after."""
    import jax
    import jax.numpy as jnp

    from lemas_tts_tpu.models.modules import GroupedConvTaps, mish

    c, _, k = w.shape
    mod = GroupedConvTaps(c, k, groups, compute_dtype=jnp.float32, padding=padding)
    assert x.shape[0] <= mod.tap_batch_threshold  # the tap form, not lax's conv
    params = {"params": {"kernel": jnp.asarray(w.transpose(2, 1, 0)), "bias": jnp.asarray(b)}}
    h = mod.apply(params, jnp.asarray(x))
    if dtype == torch.float32:
        return np.asarray(jax.device_get(mish(h)))
    out = mish(h.astype(jnp.bfloat16).astype(jnp.float32))
    return np.asarray(jax.device_get(out.astype(jnp.bfloat16).astype(jnp.float32)))


def _round(a, dtype):
    """``a`` as ``dtype`` holds it, back in f32 numpy."""
    return torch.from_numpy(a).to(dtype).float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [40, 130])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_plain_matches_jax_taps(padding, n, dtype):
    """Channels 4 groups x 8, k 31 (SAME pads (15, 15)); N 40 and 130 (not
    a multiple of the kernel's 128-frame tile). f32 at the repository's
    2e-4; bf16 nearly every value equal, the rest one rounding apart (sums
    in another order can round the conv output the other way)."""
    c, groups, k, B = 32, 4, 31, 2
    w, b = (_round(a, dtype) for a in _weights(c, groups, k, seed=n))
    x = _round(np.random.default_rng(n + 1).standard_normal((B, n, c)).astype(np.float32), dtype)
    pad = (15, 15) if padding == "SAME" else (0, 0)
    ref = _jax_conv_mish(x, w, b, groups, padding, dtype)
    taps = conv.conv_taps(torch.from_numpy(w), groups, dtype)
    got = conv.conv_taps_mish_plain(torch.from_numpy(x).to(dtype), taps,
                                    torch.from_numpy(b).to(dtype), pad).float().numpy()
    assert got.shape == ref.shape == (B, n if padding == "SAME" else n - k + 1, c)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    else:
        assert np.mean(got == ref) >= 0.97
        np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=2 ** -10)


def test_taps_layout():
    """Tap t of group g is ``w[g C/g + o, i, t]`` at [g, t, o, i]."""
    w = torch.arange(8 * 4 * 3, dtype=torch.float32).view(8, 4, 3)
    taps = conv.conv_taps(w, 2, torch.float32)
    assert taps.shape == (2, 3, 4, 4) and taps.is_contiguous()
    for g, t, o, i in ((0, 0, 0, 0), (1, 2, 3, 1), (0, 1, 2, 3), (1, 0, 1, 2)):
        assert taps[g, t, o, i] == w[4 * g + o, i, t]


def test_cpu_takes_the_plain_version_and_launches_nothing():
    c, groups, k = 16, 2, 5
    w, b = _weights(c, groups, k, seed=3)
    x = torch.randn(1, 21, c)
    taps, bias = conv.conv_taps(torch.from_numpy(w), groups, x.dtype), torch.from_numpy(b)
    before = conv.conv_taps_mish.launches
    for pad in ((2, 2), (0, 0), (0, 4)):
        assert torch.equal(conv.conv_taps_mish(x, taps, bias, pad),
                           conv.conv_taps_mish_plain(x, taps, bias, pad))
    assert conv.conv_taps_mish.launches == before
    assert launches.counters()["conv_taps_mish"] is conv.conv_taps_mish


@pytest.mark.parametrize("case", ["channels", "bias", "padding", "frames", "rank"])
def test_shapes_that_do_not_fit_raise(case):
    x, taps, bias, pad = torch.zeros(1, 10, 16), torch.zeros(2, 5, 8, 8), torch.zeros(16), (2, 2)
    if case == "channels":
        x = torch.zeros(1, 10, 24)
    elif case == "bias":
        bias = torch.zeros(8)
    elif case == "padding":
        pad = (-1, 2)
    elif case == "frames":
        x = torch.zeros(1, 3, 16)
        pad = (0, 1)
    else:
        taps = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError):
        conv.conv_taps_mish(x, taps, bias, pad)


def test_other_devices_raise():
    x = torch.empty(1, 40, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        conv.conv_taps_mish(x, torch.empty(2, 31, 64, 64, device="meta"),
                            torch.empty(128, device="meta"), (15, 15))


def _tiny_dit():
    from lemas_tts_tpu_torch.config import DiTArch
    from lemas_tts_tpu_torch.models.dit import DiT

    torch.manual_seed(0)
    arch = DiTArch(dim=64, depth=1, heads=2, dim_head=32, ff_mult=2, text_dim=16, conv_layers=1)
    return DiT(arch, mel_dim=8, text_num_embeds=11)


def _dit_inputs(B=2, N=48):
    g = torch.Generator().manual_seed(1)
    x, cond = torch.randn(B, N, 8, generator=g), torch.randn(B, N, 8, generator=g)
    text = torch.randint(0, 11, (B, 12), generator=g, dtype=torch.int32)
    return x, cond, text, torch.tensor([0.2, 0.7])


@pytest.fixture
def counted(monkeypatch):
    """The models' ``conv_taps_mish`` counting as a launch (the plain version
    computes): what a CUDA run of the wrapper adds to the counter."""
    from lemas_tts_tpu_torch.models import modules

    def stub(x, taps, bias, padding):
        launches.count(conv.conv_taps_mish)
        return conv.conv_taps_mish_plain(x, taps, bias, padding)

    monkeypatch.setattr(modules, "conv_taps_mish", stub)


def test_inference_route_launches_twice_a_forward(counted):
    """Two launches a DiT forward, and inside a capture's record (a graph's
    launches, ``cfm/graph.py``) the same two, added at each replay."""
    dit = _tiny_dit().eval()
    before = conv.conv_taps_mish.launches
    with torch.no_grad():
        dit(*_dit_inputs())
    assert conv.conv_taps_mish.launches == before + 2
    with launches.recording() as record, torch.no_grad():
        dit(*_dit_inputs())
    assert record == {"conv_taps_mish": 2} and conv.conv_taps_mish.launches == before + 2
    for replay in (1, 2):
        launches.add(record)
        assert conv.conv_taps_mish.launches == before + 2 + 2 * replay


@pytest.mark.parametrize("route", [dict(autograd=True), dict(deterministic=False)],
                         ids=["autograd", "dropout"])
def test_training_route_keeps_the_differentiable_chain(monkeypatch, route):
    """The training route never reaches the wrapper (the kernel refuses
    grad) and back-propagates into both conv weights; at dropout 0 it gives
    the inference route's values."""
    from lemas_tts_tpu_torch.models import modules

    dit = _tiny_dit()
    with torch.no_grad():
        ref = dit(*_dit_inputs())

    def refuse(*args):
        raise AssertionError("the training route called conv_taps_mish")

    monkeypatch.setattr(modules, "conv_taps_mish", refuse)
    out = dit(*_dit_inputs(), generator=torch.Generator().manual_seed(0), **route)
    out.square().mean().backward()
    convs = dit.input_embed.conv_pos_embed.conv1d
    for i in (0, 2):
        assert convs[i].weight.grad is not None and convs[i].weight.grad.abs().sum() > 0
        assert convs[i].bias.grad is not None
    if "autograd" in route:
        np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


def test_taps_follow_the_weights():
    """The inference route reads the live weights: after an in-place update
    of both convs it still gives the differentiable chain's values."""
    from lemas_tts_tpu_torch.models.modules import ConvPositionEmbedding

    torch.manual_seed(0)
    emb = ConvPositionEmbedding(32, kernel_size=5, groups=4)
    x = torch.randn(2, 40, 32)
    with torch.no_grad():
        before = emb(x)
        np.testing.assert_allclose(before.numpy(), emb(x, train=True).numpy(),
                                   rtol=2e-5, atol=2e-6)
        for i in (0, 2):
            emb.conv1d[i].weight.mul_(2)
        after = emb(x)
        np.testing.assert_allclose(after.numpy(), emb(x, train=True).numpy(),
                                   rtol=2e-5, atol=2e-6)
    assert not torch.allclose(after, before)


def _kernel_names():
    text = (REPO / "lemas_tts_tpu_torch" / "csrc" / "conv_taps.cu").read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text)


def test_kernel_symbols_match_no_roofline_pattern():
    """No name of the kernels, mangled as ptxas reports it or demangled as
    the profiler does, is counted by a K1-K6 pattern of
    ``portbench/roofline.py``."""
    from portbench import roofline

    names = _kernel_names()
    assert sorted(names) == ["conv_taps_f32_kernel", "conv_taps_sm90_kernel"]
    for name in names:
        forms = [name, f"(anonymous namespace)::{name}(CUtensorMap_st, CUtensorMap_st, "
                       f"(anonymous namespace)::ConvArgs, int)",
                 f"void (anonymous namespace)::{name}(float const*, float const*, float const*, "
                 f"float*, int, int, int, int, int)",
                 f"_ZN45_GLOBAL__N__75d568e7_12_conv_taps_cu_8f0b7c39{len(name)}{name}"
                 f"E14CUtensorMap_stS0_NS_8ConvArgsEi"]
        for form in forms:
            assert roofline.kernel_of(form) is None, form


CARD_CASES = [("bf16", 2, 1024, (15, 15)), ("bf16", 2, 1536, (15, 15)),
              ("bf16", 16, 1536, (15, 15)), ("bf16", 2, 1025, (15, 15)),
              ("bf16", 2, 1084, (0, 0)), ("f32", 2, 1024, (15, 15)),
              ("f32", 2, 1025, (15, 15)), ("f32", 2, 1084, (0, 0))]


@pytest.mark.card
@pytest.mark.parametrize("tag,rows,n,padding", CARD_CASES)
def test_card_kernel_matches_plain(tag, rows, n, padding):
    """The kernel against its plain version on the card at dim 1024, 16
    groups, k 31: bf16 rel-L2 <= 4e-3, f32 <= 2e-4 with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip")
    dtype = torch.bfloat16 if tag == "bf16" else torch.float32
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c, groups, k = 1024, 16, 31
        w, b = _weights(c, groups, k, seed=rows * n)
        g = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn(rows, n, c, generator=g, device="cuda").to(dtype)
        taps = conv.conv_taps(torch.from_numpy(w).cuda(), groups, dtype)
        bias = torch.from_numpy(b).cuda().to(dtype)
        before = conv.conv_taps_mish.launches
        got = conv.conv_taps_mish(x, taps, bias, padding)
        ref = conv.conv_taps_mish_plain(x, taps, bias, padding)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert conv.conv_taps_mish.launches == before + 1
    assert got.shape == ref.shape == (rows, n + sum(padding) - k + 1, c)
    rel = float((got.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= (4e-3 if tag == "bf16" else 2e-4), rel
