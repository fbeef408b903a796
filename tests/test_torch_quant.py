"""W8A8 int8 (``ops/quant.py``) against the JAX package's ``ops/quant.py`` on
the CPU.

- ``quantize_weight`` (the port's weight is the transpose: torch ``Linear``
  layout) and ``quantize_activation``: the int8 codes and the f32 scales are
  equal. Both divide in f32 and round half to even, so no entry lands a
  quantum off here (the share off by one is asserted to be 0).
- ``int8_dense``: the int32 sums are exact on both sides, so the f32 output
  is equal bit for bit.
- The int8 and int8_ff DiTs (width 128, 2 heads x 64, depth 2, the same float
  weights carried over by ``weights.py`` and quantized on each side) against
  the JAX int8 DiT, f32. The float DiTs agree to rel-L2 ~2e-6; at that level
  an activation whose ``x/scale`` lies within ~1e-4 of a half (about 2e-4 of
  the entries of a layer's input here) rounds to the other code, and a code a
  quantum off spreads through attention. So the bar is the port's own
  sensitivity: the port may differ from JAX by at most twice what the port's
  output moves when its input moves by 2e-6 (rel-L2; measured 1.5e-3 against
  1.6e-3 for int8 and 1.6e-4 against 2.1e-4 for int8_ff), and by at most
  5e-3 in any case. The bar rejects a port that skips quantization: the
  float port DiT on the same input lies outside it (rel-L2 to the JAX int8
  DiT 4.0e-3 against a bar of 3.1e-3 for int8, 3.8e-3 against 4.1e-4 for
  int8_ff), and the test asserts so.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.config import DiTArch as JArch
from lemas_tts_tpu.models.dit import DiT as JDiT
from lemas_tts_tpu.ops import quant as jquant
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.config import DiTArch
from lemas_tts_tpu_torch.models.dit import DiT
from lemas_tts_tpu_torch.models.modules import DiTBlock
from lemas_tts_tpu_torch.ops import quant

ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1)


@pytest.mark.parametrize("shape,scale", [((128, 256), 1.0), ((256, 64), 0.02), ((64, 8), 50.0)])
def test_quantize_weight_matches_jax(shape, scale):
    w = (scale * np.random.default_rng(shape[0]).standard_normal(shape)).astype(np.float32)
    jwq, js = jquant.quantize_weight(jnp.asarray(w))
    wq, s = quant.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert wq.dtype == torch.int8 and s.dtype == torch.float32
    off = np.mean(np.asarray(jwq).T != wq.numpy())
    assert off == 0.0, f"share of codes a quantum off: {off}"
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("rows", [1, 7, 300])
def test_quantize_activation_matches_jax(rows):
    x = np.random.default_rng(rows).standard_normal((rows, 96)).astype(np.float32)
    x[0, :] = 0.0  # an all-zero row: the 1e-8 scale floor
    jxq, jxs = jquant.quantize_activation(jnp.asarray(x))
    xq, xs = quant.quantize_activation(torch.from_numpy(x))
    off = np.mean(np.asarray(jxq) != xq.numpy())
    assert off == 0.0, f"share of codes a quantum off: {off}"
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))


@pytest.mark.parametrize("bias", [True, False])
def test_int8_dense_matches_jax(bias):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 50, 128)).astype(np.float32)
    w = rng.standard_normal((128, 256)).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32) if bias else None
    jwq, js = jquant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jquant.int8_dense(jnp.asarray(x), jwq, js,
                                        None if b is None else jnp.asarray(b)))
    wq, s = quant.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    got = quant.int8_dense(torch.from_numpy(x), wq, s, None if b is None else torch.from_numpy(b))
    assert got.shape == (3, 50, 256) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_dense_shared_equals_separate_calls():
    """q/k/v share one quantization of x: each output equals the layer's own
    call bit for bit."""
    torch.manual_seed(0)
    layers = [quant.QuantLinear.from_linear(torch.nn.Linear(64, n)) for n in (64, 64, 32)]
    x = torch.randn(2, 40, 64)
    for got, lin in zip(quant.int8_dense_shared(x, layers), layers):
        assert torch.equal(got, lin(x))


def test_int8_matmul_is_exact():
    """The CPU's int32 integer product equals the exact sum (float64 holds it:
    |sum| <= 2048·127² < 2⁵³)."""
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, (33, 2048)).astype(np.int8)
    b = rng.integers(-127, 128, (40, 2048)).astype(np.int8)
    got = quant.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), (a.astype(np.float64) @ b.T.astype(np.float64)))


def test_quant_linear_loads_float_weights():
    """A float state dict loads into a QuantLinear, quantized as it loads,
    equal to ``from_linear`` of the same Linear."""
    lin = torch.nn.Linear(64, 32)
    q = quant.QuantLinear(64, 32)
    q.load_state_dict(lin.state_dict())
    ref = quant.QuantLinear.from_linear(lin)
    for k in ("weight_q", "scale", "bias"):
        assert torch.equal(getattr(q, k), getattr(ref, k)), k
    assert set(q.state_dict()) == {"weight_q", "scale", "bias"}


@pytest.fixture(scope="module")
def float_pair():
    jdit = JDiT(arch=JArch(**ARCH), mel_dim=20, text_num_embeds=11)
    params = jdit.init(jax.random.key(0), jnp.zeros((1, 32, 20)), jnp.zeros((1, 32, 20)),
                       jnp.zeros((1, 8), jnp.int32), jnp.zeros((1,)))
    return params, weights.dit_state_from_jax(params)


@pytest.mark.parametrize("mode", ["int8", "int8_ff"])
def test_int8_dit_matches_jax(float_pair, mode):
    params, state = float_pair
    names = jquant.FF_QUANT_NAMES if mode == "int8_ff" else None
    jdit = JDiT(arch=JArch(**ARCH), mel_dim=20, text_num_embeds=11,
                quant=mode)
    qparams = {"params": jquant.quantize_dense_tree(params["params"], names=names)}
    dit = DiT(DiTArch(**ARCH), mel_dim=20, text_num_embeds=11)
    dit.load_state_dict(state)
    quant.quantize_dense_tree(dit, quant.MODES[mode]).eval()
    blk: DiTBlock = dit.transformer_blocks[0]
    # int8: q/k/v leave K1 (K3 still runs), the FF leaves K2; int8_ff: only K2 goes
    assert blk.fused_attn_ok(256) == (mode == "int8_ff") and not blk.fused_ff_ok(256)
    assert isinstance(blk.attn.to_out[0], quant.QuantLinear) == (mode == "int8")

    rng = np.random.default_rng(0)
    B, N = 2, 256
    x = rng.standard_normal((B, N, 20)).astype(np.float32)
    cond = rng.standard_normal((B, N, 20)).astype(np.float32)
    text = np.full((B, 40), -1, np.int32)
    text[0, :30] = rng.integers(0, 11, 30)
    text[1, :12] = rng.integers(0, 11, 12)
    time = np.asarray([0.3, 0.8], np.float32)
    mask = np.arange(N)[None, :] < np.asarray([200, N])[:, None]
    want = np.asarray(jdit.apply(qparams, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(text),
                                 jnp.asarray(time), jnp.asarray(mask)))

    def port(x):
        with torch.no_grad():
            return dit(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(text),
                       torch.from_numpy(time), torch.from_numpy(mask)).numpy()

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    got = port(x)
    nudged = x * (1 + 2e-6 * np.random.default_rng(5).standard_normal(x.shape)).astype(np.float32)
    sensitivity = rel_l2(port(nudged), got)
    err = rel_l2(got, want)
    bar = min(2 * sensitivity, 5e-3)
    assert err <= bar, (err, sensitivity)
    # the bar rejects a port that does not quantize: the float DiT lies outside it
    float_dit = DiT(DiTArch(**ARCH), mel_dim=20, text_num_embeds=11)
    float_dit.load_state_dict(state)
    dit = float_dit.eval()
    unquantized = rel_l2(port(x), want)
    assert unquantized > bar, (unquantized, bar)
