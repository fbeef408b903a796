"""The port's UNetT (E2 TTS) against the benchmark's plain reference
(``portbench/reference/unett.py``, through the UNetT family
``portbench/backbones/unett.py``) on the CPU, in float32, on seeded weights.

- ``UNetT.forward`` at width 128 (2 heads x 64), depth 4, ff_mult 4, with
  each skip type, rope on the first head (E2 TTS Base) or on every head, the
  text embedding with or without its ConvNeXt stack, a key mask: rel-L2 at
  most 2e-4, the repo's float32 bar.
- ``Synthesizer.synthesize_chunks`` on that UNetT (concat skips, rope on the
  first head) against ``portbench/reference/request.py`` on the same
  request and noise: prep, duration, 32 Euler steps under CFG, Vocos and the
  RMS restore. Both run in float32; the reference follows F5-TTS's RMSNorm
  (eps clamps the L2 norm) where the port adds 1e-6 to the mean square, a
  relative 5e-7 a norm, and the attention, rope and conv position embedding
  are computed in another order. rel-L2 at most 2e-4 on the mel and the wave
  (a hundredth of the bf16 cell's gap).
- The family's ``param_shapes`` are the names and shapes, in order, of the
  port's ``UNetT(...).state_dict()`` at the published widths (on the meta
  device).
"""

import json

import numpy as np
import pytest
import torch

from lemas_tts_tpu_torch.config import DiTArch, load_model_config
from lemas_tts_tpu_torch.models.unett import UNetT
from portbench import check, system, weights
from portbench import traffic as gen
from portbench.spec import Bench
from portbench.tests import tiny

TOL = 2e-4
CONFIG = tiny.REPO / "portbench/configs/e2tts_base.json"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def family():
    return Bench(tiny.REPO).family("backbone", "UNetT")


def _config(**arch) -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg.update(name="tiny", precision="float32")
    cfg["model"]["arch"].update(dim=128, depth=4, heads=2, dim_head=64, **arch)
    cfg["vocoder"] = {"name": "vocos", "dim": 64, "intermediate_dim": 128, "num_layers": 2}
    return cfg


def _rel_l2(got, want) -> float:
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


@pytest.mark.parametrize("skip,pe_attn_head,conv_layers", [
    ("concat", 1, 0), ("add", 1, 0), ("none", None, 1), ("concat", None, 2)])
def test_unett_forward_matches_the_reference(family, skip, pe_attn_head, conv_layers):
    cfg = _config(skip_connect_type=skip, pe_attn_head=pe_attn_head, conv_layers=conv_layers)
    arch = cfg["model"]["arch"]
    model = UNetT(DiTArch(**{k: v for k, v in arch.items() if k != "skip_connect_type"}),
                  mel_dim=100, text_num_embeds=cfg["vocab_size"], skip_connect_type=skip)
    W = {k: v.float() for k, v in
         weights.make(family.param_shapes(cfg), 11, "cpu", family.weight_rule).items()}
    system._load(model, W)
    rng = np.random.default_rng(1)
    B, N = 2, 96
    x, cond = (torch.from_numpy(rng.standard_normal((B, N, 100)).astype(np.float32))
               for _ in range(2))
    text = torch.full((B, 30), -1)
    text[0, :21] = torch.from_numpy(rng.integers(0, 256, 21))
    text[1, :9] = torch.from_numpy(rng.integers(0, 256, 9))
    t = torch.tensor([0.25, 0.9])
    mask = torch.arange(N)[None] < torch.tensor([N, 70])[:, None]
    with torch.no_grad():
        got = model.eval()(x, cond, text, t, mask)
        for drop in (False, True):
            te = family.text_embedding(W, cfg, text, N, drop)
            assert _rel_l2(model.embed_text(text, N, drop_text=drop), te) <= TOL
        te = family.text_embedding(W, cfg, text, N, False)
        want, cache = family.velocity(W, cfg, x, cond, te, t, mask, None, True, None)
    assert cache is None and got.shape == want.shape
    assert _rel_l2(got, want) <= TOL


def test_reference_refuses_a_block_cache(family):
    cfg = _config()
    W = {k: v.float() for k, v in
         weights.make(family.param_shapes(cfg), 3, "cpu", family.weight_rule).items()}
    x = torch.zeros(1, 8, 100)
    with pytest.raises(ValueError, match="block cache"):
        family.velocity(W, cfg, x, x, torch.zeros(1, 8, 100), torch.tensor(0.5),
                        torch.ones(1, 8, dtype=torch.bool), (0, 2), True, None)


def test_synthesize_chunks_matches_the_reference(tmp_path):
    root = tiny.make_root(tmp_path, entry="single")
    cfg_file = root / "portbench/configs/tiny.json"
    cfg_file.write_text(json.dumps(_config()))
    cell = Bench(root).cell(tiny.CELL)
    assert cell.backbone.__name__.endswith("unett")
    sysm = system.build(cell, cell.traffic, cfg_file, 2 ** 31 + 5, "cpu")
    assert isinstance(sysm.synth.dit_model, UNetT)
    pool = gen.pool(cell.traffic, 2 ** 31 + 5)
    r = max(pool, key=lambda r: max(r.durations))
    out = sysm.synth.synthesize_chunks(r.ref_wav, r.ref_sr, r.ref_text, r.chunks, cfg=sysm.cfg,
                                       seed=r.seed)
    model = check.reference_model(cell, sysm.host_weights, "cpu")
    refs = check.reference([r], model, cell.traffic, "cpu")
    got = check.numbers([out], refs, model, cell.traffic, "cpu")
    assert got["frames_off"] == 0
    assert got["mel_rel_l2"] <= TOL and got["wave_rel_l2"] <= TOL, got


def test_param_shapes_are_the_ports_state_dict(family):
    cfg = json.loads(CONFIG.read_text())
    mc = load_model_config(CONFIG)
    assert (mc.backbone, mc.arch.dim, mc.arch.depth, mc.arch.heads, mc.arch.dim_head,
            mc.arch.ff_mult, mc.arch.pe_attn_head) == ("UNetT", 1024, 24, 16, 64, 4, 1)
    with torch.device("meta"):
        model = UNetT(mc.arch, mel_dim=100, text_num_embeds=cfg["vocab_size"],
                      skip_connect_type="concat")
    want = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    assert list(family.param_shapes(cfg).items()) == want
    assert sum(int(np.prod(s)) for _, s in want) == 333_241_544  # 333 M, byte vocabulary
