"""Rules of the PyTorch port: it imports neither JAX nor the JAX package, its
entry point runs on CUDA unless the CPU is asked for, and its config matches
the JAX package's."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

import torch

from lemas_tts_tpu.config import load_model_config as jload_model_config
from lemas_tts_tpu_torch.config import load_model_config

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "lemas_tts_tpu_torch"


def test_import_leaves_jax_out():
    """Importing every module of the port (and building nothing), its
    ``text/``, ``scripts/``, ``uvr5/`` and ``eval/`` subpackages, the
    training and multi-GPU modules, the measurement tools, the native
    checkpoints, the C++ host runtime and the asset tools included, pulls in
    neither jax, orbax nor lemas_tts_tpu (nor the tests' torch mirrors), and
    not tensorstore, which the native checkpoints import when they run."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lemas_tts_tpu_torch, lemas_tts_tpu_torch.api\n"
        "names = [m.name for m in pkgutil.walk_packages(lemas_tts_tpu_torch.__path__,"
        " 'lemas_tts_tpu_torch.')]\n"
        "for sub in ('text.frontend', 'text.en_ipa', 'scripts.tts_multilingual',"
        " 'scripts.speech_edit_multilingual', 'scripts.g2p', 'infer.editing',"
        " 'scripts.serve_http', 'serve.engine', 'serve.batcher', 'cfm.graph', 'ops.quant',"
        " 'ops.fbank', 'models.prosody', 'models.bigvgan', 'models.unett', 'scripts.denoise',"
        " 'uvr5.mdxnet', 'uvr5.inference', 'uvr5.onnx_weights', 'uvr5.band_params',"
        " 'uvr5.spec_utils', 'uvr5.pyrb', 'uvr5.vr_network', 'uvr5.vr_legacy', 'cfm.loss',"
        " 'cfm.train', 'cfm.data', 'cfm.checkpoint', 'cfm.distill', 'models.speaker',"
        " 'eval.metrics', 'scripts.train', 'scripts.distill', 'scripts.evaluate', 'infer.asr',"
        " 'parallel.distributed', 'parallel.mesh', 'parallel.sequence', 'ops.ring_attention',"
        " 'serve.multihost', 'parallel.tensor', 'parallel.pipeline', 'utils.flops',"
        " 'utils.misc', 'scripts._probe_common', 'scripts.kernel_check',"
        " 'scripts.profile_sampler', 'scripts.cutoff_probe', 'scripts.blockcache_probe',"
        " 'scripts.quant_probe', 'scripts.attn_pack_probe', 'scripts.widehead_probe',"
        " 'scripts.latency_probe', 'scripts.distill_probe', 'scripts.student_stack_probe',"
        " 'scripts.parity_check', 'infer.checkpoints', 'native', 'native.audio',"
        " 'native.batcher', 'scripts.convert_checkpoint', 'scripts.validate_assets',"
        " 'scripts.capture_phone_goldens', 'scripts.inference_gradio'):\n"
        "    assert 'lemas_tts_tpu_torch.' + sub in names, sub\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'orbax', 'tensorstore', 'lemas_tts_tpu', 'tests'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_sources_name_no_jax_module():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "flax", "lemas_tts_tpu", "tests"), \
                    (path, name)


def test_entry_points_match_c_sources():
    """Every ``extern "C" int lemas_*(...)`` of ``csrc/<library>.cu`` is in
    ``ops/_cuda.py:ENTRY_POINTS[<library>]`` with one argtype per parameter
    of the same kind (pointer, int, float), and nothing else is: a changed
    signature fails here, not only on the card."""
    import ctypes
    import re

    from lemas_tts_tpu_torch.ops import _cuda

    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
    found = {}
    for src in sorted((PKG / "csrc").glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in re.findall(r'extern\s+"C"\s+int\s+(lemas_\w+)\s*\(([^)]*)\)', text):
            got = []
            for param in params.split(","):
                decl = " ".join(param.split())
                got.append("pointer" if "*" in decl else decl.rsplit(" ", 1)[0].split()[-1])
            found.setdefault(src.stem, {})[name] = got
    assert found and set(found) == set(_cuda.ENTRY_POINTS)
    for lib, entries in found.items():
        want = {name: [kinds[t] for t in argtypes]
                for name, argtypes in _cuda.ENTRY_POINTS[lib].items()}
        assert entries == want, lib


def test_k6_bf16_kernel_is_its_own():
    """K6's bf16 kernel is ``csrc/attention_splash_sm90.cuh``'s: the splash
    library instantiates nothing of K5's bf16 kernel, and K5's bf16 kernel
    (``attn_bhnd_sm90_kernel``) and the 64-key ``softmax_step`` take no
    segment flag, so K5's code path cannot drift back into K6's. The f32
    kernel keeps ``SEG``: it is K6's checking path."""
    import re

    def source(name):
        return re.sub(r"//[^\n]*", "", (PKG / "csrc" / name).read_text())

    def template_of(text, fn):
        """The template parameter list of ``fn``'s definition (its first
        call-shaped occurrence)."""
        i = text.index(fn + "(")
        t = text.rindex("template", 0, i)
        return text[t:text.index(">", t) + 1]

    splash = source("attention_splash.cu") + source("attention_splash_sm90.cuh")
    assert "splash_sm90_kernel" in splash
    assert "attn_bhnd_sm90_kernel" not in splash and "launch_bhnd_sm90" not in splash
    assert "SEG" not in source("attention_sm90.cuh")
    assert "SEG" not in template_of(source("attention_sm90.cuh"), "softmax_step")
    bhnd = source("attention_bhnd.cuh")
    assert "SEG" not in template_of(bhnd, "attn_bhnd_sm90_kernel")
    assert "SEG" not in bhnd[bhnd.index(template_of(bhnd, "attn_bhnd_sm90_kernel")):]
    assert "bool SEG" in template_of(bhnd, "attn_bhnd_kernel")


def test_refusals_left_are_the_multi_gpu_flags():
    """The attention backends, ASR and multi-GPU training are ported: no
    ``refuse_unported`` is left (the last, ``scripts/train.py``'s multi-GPU
    flags, went with them), and no ``NotImplementedError`` of the port names
    ``--attn_backend``, an empty ``ref_text``, a mesh, FSDP, orbax or a
    ROADMAP item."""
    defs = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and node.name == "refuse_unported":
                defs.append(path.relative_to(PKG).as_posix())
            if (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", "") == "NotImplementedError"):
                text = ast.unparse(node.exc)
                for word in ("attn_backend", "ref_text", "mesh", "fsdp", "model_parallel",
                             "pipe_parallel", "A14", "A15", "A16", "orbax"):
                    assert word not in text, (path, text)
    assert defs == []


def test_tts_without_cuda_raises():
    from lemas_tts_tpu_torch import TTS

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: TTS() would run on it")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            TTS(model="tests/data/tiny.yaml", device=device)


@pytest.mark.parametrize("name", ["AudioTokenizer", "AudioSR"])
def test_codec_wrappers_default_to_cuda(name, monkeypatch):
    """The codec wrappers resolve their device as every entry point does:
    no device means CUDA (raising without it), and only an explicit "cpu"
    runs on the CPU. Their optional packages are stood in for by stubs."""
    import types

    from lemas_tts_tpu_torch.text import tokenizer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the wrappers would run on it")

    class Codec(torch.nn.Linear):
        sample_rate, channels = 24000, 1

        def __init__(self):
            super().__init__(2, 2)

    solvers = types.ModuleType("audiocraft.solvers")
    solvers.CompressionSolver = types.SimpleNamespace(model_from_checkpoint=lambda sig: Codec())
    audiocraft = types.ModuleType("audiocraft")
    audiocraft.solvers = solvers
    dac = types.ModuleType("dac")
    dac.DAC = types.SimpleNamespace(load=lambda path: Codec())
    for mod, obj in (("audiocraft", audiocraft), ("audiocraft.solvers", solvers), ("dac", dac)):
        monkeypatch.setitem(sys.modules, mod, obj)
    cls = getattr(tokenizer, name)
    args = () if name == "AudioTokenizer" else ("model.pth",)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(*args, device=device)
    wrapper = cls(*args, device="cpu")
    assert wrapper.device == torch.device("cpu")
    assert next(wrapper.codec.parameters()).device.type == "cpu"


def test_meshes_without_cuda_raise():
    """A mesh's device type defaults to CUDA, as every entry point's does:
    without CUDA ``make_mesh()``/``make_seq_mesh()`` raise before any
    process group is made."""
    import torch.distributed as dist

    from lemas_tts_tpu_torch.parallel.mesh import make_mesh
    from lemas_tts_tpu_torch.parallel.sequence import make_seq_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the meshes would be made on it")
    for make in (make_mesh, make_seq_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert not dist.is_initialized()


@pytest.mark.parametrize("option", [dict(quantization="int8"), dict(ode_method="midpoint")])
def test_unported_options_raise(option, tmp_path):
    """Options once refused are ported: ``TTS(quantization="int8")`` and
    ``TTS(ode_method="midpoint")`` build, and ``synthesize_chunks`` on the
    weights of the JAX ``TTS`` with the same option (carried over as floats;
    the port quantizes them as they load) and the same noise matches it.
    Midpoint: f32, 2e-4 of the peak. int8: an activation code may land a
    quantum off where the two packages' f32 activations straddle a half, so
    the bar is twice the port's own rel-L2 change under a 2e-6 relative
    nudge of the noise (at most 1e-2; see tests/test_torch_quant.py), at NFE
    4 and at NFE 1. The sampler's steps spread a flipped code: at NFE 4 the
    float port (the same weights, not quantized) lies inside the bar too
    (mel rel-L2 3.4e-3 against a bar of 5.3e-3), at NFE 1 it lies outside
    (5.9e-3 against ~3e-3, the int8 port 3.8e-4), and the test asserts so.
    A port that skipped quantization would also fail its own bar, which its
    smooth response to the nudge sets near 4e-6."""
    import numpy as np
    import warnings

    from lemas_tts_tpu import TTS as JTTS
    from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig
    from lemas_tts_tpu_torch import TTS, weights
    from lemas_tts_tpu_torch.config import SamplerConfig

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!"])
                     + "\n")
    kw = dict(model="tests/data/tiny.yaml", vocab_file=str(vocab), frontend=None, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfloat = JTTS(**kw)
        jtts = JTTS(**kw, **option)
        tts = TTS(**kw, **option)
    tts.load_weights(weights.dit_state_from_jax(jfloat.synth.dit_params),
                     weights.vocos_state_from_jax(jfloat.synth.vocoder_params))
    rng = np.random.default_rng(0)
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(12000) / 16000)
           + 0.05 * rng.standard_normal(12000)).astype(np.float32)
    noise = rng.standard_normal((512, 20)).astype(np.float32)
    cfg = dict(nfe_steps=4, cfg_strength=2.0, sway_sampling_coef=1.0, max_duration=512,
               ode_method=option.get("ode_method", "euler"))
    args = (ref, 16000, "hello there. ", ["general kenobi.", "you are a bold one."])
    jw, jsr, jmel = jtts.synth.synthesize_chunks(*args, cfg=JSamplerConfig(**cfg), seed=3,
                                                 noise_override=noise)
    w, sr, mel = tts.synth.synthesize_chunks(*args, cfg=SamplerConfig(**cfg), seed=3,
                                             noise_override=noise)
    assert sr == jsr and mel.shape == jmel.shape and w.shape == jw.shape
    if "ode_method" in option:
        np.testing.assert_allclose(mel, jmel, rtol=2e-4, atol=2e-4 * np.abs(jmel).max())
        np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-4 * np.abs(jw).max())
        return

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ftts = TTS(**kw)  # the float port, to show that the bar rejects it
    ftts.load_weights(weights.dit_state_from_jax(jfloat.synth.dit_params),
                      weights.vocos_state_from_jax(jfloat.synth.vocoder_params))
    nudged = noise * (1 + 2e-6 * rng.standard_normal(noise.shape)).astype(np.float32)
    for nfe in (4, 1):
        scfg = SamplerConfig(**dict(cfg, nfe_steps=nfe))
        if nfe != 4:
            jw, _, jmel = jtts.synth.synthesize_chunks(
                *args, cfg=JSamplerConfig(**dict(cfg, nfe_steps=nfe)), seed=3,
                noise_override=noise)
            w, _, mel = tts.synth.synthesize_chunks(*args, cfg=scfg, seed=3, noise_override=noise)
        nw, _, nmel = tts.synth.synthesize_chunks(*args, cfg=scfg, seed=3, noise_override=nudged)
        bars = [min(2 * rel_l2(own, got), 1e-2) for own, got in ((nmel, mel), (nw, w))]
        for got, want, bar in ((mel, jmel, bars[0]), (w, jw, bars[1])):
            assert rel_l2(got, want) <= bar, (nfe, rel_l2(got, want), bar)
    fw, _, fmel = ftts.synth.synthesize_chunks(*args, cfg=scfg, seed=3, noise_override=noise)
    for unquantized, want, bar in ((fmel, jmel, bars[0]), (fw, jw, bars[1])):
        assert rel_l2(unquantized, want) > bar, (rel_l2(unquantized, want), bar)


@pytest.mark.parametrize("frontend", ["phone", "char"])
def test_text_frontends_build(frontend):
    """Both text frontends are ported; ``"phone"`` is the default, as in the
    JAX package."""
    import inspect

    from lemas_tts_tpu_torch import TTS

    assert inspect.signature(TTS).parameters["frontend"].default == "phone"
    with pytest.warns(UserWarning):
        tts = TTS(model="tests/data/tiny.yaml", device="cpu", frontend=frontend)
    assert tts.frontend.dtype == frontend


@pytest.mark.parametrize("name", ["multilingual", "tests/data/tiny.yaml",
                                  "lemas_tts_tpu_torch/configs/f5tts_base.json",
                                  "multilingual_prosody",
                                  "lemas_tts_tpu_torch/configs/f5tts_base_bigvgan.json",
                                  "lemas_tts_tpu_torch/configs/e2tts_base.json"])
def test_config_matches_jax(name):
    """The bundled JSON configs and a YAML config load to the same fields as
    the JAX package's YAML loader gives (JSON is YAML)."""
    got, ref = load_model_config(name), jload_model_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_f5tts_base_config_is_the_published_v0_arch():
    """F5-TTS v0 ``F5TTS_Base``: the flagship's widths, rope on the first
    head only, text padding not masked, Vocos 24 kHz mels."""
    cfg = load_model_config("f5tts_base")
    assert cfg == load_model_config(PKG / "configs" / "f5tts_base.json")
    a, m = cfg.arch, cfg.mel_spec
    assert (cfg.backbone, a.dim, a.depth, a.heads, a.dim_head, a.ff_mult, a.text_dim,
            a.conv_layers) == ("DiT", 1024, 22, 16, 64, 2, 512, 4)
    assert a.pe_attn_head == 1 and a.text_mask_padding is False and a.qk_norm is None
    assert (m.mel_spec_type, m.target_sample_rate, m.n_mel_channels, m.hop_length,
            m.win_length, m.n_fft) == ("vocos", 24000, 100, 256, 1024, 1024)


@pytest.mark.parametrize("backbone", ["MMDiT", "UNetT"])
def test_backbones(backbone, tmp_path):
    """Both other backbones are ported (UNetT, once refused, runs on the
    port's split-head attention): the config's backbone is the model built,
    at the config's depth, and neither takes prosody conditioning."""
    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.models.mmdit import MMDiT
    from lemas_tts_tpu_torch.models.unett import UNetT

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text((REPO / "tests/data/tiny.yaml").read_text()
                   .replace("backbone: DiT", f"backbone: {backbone}"))
    with pytest.warns(UserWarning):
        tts = TTS(model=str(cfg), device="cpu")
    cls, blocks = {"MMDiT": (MMDiT, "transformer_blocks"), "UNetT": (UNetT, "layers")}[backbone]
    assert isinstance(tts.dit, cls) and len(getattr(tts.dit, blocks)) == 2
    with pytest.raises(NotImplementedError, match="prosody"):
        TTS(model=str(cfg), device="cpu", use_prosody_encoder=True)
    x = torch.zeros(1, 8, tts.dit.proj_out.out_features)
    with pytest.raises(NotImplementedError, match="prosody"):
        tts.dit(x, x, torch.zeros(1, 3, dtype=torch.long), torch.zeros(1),
                prosody_text=torch.zeros(1, 3, 512))
