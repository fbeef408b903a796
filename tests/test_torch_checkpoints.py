"""Reference checkpoints load into the port directly: the port's parameter
names are the reference torch names. The plain-torch mirrors of the reference
DiT and Vocos (``tests/torch_ref``) are saved in the reference checkpoint
layouts, loaded through ``TTS(ckpt_file=..., vocoder_local_path=...)``, and
the port's modules must reproduce the mirrors' outputs (f32; 1e-4 relative
to the output peak: the mirrors use the exact LayerNorm variance and
``torch.istft``, the port the fast variance and its own masked iSTFT)."""

import pytest

import torch

from lemas_tts_tpu_torch import TTS
from tests.torch_ref.dit_torch import DiTRef
from tests.torch_ref.vocos_torch import VocosRef


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    (d / "vocab.txt").write_text("\n".join([" "] + list("abcdefghij")) + "\n")
    with torch.random.fork_rng():
        torch.manual_seed(0)
        ref_dit = DiTRef(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20,
                         text_num_embeds=11, text_dim=32, conv_layers=1).eval()
        ref_voc = VocosRef(in_ch=20, dim=512, inter=1536, layers=8, n_fft=256, hop=64).eval()
    ema = {f"ema_model.transformer.{k}": v for k, v in ref_dit.state_dict().items()}
    ema["ema_model.step"] = torch.tensor(7)
    torch.save({"ema_model_state_dict": ema}, d / "model.pt")
    (d / "vocos").mkdir()
    torch.save(ref_voc.ckpt_state_dict(), d / "vocos" / "pytorch_model.bin")
    tts = TTS(model="tests/data/tiny.yaml", ckpt_file=str(d / "model.pt"),
              vocab_file=str(d / "vocab.txt"), vocoder_local_path=str(d / "vocos"),
              device="cpu")
    return tts, ref_dit, ref_voc


def test_reference_dit_checkpoint_loads(loaded):
    tts, ref_dit, _ = loaded
    g = torch.Generator().manual_seed(1)
    x, cond = torch.randn(2, 96, 20, generator=g), torch.randn(2, 96, 20, generator=g)
    text = torch.full((2, 30), -1, dtype=torch.long)
    text[0, :25] = torch.randint(0, 11, (25,), generator=g)
    text[1, :9] = torch.randint(0, 11, (9,), generator=g)
    time_, mask = torch.rand(2, generator=g), torch.arange(96)[None, :] < torch.tensor([[70], [96]])
    with torch.no_grad():
        ref = ref_dit(x, cond, text, time_, mask=mask)
        got = tts.dit(x, cond, text, time_, mask)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_published_vocos_checkpoint_loads(loaded):
    tts, _, ref_voc = loaded
    mel = torch.randn(1, 20, 40, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = ref_voc.decode(mel)
        got = tts.vocoder.decode(mel)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


# --------------------------------------------------------------------------
# Native (orbax) checkpoints, without JAX in the port: the port's
# ``infer/checkpoints.py`` against the JAX package's on the same trees and
# directories. Leaves compare exactly; the TTS on a JAX native directory
# within rtol 2e-4 of the JAX TTS on it (f32, the same noise_override).

import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lemas_tts_tpu.infer import checkpoints as jck  # noqa: E402
from lemas_tts_tpu_torch import weights  # noqa: E402
from lemas_tts_tpu_torch.config import SamplerConfig  # noqa: E402
from lemas_tts_tpu_torch.infer import checkpoints as ck  # noqa: E402

TINY = "tests/data/tiny.yaml"
CHARS = [" "] + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree, at=()):
    """{key path: leaf} of a nested dict/list tree, jax arrays as numpy,
    empty containers as leaves."""
    if isinstance(tree, (dict, list, tuple)) and not tree:
        return {at: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, at + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in leaves(sub, at + (i,)).items()}
    return {at: np.asarray(tree) if hasattr(tree, "shape") else tree}


def assert_same_tree(got, want):
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], np.ndarray):
            assert isinstance(g[k], np.ndarray) and g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))
        else:
            assert g[k] == w[k] and type(g[k]) is type(w[k]), k


def mixed_tree():
    rng = np.random.default_rng(0)
    return {"step": 7, "lr": 0.5, "params": {
        "a": {"kernel": rng.standard_normal((3, 5)).astype(np.float32),
              "bias": jnp.asarray(rng.standard_normal(5), jnp.bfloat16)},
        "ids": np.arange(4, dtype=np.int32), "q": {"kernel_q": np.ones((2, 2), np.int8)}},
        "ema_params": None, "stack": [np.zeros(2), {"x": np.float32(2.5)}],
        "empty": {}, "none_list": [], "none_tuple": ()}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A reference-layout tiny DiT checkpoint (EMA keys), a published-layout
    Vocos directory and the JAX converter's orbax directories of both."""
    from lemas_tts_tpu.scripts import convert_checkpoint as jconvert

    d = tmp_path_factory.mktemp("native")
    (d / "vocab.txt").write_text("\n".join(CHARS) + "\n")
    with torch.random.fork_rng():
        torch.manual_seed(3)
        ref_dit = DiTRef(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20,
                         text_num_embeds=len(CHARS), text_dim=32, conv_layers=1).eval()
        ref_voc = VocosRef(in_ch=20, dim=512, inter=1536, layers=8, n_fft=256, hop=64).eval()
    sd = {f"ema_model.transformer.{k}": v for k, v in ref_dit.state_dict().items()}
    sd["ema_model.step"] = torch.tensor(3)
    torch.save({"ema_model_state_dict": sd}, d / "model.pt")
    (d / "vocos").mkdir()
    torch.save(ref_voc.ckpt_state_dict(), d / "vocos" / "pytorch_model.bin")
    assert jconvert.main(["--ckpt", str(d / "model.pt"), "--out", str(d / "native_model"),
                          "--use_ema"]) == 0
    assert jconvert.main(["--vocos", str(d / "vocos"), "--out", str(d / "vocos_native")]) == 0
    return d


@pytest.mark.parametrize("which", ["mixed", "zarr3", "convert_cfm", "convert_vocos"])
def test_load_native_reads_jax_directories(which, assets, tmp_path):
    """The port's ``load_native`` of what JAX's ``save_native`` /
    ``convert_checkpoint`` wrote (and of an orbax tree in zarr3) equals
    JAX's ``load_native``, leaf for leaf (jax arrays as numpy, python
    scalars, None and empty containers kept)."""
    if which == "mixed":
        path = tmp_path / "mixed"
        jck.save_native(mixed_tree(), str(path))
    elif which == "zarr3":
        import orbax.checkpoint as ocp

        path = tmp_path / "zarr3"
        tree = {k: v for k, v in mixed_tree().items() if k in ("step", "lr", "params")}
        ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
            str(path), args=ocp.args.PyTreeSave(tree))
        assert json.loads((path / "_METADATA").read_text())["use_zarr3"]
    else:
        path = assets / {"convert_cfm": "native_model", "convert_vocos": "vocos_native"}[which]
    assert_same_tree(ck.load_native(path), jck.load_native(str(path)))


def test_jax_reads_port_save_native(tmp_path):
    """JAX's ``load_native`` of the port's ``save_native`` output is the
    input (torch tensors saved as numpy), and the port reads it back."""
    tree = mixed_tree()
    tree["params"]["t"] = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ck.save_native(tree, tmp_path / "port")
    want = dict(tree, params=dict(tree["params"], t=tree["params"]["t"].numpy()))
    assert_same_tree(jck.load_native(str(tmp_path / "port")), want)
    assert_same_tree(ck.load_native(tmp_path / "port"), want)


def test_native_needs_tensorstore(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        ck.load_native(tmp_path)
    with pytest.raises(ImportError, match="tensorstore"):
        ck.save_native({"a": np.zeros(2)}, tmp_path / "x")


def test_conversion_and_export_match_jax(assets):
    """``convert_dit``/``convert_cfm`` equal JAX's leaf for leaf;
    ``export_dit_state_dict`` of the conversion is the reference state dict
    exactly, and equals JAX's export."""
    sd = ck.normalize_state_dict(ck.load_state_dict(str(assets / "model.pt")))
    jsd = jck.normalize_state_dict(jck.load_state_dict(str(assets / "model.pt")))
    assert_same_tree(sd, jsd)
    tree = ck.convert_cfm(sd)
    assert_same_tree(tree, jck.convert_cfm(jsd))
    back = ck.export_dit_state_dict(tree)
    assert back.keys() == {k for k in sd if k.startswith("transformer.")}
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    assert_same_tree(back, jck.export_dit_state_dict(jck.convert_cfm(jsd)))


@pytest.mark.parametrize("layout", ["both", "ema_only", "ema_and_stray"])
@pytest.mark.parametrize("use_ema", [True, False])
def test_one_stream_rule(layout, use_ema, tmp_path):
    """``convert_checkpoint``'s reader (``normalize_state_dict`` of
    ``load_state_dict``), ``weights.load_reference_checkpoint`` (what
    ``TTS`` loads) and ``load_cfm_checkpoint`` take the same stream of a
    file. It is JAX's, except for an EMA file whose only plain key is no
    backbone's under ``use_ema=False``: the port takes the EMA stream, the
    JAX function the stray key alone."""
    g = np.random.default_rng(5)
    ema = {"transformer.proj_out.weight": g.standard_normal((4, 3), np.float32),
           "prosody_to_mel.weight": g.standard_normal((5, 4), np.float32),
           "prosody_to_mel.bias": g.standard_normal(5).astype(np.float32)}
    plain = {k: v + 1 for k, v in ema.items()}
    sd = {f"ema_model.{k}": v for k, v in ema.items()}
    sd["ema_model.step"] = np.asarray(3.0, np.float32)
    if layout == "both":
        sd.update(plain)
    elif layout == "ema_and_stray":
        sd["mel_spec.mel_stft.mel_scale.fb"] = np.zeros(2, np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "m.pt")
    path = str(tmp_path / "m.pt")
    want = plain if layout == "both" and not use_ema else ema

    got = ck.normalize_state_dict(ck.load_state_dict(path, use_ema=use_ema), use_ema=use_ema)
    assert_same_tree(got, want)
    backbone, to_mel = weights.load_reference_checkpoint(path, use_ema=use_ema)
    loaded = ck.load_cfm_checkpoint(path, use_ema=use_ema)
    for state in (backbone, loaded["dit"]):
        assert state.keys() == {"proj_out.weight"}
        np.testing.assert_array_equal(state["proj_out.weight"].numpy(),
                                      want["transformer.proj_out.weight"])
    for lin in (to_mel, loaded["prosody_to_mel"]):
        np.testing.assert_array_equal(lin["weight"].numpy(), want["prosody_to_mel.weight"])

    jgot = jck.normalize_state_dict(jck.load_state_dict(path, use_ema=use_ema),
                                    use_ema=use_ema)
    if layout == "ema_and_stray" and not use_ema:
        assert jgot == {}  # the stray key, deleted as back-compat
    else:
        assert_same_tree(got, jgot)


def test_quantized_trees_are_refused(assets, tmp_path):
    """An int8 tree (JAX ``quantize_dense_tree``: every block matmul, or the
    FF ones only) is refused by the export, by the carry-over and by ``TTS``
    with ``ValueError`` naming the float checkpoint, as JAX's export refuses
    the first (the second, whose ``to_q`` is float, fails there later with a
    ``KeyError``)."""
    from lemas_tts_tpu.ops.quant import FF_QUANT_NAMES, quantize_dense_tree

    from lemas_tts_tpu_torch import TTS

    tree = jck.load_native(str(assets / "native_model"))
    for names in (None, FF_QUANT_NAMES):
        q = quantize_dense_tree(tree["dit"], names=names)
        with pytest.raises(ValueError if names is None else KeyError):
            jck.export_dit_state_dict(q)
        with pytest.raises(ValueError, match="float checkpoint"):
            ck.export_dit_state_dict(q)
        with pytest.raises(ValueError, match="float checkpoint"):
            weights.dit_state_from_jax(q)
    jck.save_native({"dit": q}, str(tmp_path / "int8"))
    with pytest.raises(ValueError, match="float checkpoint"):
        TTS(model=TINY, ckpt_file=str(tmp_path / "int8"), vocab_file=str(assets / "vocab.txt"),
            frontend=None, device="cpu")


def _ref_and_noise():
    rng = np.random.default_rng(0)
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(12000) / 16000)
           + 0.05 * rng.standard_normal(12000)).astype(np.float32)
    return ref, rng.standard_normal((512, 20)).astype(np.float32)


def _both_tts(ckpt, assets, **kw):
    from lemas_tts_tpu import TTS as JTTS

    from lemas_tts_tpu_torch import TTS

    common = dict(model=TINY, ckpt_file=str(ckpt), vocab_file=str(assets / "vocab.txt"),
                  vocoder_local_path=str(assets / "vocos"), frontend=None, device="cpu", **kw)
    return JTTS(**common), TTS(**common)


def _assert_same_synthesis(jtts, tts, jcfg, cfg):
    ref, noise = _ref_and_noise()
    args = (ref, 16000, "hello there. ", ["general kenobi."])
    jw, jsr, jmel = jtts.synth.synthesize_chunks(*args, cfg=jcfg, seed=3, noise_override=noise)
    w, sr, mel = tts.synth.synthesize_chunks(*args, cfg=cfg, seed=3, noise_override=noise)
    assert sr == jsr and mel.shape == jmel.shape and w.shape == jw.shape
    np.testing.assert_allclose(mel, jmel, rtol=2e-4, atol=2e-4 * np.abs(jmel).max())
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-4 * np.abs(jw).max())


def test_tts_on_a_jax_native_directory(assets):
    """``TTS(ckpt_file=<convert_checkpoint --ckpt output>)`` against the JAX
    ``TTS`` on the same directory: the backbone is the reference file's, and
    the mel agrees within 2e-4 under the same noise (f32)."""
    from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig

    jtts, tts = _both_tts(assets / "native_model", assets)
    from_file, _ = weights.load_reference_checkpoint(str(assets / "model.pt"))
    for k, v in tts.dit.state_dict().items():
        torch.testing.assert_close(v, from_file[k], rtol=0, atol=0, msg=k)
    kw = dict(nfe_steps=4, cfg_strength=2.0, sway_sampling_coef=1.0, max_duration=512)
    _assert_same_synthesis(jtts, tts, JSamplerConfig(**kw), SamplerConfig(**kw))


def test_tts_on_a_jax_distill_stage(assets, tmp_path):
    """A JAX distillation stage (the student's bare tree, ``student.json``
    with a wide-head split beside it): the same student settings and head
    split, and the same mel, in both packages."""
    from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig

    stage = tmp_path / "stage_4"
    jck.save_native({"params": jck.load_native(str(assets / "native_model"))["dit"]}, str(stage))
    meta = {"student_steps": 4, "cfg_strength": 0.0, "sway_sampling_coef": 1.0,
            "arch": {"heads": 2, "dim_head": 32}}
    (stage / "student.json").write_text(json.dumps(meta))
    jtts, tts = _both_tts(stage, assets)
    assert tts.student == jtts.student == meta
    assert (tts.config.arch.heads, tts.config.arch.dim_head) == (2, 32)
    kw = dict(nfe_steps=32, cfg_strength=2.0, sway_sampling_coef=5.0, max_duration=512)
    jcfg = jtts.apply_student_settings(JSamplerConfig(**kw))
    cfg = tts.apply_student_settings(SamplerConfig(**kw))
    assert (cfg.nfe_steps, cfg.cfg_strength) == (jcfg.nfe_steps, jcfg.cfg_strength) == (4, 0.0)
    _assert_same_synthesis(jtts, tts, jcfg, cfg)


def test_vocoder_native_directory(assets, tmp_path):
    """A vocoder directory holding ``native/`` (the JAX layout) loads the
    same weights as the published ``pytorch_model.bin``."""
    import shutil

    from lemas_tts_tpu_torch import TTS

    shutil.copytree(assets / "vocos_native", tmp_path / "voc" / "native")
    kw = dict(model=TINY, vocab_file=str(assets / "vocab.txt"), frontend=None, device="cpu")
    with pytest.warns(UserWarning):
        nat = TTS(vocoder_local_path=str(tmp_path / "voc"), **kw)
        pub = TTS(vocoder_local_path=str(assets / "vocos"), **kw)
    a, b = nat.vocoder.state_dict(), pub.vocoder.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_distill_load_teacher_reads_a_jax_trainer_run(tmp_path):
    """``distill.load_teacher`` on a JAX ``Trainer`` run directory (orbax
    ``model_last`` with step, params, EMA and optimizer state): the EMA
    backbone, as JAX's ``load_teacher`` returns it; on a run saved before the
    EMA exists, the trained backbone."""
    from lemas_tts_tpu.cfm.checkpoint import CheckpointManager
    from lemas_tts_tpu.cfm.train import Trainer as JTrainer
    from lemas_tts_tpu.config import DiTArch as JArch
    from lemas_tts_tpu.config import TrainConfig as JTrainConfig
    from lemas_tts_tpu.models.dit import DiT as JDiT
    from lemas_tts_tpu.scripts.distill import load_teacher as jload_teacher

    from lemas_tts_tpu_torch.scripts.distill import load_teacher

    rng = np.random.default_rng(0)
    batch = {"mel": jnp.asarray(rng.standard_normal((2, 32, 12)), jnp.float32),
             "mel_lengths": jnp.asarray([32, 20], jnp.int32),
             "text": jnp.asarray(rng.integers(0, 20, (2, 6)), jnp.int32),
             "langs": jnp.asarray([1, 2], jnp.int32)}
    jd = JDiT(arch=JArch(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, text_dim=16,
                         conv_layers=1), mel_dim=12, text_num_embeds=20)
    cfg = JTrainConfig(save_per_updates=0, last_per_updates=1)
    state = JTrainer(jd, vocab_size=20, mel_dim=12, cfg=cfg).init_state(jax.random.key(0), batch)
    ema = jax.tree_util.tree_map(lambda x: x + 1.0, state.params["dit"])
    for run, ema_params in (("with_ema", ema), ("no_ema", None)):
        CheckpointManager(str(tmp_path / run), cfg).maybe_save(1, state.params, ema_params,
                                                               state.opt_state)
        want = weights.dit_state_from_jax(jload_teacher(str(tmp_path / run)))
        got = load_teacher(str(tmp_path / run))
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    np.testing.assert_array_equal(
        load_teacher(str(tmp_path / "with_ema"))["proj_out.bias"].numpy(),
        np.asarray(ema.get("params", ema)["proj_out"]["bias"]))


@pytest.mark.parametrize("uri", ["hf://org/repo/sub/model.safetensors", "hf://org/repo",
                                 "plain/path.pt"])
def test_resolve_ckpt_matches_jax(uri, monkeypatch, tmp_path):
    """``hf://<org>/<repo>/<file>`` through the hub download (patched here:
    no network), a malformed URI refused, a plain path unchanged, as JAX's
    ``resolve_ckpt``."""
    import huggingface_hub

    from lemas_tts_tpu.api import resolve_ckpt as jresolve

    from lemas_tts_tpu_torch.api import resolve_ckpt

    calls = []

    def fake(repo_id, filename, cache_dir=None, **kw):
        calls.append((repo_id, filename, cache_dir))
        return f"{cache_dir}/{repo_id}/{filename}"

    monkeypatch.setattr(huggingface_hub, "hf_hub_download", fake)
    outs = []
    for fn in (jresolve, resolve_ckpt):
        try:
            outs.append(fn(uri, str(tmp_path)))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[0] == outs[1]
    assert len(calls) == (2 if uri.count("/") >= 4 else 0)


def test_tts_takes_hf_uris_and_the_vocos_hub_fallback(assets, monkeypatch, tmp_path):
    """``TTS(ckpt_file="hf://...", hf_cache_dir=...)`` loads the downloaded
    file; at the default vocoder path Vocos comes from the hub's cache, and a
    network download is tried only under ``LEMAS_HF_FALLBACK=1``."""
    import huggingface_hub

    from lemas_tts_tpu_torch import TTS

    calls = []

    def fake(repo_id, filename, cache_dir=None, local_files_only=False, **kw):
        calls.append((repo_id, filename, cache_dir, local_files_only))
        if repo_id == "charactr/vocos-mel-24khz":
            if local_files_only and os.environ.get("HUB_CACHED") != "1":
                raise FileNotFoundError("not in the cache")
            return str(assets / "vocos" / "pytorch_model.bin")
        return str(assets / "model.pt")

    import os

    monkeypatch.setattr(huggingface_hub, "hf_hub_download", fake)
    monkeypatch.setenv("LEMAS_PRETRAINED_ROOT", str(tmp_path / "none"))
    monkeypatch.delenv("LEMAS_HF_FALLBACK", raising=False)
    kw = dict(model=TINY, vocab_file=str(assets / "vocab.txt"), frontend=None, device="cpu",
              hf_cache_dir=str(tmp_path / "hub"))
    with pytest.warns(UserWarning, match="random init"):
        tts = TTS(ckpt_file="hf://org/repo/model.pt", **kw)
    assert calls[0] == ("org/repo", "model.pt", str(tmp_path / "hub"), False)
    assert calls[1][0] == "charactr/vocos-mel-24khz" and calls[1][3] is True
    assert len(calls) == 2  # no network try without LEMAS_HF_FALLBACK=1
    from_file, _ = weights.load_reference_checkpoint(str(assets / "model.pt"))
    torch.testing.assert_close(tts.dit.state_dict()["proj_out.bias"], from_file["proj_out.bias"])
    want = TTS(vocoder_local_path=str(assets / "vocos"), **kw).vocoder.state_dict()
    monkeypatch.setenv("LEMAS_HF_FALLBACK", "1")
    calls.clear()
    got = TTS(**kw).vocoder.state_dict()
    assert [c[3] for c in calls] == [True, False]
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    with pytest.raises(FileNotFoundError):  # a path that was given never falls back
        TTS(vocoder_local_path=str(tmp_path / "missing"), **kw)
