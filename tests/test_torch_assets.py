"""The port's asset tools on the CPU against the JAX package's:
``convert_checkpoint`` (the same orbax key paths and leaves as the JAX CLI
for the CFM, Vocos and UVR5 inputs, ``--export_dit`` back to the reference
layout; BigVGAN's converter function against JAX's, the CLI's default
generator being 112 M parameters), the ``validate_assets`` runbook (its step
records, skips, ``--dry_run`` and exit codes against the JAX runbook on the
same tiny assets, the whole chain at tiny width with the reprobes, and the
chain without ``tensorstore``), ``capture_phone_goldens`` (equal to
``tests/data/phone_goldens.json`` on this host's built-in backends), the
Gradio handlers without ``gradio``, the codec wrappers' gates,
``evaluate --speaker_ckpt`` on a JAX orbax tree, and the ``TTS`` keywords
``export_wav(remove_silence=)`` and ``infer(progress=)``.

Widths: the tiny DiT of ``tests/data/tiny.yaml`` (64 x 2 blocks), the
published Vocos at 20 mels, a two-scale MDX net; f32.
"""

import json
import sys
import warnings

import numpy as np
import pytest

import torch

from lemas_tts_tpu.infer import checkpoints as jck
from lemas_tts_tpu_torch.infer import checkpoints as ck
from lemas_tts_tpu_torch.scripts import validate_assets
from lemas_tts_tpu_torch.utils.audio_io import write_wav
from tests.torch_ref.dit_torch import DiTRef
from tests.torch_ref.mdxnet_torch import ConvTDFNetTorch
from tests.torch_ref.vocos_torch import VocosRef

TINY = "tests/data/tiny.yaml"
TOKENS = [" "] + list("abcdefghijklmnopqrstuvwxyz.")
PROBE_ARGS = ("--dim 64 --depth 2 --heads 4 --mel_dim 20 --vocab 28 --text_dim 32 "
              "--conv_layers 1 --n 64 --batch 2 --nfe 8")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree, at=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, at + (key,)).items()}
    return {at: np.asarray(tree)}


def assert_same_tree(got, want):
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    (d / "vocab.txt").write_text("\n".join(TOKENS) + "\n")
    with torch.random.fork_rng():
        torch.manual_seed(5)
        ref_dit = DiTRef(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20,
                         text_num_embeds=len(TOKENS), text_dim=32, conv_layers=1)
        ref_voc = VocosRef(in_ch=20, dim=512, inter=1536, layers=8, n_fft=256, hop=64)
        mdx = ConvTDFNetTorch(4, 24, 5, 2, 4, 3, 2, False)
    sd = {f"ema_model.transformer.{k}": v for k, v in ref_dit.state_dict().items()}
    sd["ema_model.initted"] = torch.tensor(True)
    sd["ema_model.step"] = torch.tensor(1)
    # a plain stream beside the EMA one, so --use_ema picks
    sd.update({f"transformer.{k}": v + 1.0 for k, v in ref_dit.state_dict().items()})
    torch.save(sd, d / "model_last.pt")
    (d / "vocos").mkdir()
    torch.save(ref_voc.ckpt_state_dict(), d / "vocos" / "pytorch_model.bin")
    torch.save(mdx.state_dict(), d / "mdx.ckpt")
    sr = 8000
    t = np.arange(int(0.8 * sr)) / sr
    write_wav(str(d / "ref.wav"), (0.25 * np.sin(2 * np.pi * 200 * t)).astype(np.float32), sr)
    return d


# ------------------------------------------------------------ convert_checkpoint
@pytest.mark.parametrize("kind", ["ckpt", "ckpt_ema", "vocos", "uvr5"])
def test_convert_checkpoint_matches_jax(kind, assets, tmp_path):
    """The port's CLI writes the orbax directory the JAX CLI writes for the
    same input: the same key paths, equal leaves."""
    from lemas_tts_tpu.scripts import convert_checkpoint as jconvert

    from lemas_tts_tpu_torch.scripts import convert_checkpoint

    src = {"ckpt": ["--ckpt", str(assets / "model_last.pt")],
           "ckpt_ema": ["--ckpt", str(assets / "model_last.pt"), "--use_ema"],
           "vocos": ["--vocos", str(assets / "vocos")],
           "uvr5": ["--uvr5", str(assets / "mdx.ckpt")]}[kind]
    assert jconvert.main([*src, "--out", str(tmp_path / "jax")]) == 0
    assert convert_checkpoint.main([*src, "--out", str(tmp_path / "port"),
                                    "--device", "cpu"]) == 0
    assert_same_tree(ck.load_native(tmp_path / "port"), ck.load_native(tmp_path / "jax"))


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_convert_checkpoint_export_dit(suffix, assets, tmp_path):
    """``--export_dit`` of a native DiT tree writes the reference layout
    exactly (the EMA stream it was converted from): the JAX CLI's file for
    ``.pt``. For ``.safetensors`` the JAX export hands safetensors'
    numpy writer transposed views, which it stores scrambled; the port
    writes C-order arrays."""
    from lemas_tts_tpu.scripts import convert_checkpoint as jconvert

    from lemas_tts_tpu_torch.scripts import convert_checkpoint

    assert jconvert.main(["--ckpt", str(assets / "model_last.pt"), "--use_ema",
                          "--out", str(tmp_path / "native")]) == 0
    out = {n: str(tmp_path / f"{n}{suffix}") for n in ("jax", "port")}
    assert jconvert.main(["--export_dit", str(tmp_path / "native"), "--out", out["jax"]]) == 0
    assert convert_checkpoint.main(["--export_dit", str(tmp_path / "native"), "--out",
                                    out["port"], "--device", "cpu"]) == 0
    load = ck.load_state_dict
    got, want = load(out["port"]), load(out["jax"])
    ema = ck.normalize_state_dict(load(str(assets / "model_last.pt")), use_ema=True)
    assert got.keys() == want.keys() == {k for k in ema if k.startswith("transformer.")}
    for k in want:
        np.testing.assert_array_equal(got[k], ema[k], err_msg=k)
        if suffix == ".pt":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_convert_checkpoint_refuses_empty_arguments(capsys):
    from lemas_tts_tpu.scripts import convert_checkpoint as jconvert

    from lemas_tts_tpu_torch.scripts import convert_checkpoint

    for flag in ("--ckpt", "--vocos", "--bigvgan", "--uvr5", "--export_dit"):
        assert convert_checkpoint.main([flag, " ", "--out", "x", "--device", "cpu"]) == 2
        assert jconvert.main([flag, " ", "--out", "x"]) == 2
    assert "is empty" in capsys.readouterr().err


@pytest.mark.parametrize("activation", ["snakebeta", "snake"])
def test_convert_bigvgan_matches_jax(activation):
    """The BigVGAN converter (weight norm folded in numpy) against JAX's, on
    a weight-normed state dict of a small generator."""
    from lemas_tts_tpu.models.bigvgan import BigVGANConfig as JConfig
    from lemas_tts_tpu.models.bigvgan import convert_bigvgan as jconvert_bigvgan

    from lemas_tts_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, convert_bigvgan

    kw = dict(num_mels=20, upsample_initial_channel=32, upsample_rates=(4, 2),
              upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3), (1, 3)), activation=activation)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        gen = BigVGAN(BigVGANConfig(**kw))
    sd = {}
    for k, v in gen.state_dict().items():
        v = v.numpy() + 0.1 * (k.endswith(".alpha") or k.endswith(".beta"))
        if k.endswith(".weight") and v.ndim == 3:  # NVIDIA stores the convs weight-normed
            p = k[: -len(".weight")]
            sd[f"{p}.weight_v"] = v * 2.0
            sd[f"{p}.weight_g"] = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
        else:
            sd[k] = v
    assert_same_tree(convert_bigvgan(sd, BigVGANConfig(**kw)),
                     jconvert_bigvgan(sd, JConfig(**kw)))


# --------------------------------------------------------------- validate_assets
def _recs(out: str) -> dict:
    return {r["step"]: r for r in (json.loads(ln[len("[step] "):]) for ln in out.splitlines()
                                   if ln.startswith("[step] "))}


def _run_both(capsys, args, port_extra=(), jax_extra=()):
    from lemas_tts_tpu.scripts import validate_assets as jvalidate

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jrc = jvalidate.main([*args, *jax_extra])
        jrecs = _recs(capsys.readouterr().out)
        rc = validate_assets.main([*args, *port_extra])
        out = capsys.readouterr().out
    return rc, _recs(out), json.loads(out.strip().splitlines()[-1]), jrc, jrecs


def test_runbook_without_assets_skips_as_jax(capsys, tmp_path):
    """Nothing on disk: every step skips with the JAX runbook's reason, and
    both exit 0."""
    from lemas_tts_tpu_torch.text import tokenizer as tok

    rc, recs, final, jrc, jrecs = _run_both(capsys, ["--out", str(tmp_path / "v")],
                                            port_extra=["--device", "cpu"])
    assert rc == jrc == 0 and final["failed"] == []
    assert set(recs) == set(validate_assets.STEPS)
    for step in validate_assets.STEPS:
        if step == "phone_goldens" and tok.available():
            continue
        assert recs[step]["status"] == jrecs[step]["status"] == "skip"
        assert recs[step]["reason"] == jrecs[step]["reason"], step


def test_runbook_unknown_step_and_dry_run(capsys, tmp_path):
    """An unknown step: exit 2, as JAX. ``--dry_run`` prints each step's
    stand-alone command: the JAX runbook's, on the port's CLIs, with
    ``--device``; the capture names its bundle with ``--bundle``, the flag
    ``parity_check`` takes (the JAX runbook passes ``--out``)."""
    from lemas_tts_tpu.scripts import validate_assets as jvalidate

    assert validate_assets.main(["--out", str(tmp_path), "--only", "bogus"]) == 2
    assert jvalidate.main(["--out", str(tmp_path), "--only", "bogus"]) == 2
    args = ["--ckpt", "model.safetensors", "--vocab_file", "vocab.txt", "--vocos", "vocos_dir",
            "--uvr5", "kim.onnx", "--ref_repo", "/ref", "--manifest", "cases.json",
            "--out", str(tmp_path / "v"), "--dry_run"]
    assert jvalidate.main(args) == 0
    want = capsys.readouterr().out.splitlines()
    assert validate_assets.main([*args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.startswith("python -m "):
            w = w.replace("lemas_tts_tpu.scripts.", "lemas_tts_tpu_torch.scripts.")
            if "--capture" in w:
                w = w.replace(" --out ", " --bundle ")
            assert g == w + " --device cpu"
        else:
            assert g.split(":")[0] == w.split(":")[0]


def test_runbook_convert_and_smoke_against_jax(capsys, assets, tmp_path):
    """convert_cfm -> smoke_infer on a tiny reference checkpoint, both
    runbooks on the same inputs: both pass, write the same orbax tree and
    the same length of audio, the port's smoke loading the converted
    directory."""
    base = ["--ckpt", str(assets / "model_last.pt"), "--use_ema",
            "--vocab_file", str(assets / "vocab.txt"), "--model", TINY,
            "--ref_audio", str(assets / "ref.wav"), "--ref_text", "a reference.",
            "--only", "convert_cfm,smoke_infer"]
    rc, recs, final, jrc, jrecs = _run_both(
        capsys, base, port_extra=["--out", str(tmp_path / "p"), "--device", "cpu"],
        jax_extra=["--out", str(tmp_path / "j")])
    assert rc == jrc == 0, (recs, jrecs)
    for step in validate_assets.STEPS:
        assert recs[step]["status"] == jrecs[step]["status"], step
    assert recs["smoke_infer"]["status"] == "pass" and recs["smoke_infer"]["peak"] > 1e-4
    assert recs["smoke_infer"]["loaded"] == str(tmp_path / "p" / "native_model")
    assert recs["smoke_infer"]["audio_s"] == jrecs["smoke_infer"]["audio_s"]
    assert "launches" not in recs["smoke_infer"]  # the CPU runs the plain versions
    assert_same_tree(ck.load_native(tmp_path / "p" / "native_model"),
                     ck.load_native(tmp_path / "j" / "native_model"))
    assert (tmp_path / "p" / "smoke.wav").is_file()


def test_runbook_whole_chain_at_tiny_width(capsys, assets, tmp_path):
    """The whole runbook on the port at tiny width: the conversions, the
    smoke, the three reprobes (``--probe_args`` at the checkpoint's
    geometry); parity and the goldens skip (no reference repo, no espeak);
    every artifact written."""
    from lemas_tts_tpu_torch.text import tokenizer as tok

    out = tmp_path / "v"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = validate_assets.main([
            "--ckpt", str(assets / "model_last.pt"), "--use_ema",
            "--vocab_file", str(assets / "vocab.txt"), "--vocos", str(assets / "vocos"),
            "--uvr5", str(assets / "mdx.ckpt"), "--model", TINY,
            "--ref_audio", str(assets / "ref.wav"), "--ref_text", "a reference.",
            "--probe_args", PROBE_ARGS, "--threshold", "0.05", "--device", "cpu",
            "--out", str(out)])
    txt = capsys.readouterr().out
    recs, final = _recs(txt), json.loads(txt.strip().splitlines()[-1])
    assert rc == 0 and final["failed"] == [], (final, recs)
    skips = {"parity_capture", "parity_compare"} | (set() if tok.available()
                                                    else {"phone_goldens"})
    for step in validate_assets.STEPS:
        assert recs[step]["status"] == ("skip" if step in skips else "pass"), recs[step]
    for name in ("native_model", "vocos_native", "uvr5_native", "smoke.wav"):
        assert (out / name).exists(), name
    assert recs["reprobe_cutoff"]["mel_mse"] >= 0 and recs["reprobe_blockcache"]["mel_mse"] >= 0
    assert recs["reprobe_quant"]["mel_mse_int8_vs_bf16"] >= 0


def test_runbook_without_tensorstore(capsys, assets, tmp_path, monkeypatch):
    """Without ``tensorstore`` the conversions skip with that reason, the
    smoke loads the reference file and the reprobes probe it."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    out = tmp_path / "v"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = validate_assets.main([
            "--ckpt", str(assets / "model_last.pt"), "--use_ema",
            "--vocab_file", str(assets / "vocab.txt"), "--vocos", str(assets / "vocos"),
            "--model", TINY, "--ref_audio", str(assets / "ref.wav"),
            "--ref_text", "a reference.", "--probe_args", PROBE_ARGS, "--threshold", "0.05",
            "--skip", "reprobe_blockcache,reprobe_quant", "--device", "cpu",
            "--out", str(out)])
    recs = _recs(capsys.readouterr().out)
    assert rc == 0, recs
    for step in ("convert_cfm", "convert_vocoder"):
        assert recs[step]["status"] == "skip" and "tensorstore" in recs[step]["reason"]
    assert recs["smoke_infer"]["status"] == "pass"
    assert recs["smoke_infer"]["loaded"] == str(assets / "model_last.pt")
    assert recs["reprobe_cutoff"]["status"] == "pass"
    assert not (out / "native_model").exists()


def test_runbook_failed_step_sets_the_exit_code(capsys, assets, tmp_path):
    """A step that runs and fails (a bar no probe can meet) gives exit 1
    with its error; the chain goes on."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = validate_assets.main([
            "--ckpt", str(assets / "model_last.pt"), "--use_ema", "--model", TINY,
            "--probe_args", PROBE_ARGS, "--threshold", "-1", "--device", "cpu",
            "--only", "convert_cfm,reprobe_cutoff", "--out", str(tmp_path / "v")])
    txt = capsys.readouterr().out
    recs, final = _recs(txt), json.loads(txt.strip().splitlines()[-1])
    assert rc == 1 and final["failed"] == ["reprobe_cutoff"]
    assert recs["reprobe_cutoff"]["status"] == "FAIL" and "diverges" in recs["reprobe_cutoff"][
        "error"]
    assert recs["convert_cfm"]["status"] == "pass"


# ------------------------------------------------------------ phone goldens
def test_capture_phone_goldens_equals_the_fixture(tmp_path, capsys):
    """On this host's built-in backends the port's frontend gives the
    fixture the JAX script captured, case for case, and the vocab snapshot."""
    from lemas_tts_tpu_torch.scripts import capture_phone_goldens
    from lemas_tts_tpu_torch.text import tokenizer as tok

    want = json.loads(open("tests/data/phone_goldens.json", encoding="utf-8").read())
    if tok.available() != want["backend"].startswith("espeak"):
        pytest.skip(f"fixture captured with {want['backend']!r}, another backend here")
    (tmp_path / "vocab.txt").write_text("a\nb\n")
    assert capture_phone_goldens.main(["--out", str(tmp_path / "g.json"), "--vocab_file",
                                       str(tmp_path / "vocab.txt"), "--device", "cpu"]) == 0
    got = json.loads((tmp_path / "g.json").read_text(encoding="utf-8"))
    assert got.pop("vocab") == ["a", "b"]
    assert got == want
    assert "24 cases captured" in capsys.readouterr().out


# ------------------------------------------------------------------ gradio
@pytest.fixture(scope="module")
def gradio_args(assets):
    from lemas_tts_tpu_torch.scripts import inference_gradio

    return inference_gradio.build_parser().parse_args(
        ["--model", TINY, "--vocab_file", str(assets / "vocab.txt"), "--device", "cpu"])


class Refused(Exception):
    pass


@pytest.mark.parametrize("fast_mode", [False, True])
def test_gradio_infer_fn_without_gradio(fast_mode, gradio_args, assets, monkeypatch, tmp_path):
    """The ``infer_fn`` handler on the CPU with no ``gradio``: int16 audio
    at the model's rate and the seed, equal to ``TTS.infer`` with the
    settings it passes (fast mode: CFG cutoff 1.0 and the serving block
    cache); the ``TTS`` is built once."""
    from lemas_tts_tpu_torch.config import SERVING_BLOCK_CACHE
    from lemas_tts_tpu_torch.scripts import inference_gradio
    from lemas_tts_tpu_torch.utils.audio_io import read_audio

    monkeypatch.setitem(sys.modules, "gradio", None)
    monkeypatch.setattr(inference_gradio, "_model_cache", {})
    infer_fn, _ = inference_gradio.make_handlers(gradio_args, Refused)
    wav, sr = read_audio(str(assets / "ref.wav"))
    pcm = (wav[0] * 32767).astype(np.int16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (out_sr, audio), seed = infer_fn((sr, pcm), "a reference.", "hello there.", 4, 2.0, 1.0,
                                         1.0, 1.0, False, False, fast_mode, "7")
        tts = inference_gradio.get_tts(TINY, "", gradio_args.vocab_file, device="cpu")
        assert len(inference_gradio._model_cache) == 1
        write_wav(str(tmp_path / "ref.wav"), pcm.astype(np.float32) / 32768, sr)  # as it does
        want, _, _ = tts.infer(str(tmp_path / "ref.wav"), "a reference.",
                               "hello there.", nfe_step=4, cfg_strength=2.0,
                               sway_sampling_coef=1.0, seed=7,
                               cfg_cutoff=1.0 if fast_mode else None,
                               block_cache=SERVING_BLOCK_CACHE if fast_mode else None,
                               show_info=lambda *a: None)
    assert seed == "7" and out_sr == 8000 and audio.dtype == np.int16
    np.testing.assert_array_equal(audio, (np.clip(want, -1, 1) * 32767).astype(np.int16))


def test_gradio_handlers_refuse_and_denoise_needs_weights(gradio_args):
    from lemas_tts_tpu_torch.scripts import inference_gradio

    infer_fn, denoise_fn = inference_gradio.make_handlers(gradio_args, Refused)
    with pytest.raises(Refused, match="required"):
        infer_fn(None, "", "text", 4, 2.0, 1.0, 1.0, 1.0, False, False, False, "")
    assert denoise_fn(None) is None
    with pytest.raises(Refused, match="uvr5_model"):
        denoise_fn((8000, np.zeros(800, np.int16)))


def test_gradio_main_without_gradio(monkeypatch, capsys):
    from lemas_tts_tpu_torch.scripts import inference_gradio

    monkeypatch.setitem(sys.modules, "gradio", None)
    assert inference_gradio.main(["--device", "cpu"]) == 2
    assert "gradio is not installed" in capsys.readouterr().err
    with pytest.raises(ImportError):
        inference_gradio.build_app(inference_gradio.build_parser().parse_args([]))


def test_gradio_list_checkpoints_and_stats(tmp_path):
    """Checkpoint files and orbax directories per project, as JAX lists
    them; the stats panel's text."""
    from lemas_tts_tpu.scripts import inference_gradio as jgradio

    from lemas_tts_tpu_torch.scripts import inference_gradio

    proj = tmp_path / "proj"
    (proj / "native").mkdir(parents=True)
    (proj / "native" / "_METADATA").write_text("{}")
    for name in ("a.pt", "b.safetensors", "notes.txt"):
        (proj / name).write_text("")
    (tmp_path / "empty").mkdir()
    got = inference_gradio.list_checkpoints(str(tmp_path))
    assert got == jgradio.list_checkpoints(str(tmp_path))
    assert [p.split("/")[-1] for p in got["proj"]] == ["a.pt", "b.safetensors", "native"]
    assert "torch" in inference_gradio.system_stats()


# ------------------------------------------------------------- codec wrappers
@pytest.mark.parametrize("name", ["AudioTokenizer", "AudioSR"])
def test_codec_wrappers_are_gated_as_jax(name, monkeypatch):
    from lemas_tts_tpu.text import tokenizer as jtok

    from lemas_tts_tpu_torch.text import tokenizer as tok

    for mod in ("audiocraft", "audiocraft.solvers", "dac"):
        monkeypatch.setitem(sys.modules, mod, None)
    args = () if name == "AudioTokenizer" else ("model.pth",)
    msgs = []
    for m in (jtok, tok):
        with pytest.raises(ImportError) as e:
            getattr(m, name)(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------- evaluate
def test_evaluate_speaker_ckpt_on_a_jax_orbax_tree(tmp_path):
    """``evaluate --speaker_ckpt <orbax dir>`` (the JAX ``SpeakerEncoder``'s
    variables at its default widths): the speaker cosine of the JAX CLI."""
    import jax
    import jax.numpy as jnp

    from lemas_tts_tpu.models.speaker import SpeakerEncoder as JSpeakerEncoder
    from lemas_tts_tpu.scripts import evaluate as jevaluate

    from lemas_tts_tpu_torch.scripts import evaluate

    variables = JSpeakerEncoder().init(jax.random.key(0), jnp.zeros((1, 16, 100)))
    variables = jax.tree_util.tree_map(lambda x: x, dict(variables))
    jck.save_native(variables, str(tmp_path / "spk"))
    sr = 24000
    t = np.arange(sr // 2) / sr
    for name, f in (("ref", 220), ("hyp", 250)):
        write_wav(str(tmp_path / f"{name}.wav"),
                  (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32), sr)
    (tmp_path / "m.jsonl").write_text(json.dumps({"ref": str(tmp_path / "ref.wav"),
                                                  "hyp": str(tmp_path / "hyp.wav")}) + "\n")
    args = ["--manifest", str(tmp_path / "m.jsonl"), "--speaker_ckpt", str(tmp_path / "spk")]
    assert jevaluate.main([*args, "--out", str(tmp_path / "j.json")]) == 0
    assert evaluate.main([*args, "--out", str(tmp_path / "t.json"), "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    key = next(k for k in want if "speaker" in k)
    np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- TTS keywords
def test_export_wav_remove_silence_and_infer_progress(assets, tmp_path):
    """``export_wav(remove_silence=True)`` cuts the long silences (a shorter
    finite file, equal to JAX's ``remove_long_silence``); ``infer`` takes
    ``progress=`` as the JAX signature does."""
    from lemas_tts_tpu.infer.audio_prep import remove_long_silence as jremove

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.utils.audio_io import read_audio

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TTS(model=TINY, vocab_file=str(assets / "vocab.txt"), frontend=None, device="cpu")
        wave, sr, _ = tts.infer(str(assets / "ref.wav"), "a reference.", "hello.", nfe_step=2,
                                seed=1, progress=object())
    assert np.isfinite(wave).all()
    rng = np.random.default_rng(0)
    x = np.concatenate([0.3 * rng.standard_normal(sr), np.zeros(3 * sr),
                        0.3 * rng.standard_normal(sr)]).astype(np.float32)
    tts.export_wav(x, str(tmp_path / "full.wav"))
    tts.export_wav(x, str(tmp_path / "cut.wav"), remove_silence=True)
    full, _ = read_audio(str(tmp_path / "full.wav"))
    cut, _ = read_audio(str(tmp_path / "cut.wav"))
    assert cut.shape[1] == len(jremove(x, sr)) < full.shape[1] == len(x)
    assert np.isfinite(cut).all()
