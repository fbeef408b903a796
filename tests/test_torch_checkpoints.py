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
