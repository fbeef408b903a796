"""Top-level ``TTS`` facade (counterpart of ``lemas_tts_tpu/api.py``):
construction loads the config, vocab, text frontend, acoustic model (the
config's ``backbone``: DiT, MMDiT or UNetT), the prosody encoder and
``prosody_to_mel`` when the model is prosody-conditioned, and the vocoder
the config's ``mel_spec_type`` names (Vocos or BigVGAN) onto one device;
``infer`` runs zero-shot TTS from a reference
audio/text pair (an empty reference text is transcribed, ``transcribe``);
``prepare_units`` gives the frontend units of one text;
``export_wav``/``export_spectrogram`` save artifacts; ``process_phone_list``
adds language-id prefixes for mixed-language phone streams.

Differences from the JAX package:
 - ``device=None`` means ``"cuda"``, and raises when no CUDA device is
   present; only an explicit ``device="cpu"`` runs on the CPU. An explicit
   request never silently becomes another device.
 - The compute dtype is bf16 on CUDA and f32 on the CPU.
 - The text frontend (``frontend="phone"``, the default, ``"char"`` or
   ``None`` for raw strings) is the port's own copy, ``text/``; it takes only
   an exact ``#1``-``#4`` as a pause token (``text/__init__.py``).
 - ``quantization="int8"|"int8_ff"`` (W8A8, ``ops/quant.py``) quantizes the
   float weights as they load, as ``quantize_dense_tree`` does in the JAX
   package; ``ode_method="midpoint"`` and ``infer(block_cache=...)`` run the
   sampler's second-order step and block-range cache.
 - ``use_prosody_encoder`` (or a config that sets it) builds the DiT with its
   prosody projection, the Pretssel encoder (``prosody_cfg_path``,
   ``prosody_ckpt_path``; random weights from a seed without a checkpoint)
   and ``prosody_to_mel`` (from the checkpoint, else seeded normal x 0.02
   with a zero bias, as the JAX package draws it); ``infer(use_prosody_encoder=
   False)`` turns the conditioning off for one request. The encoder and
   ``prosody_to_mel`` run in f32 whatever the compute dtype.
 - A distilled student's directory (``scripts/distill.py``: ``model.pt`` with
   ``student.json`` beside it) pins the sampler to the student's settings in
   ``infer`` (``apply_student_settings``), with the sidecar's head split.
 - ``attn_backend`` takes the JAX names: ``"vmem"`` (K1-K3, or K5 on the
   split-head chain), ``"splash"`` (the split-head chain on K6) and
   ``"xla"`` (plain PyTorch attention, no kernel of the port). ``None``
   means ``"vmem"`` on either device, where the JAX default off the TPU is
   ``"xla"``: the port's kernels are its main path on the card, and the CPU
   runs their plain versions. An unknown name raises ``ValueError``.
 - ``transcribe`` (ASR, ``infer/asr.py``) runs Whisper through the
   ``transformers`` pipeline on this ``TTS``'s device, never on another;
   without ``transformers`` it raises ``ImportError``.
 - ``mesh`` is a ``torch.distributed`` ``DeviceMesh`` (``parallel/mesh.py:
   make_mesh``, ``parallel/sequence.py:make_seq_mesh``) of this ``TTS``'s
   device type, one process per device: every process of the job builds the
   same ``TTS`` and makes the same ``infer`` calls with the same inputs and
   seeds (SPMD, as under ``torchrun``), and every process gets the whole
   result. Batches shard over ``data``; on a ``("data", "seq")`` mesh each
   utterance's sequence shards over ``seq`` (DiT only).
 - Not ported yet: native orbax checkpoints, ``hf://`` checkpoint URIs and
   ``export_wav(remove_silence=...)`` have no keyword here, so passing one
   gives a ``TypeError``.
 - A missing checkpoint or vocoder gives random weights (seeded), as in the
   JAX package; reference ``.pt``/``.safetensors`` checkpoints and the
   published Vocos ``pytorch_model.bin`` load directly (same key names).
"""

from __future__ import annotations

import os
import random
import warnings
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from lemas_tts_tpu_torch.config import ModelConfig, SamplerConfig, load_model_config
from lemas_tts_tpu_torch.utils.vocab import Vocab, get_tokenizer

THIS_FILE = Path(__file__)

# Languages recognized as "(lang)" tags (reference ``api.py:109``).
LANGS = {
    "cmn": "zh", "zh": "zh", "en": "en-us", "it": "it", "es": "es",
    "pt": "pt-br", "fr": "fr-fr", "de": "de", "ru": "ru", "id": "id",
    "vi": "vi", "th": "th",
}

_PUNCS = {"#1", "#2", "#3", "#4", "_", "!", ",", ".", "?", '"', "'", "^",
          "。", "，", "？", "！"}


def find_pretrained_root() -> Path:
    """``LEMAS_PRETRAINED_ROOT`` if set, else ``<repo>/pretrained_models``."""
    env = os.environ.get("LEMAS_PRETRAINED_ROOT")
    if env:
        return Path(env)
    return THIS_FILE.parent.parent / "pretrained_models"


def select_device(device: Optional[str]) -> torch.device:
    """``None`` -> CUDA (raises without it); anything else as asked, checked."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs CUDA, but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"device {device!r}: only 'cuda' and 'cpu' are supported")
    return dev


def seeded_init(build, seed: int):
    """Build a module with random weights from ``seed`` without touching the
    global torch RNG."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


class TTS:
    """Zero-shot multilingual TTS."""

    def __init__(self, model: str = "multilingual", ckpt_file: str = "", vocab_file: str = "",
                 ode_method: str = "euler", use_ema: bool = False,
                 vocoder_local_path: Optional[str] = None, use_prosody_encoder: bool = False,
                 prosody_cfg_path: str = "", prosody_ckpt_path: str = "",
                 device: Optional[str] = None, frontend: Optional[str] = "phone",
                 compute_dtype: Optional[str] = None, quantization: Optional[str] = None,
                 attn_backend: Optional[str] = None, mesh=None):
        from functools import partial

        from lemas_tts_tpu_torch.infer.pipeline import Synthesizer
        from lemas_tts_tpu_torch.models.dit import PROSODY_DIM, DiT, cast_matrices
        from lemas_tts_tpu_torch.models.mmdit import MMDiT
        from lemas_tts_tpu_torch.models.unett import UNetT
        from lemas_tts_tpu_torch.ops.attention import check_backend
        from lemas_tts_tpu_torch.ops.quant import MODES, quantize_dense_tree
        from lemas_tts_tpu_torch.weights import load_reference_checkpoint

        if ode_method not in ("euler", "midpoint"):
            raise ValueError(f"unknown ode_method: {ode_method!r}")
        if quantization is not None and quantization not in MODES:
            raise ValueError(f"unknown quantization mode: {quantization!r}")
        self.ode_method = ode_method
        self.quant = quantization
        self.attn_backend = check_backend("vmem" if attn_backend is None else attn_backend)
        self.config: ModelConfig = load_model_config(model)
        use_pros = bool(use_prosody_encoder or self.config.use_prosody_encoder)
        self.use_prosody_encoder = use_pros
        backbones = {"DiT": partial(DiT, use_prosody_encoder=use_pros), "MMDiT": MMDiT,
                     "UNetT": UNetT}
        if self.config.backbone not in backbones:
            raise ValueError(f"unknown backbone: {self.config.backbone!r}")
        if quantization is not None and self.config.backbone != "DiT":
            raise ValueError("quantization is only supported for the DiT backbone")
        if use_pros and self.config.backbone != "DiT":
            raise NotImplementedError(f"{self.config.backbone} does not take prosody "
                                      "conditioning; the prosody models use the DiT backbone")
        self.target_sample_rate = self.config.mel_spec.target_sample_rate
        self.langs = dict(LANGS)
        self.seed: Optional[int] = None

        self.device = select_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a TTS on {self.device}")
        if compute_dtype is None:
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32

        # ---- vocab / tokenizer (checkpoint contract: custom vocab.txt)
        if not vocab_file:
            cand = find_pretrained_root() / "data" / f"{self.config.name}_grl" / "vocab.txt"
            default_tok = Path(self.config.tokenizer_path)
            if cand.is_file():
                vocab_file = str(cand)
            elif default_tok.is_file():
                vocab_file = str(default_tok)
        if vocab_file:
            self.vocab: Vocab = get_tokenizer(vocab_file, "custom")
        else:
            warnings.warn("no vocab file found — using the byte tokenizer")
            self.vocab = get_tokenizer("", "byte")

        # ---- text frontend
        if frontend is not None:
            from lemas_tts_tpu_torch.text import TextNorm

            self.frontend = TextNorm(dtype=frontend)
        else:
            self.frontend = None

        # ---- a distilled student's sidecar, read before the backbone is built:
        # its head split (same parameters) and, at infer time, its sampler settings
        self.student: Optional[dict] = None
        if ckpt_file:
            from lemas_tts_tpu_torch.weights import checkpoint_file

            sidecar = (Path(ckpt_file) if os.path.isdir(ckpt_file)
                       else Path(ckpt_file).parent) / "student.json"
            ckpt_file = str(checkpoint_file(ckpt_file))
            if sidecar.is_file():
                import dataclasses
                import json

                self.student = json.loads(sidecar.read_text())
                if self.student.get("arch"):
                    arch = dataclasses.replace(
                        self.config.arch,
                        **{k: int(v) for k, v in self.student["arch"].items()})
                    self.config = dataclasses.replace(self.config, arch=arch)

        # ---- acoustic model (the config's backbone)
        mel = self.config.mel_spec
        backbone = backbones[self.config.backbone]
        self.dit = seeded_init(lambda: backbone(self.config.arch, mel_dim=mel.n_mel_channels,
                                                 text_num_embeds=self.vocab.size,
                                                 compute_dtype=dtype,
                                                 attn_backend=self.attn_backend), seed=0)
        pros_to_mel = None
        if ckpt_file:
            state, pros_to_mel = load_reference_checkpoint(ckpt_file, use_ema=use_ema)
            self.dit.load_state_dict(state)
        else:
            warnings.warn("no checkpoint — random-initializing model weights")
        if quantization is not None:  # from the float weights, before the dtype cast
            quantize_dense_tree(self.dit, MODES[quantization])

        # ---- prosody encoder and prosody_to_mel (f32, frozen)
        self.prosody_encoder = self.prosody_to_mel = None
        if use_pros:
            from lemas_tts_tpu_torch.models.prosody import ProsodyEncoder

            def random_to_mel():
                lin = torch.nn.Linear(PROSODY_DIM, mel.n_mel_channels)
                torch.nn.init.normal_(lin.weight, std=0.02)
                torch.nn.init.zeros_(lin.bias)
                return lin

            self.prosody_to_mel = seeded_init(random_to_mel, seed=2)
            if pros_to_mel is not None:
                self.prosody_to_mel.load_state_dict(pros_to_mel)
            self.prosody_to_mel.to(self.device).eval()
            self.prosody_encoder = ProsodyEncoder.build(
                cfg_path=prosody_cfg_path or self.config.prosody_cfg_path,
                ckpt_path=prosody_ckpt_path or self.config.prosody_ckpt_path, device=self.device)

        # ---- vocoder (the config's mel_spec_type)
        self.vocoder = self._build_vocoder(mel, dtype, vocoder_local_path)

        for m in (self.dit, self.vocoder):
            cast_matrices(m, dtype).to(self.device).eval()
        self.synth = Synthesizer(self.dit, self.vocoder, self.vocab, mel, device=self.device,
                                 prosody_encoder=self.prosody_encoder,
                                 prosody_to_mel=self.prosody_to_mel, mesh=mesh)

    @staticmethod
    def _build_vocoder(mel, dtype: torch.dtype, vocoder_local_path: Optional[str]):
        """Vocos (the published ``pytorch_model.bin``) or BigVGAN (NVIDIA's
        generator, weight norm folded); random weights from a seed when the
        default path holds none, ``FileNotFoundError`` when a path that was
        given holds none."""
        from lemas_tts_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
        from lemas_tts_tpu_torch.models.vocos import Vocos
        from lemas_tts_tpu_torch.weights import find_bigvgan_checkpoint, load_bigvgan_checkpoint

        bigvgan = mel.mel_spec_type == "bigvgan"
        default = "bigvgan_v2_24khz_100band_256x" if bigvgan else "vocos-mel-24khz"
        voc_path = Path(vocoder_local_path if vocoder_local_path is not None
                        else find_pretrained_root() / "ckpts" / default)
        if bigvgan:
            vocoder = seeded_init(lambda: BigVGAN(BigVGANConfig.for_hop(
                mel.hop_length, mel.n_mel_channels), compute_dtype=dtype), seed=1)
            ckpt = find_bigvgan_checkpoint(voc_path)
        else:
            vocoder = seeded_init(lambda: Vocos(input_channels=mel.n_mel_channels,
                                                 n_fft=mel.n_fft, hop_length=mel.hop_length,
                                                 compute_dtype=dtype), seed=1)
            ckpt = voc_path / "pytorch_model.bin"
            ckpt = ckpt if ckpt.is_file() else None
        if ckpt is None:
            if vocoder_local_path is not None:
                raise FileNotFoundError(f"no vocoder weights at {voc_path}")
            warnings.warn(f"no vocoder weights at {voc_path} — random init")
            return vocoder
        sd = (load_bigvgan_checkpoint(ckpt) if bigvgan
              else torch.load(ckpt, map_location="cpu", weights_only=True))
        keys = set(vocoder.state_dict())  # drops Vocos' mel extractor and istft window
        vocoder.load_state_dict({k: v for k, v in sd.items() if k in keys})
        return vocoder

    def load_weights(self, dit_state: dict, vocoder_state: Optional[dict] = None,
                     prosody_state: Optional[dict] = None,
                     prosody_to_mel_state: Optional[dict] = None) -> None:
        """Replace the weights (e.g. from :mod:`lemas_tts_tpu_torch.weights`);
        the backbone's and the vocoder's are stored in their compute dtype on
        the device, the prosody encoder's and ``prosody_to_mel``'s in f32, and
        a quantized model quantizes the float weights as they load."""
        self.dit.load_state_dict(dit_state)
        if vocoder_state is not None:
            self.vocoder.load_state_dict(vocoder_state)
        if prosody_state is not None:
            self.prosody_encoder.model.load_state_dict(prosody_state)
        if prosody_to_mel_state is not None:
            self.prosody_to_mel.load_state_dict(prosody_to_mel_state)

    def prepare_units(self, text: str):
        """One text -> frontend token units, exactly as :meth:`infer` prepares
        them (phone: ``text2phn`` split on ``|`` with ``(cmn)``->``(zh)``;
        char: ``text2norm`` + lang tag; no frontend or a byte vocab: the raw
        string)."""
        if self.vocab.char_map is None or self.frontend is None:
            return text
        if self.frontend.dtype == "phone":
            return self.frontend.text2phn(text + ". ").replace("(cmn)", "(zh)").split("|")
        lang, norm = self.frontend.text2norm(text + ". ")
        return [f"({lang.replace('cmn', 'zh')})"] + list(norm)

    def process_phone_list(self, parts: Sequence[str]) -> List[str]:
        return process_phone_list(parts, self.langs)

    def transcribe(self, ref_audio, language: Optional[str] = None) -> str:
        """Whisper transcription of a WAV path or a ``(wave, sr)`` pair on
        this ``TTS``'s device (``infer/asr.py``)."""
        from lemas_tts_tpu_torch.infer.asr import transcribe

        return transcribe(ref_audio, language, device=self.device)

    def export_wav(self, wav: np.ndarray, file_wave: str) -> None:
        from lemas_tts_tpu_torch.utils.audio_io import write_wav

        write_wav(file_wave, np.asarray(wav), self.target_sample_rate)

    def export_spectrogram(self, spec: np.ndarray, file_spec: str) -> None:
        """Save a [n_mels, T] spectrogram image (reference
        ``utils_infer.py:646-651``)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(12, 4))
        plt.imshow(np.asarray(spec), origin="lower", interpolation="nearest", aspect="auto")
        plt.colorbar()
        plt.savefig(file_spec)
        plt.close(fig)

    def infer(self, ref_file, ref_text: str, gen_text: str, show_info=print,
              target_rms: float = 0.1, cross_fade_duration: float = 0.15,
              use_acc_grl: bool = False, ref_ratio: Optional[float] = None,
              no_ref_audio: bool = False, cfg_strength: float = 2.0, nfe_step: int = 32,
              speed: float = 1.0, sway_sampling_coef: Optional[float] = 5,
              cfg_cutoff: Optional[float] = None, separate_langs: bool = False,
              fix_duration: Optional[float] = None, use_prosody_encoder: bool = True,
              file_wave: Optional[str] = None, file_spec: Optional[str] = None,
              seed: Optional[int] = None, transcribe_fn=None,
              block_cache: Optional[str] = None):
        """Zero-shot TTS. ``ref_file`` is a WAV path or a ``(wave, sr)``
        tuple. One chunk per line of ``gen_text`` with a frontend; the raw
        string path chunks by a byte budget. ``block_cache`` is a
        ``"lo-hi:every[+hN][+tN]"`` block-range cache spec;
        ``use_prosody_encoder`` conditions a prosody model's request on the
        reference's prosody. An empty ``ref_text`` is transcribed by
        ``transcribe_fn(wave, sr)``, by default :meth:`transcribe`, once for
        each reference audio (``infer/preprocess.py``'s cache). Returns
        ``(wav, sample_rate, spec)``."""
        from lemas_tts_tpu_torch.infer.pipeline import chunk_text
        from lemas_tts_tpu_torch.infer.preprocess import preprocess_ref_audio_text

        if seed is None:
            seed = random.randint(0, 2 ** 31 - 1)
        self.seed = seed
        if transcribe_fn is None:
            transcribe_fn = lambda w, s: self.transcribe((w, s))  # noqa: E731
        wav, sr, ref_text = preprocess_ref_audio_text(ref_file, ref_text, show_info=show_info,
                                                      transcribe_fn=transcribe_fn)
        if self.vocab.char_map is not None and self.frontend is not None:
            ref_units = self.prepare_units(ref_text)
            gen_chunks = [self.prepare_units(x) for x in gen_text.split("\n")]
        else:  # raw-string path with a byte budget per chunk (api.py:555-562)
            ref_units = ref_text
            max_chars = int(len(ref_text.encode("utf-8")) / (wav.shape[-1] / sr)
                            * (22 - wav.shape[-1] / sr)) if wav.shape[-1] > 0 else 135
            gen_chunks = chunk_text(gen_text, max_chars=max(1, max_chars))
        if separate_langs and not isinstance(ref_units, str):
            ref_units = self.process_phone_list(ref_units)
            gen_chunks = [self.process_phone_list(x) for x in gen_chunks]
        cfg = SamplerConfig(nfe_steps=nfe_step, cfg_strength=cfg_strength,
                            sway_sampling_coef=sway_sampling_coef, cfg_cutoff=cfg_cutoff,
                            block_cache=block_cache, ode_method=self.ode_method,
                            speed=speed, target_rms=target_rms,
                            cross_fade_duration=cross_fade_duration, use_acc_grl=use_acc_grl,
                            use_prosody_encoder=use_prosody_encoder and self.use_prosody_encoder,
                            ref_ratio=ref_ratio, no_ref_audio=no_ref_audio,
                            fix_duration=fix_duration)
        cfg = self.apply_student_settings(cfg, show_info=show_info)
        wave, out_sr, spec = self.synth.synthesize_chunks(wav, sr, ref_units, gen_chunks,
                                                          cfg=cfg, seed=seed)
        if file_wave is not None:
            self.export_wav(wave, file_wave)
        if file_spec is not None:
            self.export_spectrogram(spec, file_spec)
        return wave, out_sr, spec

    def apply_student_settings(self, cfg: SamplerConfig, show_info=None) -> SamplerConfig:
        """For a distilled student (a ``student.json`` sidecar), the sampler
        settings it was trained for: ``steps=K``, ``cfg_strength=0`` (the
        guidance is in the weights), its sway, no CFG cutoff, and the block
        cache only when the sidecar names one. The caller's NFE and CFG are
        overridden. ``cfg`` unchanged for other checkpoints."""
        if self.student is None:
            return cfg
        import dataclasses

        new = dataclasses.replace(
            cfg, nfe_steps=int(self.student["student_steps"]),
            cfg_strength=float(self.student.get("cfg_strength", 0.0)),
            sway_sampling_coef=self.student.get("sway_sampling_coef"), cfg_cutoff=None,
            block_cache=self.student.get("block_cache"))
        if show_info is not None and (cfg.nfe_steps != new.nfe_steps
                                      or cfg.cfg_strength != new.cfg_strength):
            show_info(f"distilled student checkpoint: sampler pinned to steps={new.nfe_steps}, "
                      "cfg_strength=0 (baked-in guidance)")
        return new


def process_phone_list(parts: Sequence[str], langs=LANGS) -> List[str]:
    """Prefix bare phones with the current ``(lang)`` tag and collapse
    separator/punctuation runs (reference ``api.py:252-276``; phones before
    the first tag pass through bare, as there)."""
    processed: List[str] = []
    current_lang = ""
    for part in parts:
        if part.startswith("(") and part.endswith(")") and part[1:-1] in langs:
            current_lang = part
        elif part in _PUNCS:
            if processed and processed[-1] == "_":
                processed.pop()
            elif processed and processed[-1] in _PUNCS and part == "_":
                continue
            processed.append(part)
        else:
            processed.append(f"{current_lang}{part}")
    return processed
