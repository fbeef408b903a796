"""Typed configuration: the dataclasses of ``lemas_tts_tpu/config.py``.

The bundled configs ship as JSON (``configs/``: the flagship
``multilingual``, the prosody-conditioned ``multilingual_prosody``, F5-TTS v0
``f5tts_base`` and its BigVGAN-vocoded ``f5tts_base_bigvgan``, and the E2-TTS
``e2tts_base`` on the UNetT backbone) so that the port needs no
``yaml`` at run time; ``yaml`` is imported only when a
``.yaml``/``.yml`` path is given.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

CONFIG_DIR = Path(__file__).parent / "configs"


@dataclass(frozen=True)
class DiTArch:
    """DiT backbone hyper-parameters (reference ``model.arch``)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    text_dim: int = 512
    text_mask_padding: bool = True
    qk_norm: Optional[str] = None  # None | "rms_norm"
    conv_layers: int = 4
    conv_mult: int = 2
    pe_attn_head: Optional[int] = None
    long_skip_connection: bool = False
    checkpoint_activations: bool = False
    dropout: float = 0.1

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head


@dataclass(frozen=True)
class MelSpecConfig:
    """Mel-spectrogram frontend parameters (reference ``model.mel_spec``)."""

    target_sample_rate: int = 24000
    n_mel_channels: int = 100
    hop_length: int = 256
    win_length: int = 1024
    n_fft: int = 1024
    mel_spec_type: str = "vocos"  # "vocos" | "bigvgan"

    @property
    def frames_per_second(self) -> float:
        return self.target_sample_rate / self.hop_length


@dataclass(frozen=True)
class VocoderConfig:
    is_local: bool = True
    local_path: str = "pretrained_models/ckpts/vocos-mel-24khz"
    name: str = "vocos"  # "vocos" | "bigvgan"


@dataclass(frozen=True)
class ModelConfig:
    """Top-level model config (reference ``model:`` section)."""

    name: str = "multilingual"
    backbone: str = "DiT"
    tokenizer: str = "custom"
    tokenizer_path: str = "pretrained_models/data/multilingual_grl/vocab.txt"
    use_ctc_loss: bool = True
    use_spk_enc: bool = False
    use_prosody_encoder: bool = False
    prosody_cfg_path: str = "pretrained_models/ckpts/prosody_encoder/pretssel_cfg.json"
    prosody_ckpt_path: str = (
        "pretrained_models/ckpts/prosody_encoder/prosody_encoder_UnitY2.pt"
    )
    arch: DiTArch = field(default_factory=DiTArch)
    mel_spec: MelSpecConfig = field(default_factory=MelSpecConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)


# Serving defaults, as the JAX package's serving entry points set them
# (``lemas_tts_tpu/config.py:95-135``); the library ``SamplerConfig`` keeps
# exact reference semantics (None), the server opts in. Their speed and error
# on the H100 are measured by ``chip_smoke.py`` (PERF.md), not carried over.
# CFG truncation: the uncond pass stops once cfg_strength·(1−t)² < 0.5.
SERVING_CFG_CUTOFF = 0.5
# Block-range residual cache: the whole stack's residual refreshed every 2nd
# step and on the last 2 steps, one cached add in between.
SERVING_BLOCK_CACHE = "0-22:2+t2"


def resolve_quant(value: Optional[str]) -> Optional[str]:
    """One grammar for the quantization knob of every entry point:
    ``None``/``""``/``"none"``/``"0"``/``"off"`` disable, ``"default"`` is the
    serving default, anything else is a mode that the model build checks."""
    if value is None or str(value).strip().lower() in ("", "none", "0", "off"):
        return None
    v = str(value).strip()
    return SERVING_QUANT if v == "default" else v


# W8A8 int8 for the DiT block products (``ops/quant.py``); the environment
# variable ``LEMAS_SERVING_QUANT`` overrides it ("" disables).
SERVING_QUANT: Optional[str] = resolve_quant(os.environ.get("LEMAS_SERVING_QUANT", "int8"))


@dataclass(frozen=True)
class SamplerConfig:
    """CFM sampler parameters (library defaults follow the reference
    ``utils_infer.py:77-79``: NFE 32, CFG 3.0, sway 1)."""

    nfe_steps: int = 32
    cfg_strength: float = 3.0
    sway_sampling_coef: Optional[float] = 1.0
    ode_method: str = "euler"  # "euler" (reference) | "midpoint" (2 evals a step)
    # opt-in CFG truncation: the uncond pass stops once cfg·(1−t)² < cutoff
    cfg_cutoff: Optional[float] = None
    # block-range residual cache spec "lo-hi:every[+hN][+tN]" (cfm/sampler.py)
    block_cache: Optional[str] = None
    max_duration: int = 4096
    speed: float = 1.0
    target_rms: float = 0.1
    cross_fade_duration: float = 0.15
    use_acc_grl: bool = True
    use_prosody_encoder: bool = True  # when the model has a prosody encoder
    ref_ratio: Optional[float] = None
    no_ref_audio: bool = False
    fix_duration: Optional[float] = None
    duplicate_test: bool = False
    t_inter: float = 0.1


@dataclass(frozen=True)
class TrainConfig:
    """Training fields mirrored from the reference ``optim:``/``datasets:``
    sections (``lemas_tts_tpu/config.py:TrainConfig``)."""

    epochs: int = 100
    learning_rate: float = 1e-5
    num_warmup_updates: int = 1000
    grad_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    batch_size_per_gpu: int = 40000
    batch_size_type: str = "frame"
    max_samples: int = 64
    audio_drop_prob: float = 0.3
    text_drop_prob: float = 0.1
    frac_lengths_mask: tuple[float, float] = (0.7, 1.0)
    save_per_updates: int = 1000
    keep_last_n_checkpoints: int = -1
    last_per_updates: int = 1000


def _filter_kwargs(cls, d: dict[str, Any]) -> dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def load_model_config(name_or_path: str | os.PathLike) -> ModelConfig:
    """Load a :class:`ModelConfig`: a bare name resolves to the bundled
    ``configs/<name>.json``; a ``.json`` path is read as JSON; a
    ``.yaml``/``.yml`` path needs ``pyyaml`` (imported only then)."""
    p = Path(name_or_path)
    if not p.suffix:
        p = CONFIG_DIR / f"{p.name}.json"
    if p.suffix in (".yaml", ".yml"):
        import yaml

        with open(p, "r", encoding="utf-8") as f:
            raw = yaml.safe_load(f)
    else:
        with open(p, "r", encoding="utf-8") as f:
            raw = json.load(f)

    m = raw.get("model", raw)
    arch = DiTArch(**_filter_kwargs(DiTArch, m.get("arch", {})))
    mel = MelSpecConfig(**_filter_kwargs(MelSpecConfig, m.get("mel_spec", {})))
    voc = VocoderConfig(**_filter_kwargs(VocoderConfig, m.get("vocoder", {})))
    return ModelConfig(
        arch=arch,
        mel_spec=mel,
        vocoder=voc,
        **_filter_kwargs(
            ModelConfig,
            {k: v for k, v in m.items() if k not in ("arch", "mel_spec", "vocoder")},
        ),
    )
