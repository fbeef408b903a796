"""The Vocos vocoder family (``vocoder.name: "vocos"``; charactr/vocos-mel-24khz
layout): the widths from the configuration's ``vocoder`` section, the mel
settings from ``model.mel_spec``.

What the harness needs of a vocoder, each a function of the whole
configuration file: ``param_shapes`` and ``weight_rule`` (as a backbone
family's), ``build`` (the program's vocoder through the port's own classes,
imported inside it only; the ``Synthesizer`` calls its ``decode(mel,
mask)`` and ``wave_length(frames)``), the reference ``decode`` of one
unpadded mel (``portbench/reference/vocos.py``, which imports nothing of the
program) and the fp8 control's hook ``quantize_all``; the W8A8 path leaves
the vocoder as it is, so there is no ``quantize_blocks``.
"""

from __future__ import annotations

from typing import Dict, Optional

from portbench.reference import dit as ref_dit
from portbench.reference import vocos as ref


def param_shapes(config: dict) -> Dict[str, tuple]:
    v, mel = config["vocoder"], config["model"]["mel_spec"]
    return ref.param_shapes(mel["n_mel_channels"], v["dim"], v["intermediate_dim"],
                            v["num_layers"], mel["n_fft"])


def weight_rule(name: str, shape: tuple) -> Optional[tuple]:
    """The layer scales ``1/8 + N(0, 0.01^2)``."""
    return (0.125, 0.01) if name.endswith(".gamma") and len(shape) == 1 else None


def build(config: dict, config_path, compute_dtype):
    from lemas_tts_tpu_torch.models.vocos import Vocos

    v, mel = config["vocoder"], config["model"]["mel_spec"]
    return Vocos(input_channels=mel["n_mel_channels"], dim=v["dim"],
                 intermediate_dim=v["intermediate_dim"], num_layers=v["num_layers"],
                 n_fft=mel["n_fft"], hop_length=mel["hop_length"], compute_dtype=compute_dtype)


def decode(W, config: dict, mel):
    """``mel [n_mels, T]`` -> wave ``[(T - 1) * hop]``."""
    m = config["model"]["mel_spec"]
    return ref.decode(W, mel, config["vocoder"]["num_layers"], m["n_fft"], m["hop_length"])


def quantize_all(W, config: dict, fmt):
    return ref_dit.quantize_all(W, fmt)


quantize_blocks = None
