"""A toy vocoder family that no configuration of the benchmark uses: each
mel frame to ``hop`` samples through one linear layer and a tanh. Test files
copy it into a temporary checkout as ``portbench/vocoders/<name>.py``. Its
program half keeps the ``Synthesizer``'s contract (``decode(mel, mask)``,
``wave_length(frames)``)."""

from typing import Dict, Optional

import torch
from torch import nn


def _dims(config: dict) -> tuple:
    mel = config["model"]["mel_spec"]
    return mel["n_mel_channels"], mel["hop_length"]


def param_shapes(config: dict) -> Dict[str, tuple]:
    n_mels, hop = _dims(config)
    return {"frame.weight": (hop, n_mels), "frame.bias": (hop,)}


def weight_rule(name: str, shape: tuple) -> Optional[tuple]:
    return None


def _decode(W, mel):
    """``mel [B, n_mels, T]`` -> ``[B, T * hop]``."""
    w = torch.tanh(mel.float().transpose(1, 2) @ W["frame.weight"].t() + W["frame.bias"])
    return w.reshape(w.shape[0], -1)


class ToyVocoder(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        n_mels, self.hop = _dims(config)
        self.frame = nn.Linear(n_mels, self.hop)

    def wave_length(self, n_frames: int) -> int:
        return n_frames * self.hop

    def decode(self, mel, frame_mask=None):
        return _decode(dict(self.named_parameters()), mel)


def build(config: dict, config_path, compute_dtype):
    return ToyVocoder(config)


def decode(W, config: dict, mel):
    return _decode(W, mel[None])[0]


quantize_blocks = quantize_all = None
