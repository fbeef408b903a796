"""A toy backbone family that no configuration of the benchmark uses: one
hidden layer on the frame's noisy mel, its kept-frame condition and its
text embedding, with the time added. Test files copy it into a temporary
checkout as ``portbench/backbones/<name>.py`` to show that a backbone the
harness has never seen is taken by new files only. Its program half is its
own ``torch`` module (the sampler's contract: ``embed_text`` and the forward
that ``cfm/sampler.py:sample_mel`` calls); its reference half is the same
arithmetic from the weights alone."""

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _dims(config: dict) -> tuple:
    m = config["model"]
    return m["arch"]["dim"], m["mel_spec"]["n_mel_channels"], config["vocab_size"]


def param_shapes(config: dict) -> Dict[str, tuple]:
    d, mel, vocab = _dims(config)
    return {"text.weight": (vocab + 1, d), "inp.weight": (d, 2 * mel + d), "inp.bias": (d,),
            "time_scale": (d,), "out.weight": (mel, d), "out.bias": (mel,)}


def weight_rule(name: str, shape: tuple) -> Optional[tuple]:
    return (0.0, 1.0) if name == "time_scale" else None


def _text(table, ids, n: int, drop_text: bool):
    ids = ids.long() + 1
    ids = F.pad(ids, (0, n - ids.shape[1]))[:, :n] if ids.shape[1] < n else ids[:, :n]
    return table[torch.zeros_like(ids) if drop_text else ids]


def _velocity(W, x, cond, text_emb, t):
    h = torch.cat([x, cond, text_emb], dim=-1) @ W["inp.weight"].t() + W["inp.bias"]
    h = torch.tanh(h + t.float()[:, None, None] * W["time_scale"])
    return h @ W["out.weight"].t() + W["out.bias"]


class Toy(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        d, mel, vocab = _dims(config)
        self.text = nn.Embedding(vocab + 1, d)
        self.inp = nn.Linear(2 * mel + d, d)
        self.time_scale = nn.Parameter(torch.zeros(d))
        self.out = nn.Linear(d, mel)

    def embed_text(self, text_ids, seq_len: int, drop_text: bool = False):
        return _text(self.text.weight, text_ids, seq_len, drop_text)

    def forward(self, x, cond, text_ids, time, mask, text_embed=None, prosody_text=None):
        return _velocity(dict(self.named_parameters()), x.float(), cond.float(), text_embed, time)


def build(config: dict, config_path, compute_dtype):
    return Toy(config)


def text_embedding(W, config: dict, ids, n: int, drop_text: bool):
    return _text(W["text.weight"], ids, n, drop_text)


def velocity(W, config: dict, x, cond, text_emb, t, mask, lo_hi, refresh: bool, cache):
    return _velocity(W, x, cond, text_emb, t.expand(x.shape[0])), cache


quantize_blocks = quantize_all = None


def depth(config: dict) -> int:
    return 0


def block_kernels(config: dict, quant) -> List[str]:
    return []


def sampler_call_flops(config: dict, sampler: dict, batch: int, n: int, quant=None) -> dict:
    d, mel, _ = _dims(config)
    width = 2 if sampler["cfg_strength"] >= 1e-5 else 1
    per_row = 2.0 * n * d * (3 * mel + d)
    return {"bf16": sampler["nfe_steps"] * width * batch * per_row, "int8": 0.0}
