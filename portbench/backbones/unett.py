"""The UNetT backbone family (``model.backbone: "UNetT"``): E2 TTS.

What the harness needs of a backbone (``backbones/dit.py`` lists it), for
the port's ``models/unett.py:UNetT``: pre-norm RMSNorm blocks without
AdaLN, long skips from the first half to the second (concat and a bias-free
projection), the time embedding as token 0, so that every block runs at
N + 1 frames.

Routing (``models/modules.py:Attention``): the flat kernel K3 takes only N a
multiple of 64 with rope on every head, and N + 1 never is one for the
duration buckets, so under the ``vmem`` backend every block's attention is
the split-head chain with K5; the q/k/v, out and feed-forward products are
``dense`` (cuBLAS), not K1 or K2. The port takes W8A8 for the DiT only
(``api.py``), so there is no ``quantize_blocks``; ``quantize_all`` (fp8, the
control) is the reference's.

FLOPs of one sampler call: matmul work only, as the DiT family counts it.
Per row and block at n' = N + 1: the q/k/v/out products ``8 n' d inner``,
attention ``4 n'^2 inner``, the feed-forward ``4 ff_mult n' d^2``; each
skip projection of the second half ``4 n' d^2`` (2d -> d); per row at N:
the input projection ``2 N (2 mel + text_dim) d``, the conv position
embedding ``2 * 2 N d (d/16) 31``, the time MLP ``2 (256 d + d^2)`` and the
head ``2 N d mel``; the text embedding's ConvNeXt stack where there is one.
No modulation. The block cache does not apply: the port drops it for a
UNetT, so every step runs every block.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench.backbones import dit
from portbench.flops import schedule
from portbench.reference import dit as ref_dit
from portbench.reference import unett as ref

NORM_GAINS = (".1.weight", ".3.weight")  # layers.{i}.1 and .3: the blocks' RMSNorm gains


def param_shapes(config: dict) -> Dict[str, tuple]:
    m = config["model"]
    return ref.param_shapes(m["arch"], m["mel_spec"]["n_mel_channels"], config["vocab_size"])


def weight_rule(name: str, shape: tuple) -> Optional[tuple]:
    """The text embedding table ``N(0, 1)``; the RMSNorm gains ``1 + N(0,
    0.02^2)``, as the common rule draws LayerNorm weights."""
    if len(shape) == 1 and (name == "norm_out.weight"
                            or (name.startswith("layers.") and name.endswith(NORM_GAINS))):
        return 1.0, 0.02
    return dit.weight_rule(name, shape)


def build(config: dict, config_path, compute_dtype):
    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.models.unett import UNetT

    mc = load_model_config(config_path)
    return UNetT(mc.arch, mel_dim=mc.mel_spec.n_mel_channels,
                 text_num_embeds=config["vocab_size"], compute_dtype=compute_dtype,
                 skip_connect_type=ref.skip_type(config["model"]["arch"]), attn_backend="vmem")


def text_embedding(W, config: dict, ids, n: int, drop_text: bool):
    return ref_dit.text_embedding(W, config["model"]["arch"], ids, n, drop_text)


def velocity(W, config: dict, x, cond, text_emb, t, mask, lo_hi, refresh: bool, cache):
    return ref.velocity(W, config["model"]["arch"], x, cond, text_emb, t, mask, lo_hi, refresh,
                        cache)


quantize_blocks = None


def quantize_all(W, config: dict, fmt):
    return ref_dit.quantize_all(W, fmt)


def depth(config: dict) -> int:
    return config["model"]["arch"]["depth"]


def block_kernels(config: dict, quant: Optional[str]) -> List[str]:
    """The hand-written kernels one block evaluation launches, once each."""
    return ["K5"]


def _arch(config: dict) -> dict:
    """The arch with ``text_dim`` resolved (None: the mel's width)."""
    m = config["model"]
    td = m["arch"].get("text_dim")
    return dict(m["arch"], text_dim=m["mel_spec"]["n_mel_channels"] if td is None else td)


def block_flops_per_row(arch: dict, n: int) -> float:
    """One block, one row, ``n`` tokens (the time token included)."""
    d, inner = arch["dim"], arch["heads"] * arch["dim_head"]
    return 8.0 * n * d * inner + 4.0 * n * n * inner + 4.0 * arch["ff_mult"] * n * d * d


def sampler_call_flops(config: dict, sampler: dict, batch: int, n: int,
                       quant: Optional[str] = None) -> Dict[str, float]:
    """FLOPs of one sampler call on a ``[batch, n]`` bucket, all at the bf16
    peak: ``{"bf16": ..., "int8": 0.0}``."""
    arch = _arch(config)
    mel = config["model"]["mel_spec"]["n_mel_channels"]
    d, depth_ = arch["dim"], arch["depth"]
    n1 = n + 1
    skips = depth_ // 2 if ref.skip_type(arch) == "concat" else 0
    per_row = (depth_ * block_flops_per_row(arch, n1) + skips * 4.0 * n1 * d * d
               + 2.0 * n * (2 * mel + arch["text_dim"]) * d
               + 2 * (2.0 * n * d * (d / 16.0) * 31)
               + 2.0 * (256 * d + d * d) + 2.0 * n * d * mel)
    total = 0.0
    for width, _ in schedule(dict(sampler, block_cache=None), depth_):
        total += width * batch * per_row
    n_te = 2 if sampler["cfg_strength"] >= 1e-5 else 1
    total += n_te * batch * dit.text_embed_flops_per_row(arch, n, mel)
    return {"bf16": total, "int8": 0.0}
