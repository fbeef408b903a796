"""The DiT backbone family (``model.backbone: "DiT"``): F5-TTS and LEMAS-TTS.

What the harness needs of a backbone, each a function of the whole
configuration file:

- ``param_shapes``: name -> shape of every parameter, in the order of the
  seeded draw (``portbench/weights.py``); ``weight_rule``: the ``(mean,
  std)`` of the parameters that the common rule does not fit, else None;
- ``build``: the program's model through the port's own classes (the port is
  imported inside it only);
- the reference (``portbench/reference/dit.py``, which imports nothing of
  the program): ``text_embedding``, ``velocity`` (one sampler step under the
  block-range cache), and the control hooks ``quantize_blocks`` (W8A8 /
  W4A4 block products) and ``quantize_all`` (fp8);
- ``depth``: the blocks of one forward, which the block cache skips;
- ``block_kernels``: the hand-written kernels one block evaluation launches,
  once each (K1-K6, whose arithmetic ``portbench/roofline.py`` holds);
- ``sampler_call_flops``: the FLOPs of one sampler call, by the peak each
  part is held against.

The FLOP count is a frozen copy of the sampler's analytic model, from
``lemas_tts_tpu_torch/utils/flops.py`` at commit a2fd43e
(``dit_block_flops_per_row``, ``dit_embed_head_flops_per_row``,
``text_embed_flops_per_row``, ``sampler_call_flops``), so that a later
change to the program does not move the yardstick; split by the precision
each product runs in (under W8A8 the q/k/v, out and feed-forward products
are int8, the rest bf16). Matmul work only: elementwise, softmax, norm work
and the vocoder are left out, so a share from it reads slightly low.

The routing is the block's (``models/modules.py`` at a2fd43e): under the
``vmem`` backend a block with rope on every head, no qk norm and d64 heads
in pairs (or d128) runs K1 + K3 for attention, else the split-head chain
with K5; the feed-forward side is K2; W8A8 int8 takes the q/k/v, out and
feed-forward products to ``torch._int_mm``, which leaves K1 and K2 and keeps
K3 or K5.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench.flops import schedule
from portbench.reference import dit as ref


def param_shapes(config: dict) -> Dict[str, tuple]:
    m = config["model"]
    return ref.param_shapes(m["arch"], m["mel_spec"]["n_mel_channels"], config["vocab_size"])


def weight_rule(name: str, shape: tuple) -> Optional[tuple]:
    """The text embedding table ``N(0, 1)``."""
    return (0.0, 1.0) if name.endswith("text_embed.text_embed.weight") else None


def build(config: dict, config_path, compute_dtype):
    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT

    mc = load_model_config(config_path)
    return DiT(mc.arch, mel_dim=mc.mel_spec.n_mel_channels, text_num_embeds=config["vocab_size"],
               compute_dtype=compute_dtype, attn_backend="vmem")


def text_embedding(W, config: dict, ids, n: int, drop_text: bool):
    return ref.text_embedding(W, config["model"]["arch"], ids, n, drop_text)


def velocity(W, config: dict, x, cond, text_emb, t, mask, lo_hi, refresh: bool, cache):
    return ref.velocity(W, config["model"]["arch"], x, cond, text_emb, t, mask, lo_hi, refresh,
                        cache)


def quantize_blocks(W, config: dict, fmt):
    return ref.quantize_blocks(W, config["model"]["arch"]["depth"], fmt)


def quantize_all(W, config: dict, fmt):
    return ref.quantize_all(W, fmt)


def depth(config: dict) -> int:
    return config["model"]["arch"]["depth"]


def block_kernels(config: dict, quant: Optional[str]) -> List[str]:
    """The hand-written kernels one block evaluation launches, once each."""
    arch = config["model"]["arch"]
    heads, dh = arch["heads"], arch["dim_head"]
    flat = (arch.get("qk_norm") is None and arch.get("pe_attn_head") is None
            and ((dh == 64 and heads % 2 == 0) or dh == 128))
    out = []
    if quant is None:
        out += ["K1", "K3"] if flat else ["K5"]
        out.append("K2")
    else:
        out.append("K3" if flat else "K5")
    return out


def block_flops_per_row(arch: dict, n: int) -> Dict[str, float]:
    """One block, one row of ``n`` frames: ``proj`` (q, k, v, out and the
    feed-forward products, the ones W8A8 quantizes) and ``other``."""
    d = arch["dim"]
    inner = arch["heads"] * arch["dim_head"]
    attn_proj = 8.0 * n * d * inner
    attn_core = 4.0 * n * n * inner
    ff = 4.0 * arch["ff_mult"] * n * d * d
    modulation = 12.0 * d * d
    return {"proj": attn_proj + ff, "other": attn_core + modulation}


def embed_head_flops_per_row(arch: dict, n: int, mel_dim: int) -> float:
    d = arch["dim"]
    text_dim = arch["text_dim"] if arch.get("text_dim") is not None else mel_dim
    input_proj = 2.0 * n * (2 * mel_dim + text_dim) * d
    conv_pos = 2 * (2.0 * n * d * (d / 16.0) * 31)
    time_mlp = 4.0 * d * d
    head = 4.0 * d * d + 2.0 * n * d * mel_dim
    return input_proj + conv_pos + time_mlp + head


def text_embed_flops_per_row(arch: dict, n: int, mel_dim: int) -> float:
    td = arch["text_dim"] if arch.get("text_dim") is not None else mel_dim
    per_layer = 2.0 * n * td * 7 + 2 * (2.0 * n * td * td * arch.get("conv_mult", 2))
    return arch["conv_layers"] * per_layer


def sampler_call_flops(config: dict, sampler: dict, batch: int, n: int,
                       quant: Optional[str] = None) -> Dict[str, float]:
    """FLOPs of one sampler call on a ``[batch, n]`` bucket, by the peak
    each part is held against: ``{"bf16": ..., "int8": ...}``."""
    arch = config["model"]["arch"]
    mel_dim = config["model"]["mel_spec"]["n_mel_channels"]
    blk = block_flops_per_row(arch, n)
    embed = embed_head_flops_per_row(arch, n, mel_dim)
    proj = other = 0.0
    for width, blocks in schedule(sampler, arch["depth"]):
        rows = width * batch
        proj += rows * blocks * blk["proj"]
        other += rows * (blocks * blk["other"] + embed)
    n_te = 2 if sampler["cfg_strength"] >= 1e-5 else 1
    other += n_te * batch * text_embed_flops_per_row(arch, n, mel_dim)
    if quant == "int8":
        return {"bf16": other, "int8": proj}
    return {"bf16": other + proj, "int8": 0.0}
