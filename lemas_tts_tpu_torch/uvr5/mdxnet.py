"""MDX-Net ``ConvTDFNet`` (counterpart of ``lemas_tts_tpu/uvr5/mdxnet.py``).

The TFC-TDF U-Net of the UVR5 MDX models (reference
``uvr5/lib_v5/mdxnet.py:34-124`` and ``uvr5/lib_v5/modules.py``):

  1×1 stem conv → n× [TFC_TDF → 2×2 strided conv] → bottleneck TFC_TDF →
  n× [2×2 transpose conv → ×skip → TFC_TDF] → 1×1 head conv

TFC = stack of 3×3 convs (+norm+ReLU); TDF = bottlenecked Linear over the
frequency axis, added residually. Skip connections are *multiplicative*
(``mdxnet.py:117``). The layout is the reference's ``[B, C, T, F]``, so the
frequency Linear acts on the last axis; the modules and their parameter
names are the reference's (``first_conv.0``, ``encoding_blocks.{i}.tfc.H.{j}.0``,
``encoding_blocks.{i}.tdf.{0,3}``, ``ds.{i}.0``, ``us.{i}.0``,
``bottleneck_block``, ``final_conv.0``), so a reference ``.ckpt`` state dict
or the initializers of an ``.onnx`` file load with ``load_state_dict``.

Norms: models trained with adamw use ``GroupNorm(2)`` (``mdxnet.py:52-55``);
rmsprop models use ``BatchNorm2d``, which runs here in eval mode on its
running statistics (the JAX package folds them into a per-channel affine,
``norm="affine"``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


@dataclass(frozen=True)
class MDXConfig:
    """ConvTDFNet hyper-parameters. Defaults match the UVR Kim/Voc family
    (n_fft 7680, dim_f 3072, dim_t 2^8, 11 blocks, growth 32/48 varies)."""

    dim_c: int = 4
    dim_f: int = 3072
    dim_t: int = 256
    n_fft: int = 7680
    hop: int = 1024
    num_blocks: int = 11
    l: int = 3  # convs per TFC
    g: int = 48  # channel growth
    k: int = 3  # TFC kernel
    bn: int = 8  # TDF bottleneck factor (0 = single Linear)
    bias: bool = False
    norm: str = "group"  # "group" (adamw) | "affine" (BatchNorm, eval mode)

    @property
    def n(self) -> int:
        return self.num_blocks // 2

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1


def norm_layer(mode: str, c: int) -> nn.Module:
    """``GroupNorm(2, eps 1e-5)`` for ``"group"``, ``BatchNorm2d`` (eval
    mode: its running statistics) for ``"affine"``."""
    if mode == "group":
        return nn.GroupNorm(2, c, eps=1e-5)
    if mode == "affine":
        return nn.BatchNorm2d(c, eps=1e-5)
    raise ValueError(f"unknown MDX norm {mode!r}")


class TFC(nn.Module):
    """l× (3×3 conv → norm → ReLU) (reference ``modules.py:5-22``)."""

    def __init__(self, c: int, l: int, k: int, norm: str):
        super().__init__()
        self.H = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(c, c, k, 1, k // 2), norm_layer(norm, c), nn.ReLU())
             for _ in range(l)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for h in self.H:
            x = h(x)
        return x


class TFC_TDF(nn.Module):
    """TFC, plus the bottlenecked Linear over the frequency axis added
    residually (reference ``modules.py:25-68``). x: [B, C, T, F]."""

    def __init__(self, c: int, l: int, f: int, k: int, bn: int, bias: bool, norm: str):
        super().__init__()
        self.tfc = TFC(c, l, k, norm)
        if bn == 0:
            self.tdf = nn.Sequential(nn.Linear(f, f, bias=bias), norm_layer(norm, c), nn.ReLU())
        else:
            self.tdf = nn.Sequential(
                nn.Linear(f, f // bn, bias=bias), norm_layer(norm, c), nn.ReLU(),
                nn.Linear(f // bn, f, bias=bias), norm_layer(norm, c), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.tfc(x)
        return x + self.tdf(x)


class ConvTDFNet(nn.Module):
    """[B, dim_c, dim_t, dim_f] packed spectrogram → same shape (the target
    stem). Call ``.eval()`` before use when ``norm="affine"``."""

    def __init__(self, cfg: MDXConfig):
        super().__init__()
        self.cfg = c = cfg
        self.first_conv = nn.Sequential(nn.Conv2d(c.dim_c, c.g, 1), norm_layer(c.norm, c.g),
                                        nn.ReLU())
        f, ch = c.dim_f, c.g
        self.encoding_blocks, self.ds = nn.ModuleList(), nn.ModuleList()
        for _ in range(c.n):
            self.encoding_blocks.append(TFC_TDF(ch, c.l, f, c.k, c.bn, c.bias, c.norm))
            self.ds.append(nn.Sequential(nn.Conv2d(ch, ch + c.g, 2, 2),
                                         norm_layer(c.norm, ch + c.g), nn.ReLU()))
            f, ch = f // 2, ch + c.g
        self.bottleneck_block = TFC_TDF(ch, c.l, f, c.k, c.bn, c.bias, c.norm)
        self.decoding_blocks, self.us = nn.ModuleList(), nn.ModuleList()
        for _ in range(c.n):
            self.us.append(nn.Sequential(nn.ConvTranspose2d(ch, ch - c.g, 2, 2),
                                         norm_layer(c.norm, ch - c.g), nn.ReLU()))
            f, ch = f * 2, ch - c.g
            self.decoding_blocks.append(TFC_TDF(ch, c.l, f, c.k, c.bn, c.bias, c.norm))
        self.final_conv = nn.Sequential(nn.Conv2d(ch, c.dim_c, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.first_conv(x)
        skips = []
        for enc, ds in zip(self.encoding_blocks, self.ds):
            x = enc(x)
            skips.append(x)
            x = ds(x)
        x = self.bottleneck_block(x)
        for i, (us, dec) in enumerate(zip(self.us, self.decoding_blocks)):
            x = dec(us(x) * skips[-i - 1])  # multiplicative skip (mdxnet.py:117)
        return self.final_conv(x)


class Mixer(nn.Module):
    """Multi-stem blending head (reference ``mdxnet.py:126-140``): a bias-free
    Linear over the (stems+mix)×2 channel stack, applied per sample.
    [n_stems+1, 2, T] → [n_stems, 2, T]."""

    def __init__(self, n_stems: int = 4):
        super().__init__()
        self.n_stems = n_stems
        self.linear = nn.Linear((n_stems + 1) * 2, n_stems * 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[-1]
        h = self.linear(x.reshape(1, (self.n_stems + 1) * 2, T).transpose(-1, -2))
        return h.transpose(-1, -2).reshape(self.n_stems, 2, T)


def seeded_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` in place: every conv/linear weight
    and bias uniform in ±1/sqrt(fan-in) (torch's default bound), norms at
    their identity (weight 1, bias 0, running mean 0, variance 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                bound = 1.0 / float(np.sqrt(m.weight[0].numel()))
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)
    return module


def infer_config_from_state_dict(
    sd: Mapping[str, np.ndarray], n_fft: int = 7680, hop: int = 1024,
    dim_t: int = 256, norm: str = "group",
) -> MDXConfig:
    """Derive (g, l, n, bn, bias, dim_f, dim_c) from tensor shapes so any
    MDX variant loads without a side-channel config."""
    g, dim_c = tuple(sd["first_conv.0.weight"].shape[:2])  # [g, dim_c, 1, 1]
    l = 0
    while f"encoding_blocks.0.tfc.H.{l}.0.weight" in sd:
        l += 1
    n = 0
    while f"encoding_blocks.{n}.tfc.H.0.0.weight" in sd:
        n += 1
    k = int(sd["encoding_blocks.0.tfc.H.0.0.weight"].shape[-1])
    f_out, dim_f = tuple(sd["encoding_blocks.0.tdf.0.weight"].shape)  # [f/bn or f, f]
    bn = 0 if f_out == dim_f and "encoding_blocks.0.tdf.3.weight" not in sd else dim_f // f_out
    bias = "encoding_blocks.0.tdf.0.bias" in sd
    return MDXConfig(dim_c=int(dim_c), dim_f=int(dim_f), dim_t=dim_t, n_fft=n_fft, hop=hop,
                     num_blocks=2 * n + 1, l=l, g=int(g), k=k, bn=int(bn), bias=bias,
                     norm=norm)


# ------------------------------------------------- reference -> JAX layout
def _conv2d_p(sd: Mapping[str, np.ndarray], p: str) -> Dict[str, np.ndarray]:
    # torch [out, in, kh, kw] (a transposed conv's [in, out, kh, kw]) ->
    # [kh, kw, in, out] ([kh, kw, out, in] with transpose_kernel)
    out = {"kernel": np.transpose(np.asarray(sd[f"{p}.weight"]), (2, 3, 1, 0))}
    if f"{p}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{p}.bias"])
    return out


def _norm_p(sd: Mapping[str, np.ndarray], p: str, mode: str) -> Dict[str, Any]:
    if mode == "group":
        return {"gn": {"scale": np.asarray(sd[f"{p}.weight"]),
                       "bias": np.asarray(sd[f"{p}.bias"])}}
    # BatchNorm's running statistics folded into an affine, as the JAX package does
    w, b = np.asarray(sd[f"{p}.weight"]), np.asarray(sd[f"{p}.bias"])
    mean, var = np.asarray(sd[f"{p}.running_mean"]), np.asarray(sd[f"{p}.running_var"])
    inv = w / np.sqrt(var + 1e-5)
    return {"scale": inv, "bias": b - mean * inv}


def _tdf_p(sd, p, mode, bias) -> Dict[str, Any]:
    # torch Sequential: Linear(0), norm(1), ReLU(2)[, Linear(3), norm(4), ReLU(5)]
    out: Dict[str, Any] = {"lin0_w": np.asarray(sd[f"{p}.0.weight"]).T,
                           "norm_0": _norm_p(sd, f"{p}.1", mode)}
    if bias:
        out["lin0_b"] = np.asarray(sd[f"{p}.0.bias"])
    if f"{p}.3.weight" in sd:
        out["lin1_w"] = np.asarray(sd[f"{p}.3.weight"]).T
        out["norm_1"] = _norm_p(sd, f"{p}.4", mode)
        if bias:
            out["lin1_b"] = np.asarray(sd[f"{p}.3.bias"])
    return out


def _tfc_tdf_p(sd, p, cfg: MDXConfig) -> Dict[str, Any]:
    tfc: Dict[str, Any] = {}
    for i in range(cfg.l):
        tfc[f"conv_{i}"] = _conv2d_p(sd, f"{p}.tfc.H.{i}.0")
        tfc[f"norm_{i}"] = _norm_p(sd, f"{p}.tfc.H.{i}.1", cfg.norm)
    return {"tfc": tfc, "tdf": _tdf_p(sd, f"{p}.tdf", cfg.norm, cfg.bias)}


def convert_convtdfnet(sd: Mapping[str, np.ndarray], cfg: MDXConfig) -> Dict[str, Any]:
    """A reference ``ConvTDFNet`` state dict (or an ``.onnx`` file's
    initializers), numpy -> the JAX ``ConvTDFNet``'s param tree, leaf for
    leaf what ``lemas_tts_tpu/uvr5/mdxnet.py:convert_convtdfnet`` gives
    (``scripts/convert_checkpoint.py --uvr5``)."""
    params: Dict[str, Any] = {"first_conv": _conv2d_p(sd, "first_conv.0"),
                              "first_norm": _norm_p(sd, "first_conv.1", cfg.norm),
                              "bottleneck": _tfc_tdf_p(sd, "bottleneck_block", cfg),
                              "final_conv": _conv2d_p(sd, "final_conv.0")}
    for i in range(cfg.n):
        params[f"enc_{i}"] = _tfc_tdf_p(sd, f"encoding_blocks.{i}", cfg)
        params[f"ds_conv_{i}"] = _conv2d_p(sd, f"ds.{i}.0")
        params[f"ds_norm_{i}"] = _norm_p(sd, f"ds.{i}.1", cfg.norm)
        params[f"us_conv_{i}"] = _conv2d_p(sd, f"us.{i}.0")
        params[f"us_norm_{i}"] = _norm_p(sd, f"us.{i}.1", cfg.norm)
        params[f"dec_{i}"] = _tfc_tdf_p(sd, f"decoding_blocks.{i}", cfg)
    return params
