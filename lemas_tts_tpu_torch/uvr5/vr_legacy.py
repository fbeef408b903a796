"""Legacy UVR5 VR-architecture network ``CascadedASPPNet`` (counterpart of
``lemas_tts_tpu/uvr5/vr_legacy.py``).

The arch behind most published VR-arch separation checkpoints (reference
``uvr5/lib_v5/vr_network/nets.py:99-165`` with the capacity table at
``nets.py:49-97`` and layer library ``layers.py:7-143``): a three-stage
cascade of ASPP U-Nets over a multi-band magnitude spectrogram — stage 1
processes the low/high halves with separate nets, stages 2/3 refine the full
band through 1×1 "bridge" convs — emitting a sigmoid magnitude mask.

Model capacity comes in three families selected by ``nn_architecture`` (an
upstream convention: the checkpoint file size in KiB): "sp" {31191, 33966,
129605}, "hp" {123821, 123812}, "hp2" {537238, 537227}. Architecture 129605
adds a 5th encoder stage and a 6-branch ASPP; 537238/537227/33966 use a
7-branch ASPP whose two extra branches share one weight set in reference
checkpoints (``layers.py:103-110``: ``conv6``/``conv7`` are one module
object, so the files carry identical tensors under both names). Here they
are two modules, as in the JAX package: a reference file loads into both.

The layout is the reference's ``[B, C, F, T]`` and the parameter names its
own, the training-only ``aux1_out``/``aux2_out`` heads included (not run).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from lemas_tts_tpu_torch.uvr5.vr_network import ConvBNActiv, replicate_top, upsample_cat

SP_ARCHS = (31191, 33966, 129605)
HP_ARCHS = (123821, 123812)
HP2_ARCHS = (537238, 537227)
SIX_LAYER = (129605,)
SEVEN_LAYER = (537238, 537227, 33966)
NN_ARCH_SIZES = sorted(SP_ARCHS + HP_ARCHS + HP2_ARCHS)


class SeperableConvBNActiv(nn.Module):
    """Depthwise 3×3 dilated + pointwise 1×1 + BN + ReLU
    (reference ``layers.py:26-46``; the upstream spelling is kept)."""

    def __init__(self, nin: int, nout: int, ksize=3, stride=1, pad=1, dilation=1):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nin, ksize, stride, pad, dilation, groups=nin, bias=False),
            nn.Conv2d(nin, nout, 1, bias=False),
            nn.BatchNorm2d(nout, eps=1e-5),
            nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class EncoderLegacy(nn.Module):
    """conv1 (stride 1) → skip, conv2 (stride 2) → down; LeakyReLU
    (reference ``layers.py:50-62`` — the skip is conv1's output, the
    opposite of the new-arch Encoder)."""

    def __init__(self, nin: int, nout: int, stride: int = 2):
        super().__init__()
        self.conv1 = ConvBNActiv(nin, nout, 3, 1, 1, activ="leaky")
        self.conv2 = ConvBNActiv(nout, nout, 3, stride, 1, activ="leaky")

    def forward(self, x: torch.Tensor):
        skip = self.conv1(x)
        return self.conv2(skip), skip


class DecoderLegacy(nn.Module):
    """bilinear 2× (align_corners) → concat cropped skip → conv; ReLU
    (reference ``layers.py:65-83``; dropout branch unused at inference)."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv = ConvBNActiv(nin, nout, 3, 1, 1)

    def forward(self, x: torch.Tensor, skip=None) -> torch.Tensor:
        return self.conv(upsample_cat(x, skip))


class ASPPModuleLegacy(nn.Module):
    """Legacy ASPP: freq-pooled context + 1×1 + 3 (or 4/5) dilated separable
    branches → 1×1 bottleneck (reference ``layers.py:86-143``); branches 6
    and 7 take the last dilation."""

    def __init__(self, nin: int, nout: int, dilations: Sequence[int] = (4, 8, 16),
                 n_branches: int = 5):
        super().__init__()
        self.n_branches = n_branches
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)),
                                   ConvBNActiv(nin, nin, 1, 1, 0))
        self.conv2 = ConvBNActiv(nin, nin, 1, 1, 0)
        for i in range(3, n_branches + 1):
            d = dilations[min(i - 3, len(dilations) - 1)]
            setattr(self, f"conv{i}", SeperableConvBNActiv(nin, nin, 3, 1, d, d))
        # index 1 of the reference's Sequential is a Dropout2d: no parameters,
        # identity at inference
        self.bottleneck = nn.Sequential(ConvBNActiv(nin * n_branches, nout, 1, 1, 0),
                                        nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [self.conv1(x).expand(-1, -1, x.shape[2], -1), self.conv2(x)]
        feats += [getattr(self, f"conv{i}")(x) for i in range(3, self.n_branches + 1)]
        return self.bottleneck(torch.cat(feats, dim=1))


class BaseASPPNet(nn.Module):
    """4(+1)-level encoder / ASPP / decoder U-Net (reference ``nets.py:7-47``)."""

    def __init__(self, nin: int, ch: int, five_stage: bool = False,
                 n_aspp_branches: int = 5, dilations: Sequence[int] = (4, 8, 16)):
        super().__init__()
        self.five_stage = five_stage
        self.enc1 = EncoderLegacy(nin, ch)
        self.enc2 = EncoderLegacy(ch, ch * 2)
        self.enc3 = EncoderLegacy(ch * 2, ch * 4)
        self.enc4 = EncoderLegacy(ch * 4, ch * 8)
        if five_stage:
            self.enc5 = EncoderLegacy(ch * 8, ch * 16)
            self.aspp = ASPPModuleLegacy(ch * 16, ch * 32, dilations, n_aspp_branches)
            self.dec5 = DecoderLegacy(ch * (16 + 32), ch * 16)
        else:
            self.aspp = ASPPModuleLegacy(ch * 8, ch * 16, dilations, n_aspp_branches)
        self.dec4 = DecoderLegacy(ch * (8 + 16), ch * 8)
        self.dec3 = DecoderLegacy(ch * (4 + 8), ch * 4)
        self.dec2 = DecoderLegacy(ch * (2 + 4), ch * 2)
        self.dec1 = DecoderLegacy(ch * (1 + 2), ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, e1 = self.enc1(x)
        h, e2 = self.enc2(h)
        h, e3 = self.enc3(h)
        h, e4 = self.enc4(h)
        if self.five_stage:
            h, e5 = self.enc5(h)
            h = self.dec5(self.aspp(h), e5)
        else:
            h = self.aspp(h)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        return self.dec1(h, e1)


def _capacity(nn_architecture: int) -> dict:
    """Channel widths per family (reference ``determine_model_capacity``
    table, ``nets.py:49-97``, reduced to its two degrees of freedom)."""
    if nn_architecture in SP_ARCHS:
        ch = 16
    elif nn_architecture in HP_ARCHS:
        ch = 32
    elif nn_architecture in HP2_ARCHS:
        ch = 64
    else:
        raise ValueError(f"unknown nn_architecture {nn_architecture}")
    if nn_architecture in SIX_LAYER:
        branches = 6
    elif nn_architecture in SEVEN_LAYER:
        branches = 7
    else:
        branches = 5
    return {"ch": ch, "bridge2": ch // 2, "stg2_ch": ch,
            "bridge3": ch, "stg3_ch": ch * 2, "n_branches": branches,
            "five_stage": nn_architecture in SIX_LAYER}


class CascadedASPPNet(nn.Module):
    """[B, 2, bins, T] magnitude → sigmoid mask [B, 2, n_fft//2+1, T]
    (reference ``nets.py:99-165``; inference path — the aux heads are
    training-only and not run)."""

    def __init__(self, n_fft: int, nn_architecture: int = 123821):
        super().__init__()
        cap = _capacity(nn_architecture)
        self.nn_architecture = nn_architecture
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        ch = cap["ch"]
        kw = dict(five_stage=cap["five_stage"], n_aspp_branches=cap["n_branches"])
        self.stg1_low_band_net = BaseASPPNet(2, ch, **kw)
        self.stg1_high_band_net = BaseASPPNet(2, ch, **kw)
        self.stg2_bridge = ConvBNActiv(2 + ch, cap["bridge2"], 1, 1, 0)
        self.stg2_full_band_net = BaseASPPNet(cap["bridge2"], cap["stg2_ch"], **kw)
        self.stg3_bridge = ConvBNActiv(2 + ch + cap["stg2_ch"], cap["bridge3"], 1, 1, 0)
        self.stg3_full_band_net = BaseASPPNet(cap["bridge3"], cap["stg3_ch"], **kw)
        self.out = nn.Conv2d(cap["stg3_ch"], 2, 1, bias=False)
        self.aux1_out = nn.Conv2d(ch, 2, 1, bias=False)  # training only
        self.aux2_out = nn.Conv2d(cap["stg2_ch"], 2, 1, bias=False)  # training only

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, :, : self.max_bin]
        bandw = x.shape[2] // 2
        aux1 = torch.cat([self.stg1_low_band_net(x[:, :, :bandw]),
                          self.stg1_high_band_net(x[:, :, bandw:])], dim=2)
        aux2 = self.stg2_full_band_net(self.stg2_bridge(torch.cat([x, aux1], dim=1)))
        h = self.stg3_full_band_net(self.stg3_bridge(torch.cat([x, aux1, aux2], dim=1)))
        return replicate_top(torch.sigmoid(self.out(h)), self.output_bin)


def infer_architecture(sd) -> int:
    """Recover ``nn_architecture`` from checkpoint weight shapes: the stage-1
    channel width selects the family, enc5/conv7 presence the variant —
    replaces the upstream convention of matching the checkpoint's file size
    in KiB against ``NN_ARCH_SIZES``."""
    ch = sd["stg1_low_band_net.enc1.conv1.conv.0.weight"].shape[0]
    has_enc5 = any(".enc5." in k for k in sd)
    has_conv7 = any(".aspp.conv7." in k for k in sd)
    if ch == 16:
        if has_enc5:
            return 129605
        return 33966 if has_conv7 else 31191
    if ch == 32:
        return 123821
    if ch == 64:
        return 537238
    raise ValueError(f"unrecognized VR-arch capacity: stage-1 ch={ch}")


def is_legacy_state_dict(sd) -> bool:
    """Legacy CascadedASPPNet vs new CascadedNet key shapes: the new arch
    nests its band nets in Sequentials (``stg1_low_band_net.0.…``)."""
    return any(k.startswith("stg1_low_band_net.enc1.") for k in sd)
