"""UVR5 VR-architecture separation network ``CascadedNet`` and the
mask-based ``VRSeparator`` (counterpart of ``lemas_tts_tpu/uvr5/vr_network.py``).

Alternate separation family reachable via ``process_method='VR Arc'``
(reference ``uvr5/lib_v5/vr_network/nets_new.py:41-125`` + ``layers_new.py``):
a dual-band cascade of U-Nets — stage 1 processes low/high spectrogram bands
separately, stage 2 refines with stage-1 features, stage 3 fuses the full
band — each U-Net an encoder/ASPP/decoder with a bidirectional-LSTM bottleneck
branch; output is a sigmoid magnitude mask.

The layout is the reference's ``[B, C, F, T]`` and the parameter names are
the reference's (``stg1_low_band_net.0.enc1.conv.0.weight``, ...,
``lstm_dec2.lstm.weight_ih_l0_reverse``), so a reference checkpoint loads
with ``load_state_dict``; its training-only ``aux_out`` head is kept and
not run. BatchNorms run in eval mode (running statistics), the BiLSTM is a
bidirectional ``nn.LSTM`` and the 2× upsampling ``F.interpolate(...,
align_corners=True)``.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lemas_tts_tpu_torch.api import select_device


def crop_center(skip: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Center-crop ``skip`` [B, C, F, T] to ``target``'s F/T (requires
    skip ≥ target)."""
    dF = skip.shape[2] - target.shape[2]
    dT = skip.shape[3] - target.shape[3]
    if dF < 0 or dT < 0:
        raise ValueError(f"cannot crop {tuple(skip.shape)} to {tuple(target.shape)}")
    f0, t0 = dF // 2, dT // 2
    return skip[:, :, f0: f0 + target.shape[2], t0: t0 + target.shape[3]]


def upsample_cat(x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
    """Bilinear 2× (align_corners) upsampling, then the skip concatenated on
    the channels: upsampling can overshoot an odd-sized skip by one, so x is
    trimmed to it first."""
    x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    if skip is None:
        return x
    x = x[:, :, : skip.shape[2], : skip.shape[3]]
    return torch.cat([x, crop_center(skip, x)], dim=1)


class ConvBNActiv(nn.Module):
    """Conv (no bias) → BatchNorm → ReLU or LeakyReLU(0.01)
    (reference ``layers_new.py:7-24``)."""

    def __init__(self, nin: int, nout: int, ksize=3, stride=1, pad=1, dilation=1,
                 activ: str = "relu"):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nout, ksize, stride, pad, dilation, bias=False),
            nn.BatchNorm2d(nout, eps=1e-5),
            nn.ReLU() if activ == "relu" else nn.LeakyReLU(0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Encoder(nn.Module):
    """Strided conv1 → conv2, LeakyReLU (reference ``layers_new.py:27-40``)."""

    def __init__(self, nin: int, nout: int, stride: int = 2):
        super().__init__()
        self.conv1 = ConvBNActiv(nin, nout, 3, stride, 1, activ="leaky")
        self.conv2 = ConvBNActiv(nout, nout, 3, 1, 1, activ="leaky")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class Decoder(nn.Module):
    """Upsample 2×, concat the cropped skip, conv (reference
    ``layers_new.py:43-61``; dropout unused at inference)."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv1 = ConvBNActiv(nin, nout, 3, 1, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.conv1(upsample_cat(x, skip))


class ASPPModule(nn.Module):
    """Frequency-pooled context + 1×1 + three dilated 3×3 branches → 1×1
    bottleneck (reference ``layers_new.py:64-98``)."""

    def __init__(self, nin: int, nout: int,
                 dilations: Sequence[Tuple[int, int]] = ((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)),
                                   ConvBNActiv(nin, nout, 1, 1, 0))
        self.conv2 = ConvBNActiv(nin, nout, 1, 1, 0)
        self.conv3 = ConvBNActiv(nin, nout, 3, 1, dilations[0], dilations[0])
        self.conv4 = ConvBNActiv(nin, nout, 3, 1, dilations[1], dilations[1])
        self.conv5 = ConvBNActiv(nin, nout, 3, 1, dilations[2], dilations[2])
        self.bottleneck = ConvBNActiv(nout * 5, nout, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.conv1(x).expand(-1, -1, x.shape[2], -1)  # a 1-row map resized = broadcast
        return self.bottleneck(torch.cat(
            [g, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)], dim=1))


class LSTMModule(nn.Module):
    """conv → BiLSTM over time → dense, returned as one extra channel
    (reference ``layers_new.py:102-126``)."""

    def __init__(self, nin_conv: int, nin_lstm: int, nout_lstm: int):
        super().__init__()
        self.conv = ConvBNActiv(nin_conv, 1, 1, 1, 0)
        self.lstm = nn.LSTM(input_size=nin_lstm, hidden_size=nout_lstm // 2,
                            bidirectional=True)
        self.dense = nn.Sequential(nn.Linear(nout_lstm, nin_lstm),
                                   nn.BatchNorm1d(nin_lstm, eps=1e-5), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, _, nbins, nframes = x.shape
        h = self.conv(x)[:, 0].permute(2, 0, 1)  # [T, N, F]
        h, _ = self.lstm(h)
        h = self.dense(h.reshape(-1, h.shape[-1]))
        return h.reshape(nframes, N, 1, nbins).permute(1, 2, 3, 0)


class BaseNet(nn.Module):
    """One U-Net stage (reference ``nets_new.py:6-39``)."""

    def __init__(self, nin: int, nout: int, nin_lstm: int, nout_lstm: int,
                 dilations: Sequence[Tuple[int, int]] = ((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.enc1 = ConvBNActiv(nin, nout, 3, 1, 1)
        self.enc2 = Encoder(nout, nout * 2)
        self.enc3 = Encoder(nout * 2, nout * 4)
        self.enc4 = Encoder(nout * 4, nout * 6)
        self.enc5 = Encoder(nout * 6, nout * 8)
        self.aspp = ASPPModule(nout * 8, nout * 8, dilations)
        self.dec4 = Decoder(nout * (6 + 8), nout * 6)
        self.dec3 = Decoder(nout * (4 + 6), nout * 4)
        self.dec2 = Decoder(nout * (2 + 4), nout * 2)
        self.lstm_dec2 = LSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = Decoder(nout * (1 + 2) + 1, nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.aspp(e5)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)


def replicate_top(mask: torch.Tensor, output_bin: int) -> torch.Tensor:
    """Replicate-pad the cropped top bins back (``nets_new.py:92-96``)."""
    return F.pad(mask, (0, 0, 0, output_bin - mask.shape[2]), mode="replicate")


class CascadedNet(nn.Module):
    """[B, 2, n_fft//2+1, T] magnitude → sigmoid mask of the same shape
    (reference ``nets_new.py:41-125``)."""

    def __init__(self, n_fft: int, nout: int = 32, nout_lstm: int = 128):
        super().__init__()
        self.n_fft = n_fft
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.nin_lstm = self.max_bin // 2
        self.stg1_low_band_net = nn.Sequential(
            BaseNet(2, nout // 2, self.nin_lstm // 2, nout_lstm),
            ConvBNActiv(nout // 2, nout // 4, 1, 1, 0))
        self.stg1_high_band_net = BaseNet(2, nout // 4, self.nin_lstm // 2, nout_lstm // 2)
        self.stg2_low_band_net = nn.Sequential(
            BaseNet(nout // 4 + 2, nout, self.nin_lstm // 2, nout_lstm),
            ConvBNActiv(nout, nout // 2, 1, 1, 0))
        self.stg2_high_band_net = BaseNet(nout // 4 + 2, nout // 2, self.nin_lstm // 2,
                                          nout_lstm // 2)
        self.stg3_full_band_net = BaseNet(3 * nout // 4 + 2, nout, self.nin_lstm, nout_lstm)
        self.out = nn.Conv2d(nout, 2, 1, bias=False)
        self.aux_out = nn.Conv2d(3 * nout // 4, 2, 1, bias=False)  # training only

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, :, : self.max_bin]
        bandw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bandw], x[:, :, bandw:]
        l1 = self.stg1_low_band_net(l1_in)
        h1 = self.stg1_high_band_net(h1_in)
        aux1 = torch.cat([l1, h1], dim=2)
        l2 = self.stg2_low_band_net(torch.cat([l1_in, l1], dim=1))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1))
        aux2 = torch.cat([l2, h2], dim=2)
        f3 = self.stg3_full_band_net(torch.cat([x, aux1, aux2], dim=1))
        return replicate_top(torch.sigmoid(self.out(f3)), self.output_bin)


def random_vr_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` in place, as the JAX package fills
    its VR nets: BatchNorms at their identity (weight and running variance
    1, bias and running mean 0), every other bias 0 and every other weight
    normal x 0.05: finite, sigmoid-bounded masks for any input."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
                continue
            for name, p in m.named_parameters(recurse=False):
                if name.startswith("bias"):
                    p.zero_()
                else:
                    p.copy_(torch.randn(p.shape, generator=generator) * 0.05)
    return module


def _as_stereo(audio: np.ndarray) -> np.ndarray:
    x = np.asarray(audio, dtype=np.float32)
    if x.ndim == 1:
        x = np.stack([x, x])
    elif x.shape[0] == 1:
        x = np.concatenate([x, x], axis=0)
    return x


class VRSeparator:
    """Mask-based VR-arch separation on one device.

    Supports both network generations — the new ``CascadedNet`` (BiLSTM, this
    module) and the legacy ``CascadedASPPNet`` (``vr_legacy.py``, most
    published VR checkpoints) — and two analysis modes:

    - single-band (``band_params=None``): one STFT at ``n_fft``/``hop``,
      windowed mask prediction, masked iSTFT at the input rate.
    - multi-band (``band_params`` set, the reference contract for legacy
      checkpoints): per-band resample → STFT → ``combine_spectrograms`` →
      windowed mask → per-band iSTFT/resample chain + high-end ``mirroring``
      (``spec_utils.py:154-178,307-378``), output at the config sample rate.

    The mask windows run in batches of at most ``batch_size`` exact windows
    (the JAX package pads a batch to a power of two to bound its compiled
    programs; the network is batch-independent in eval mode, so the masks
    are the same). ``device=None`` means CUDA and raises without it.
    """

    @classmethod
    def from_file(cls, path: str, band_params=None, hop: int = 1024,
                  window_size: int = 512, device: Optional[str] = None) -> "VRSeparator":
        """Load reference VR-arch torch weights (``.pth``/``.ckpt``/
        ``.safetensors``), either generation; hyper-parameters are inferred
        from weight shapes. ``band_params`` names a registry config (e.g.
        ``"4band_v2"``), a JSON path, or a parsed dict; legacy checkpoints
        require one (it defines ``n_fft = 2·bins``; default: the reference's
        2-band param)."""
        from lemas_tts_tpu_torch.uvr5 import vr_legacy
        from lemas_tts_tpu_torch.uvr5.band_params import load_band_params
        from lemas_tts_tpu_torch.weights import load_torch_file

        sd = load_torch_file(str(path))
        mp = band_params if isinstance(band_params, dict) else \
            (load_band_params(band_params) if band_params else None)
        if vr_legacy.is_legacy_state_dict(sd):
            if mp is None:
                mp = load_band_params(None)
            n_fft = 2 * mp["bins"]
            model = vr_legacy.CascadedASPPNet(n_fft, vr_legacy.infer_architecture(sd))
            return cls(n_fft=n_fft, hop=hop, state=sd, model=model, offset=128,
                       window_size=window_size, band_params=mp, device=device)
        n_fft, nout, nout_lstm = cascadednet_hparams(sd)
        return cls(n_fft=n_fft, hop=hop, nout=nout, nout_lstm=nout_lstm, state=sd,
                   window_size=window_size, band_params=mp, device=device)

    def __init__(self, n_fft: int = 2048, hop: int = 1024, nout: int = 32,
                 nout_lstm: int = 128, state=None, model: Optional[nn.Module] = None,
                 offset: int = 64, window_size: int = 512, band_params=None,
                 batch_size: int = 4, device: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        from lemas_tts_tpu_torch.api import seeded_init
        from lemas_tts_tpu_torch.uvr5.inference import load_state

        self.device = select_device(device)
        self.n_fft = n_fft
        self.hop = hop
        self.offset = offset  # frames cropped per window edge (nets offset)
        self.window_size = window_size
        self.mp = band_params
        self.batch_size = max(1, int(batch_size))
        if model is None:
            model = seeded_init(lambda: CascadedNet(n_fft, nout, nout_lstm), 0)
        if state is None:
            warnings.warn("VR separator: random init (testing only)")
            random_vr_init_(model, generator if generator is not None
                            else torch.Generator().manual_seed(0))
        else:
            load_state(model, state)
        self.model = model.to(self.device).eval()

    # ------------------------------------------------------------- windows
    def run(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model(x)

    def _predict_mask(self, mag: np.ndarray) -> np.ndarray:
        """[2, bins, T] magnitude (pre-normalized) → [2, bins, T] mask via
        batched overlapped windows (reference chunked inference: pad by
        ``make_padding``, predict ``window_size`` frames, keep the central
        ``roi`` of each — the offset crop of ``nets.py:predict_mask``)."""
        from lemas_tts_tpu_torch.uvr5.spec_utils import make_padding

        n_frame = mag.shape[2]
        # the offset crop needs a window strictly wider than both edges
        ws = max(self.window_size, 2 * self.offset + 32)
        pad_l, pad_r, roi = make_padding(n_frame, ws, self.offset)
        n_window = int(np.ceil(n_frame / roi))
        pad = torch.from_numpy(np.pad(mag.astype(np.float32), ((0, 0), (0, 0), (pad_l, pad_r))))
        pad = pad.to(self.device)
        windows = torch.stack([pad[:, :, i * roi: i * roi + ws] for i in range(n_window)])
        masks = torch.cat([self.run(windows[i: i + self.batch_size])
                           for i in range(0, n_window, self.batch_size)])
        masks = masks[:, :, :, self.offset: self.offset + roi]  # [n, 2, bins, roi]
        masks = masks.permute(1, 2, 0, 3).reshape(2, masks.shape[2], -1)[:, :, :n_frame]
        return masks.cpu().numpy()

    # ------------------------------------------------------------ separate
    def separate(self, audio: np.ndarray, sr: int, aggressiveness: float = 0.0) -> np.ndarray:
        """Stereo [2, T] → primary stem (masked mixture). Single-band mode
        returns at the input rate; multi-band mode at the config rate
        (use :meth:`separate_full` for the rate and secondary stem)."""
        return self.separate_full(audio, sr, aggressiveness)[0]

    def separate_full(self, audio: np.ndarray, sr: int, aggressiveness: float = 0.0,
                      high_end_process: str = "mirroring", post_process: bool = False):
        """Full separation → ``(primary, secondary, out_sr)``.

        ``aggressiveness`` raises the mask power (more below the band-1 crop,
        reference ``adjust_aggr``); ``post_process`` applies
        ``merge_artifacts`` to the mask; ``high_end_process`` controls the
        mirrored high-frequency restore in multi-band mode."""
        from lemas_tts_tpu_torch.uvr5 import spec_utils as su

        dev = self.device
        x = _as_stereo(audio)
        if self.mp is None:
            spec = su.stft_stereo(x, self.n_fft, self.hop, device=dev)
            mask = self._mask_for(np.abs(spec), aggressiveness, split_bin=spec.shape[1] // 2,
                                  post_process=post_process)
            primary = su.istft_stereo(spec * mask, self.n_fft, self.hop, length=x.shape[-1],
                                      device=dev)
            secondary = su.istft_stereo(spec * (1.0 - mask), self.n_fft, self.hop,
                                        length=x.shape[-1], device=dev)
            return primary, secondary, sr

        mp = self.mp
        band_ids = sorted(mp["band"])
        bands_n = len(band_ids)
        ms_kw = dict(mid_side=mp.get("mid_side", False),
                     mid_side_b2=mp.get("mid_side_b2", False),
                     reverse=mp.get("reverse", False))
        waves: dict = {}
        specs: dict = {}
        input_high_end = None
        input_high_end_h = 0
        for d in reversed(band_ids):
            bp = mp["band"][d]
            if d == bands_n:
                waves[d] = su.resample_on(x, sr, bp["sr"], dev) if sr != bp["sr"] else x
            else:
                waves[d] = su.resample_on(waves[d + 1], mp["band"][d + 1]["sr"], bp["sr"], dev)
            specs[d] = su.wave_to_spectrogram(waves[d], bp["hl"], bp["n_fft"], **ms_kw,
                                              device=dev)
            if d == bands_n and high_end_process != "none":
                input_high_end_h = (bp["n_fft"] // 2 - bp["crop_stop"]) + (
                    mp["pre_filter_stop"] - mp["pre_filter_start"])
                input_high_end = specs[d][
                    :, bp["n_fft"] // 2 - input_high_end_h: bp["n_fft"] // 2, :]

        spec_m = su.combine_spectrograms_mp(specs, mp)
        mask = self._mask_for(np.abs(spec_m), aggressiveness,
                              split_bin=mp["band"][1]["crop_stop"], post_process=post_process)
        y_spec = mask * spec_m
        v_spec = spec_m - y_spec

        if high_end_process == "none" or input_high_end is None:
            primary = su.cmb_spectrogram_to_wave(y_spec, mp, device=dev)
        else:
            hi = su.mirroring_mp(high_end_process, y_spec, input_high_end, mp)
            primary = su.cmb_spectrogram_to_wave(y_spec, mp, input_high_end_h, hi, device=dev)
        secondary = su.cmb_spectrogram_to_wave(v_spec, mp, device=dev)
        return primary, secondary, mp["sr"]

    def _mask_for(self, mag: np.ndarray, aggressiveness: float,
                  split_bin: int, post_process: bool) -> np.ndarray:
        from lemas_tts_tpu_torch.uvr5 import spec_utils as su

        coef = float(mag.max()) or 1.0
        mask = self._predict_mask(mag / coef)
        if aggressiveness:
            mask = su.adjust_aggr(mask, False, {"value": aggressiveness,
                                                "split_bin": split_bin})
        if post_process:
            mask = su.merge_artifacts(mask)
        return mask


def cascadednet_hparams(sd) -> Tuple[int, int, int]:
    """(n_fft, nout, nout_lstm) of a ``CascadedNet`` state dict, from its
    weight shapes (covers the ``nn_arch_size == 218409 → nout 64`` quirk,
    ``nets_new.py:50``)."""
    nout = int(sd["out.weight"].shape[1])
    nout_lstm = int(sd["stg1_low_band_net.0.lstm_dec2.lstm.weight_ih_l0"].shape[0]) // 2
    n_fft = 8 * int(sd["stg1_low_band_net.0.lstm_dec2.dense.0.weight"].shape[0])
    return n_fft, nout, nout_lstm
