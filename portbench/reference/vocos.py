"""The Vocos mel vocoder (charactr/vocos-mel-24khz layout) in float32 torch:
a ConvNeXt-V1 backbone and the ISTFT head, ``torch.istft`` with a periodic
Hann window, centred. A mel of ``T`` frames gives ``(T - 1) * hop``
samples.

The head's spectrum has arbitrary phases, so its DC and Nyquist bins are not
real. The inverse of a real signal's half spectrum has no use for their
imaginary parts and drops them (numpy's ``irfft``, torch's on the CPU, and
cuFFT for one row); cuFFT adds them in when it transforms more rows at once,
so the reference makes those two bins real before the transform."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.dit import Weights, linear


def param_shapes(n_mels: int, dim: int, intermediate: int, layers: int,
                 n_fft: int) -> Dict[str, tuple]:
    s: Dict[str, tuple] = {"backbone.embed.weight": (dim, n_mels, 7), "backbone.embed.bias": (dim,),
                           "backbone.norm.weight": (dim,), "backbone.norm.bias": (dim,)}
    for i in range(layers):
        p = f"backbone.convnext.{i}."
        s.update({p + "gamma": (dim,), p + "dwconv.weight": (dim, 1, 7), p + "dwconv.bias": (dim,),
                  p + "norm.weight": (dim,), p + "norm.bias": (dim,),
                  p + "pwconv1.weight": (intermediate, dim), p + "pwconv1.bias": (intermediate,),
                  p + "pwconv2.weight": (dim, intermediate), p + "pwconv2.bias": (dim,)})
    s.update({"backbone.final_layer_norm.weight": (dim,), "backbone.final_layer_norm.bias": (dim,),
              "head.out.weight": (n_fft + 2, dim), "head.out.bias": (n_fft + 2,)})
    return s


def decode(W: Weights, mel: torch.Tensor, layers: int, n_fft: int, hop: int) -> torch.Tensor:
    """``mel [n_mels, T]`` -> wave ``[(T - 1) * hop]``."""
    def ln(x, p):
        return F.layer_norm(x, x.shape[-1:], W[p + ".weight"], W[p + ".bias"], eps=1e-6)

    x = F.conv1d(mel[None].float(), W["backbone.embed.weight"], W["backbone.embed.bias"],
                 padding=3)
    x = ln(x.transpose(1, 2), "backbone.norm")  # [1, T, C]
    for i in range(layers):
        p = f"backbone.convnext.{i}."
        h = F.conv1d(x.transpose(1, 2), W[p + "dwconv.weight"], W[p + "dwconv.bias"], padding=3,
                     groups=x.shape[-1]).transpose(1, 2)
        h = F.gelu(linear(ln(h, p + "norm"), W[p + "pwconv1.weight"], W[p + "pwconv1.bias"]))
        x = x + W[p + "gamma"] * linear(h, W[p + "pwconv2.weight"], W[p + "pwconv2.bias"])
    x = ln(x, "backbone.final_layer_norm")
    h = linear(x, W["head.out.weight"], W["head.out.bias"])[0].T  # [n_fft + 2, T]
    bins = n_fft // 2 + 1
    mag = torch.clamp(torch.exp(h[:bins]), max=1e2)
    spec = torch.polar(mag, h[bins:])
    spec[0] = spec[0].real.to(spec.dtype)
    spec[-1] = spec[-1].real.to(spec.dtype)
    window = torch.hann_window(n_fft, periodic=True, device=mel.device)
    return torch.istft(spec, n_fft, hop, n_fft, window=window, center=True)
