"""The system under test: the port's DiT, Vocos and ``Synthesizer`` built
from a configuration file, loaded with the benchmark's seeded weights, and
warmed on the shapes its traffic uses. Built through the port's own classes
(as ``TTS.__init__`` does, without its host-side init): the model in float32
on the device, the weights loaded like a checkpoint, W8A8 applied to the
float weights when the mix asks for it, then the matrices cast to the
configuration's type."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import torch

from portbench import traffic as gen
from portbench import weights
from portbench.reference import dit as ref_dit
from portbench.reference import vocos as ref_vocos

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dit_shapes(config: dict) -> Dict[str, tuple]:
    m = config["model"]
    return ref_dit.param_shapes(m["arch"], m["mel_spec"]["n_mel_channels"], config["vocab_size"])


def vocoder_shapes(config: dict) -> Dict[str, tuple]:
    v, mel = config["vocoder"], config["model"]["mel_spec"]
    return ref_vocos.param_shapes(mel["n_mel_channels"], v["dim"], v["intermediate_dim"],
                                  v["num_layers"], mel["n_fft"])


def sampler_config(traffic: dict):
    from lemas_tts_tpu_torch.config import SamplerConfig

    return SamplerConfig(**traffic["sampler"])


@dataclass
class System:
    synth: object
    cfg: object  # the port's SamplerConfig of the mix
    device: torch.device
    host_weights: Dict[str, Dict[str, torch.Tensor]]  # the benchmark's copy, bf16 on the host


def _load(module: torch.nn.Module, w: Dict[str, torch.Tensor]) -> None:
    params = dict(module.named_parameters())
    if params.keys() != w.keys():
        raise ValueError(f"parameter names differ from the configuration's: "
                         f"{sorted(params.keys() ^ w.keys())[:6]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(w[name].shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)}, weights {tuple(w[name].shape)}")
        p.data.copy_(w[name])


def build(config: dict, traffic: dict, config_path: Path, seed: int, device) -> System:
    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.infer.pipeline import Synthesizer
    from lemas_tts_tpu_torch.models.dit import DiT, cast_matrices
    from lemas_tts_tpu_torch.models.vocos import Vocos
    from lemas_tts_tpu_torch.ops.quant import MODES, quantize_dense_tree
    from lemas_tts_tpu_torch.utils.vocab import get_tokenizer

    device = torch.device(device)
    cdt = DTYPES[config["precision"]]
    mc = load_model_config(config_path)
    mel, v = mc.mel_spec, config["vocoder"]
    with torch.device(device):
        dit = DiT(mc.arch, mel_dim=mel.n_mel_channels, text_num_embeds=config["vocab_size"],
                  compute_dtype=cdt, attn_backend="vmem")
        vocoder = Vocos(input_channels=mel.n_mel_channels, dim=v["dim"],
                        intermediate_dim=v["intermediate_dim"], num_layers=v["num_layers"],
                        n_fft=mel.n_fft, hop_length=mel.hop_length, compute_dtype=cdt)
    w = {"dit": weights.make(dit_shapes(config), gen.mix(seed, "dit"), device),
         "vocoder": weights.make(vocoder_shapes(config), gen.mix(seed, "vocoder"), device)}
    with torch.no_grad():
        _load(dit, w["dit"])
        _load(vocoder, w["vocoder"])
    if traffic.get("quant"):
        quantize_dense_tree(dit, MODES[traffic["quant"]])
    for m in (dit, vocoder):
        cast_matrices(m, cdt).to(device).eval()
    synth = Synthesizer(dit, vocoder, get_tokenizer("", "byte"), mel, device=device)
    host = {k: {n: t.cpu() for n, t in d.items()} for k, d in w.items()}
    return System(synth, sampler_config(traffic), device, host)


def build_kernels(device) -> None:
    """Compile the port's CUDA libraries that are missing, all at once (the
    first run in a checkout); later runs find them built."""
    if torch.device(device).type == "cuda":
        from lemas_tts_tpu_torch.ops import _cuda

        _cuda.build()


def warm(system: System, pool: List[gen.Request], traffic: dict) -> int:
    """Run the cell's own entry once, and replay once, on every (batch,
    duration bucket) its traffic reaches, so every graph is captured and every
    vocoder shape seen before the window. Returns the calls made."""
    synth, cfg = system.synth, system.cfg
    by_bucket: Dict[tuple, List[gen.Request]] = {}
    for r in pool:
        by_bucket.setdefault((len(r.chunks), r.bucket), []).append(r)
    calls = 0
    if traffic["entry"] == "serve":
        top = traffic["server"]["max_batch"]
        sizes = [b for b in (1, 2, 4, 8, 16, 32) if b < top] + [top]
        for (_, n), reqs in sorted(by_bucket.items()):
            for b in sizes:
                rows = [dict(ref_wav=r.ref_wav, ref_sr=r.ref_sr, ref_units=r.ref_text,
                             gen_units=r.chunks[0], seed=r.seed)
                        for r in (reqs * b)[:b]]
                for _ in range(2):
                    synth.synthesize_requests(rows, cfg=cfg)
                    calls += 1
        batch_rows = range(1, top + 1)
    else:
        for (_, n), reqs in sorted(by_bucket.items()):
            r = reqs[0]
            for _ in range(2):
                synth.synthesize_chunks(r.ref_wav, r.ref_sr, r.ref_text, r.chunks, cfg=cfg,
                                        seed=r.seed)
                calls += 1
        batch_rows = sorted({len(r.chunks) for r in pool})
    # the vocoder runs eagerly: every (rows, frames bucket) it can meet
    mel = system.synth.mel_cfg
    frames = sorted({gen.pick(d - min(gen.ref_frames(len(r.ref_wav), r.ref_sr), d - 1))
                     for r in pool for d in r.durations})
    with torch.no_grad():
        for b in batch_rows:
            for f in frames:
                x = torch.zeros(b, mel.n_mel_channels, f, device=system.device)
                system.synth.vocoder_model.decode(x, torch.ones(b, f, dtype=torch.bool,
                                                                device=system.device))
    if system.device.type == "cuda":
        torch.cuda.synchronize(system.device)
    return calls

