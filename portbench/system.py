"""The system under test: the port's backbone, vocoder and ``Synthesizer``
built from a configuration file, loaded with the benchmark's seeded weights,
and warmed on the shapes its traffic uses. Built through the port's own
classes (as ``TTS.__init__`` does, without its host-side init): the
backbone and vocoder families (``portbench/backbones/``, ``vocoders/``, found
by the configuration's names) make the models in float32 on the device, the
weights are loaded like a checkpoint, W8A8 is applied to the float weights
when the mix asks for it, then the matrices are cast to the configuration's
type."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import torch

from portbench import traffic as gen
from portbench import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the tag of each part's draw from the seed (the backbone's is "dit" for every
# family, so that the DiT's weights stay what they were)
SEED_TAGS = {"backbone": "dit", "vocoder": "vocoder"}


def make_weights(cell, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"backbone": ..., "vocoder": ...}``: each part's weights drawn from
    the seed (``weights.make``) by its family's shapes and rule."""
    out = {}
    for part, tag in SEED_TAGS.items():
        fam = getattr(cell, part)
        out[part] = weights.make(fam.param_shapes(cell.config), gen.mix(seed, tag), device,
                                 fam.weight_rule)
    return out


def sampler_config(traffic: dict):
    from lemas_tts_tpu_torch.config import SamplerConfig

    return SamplerConfig(**traffic["sampler"])


@dataclass
class System:
    synth: object
    cfg: object  # the port's SamplerConfig of the mix
    device: torch.device
    host_weights: Dict[str, Dict[str, torch.Tensor]]  # backbone, vocoder: bf16 on the host


def _load(module: torch.nn.Module, w: Dict[str, torch.Tensor]) -> None:
    params = dict(module.named_parameters())
    if params.keys() != w.keys():
        raise ValueError(f"parameter names differ from the configuration's: "
                         f"{sorted(params.keys() ^ w.keys())[:6]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(w[name].shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)}, weights {tuple(w[name].shape)}")
        p.data.copy_(w[name])


def build(cell, traffic: dict, config_path: Path, seed: int, device) -> System:
    """The system of ``cell``'s configuration under ``traffic`` (the cell's
    own mix, or another with its ``quant``)."""
    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.infer.pipeline import Synthesizer
    from lemas_tts_tpu_torch.models.dit import cast_matrices
    from lemas_tts_tpu_torch.ops.quant import MODES, quantize_dense_tree
    from lemas_tts_tpu_torch.utils.vocab import get_tokenizer

    device = torch.device(device)
    cdt = DTYPES[cell.config["precision"]]
    mc = load_model_config(config_path)
    with torch.device(device):
        backbone = cell.backbone.build(cell.config, config_path, cdt)
        vocoder = cell.vocoder.build(cell.config, config_path, cdt)
    w = make_weights(cell, seed, device)
    with torch.no_grad():
        _load(backbone, w["backbone"])
        _load(vocoder, w["vocoder"])
    if traffic.get("quant"):
        quantize_dense_tree(backbone, MODES[traffic["quant"]])
    for m in (backbone, vocoder):
        cast_matrices(m, cdt).to(device).eval()
    synth = Synthesizer(backbone, vocoder, get_tokenizer("", "byte"), mc.mel_spec, device=device)
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

