"""Checkpoint conversion CLI (counterpart of
``lemas_tts_tpu/scripts/convert_checkpoint.py``, the same flags): reference
torch formats -> the JAX package's native orbax directories, and a native
DiT tree back to the reference layout.

  python -m lemas_tts_tpu_torch.scripts.convert_checkpoint \\
      --ckpt model_last.safetensors --out ckpts/native_model [--use_ema]
  python -m lemas_tts_tpu_torch.scripts.convert_checkpoint \\
      --vocos pretrained/vocos-mel-24khz --out ckpts/vocos_native
  python -m lemas_tts_tpu_torch.scripts.convert_checkpoint \\
      --bigvgan bigvgan_generator.pt --out ckpts/bigvgan_native
  python -m lemas_tts_tpu_torch.scripts.convert_checkpoint \\
      --uvr5 Kim_Vocal_1.onnx --out ckpts/uvr5_native
  python -m lemas_tts_tpu_torch.scripts.convert_checkpoint \\
      --export_dit ckpts/distilled/stage_8 --out student.safetensors

The directories hold the key paths and leaves the JAX CLI writes for the
same input (``infer/checkpoints.py``'s converters, ``models/vocos.py:
convert_vocos``, ``models/bigvgan.py:convert_bigvgan``, ``uvr5/mdxnet.py:
convert_convtdfnet``), so both packages load them; they are written and
read with ``tensorstore`` (an optional dependency). ``--export_dit`` writes
``.safetensors`` when the name asks for it, else a torch file. The
conversion is host work in numpy; ``--device`` (the port CLIs' flag: CUDA
unless ``--device cpu``) is checked like every port entry point's, so a
machine without CUDA needs ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert reference checkpoints to native orbax.")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--ckpt", type=str, help="CFM/DiT .safetensors or .pt")
    g.add_argument("--vocos", type=str, help="vocos dir (pytorch_model.bin) or file")
    g.add_argument("--bigvgan", type=str, help="BigVGAN generator .pt/.bin")
    g.add_argument("--uvr5", type=str, help="MDX-Net .onnx or .ckpt")
    g.add_argument("--export_dit", type=str,
                   help="Native DiT param tree (orbax dir) -> reference torch state dict "
                        "at --out (.safetensors or .pt).")
    p.add_argument("--out", type=str, required=True,
                   help="Output orbax directory (or torch file for --export_dit).")
    p.add_argument("--use_ema", action="store_true",
                   help="Take the EMA weights from the CFM checkpoint.")
    p.add_argument("--prefix", type=str, default="transformer.",
                   help="Key prefix for --export_dit output (reference CFM checkpoints nest "
                        "the DiT under 'transformer.').")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; never falls back to another device.")
    return p


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return int(getattr(tree, "size", 0))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from lemas_tts_tpu_torch.api import select_device
    from lemas_tts_tpu_torch.infer.checkpoints import (load_state_dict, normalize_state_dict,
                                                       save_native)

    select_device(args.device)

    for name in ("ckpt", "vocos", "bigvgan", "uvr5", "export_dit"):
        val = getattr(args, name)
        if val is not None and not val.strip():
            print(f"--{name} is empty", file=sys.stderr)
            return 2
    if args.export_dit is not None:
        from lemas_tts_tpu_torch.infer.checkpoints import export_dit_state_dict, load_native

        sd = export_dit_state_dict(load_native(Path(args.export_dit).resolve()),
                                   prefix=args.prefix)
        if args.out.endswith(".safetensors"):
            from safetensors.numpy import save_file

            save_file(sd, args.out)
        else:
            import torch

            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, args.out)
        n = sum(v.size for v in sd.values())
        print(f"[convert] dit → torch layout: {n / 1e6:.2f}M params → {args.out}")
        return 0
    if args.ckpt is not None:
        from lemas_tts_tpu_torch.infer.checkpoints import convert_cfm

        params = convert_cfm(normalize_state_dict(load_state_dict(args.ckpt, use_ema=args.use_ema),
                                                  use_ema=args.use_ema))
        kind = "cfm"
    elif args.vocos is not None:
        from lemas_tts_tpu_torch.models.vocos import convert_vocos

        p = Path(args.vocos)
        f = p / "pytorch_model.bin" if p.is_dir() else p
        params = {"params": convert_vocos(load_state_dict(str(f)))}
        kind = "vocos"
    elif args.bigvgan is not None:
        from lemas_tts_tpu_torch.models.bigvgan import convert_bigvgan

        sd = load_state_dict(args.bigvgan)
        if any(k.startswith("generator.") for k in sd):
            sd = {k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")}
        params = {"params": convert_bigvgan(sd)}
        kind = "bigvgan"
    else:
        from lemas_tts_tpu_torch.uvr5.mdxnet import convert_convtdfnet, infer_config_from_state_dict

        if args.uvr5.endswith(".onnx"):
            from lemas_tts_tpu_torch.uvr5.onnx_weights import load_onnx_initializers

            sd = load_onnx_initializers(args.uvr5)
        else:
            sd = load_state_dict(args.uvr5)
        cfg = infer_config_from_state_dict(sd)
        params = {"params": convert_convtdfnet(sd, cfg)}
        kind = f"uvr5 (derived config: {cfg})"

    save_native(params, Path(args.out).resolve())
    print(f"[convert] {kind}: {_count(params) / 1e6:.2f}M params → {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
