"""A temporary checkout root holding a tiny cell (width 128, depth 2,
Vocos 64 x 2) that the CPU can run end to end in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny.tiny-mix"
COPIED = ("metrics", "backbones", "vocoders", "kernels")  # the harness's files found by name


def tiny_config() -> dict:
    cfg = json.loads((REPO / "portbench/configs/multilingual.json").read_text())
    cfg.update(name="tiny", precision="float32")
    cfg["model"]["arch"].update(dim=128, depth=2, heads=2, dim_head=64, text_dim=64,
                                conv_layers=1)
    cfg["vocoder"] = {"name": "vocos", "dim": 64, "intermediate_dim": 128, "num_layers": 2}
    return cfg


def tiny_traffic(entry: str = "serve", quant=None) -> dict:
    name = "serve-c8-bf16" if entry == "serve" else "single"
    t = json.loads((REPO / f"portbench/traffic/{name}.json").read_text())
    t.update(pool=8, ref_seconds=[1.5, 2.5], duration_buckets={"512": 3, "768": 1},
             text_ids=[68, 124], quant=quant, profile={"after": 0.2, "batches": 2},
             check={"requests": 64})
    if t["sampler"].get("block_cache"):
        t["sampler"]["block_cache"] = "0-2:2+t2"
    return t


def make_root(root: Path, entry: str = "serve", quant=None, limits=None) -> Path:
    b = root / "portbench"
    for d in ("configs", "traffic", "limits"):
        (b / d).mkdir(parents=True, exist_ok=True)
    for d in COPIED:
        shutil.copytree(REPO / "portbench" / d, b / d, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (b / "configs/tiny.json").write_text(json.dumps(tiny_config()))
    (b / "traffic/tiny-mix.json").write_text(json.dumps(tiny_traffic(entry, quant)))
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    doc["configs"] = [{"name": "tiny", "source": "portbench/tests/tiny.py",
                       "file": "portbench/configs/tiny.json", "reduced": [], "why": "tests"}]
    doc["workloads"] = [{"name": CELL, "config": "tiny", "traffic": "tiny-mix", "chips": 1,
                         "why": "tests"}]
    for m in doc["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    lim = {"mel_rel_l2": 1e-4, "wave_rel_l2": 1e-4, "frames_off": 0, "failed_requests": 0}
    (b / f"limits/{CELL}.json").write_text(json.dumps(limits or lim))
    return root
