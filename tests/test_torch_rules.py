"""Rules of the PyTorch port: it imports neither JAX nor the JAX package, its
entry point runs on CUDA unless the CPU is asked for, and its config matches
the JAX package's."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

import torch

from lemas_tts_tpu.config import load_model_config as jload_model_config
from lemas_tts_tpu_torch.config import load_model_config

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "lemas_tts_tpu_torch"


def test_import_leaves_jax_out():
    """Importing every module of the port (and building nothing) pulls in
    neither jax nor lemas_tts_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lemas_tts_tpu_torch, lemas_tts_tpu_torch.api\n"
        "for m in pkgutil.walk_packages(lemas_tts_tpu_torch.__path__, 'lemas_tts_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'lemas_tts_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_sources_name_no_jax_module():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "flax", "lemas_tts_tpu"), (path, name)


def test_tts_without_cuda_raises():
    from lemas_tts_tpu_torch import TTS

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: TTS() would run on it")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            TTS(model="tests/data/tiny.yaml", device=device)


@pytest.mark.parametrize("option", [dict(frontend="phone"), dict(quantization="int8"),
                                    dict(ode_method="midpoint")])
def test_unported_options_raise(option):
    from lemas_tts_tpu_torch import TTS

    with pytest.raises(NotImplementedError):
        TTS(model="tests/data/tiny.yaml", device="cpu", **option)


@pytest.mark.parametrize("name", ["multilingual", "tests/data/tiny.yaml"])
def test_config_matches_jax(name):
    """The bundled JSON flagship config and a YAML config load to the same
    fields as the JAX package's YAML loader gives."""
    got, ref = load_model_config(name), jload_model_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
