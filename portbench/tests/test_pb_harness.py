"""The harness's own guards: the import guard, no result without a port or a
card, and the loader that finds a configuration, a mix and a metric by
name."""

import json
import os
import shutil
import subprocess
import sys
import types

from portbench import run
from portbench.spec import Bench
from portbench.tests import tiny


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lemas_tts_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []  # lemas_tts_tpu_torch itself is loaded by now
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "lemas_tts_tpu", types.ModuleType("lemas_tts_tpu"))
    assert run.forbidden_modules() == ["jax", "lemas_tts_tpu"]


def test_port_imports_no_jax():
    code = ("import sys, lemas_tts_tpu_torch.serve.engine, lemas_tts_tpu_torch.infer.pipeline, "
            "portbench.run; print(portbench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tiny.REPO, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]


def test_no_result_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "multilingual.single-1chunk", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        return  # the chip's case: nothing to refuse
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "multilingual.single-1chunk", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tiny.REPO, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_loader_finds_new_files_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    b = root / "portbench"
    (b / "configs/other.json").write_text(json.dumps(tiny.tiny_config()))
    (b / "traffic/other-mix.json").write_text(json.dumps(tiny.tiny_traffic("single")))
    (b / "limits/other.other-mix.json").write_text(json.dumps({"frames_off": 0}))
    (b / "metrics/pool_size.py").write_text("def read(run):\n    return len(run.pool)\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "other", "source": "x", "file": "portbench/configs/other.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "other.other-mix", "config": "other",
                             "traffic": "other-mix", "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": "pool_size", "unit": "requests", "better": "higher",
                             "source": "program_counter", "layer": "x", "moves": "audio_s_per_s",
                             "workloads": ["other.other-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = Bench(root)
    cell = bench.cell("other.other-mix")
    assert cell.config["name"] == "tiny" and cell.traffic["entry"] == "single"
    assert cell.limits == {"frames_off": 0}
    assert "pool_size" in [m["name"] for m in cell.per_layer]
    assert "pool_size" not in [m["name"] for m in bench.cell(tiny.CELL).per_layer]
    assert bench.reader("pool_size")(types.SimpleNamespace(pool=[1, 2, 3])) == 3
