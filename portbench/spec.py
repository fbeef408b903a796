"""``BENCHMARK.json`` and the files it names, found by name.

A cell is a ``workloads`` entry. Its configuration is the file its
``configs`` entry names; its traffic mix is ``<bench>/traffic/<traffic>.json``;
the limits of its correctness check are ``<bench>/limits/<workload>.json``;
each metric is read by ``<bench>/metrics/<metric>.py`` (a function ``read``).
The configuration's model is found by name too: its backbone family
(``model.backbone``) in ``<bench>/backbones/<name>.py``, its vocoder family
(``vocoder.name``) in ``<bench>/vocoders/<name>.py``, names lower-cased; a
kernel that ``roofline.py`` does not hold, which a metric names in its
``KERNELS``, in ``<bench>/kernels/<name>.py``. ``<bench>`` is the first of
``paths``. A later configuration, cell, mix, metric, family or kernel is a
new file and a new entry; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

from portbench import roofline

FAMILY_DIRS = {"backbone": "backbones", "vocoder": "vocoders", "kernel": "kernels"}


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    backbone: ModuleType  # the backbone family of the configuration
    vocoder: ModuleType  # its vocoder family


class Bench:
    def __init__(self, root):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.doc["paths"][0]
        self._modules: Dict[Path, ModuleType] = {}

    def _module(self, path: Path, prefix: str, name: str) -> ModuleType:
        mod = self._modules.get(path)
        if mod is None:
            mod_name = prefix + "".join(ch if ch.isalnum() else "_" for ch in name)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def family(self, kind: str, name: str) -> ModuleType:
        """The module of ``<bench>/<kind>s/<name>.py`` (``kind``: backbone,
        vocoder or kernel); LookupError naming the file to add where there is
        none."""
        path = self.dir / FAMILY_DIRS[kind] / f"{name.lower()}.py"
        if not path.is_file():
            raise LookupError(f"no {kind} {name!r} in the benchmark: add "
                              f"{path.relative_to(self.root).as_posix()}")
        return self._module(path, f"portbench_{kind}_", name.lower())

    def kernel(self, name: str) -> ModuleType:
        return self.family("kernel", name)

    def cell(self, workload: str) -> Cell:
        """The cell ``workload``, its families and the kernel files of its
        per-layer metrics found (LookupError, before any run, where one is
        missing)."""
        w = next((w for w in self.doc["workloads"] if w["name"] == workload), None)
        if w is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        c = next(c for c in self.doc["configs"] if c["name"] == w["config"])
        config = json.loads((self.root / c["file"]).read_text())

        def applies(m):
            return "workloads" not in m or workload in m["workloads"]

        cell = Cell(
            name=workload, chips=int(w["chips"]), config_name=c["name"], config=config,
            traffic_name=w["traffic"],
            traffic=json.loads((self.dir / "traffic" / f"{w['traffic']}.json").read_text()),
            limits=json.loads((self.dir / "limits" / f"{workload}.json").read_text()),
            end_to_end=[m for m in self.doc["end_to_end"] if applies(m)],
            per_layer=[m for m in self.doc["per_layer"] if applies(m)],
            backbone=self.family("backbone", config["model"]["backbone"]),
            vocoder=self.family("vocoder", config["vocoder"]["name"]))
        for m in cell.per_layer:
            for k in getattr(self._reader_module(m["name"]), "KERNELS", ()):
                if k not in roofline.SYMBOLS:
                    self.kernel(k)
        return cell

    def _reader_module(self, metric: str) -> ModuleType:
        return self._module(self.dir / "metrics" / f"{metric}.py", "portbench_metric_", metric)

    def reader(self, metric: str) -> Callable:
        """The ``read`` function of ``<bench>/metrics/<metric>.py``."""
        return self._reader_module(metric).read

    def readers(self, metrics: List[dict]) -> Dict[str, Callable]:
        return {m["name"]: self.reader(m["name"]) for m in metrics}
