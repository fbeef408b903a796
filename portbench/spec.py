"""``BENCHMARK.json`` and the files it names, found by name.

A cell is a ``workloads`` entry. Its configuration is the file its
``configs`` entry names; its traffic mix is ``<bench>/traffic/<traffic>.json``;
the limits of its correctness check are ``<bench>/limits/<workload>.json``;
each metric is read by ``<bench>/metrics/<metric>.py`` (a function ``read``).
``<bench>`` is the first of ``paths``. A later cell, mix or metric is a new
file and a new entry; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List


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


class Bench:
    def __init__(self, root):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.doc["paths"][0]

    def cell(self, workload: str) -> Cell:
        w = next((w for w in self.doc["workloads"] if w["name"] == workload), None)
        if w is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        c = next(c for c in self.doc["configs"] if c["name"] == w["config"])

        def applies(m):
            return "workloads" not in m or workload in m["workloads"]

        return Cell(
            name=workload, chips=int(w["chips"]), config_name=c["name"],
            config=json.loads((self.root / c["file"]).read_text()),
            traffic_name=w["traffic"],
            traffic=json.loads((self.dir / "traffic" / f"{w['traffic']}.json").read_text()),
            limits=json.loads((self.dir / "limits" / f"{workload}.json").read_text()),
            end_to_end=[m for m in self.doc["end_to_end"] if applies(m)],
            per_layer=[m for m in self.doc["per_layer"] if applies(m)])

    def reader(self, metric: str) -> Callable:
        """The ``read`` function of ``<bench>/metrics/<metric>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        mod_name = "portbench_metric_" + "".join(ch if ch.isalnum() else "_" for ch in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def readers(self, metrics: List[dict]) -> Dict[str, Callable]:
        return {m["name"]: self.reader(m["name"]) for m in metrics}
