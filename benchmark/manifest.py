"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (its `file`), the configuration's architecture module
(benchmark/reference/<name>.py, the name under its "reference" key,
`model` where it has none), its traffic mix (benchmark/traffic/<mix>.json),
the mix's client (benchmark/traffic/kinds/<kind>.py) and each metric's
reader (benchmark/metrics/<metric>.py). A later configuration, architecture,
mix, kind or metric is a new file and a new entry; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEFAULT_REFERENCE = "model"  # today's Qwen2 LM


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_module(cfg: dict, root: str = ROOT) -> ModuleType:
    """The configuration's architecture module: its plain reference
    (`encode`, `scores`) and the hooks that weights.py, roofline.py and
    port.py take in place of their Qwen2 defaults."""
    name = cfg.get("reference", DEFAULT_REFERENCE)
    return load_module(os.path.join(root, "benchmark", "reference", name + ".py"),
                       "bench_reference_" + name.replace(".", "_"))


class Manifest:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, workload: dict) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == workload["config"]:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {workload['config']!r} in BENCHMARK.json")

    def reference(self, cfg: dict) -> ModuleType:
        return reference_module(cfg, self.root)

    def mix(self, workload: dict) -> dict:
        return load_json(os.path.join(self.root, "benchmark", "traffic",
                                      workload["traffic"] + ".json"))

    def client(self, mix: dict) -> type:
        path = os.path.join(self.root, "benchmark", "traffic", "kinds", mix["kind"] + ".py")
        return load_module(path, "bench_kind_" + mix["kind"]).Client

    def end_to_end(self, workload: dict) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if workload["name"] in m.get("workloads", [workload["name"]])]

    def per_layer(self, workload: dict) -> List[dict]:
        """The cell's per-layer metrics: those that list it, and those with
        no list whose end-to-end metric the cell reports."""
        moved = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if (workload["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def readers(self, metrics: List[dict]) -> Dict[str, Tuple[ModuleType, str]]:
        """Each metric's reader module (its `read(run)`) and unit, by name."""
        return {m["name"]: (load_module(
            os.path.join(self.root, "benchmark", "metrics", m["name"] + ".py"),
            "bench_metric_" + m["name"].replace(".", "_")), m["unit"]) for m in metrics}
