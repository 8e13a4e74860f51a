"""BENCHMARK.json and the files it names, looked up by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the configuration's file is the one its entry names, the mix is
``qqbench/traffic/<traffic>.json`` and each metric's reader is
``qqbench/metrics/<metric name>.py`` (one ``read(run)`` function). Adding a
cell, a configuration, a mix or a metric is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from .paths import PKG, ROOT


class Spec:
    """The parsed BENCHMARK.json of a checkout."""

    def __init__(self, data: dict, root: Path = ROOT):
        self.data, self.root = data, root
        self.configs = {c["name"]: c for c in data["configs"]}
        self.workloads = {w["name"]: w for w in data["workloads"]}
        self.end_to_end = {m["name"]: m for m in data["end_to_end"]}
        self.per_layer = {m["name"]: m for m in data["per_layer"]}

    @classmethod
    def load(cls, root: Path = ROOT) -> "Spec":
        with open(root / "BENCHMARK.json") as f:
            return cls(json.load(f), root)

    def workload(self, name: str) -> dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(self.workloads)})")
        return self.workloads[name]

    def config(self, cell: dict) -> dict:
        """The configuration file of a cell, with its entry's name."""
        entry = self.configs[cell["config"]]
        with open(self.root / entry["file"]) as f:
            cfg = json.load(f)
        if cfg.get("name", entry["name"]) != entry["name"]:
            raise ValueError(f"{entry['file']} names {cfg['name']!r}, not {entry['name']!r}")
        return dict(cfg, name=entry["name"])

    def traffic(self, cell: dict) -> dict:
        with open(PKG / "traffic" / f"{cell['traffic']}.json") as f:
            return dict(json.load(f), name=cell["traffic"])

    def metrics_of(self, cell: dict, trace: bool) -> list:
        """The metric entries a run of the cell reports: its end-to-end
        metrics with ``trace`` off, its per-layer metrics with it on. A
        metric without a ``workloads`` key belongs to every cell (a
        per-layer one to every cell that reports the metric it moves)."""
        if not trace:
            return [m for m in self.end_to_end.values()
                    if cell["name"] in m.get("workloads", [cell["name"]])]
        e2e = {m["name"] for m in self.metrics_of(cell, False)}
        return [m for m in self.per_layer.values()
                if cell["name"] in m.get("workloads", [cell["name"]] if m["moves"] in e2e else [])]


def reader(name: str):
    """The ``read`` function of ``qqbench/metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader ({path})")
    spec = importlib.util.spec_from_file_location(
        "qqbench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
