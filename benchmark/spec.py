"""Find a cell's files by the names in ``BENCHMARK.json``: its configuration,
traffic mix, limits, program adapter, plain reference and driver, and the
reader of each per-layer metric."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``, loaded once (names may hold ``-`` and ``.``)."""
    mod_name = f"benchmark._{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    mod = sys.modules.get(mod_name)
    if mod is None:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names resolved."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or benchmark()
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, by_name[name]
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(ROOT / conf["file"])
        self.config_name = conf["name"]
        self.traffic = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(HERE / "workloads" / f"{name}.json")["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def program_model(self):
        return module("models", self.config_name)

    def reference(self):
        return module("reference", self.config_name)

    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.traffic['driver']}").DRIVER
